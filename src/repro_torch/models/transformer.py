"""Dense decoder-only transformer (ATTN blocks with a SwiGLU MLP).

The port of ``repro/models/transformer.py`` for the architectures whose
pattern is ``(ATTN,)`` with a dense MLP, as the serving path's qwen3-0.6b
and qwen1.5-0.5b are.  The reference scans one superblock over stacked
parameters; here the layers are a plain Python loop over a ``ModuleList``.

Weights keep the reference's ``(in, out)`` layout and are applied as
``x @ W`` (not transposed to ``nn.Linear``'s ``(out, in)``), so a
parameter tree of the reference converts leaf by leaf
(``from_jax_params``).
"""
from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttentionFn, KVCache
from repro_torch.models.common import (dense_init, embed_init,
                                       resolve_device, rms_norm, swiglu_mlp)


class ModelCache(NamedTuple):
    layers: List[KVCache]     # one KV cache per layer
    pos: int                  # tokens already processed


def decode_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Attention-cache length for a decode context of ``seq_len``: the
    window for sliding-window archs, the whole context up to 128k, the
    long-context window beyond (dense archs)."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    if seq_len > 131_072 and cfg.arch_type != "hybrid":
        return min(seq_len, cfg.long_context_window)
    return seq_len


def _check_ported(cfg: ModelConfig) -> None:
    if any(k != ATTN for k in cfg.block_pattern) \
            or any(m != "dense" for m in cfg.mlp_pattern) \
            or cfg.encoder_decoder or cfg.learned_pos_emb:
        raise NotImplementedError(
            f"{cfg.name}: only ATTN blocks with a dense MLP are ported")


class Transformer(nn.Module):
    """Parameters of one model, and its prefill entry point.

    Constructed from a seed (``torch.Generator`` on the target device) or,
    through ``from_jax_params``, from the reference's parameters.
    ``device=None`` means the card and raises without one.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 init: bool = True):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        shapes = {"norm1": (d,), "wq": (d, h * hd), "wk": (d, kvh * hd),
                  "wv": (d, kvh * hd), "wo": (h * hd, d), "norm2": (d,),
                  "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                  "w_down": (cfg.d_ff, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(h * hd,), bk=(kvh * hd,), bv=(kvh * hd,))
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
        gen = torch.Generator(device=self.device).manual_seed(seed) \
            if init else None

        def make(name, shape):
            if gen is None:
                t = torch.empty(shape, dtype=dtype, device=self.device)
            elif "norm" in name:
                t = torch.ones(shape, dtype=dtype, device=self.device)
            elif name in ("bq", "bk", "bv"):
                t = torch.zeros(shape, dtype=dtype, device=self.device)
            elif name == "embed":
                t = embed_init(gen, shape, dtype, self.device)
            else:
                t = dense_init(gen, shape, dtype, self.device)
            return nn.Parameter(t, requires_grad=False)

        self.embed = make("embed", (cfg.vocab_size, d))
        self.final_norm = make("final_norm", (d,))
        self.lm_head = None if cfg.tie_embeddings \
            else make("lm_head", (d, cfg.vocab_size))
        self.layers = nn.ModuleList(
            nn.ParameterDict({n: make(n, s) for n, s in shapes.items()})
            for _ in range(cfg.num_layers))

    # ---- embedding / head ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()]

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h @ head

    # ---- forward --------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> List[KVCache]:
        cfg = self.cfg
        s_cache = decode_cache_len(cfg, seq_len)
        return [attn_mod.make_kv_cache(batch, s_cache, cfg.num_kv_heads,
                                       cfg.resolved_head_dim, self.dtype,
                                       self.device)
                for _ in range(cfg.num_layers)]

    def _prefill_block(self, h: torch.Tensor, p: Mapping[str, torch.Tensor],
                       *, positions, cache: KVCache, attention: AttentionFn):
        cfg = self.cfg
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        out, new_cache = attn_mod.attn_forward(
            x, p, cfg, positions=positions, mode="prefill", cache=cache,
            attention=attention)
        h = h + out
        x2 = rms_norm(h, p["norm2"], cfg.norm_eps)
        h = h + swiglu_mlp(x2, p["w_gate"], p["w_up"], p["w_down"])
        return h, new_cache

    def serve_prefill(self, tokens: torch.Tensor,
                      cache_len: Optional[int] = None,
                      attention: AttentionFn = ops.flash_attention):
        """Process the prompt (B, S) and build the decode cache.

        Returns (last-token logits (B, V), ModelCache with pos = S).
        ``attention`` replaces the attention op (same signature as
        ``ops.flash_attention``), e.g. by its plain version for a check."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None]
        caches = self.init_cache(b, cache_len if cache_len is not None
                                 else s)
        h = self.embed_tokens(tokens)
        new_caches = []
        for p, cache in zip(self.layers, caches):
            h, c = self._prefill_block(h, p, positions=positions,
                                       cache=cache, attention=attention)
            new_caches.append(c)
        h = rms_norm(h[:, -1:], self.final_norm, self.cfg.norm_eps)
        logits = self.lm_logits(h)[:, 0]
        return logits, ModelCache(layers=new_caches, pos=s)


def from_jax_params(tree: Mapping, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> Transformer:
    """A ``Transformer`` holding the reference's parameters.

    ``tree`` is ``repro.models.init_params(key, cfg)`` with its leaves
    turned into numpy arrays by the caller (this package cannot import
    jax).  Leaves are cast to float32 first (``torch.from_numpy`` rejects
    ``ml_dtypes.bfloat16``; bf16 -> fp32 -> bf16 is exact), then to
    ``dtype``.  The reference stacks each pattern position's layers on a
    leading superblock axis, so layer ``i * period + j`` is
    ``tree["blocks"][j][...][i]``.  Weights stay ``(in, out)``.
    """
    model = Transformer(cfg, device=device, dtype=dtype, init=False)

    def put(param: nn.Parameter, leaf) -> None:
        arr = np.array(leaf, dtype=np.float32)     # a writable copy
        if arr.shape != tuple(param.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    period = len(cfg.block_pattern)
    for li, p in enumerate(model.layers):
        i, j = divmod(li, period)
        blk = tree["blocks"][j]
        flat = {"norm1": blk["norm1"], "norm2": blk["norm2"],
                **blk["mix"], **blk["mlp"]}
        if set(flat) != set(p.keys()):
            raise ValueError(f"layer {li}: keys {sorted(flat)} != "
                             f"{sorted(p.keys())}")
        for name, leaf in flat.items():
            put(p[name], np.asarray(leaf)[i])
    return model
