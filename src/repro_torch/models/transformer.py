"""Decoder-only model stacks: ATTN blocks with a SwiGLU MLP, MAMBA blocks
with a SwiGLU or MoE MLP, and the xLSTM blocks (MLSTM, SLSTM) with none.

The port of ``repro/models/transformer.py`` for the architectures whose
patterns are made of those kinds: the serving path's qwen3-0.6b and
qwen1.5-0.5b (``(ATTN,)``, dense MLP), the sliding-window starcoder2-3b
(``(ATTN,)``, dense MLP, window 4096), xlstm-1.3b (7 MLSTM + 1 SLSTM) and
jamba-v0.1-52b (7 MAMBA + 1 ATTN, every other MLP a mixture of experts).
Entry points: ``serve_prefill`` (the prompt) and ``serve_decode`` (one
token per sequence after it).
The reference scans one superblock over stacked parameters; here the
layers are a plain Python loop over a ``ModuleList``, layer ``li`` of
kind ``block_pattern[li % period]``.

Weights keep the reference's ``(in, out)`` layout and are applied as
``x @ W`` (not transposed to ``nn.Linear``'s ``(out, in)``), so a
parameter tree of the reference converts leaf by leaf
(``from_jax_params``).
"""
from __future__ import annotations

import math
from typing import List, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (ATTN, MAMBA, MLSTM, SLSTM,
                                     ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (AttentionFn, DecodeAttentionFn,
                                          KVCache)
from repro_torch.models.common import (dense_init, embed_init,
                                       resolve_device, rms_norm, swiglu_mlp)
from repro_torch.models.ssm import MambaState, SSMFn
from repro_torch.models.xlstm import MLSTMFn, MLSTMState, SLSTMState

LayerState = Union[KVCache, MambaState, MLSTMState, SLSTMState]
# (block kind, MLP kind) pairs the port implements
PORTED_KINDS = {(ATTN, "dense"), (MAMBA, "dense"), (MAMBA, "moe"),
                (MLSTM, "none"), (SLSTM, "none")}


class ModelCache(NamedTuple):
    layers: List[LayerState]  # one state per layer, of the layer's kind
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
    kinds = set(zip(cfg.block_pattern, cfg.mlp_pattern))
    if not kinds <= PORTED_KINDS or cfg.encoder_decoder \
            or cfg.learned_pos_emb:
        raise NotImplementedError(
            f"{cfg.name}: only ATTN blocks with a dense MLP, MAMBA blocks "
            f"with a dense or MoE MLP and MLSTM/SLSTM blocks without one "
            f"are ported")


def _layer_shapes(cfg: ModelConfig, kind: str, mlp_kind: str) -> dict:
    """Parameter names and shapes of one layer of ``kind``."""
    d = cfg.d_model
    shapes = {"norm1": (d,)}
    if kind == ATTN:
        hd = cfg.resolved_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        shapes.update(wq=(d, h * hd), wk=(d, kvh * hd), wv=(d, kvh * hd),
                      wo=(h * hd, d))
        if cfg.qkv_bias:
            shapes.update(bq=(h * hd,), bk=(kvh * hd,), bv=(kvh * hd,))
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
    elif kind == MAMBA:
        shapes.update(ssm_mod.mamba_param_shapes(cfg))
    elif kind == MLSTM:
        shapes.update(xlstm_mod.mlstm_param_shapes(cfg))
    else:
        shapes.update(xlstm_mod.slstm_param_shapes(cfg))
    if mlp_kind == "dense":
        shapes.update(norm2=(d,), w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    elif mlp_kind == "moe":
        shapes.update(norm2=(d,), **moe_mod.moe_param_shapes(cfg))
    return shapes


def _param_dtype(name: str, kind: str, mlp_kind: str,
                 dtype: torch.dtype) -> torch.dtype:
    """float32 for the leaves the reference keeps in float32 in any model
    (xLSTM gates, Mamba's dt_bias, A_log and D, the MoE router), else
    ``dtype``."""
    fp32 = {MLSTM: xlstm_mod.FP32_PARAMS, SLSTM: xlstm_mod.FP32_PARAMS,
            MAMBA: ssm_mod.FP32_PARAMS}.get(kind, frozenset())
    if mlp_kind == "moe":
        fp32 = fp32 | moe_mod.FP32_PARAMS
    return torch.float32 if name in fp32 else dtype


def param_bytes(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
                ) -> int:
    """Bytes of a ``Transformer``'s parameters in ``dtype``, counted from
    the shapes before anything is allocated."""
    def nbytes(shape, dt):
        return math.prod(shape) * dt.itemsize
    d, v = cfg.d_model, cfg.vocab_size
    total = nbytes((v, d), dtype) + nbytes((d,), dtype)
    if not cfg.tie_embeddings:
        total += nbytes((d, v), dtype)
    period = len(cfg.block_pattern)
    for li in range(cfg.num_layers):
        kind, mlp_kind = cfg.block_pattern[li % period], \
            cfg.mlp_pattern[li % period]
        total += sum(nbytes(s, _param_dtype(n, kind, mlp_kind, dtype))
                     for n, s in _layer_shapes(cfg, kind, mlp_kind).items())
    return total


class Transformer(nn.Module):
    """Parameters of one model, and its prefill and decode entry points.

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
        d = cfg.d_model
        period = len(cfg.block_pattern)
        self.kinds = [(cfg.block_pattern[li % period],
                       cfg.mlp_pattern[li % period])
                      for li in range(cfg.num_layers)]
        gen = torch.Generator(device=self.device).manual_seed(seed) \
            if init else None

        def make(name, shape, kind=ATTN, mlp_kind="none"):
            pdtype = _param_dtype(name, kind, mlp_kind, dtype)
            kw = dict(dtype=pdtype, device=self.device)
            if gen is None:
                t = torch.empty(shape, **kw)
            elif "norm" in name:
                t = torch.ones(shape, **kw)
            elif name in ("bq", "bk", "bv", "conv_b", "b_i"):
                t = torch.zeros(shape, **kw)
            elif name == "b_f":          # open forget gates at init
                t = torch.full(shape, 3.0, **kw)
            elif name == "A_log":        # A = -(1..state) per channel
                t = torch.log(torch.arange(
                    1, shape[1] + 1, dtype=pdtype,
                    device=self.device)).expand(shape).contiguous()
            elif name == "dt_bias":      # softplus(-4.6) ~ 0.01
                t = torch.full(shape, -4.6, **kw)
            elif name == "D":
                t = torch.ones(shape, **kw)
            elif name == "b":            # sLSTM z, i, f, o biases
                t = torch.zeros(shape, **kw)
                t[2 * d:3 * d] = 3.0
            elif name == "embed":
                t = embed_init(gen, shape, pdtype, self.device)
            elif name == "conv_w":
                t = dense_init(gen, shape, pdtype, self.device, in_axis=0)
            else:
                t = dense_init(gen, shape, pdtype, self.device)
            return nn.Parameter(t, requires_grad=False)

        self.embed = make("embed", (cfg.vocab_size, d))
        self.final_norm = make("final_norm", (d,))
        self.lm_head = None if cfg.tie_embeddings \
            else make("lm_head", (d, cfg.vocab_size))
        self.layers = nn.ModuleList(
            nn.ParameterDict({n: make(n, s, kind, mlp_kind) for n, s in
                              _layer_shapes(cfg, kind, mlp_kind).items()})
            for kind, mlp_kind in self.kinds)

    # ---- embedding / head ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()]

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h @ head

    # ---- forward --------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> List[LayerState]:
        """Each layer's empty state: a KV cache sized for ``seq_len``, or
        a zero recurrent state (the mLSTM's and sLSTM's m at -1e30)."""
        cfg = self.cfg
        s_cache = decode_cache_len(cfg, seq_len)
        caches: List[LayerState] = []
        for kind, _ in self.kinds:
            if kind == ATTN:
                caches.append(attn_mod.make_kv_cache(
                    batch, s_cache, cfg.num_kv_heads, cfg.resolved_head_dim,
                    self.dtype, self.device))
            elif kind == MAMBA:
                caches.append(ssm_mod.make_mamba_state(
                    batch, cfg, self.dtype, self.device))
            elif kind == MLSTM:
                caches.append(xlstm_mod.make_mlstm_state(
                    batch, cfg, self.dtype, self.device))
            else:
                caches.append(xlstm_mod.make_slstm_state(batch, cfg,
                                                         self.device))
        return caches

    def _block(self, h: torch.Tensor, p: Mapping[str, torch.Tensor],
               kind: str, mlp_kind: str, *, mode: str, positions,
               cache: LayerState, pos: Optional[int] = None,
               attention: AttentionFn = ops.flash_attention,
               decode_attention: DecodeAttentionFn = ops.decode_attention,
               mlstm: MLSTMFn = ops.mlstm_chunk, ssm: SSMFn = ops.ssm_scan):
        """One layer, ``mode`` "prefill" (the segment) or "decode" (one
        token at position ``pos``)."""
        cfg = self.cfg
        x = rms_norm(h, p["norm1"], cfg.norm_eps)
        decode = mode == "decode"
        if kind == ATTN:
            out, new_cache = attn_mod.attn_forward(
                x, p, cfg, positions=positions, mode=mode, cache=cache,
                pos=pos, attention=attention,
                decode_attention=decode_attention)
        elif kind == MAMBA:
            out, new_cache = ssm_mod.mamba_decode(x, p, cfg, cache) \
                if decode else ssm_mod.mamba_mix(x, p, cfg, cache, ssm=ssm)
        elif kind == MLSTM:
            out, new_cache = xlstm_mod.mlstm_decode(x, p, cfg, cache) \
                if decode else xlstm_mod.mlstm_mix(x, p, cfg, cache,
                                                   mlstm=mlstm)
        else:
            out, new_cache = (xlstm_mod.slstm_decode if decode
                              else xlstm_mod.slstm_mix)(x, p, cfg, cache)
        h = h + out
        if mlp_kind == "dense":
            x2 = rms_norm(h, p["norm2"], cfg.norm_eps)
            h = h + swiglu_mlp(x2, p["w_gate"], p["w_up"], p["w_down"])
        elif mlp_kind == "moe":
            x2 = rms_norm(h, p["norm2"], cfg.norm_eps)
            h = h + (moe_mod.moe_forward_decode(x2, p, cfg) if decode
                     else moe_mod.moe_forward(x2, p, cfg)[0])
        return h, new_cache

    def serve_prefill(self, tokens: torch.Tensor,
                      cache_len: Optional[int] = None,
                      attention: AttentionFn = ops.flash_attention,
                      mlstm: MLSTMFn = ops.mlstm_chunk,
                      ssm: SSMFn = ops.ssm_scan):
        """Process the prompt (B, S) and build the decode cache.

        Returns (last-token logits (B, V), ModelCache with pos = S).
        ``attention``, ``mlstm`` and ``ssm`` replace the attention op, the
        mLSTM chunk op and the selective-scan op (same signatures as
        ``ops.flash_attention``, ``ops.mlstm_chunk`` and ``ops.ssm_scan``),
        e.g. by their plain versions for a check."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None]
        caches = self.init_cache(b, cache_len if cache_len is not None
                                 else s)
        h = self.embed_tokens(tokens)
        new_caches = []
        for p, (kind, mlp_kind), cache in zip(self.layers, self.kinds,
                                               caches):
            h, c = self._block(h, p, kind, mlp_kind, mode="prefill",
                               positions=positions, cache=cache,
                               attention=attention, mlstm=mlstm, ssm=ssm)
            new_caches.append(c)
        h = rms_norm(h[:, -1:], self.final_norm, self.cfg.norm_eps)
        logits = self.lm_logits(h)[:, 0]
        return logits, ModelCache(layers=new_caches, pos=s)

    def serve_decode(self, tokens: torch.Tensor, cache: ModelCache,
                     decode_attention: DecodeAttentionFn =
                     ops.decode_attention):
        """One decode step.  tokens: (B,) -> (logits (B, V), ModelCache
        with pos + 1).

        Runs after ``serve_prefill`` (with ``cache_len`` = prompt + new
        tokens, or any length for a sliding-window model, whose cache is a
        ring of the window's size).  The new token sits at absolute
        position ``cache.pos``: RoPE takes that position, and its k/v go to
        ring slot ``pos % S_cache``.  Each attention layer's KV cache is
        updated in place, so the ``cache`` handed in is advanced too and
        must not be used again; the recurrent layers get new states.
        ``decode_attention`` replaces the decode attention op (same
        signature as ``ops.decode_attention``), e.g. by its plain version
        for a check."""
        pos = cache.pos
        positions = torch.full((1, 1), pos, dtype=torch.long,
                               device=tokens.device)
        h = self.embed_tokens(tokens[:, None])
        new_caches = []
        for p, (kind, mlp_kind), state in zip(self.layers, self.kinds,
                                               cache.layers):
            h, c = self._block(h, p, kind, mlp_kind, mode="decode",
                               positions=positions, cache=state, pos=pos,
                               decode_attention=decode_attention)
            new_caches.append(c)
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        logits = self.lm_logits(h)[:, 0]
        return logits, ModelCache(layers=new_caches, pos=pos + 1)


def from_jax_params(tree: Mapping, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> Transformer:
    """A ``Transformer`` holding the reference's parameters.

    ``tree`` is ``repro.models.init_params(key, cfg)`` with its leaves
    turned into numpy arrays by the caller (this package cannot import
    jax).  Leaves are cast to float32 first (``torch.from_numpy`` rejects
    ``ml_dtypes.bfloat16``; bf16 -> fp32 -> bf16 is exact), then to the
    parameter's dtype: ``dtype``, or float32 for the leaves the reference
    keeps in float32 (the xLSTM gate weights and biases, Mamba's
    ``dt_bias``, ``A_log`` and ``D``, the MoE ``router``).  The reference
    stacks each pattern position's layers on a leading superblock axis, so
    layer ``i * period + j`` is ``tree["blocks"][j][...][i]``; a layer's
    ``mix`` tree (and ``mlp``, where it has one) flatten into its
    parameter dict.  Weights stay ``(in, out)``.
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
        flat = {"norm1": blk["norm1"], **blk["mix"]}
        if "mlp" in blk:
            flat.update(norm2=blk["norm2"], **blk["mlp"])
        if set(flat) != set(p.keys()):
            raise ValueError(f"layer {li}: keys {sorted(flat)} != "
                             f"{sorted(p.keys())}")
        for name, leaf in flat.items():
            put(p[name], np.asarray(leaf)[i])
    return model
