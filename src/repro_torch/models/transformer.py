"""Model stacks: ATTN blocks with a SwiGLU or MoE MLP, MAMBA blocks with a
SwiGLU or MoE MLP, the xLSTM blocks (MLSTM, SLSTM) with none, and the
encoder-decoder's CROSS blocks with their encoder.

The port of ``repro/models/transformer.py`` for every architecture of the
reference: the serving path's qwen3-0.6b and qwen1.5-0.5b (``(ATTN,)``,
dense MLP), the sliding-window starcoder2-3b (``(ATTN,)``, dense MLP,
window 4096), chameleon-34b (dense, qk-norm) and granite-34b (dense, MQA:
48 heads over one KV head, qkv bias, tied head), the mixtures of experts
qwen3-moe-30b-a3b (128 experts, top 8, qk-norm) and phi3.5-moe-42b-a6.6b
(16 experts, top 2) (``(ATTN,)``, every MLP a mixture of experts),
xlstm-1.3b (7 MLSTM + 1 SLSTM), jamba-v0.1-52b (7 MAMBA + 1 ATTN, every
other MLP a mixture of experts) and whisper-medium (24 CROSS decoder
layers over a 24-layer encoder, sinusoidal positions instead of RoPE).
Entry points: ``serve_prefill`` (the prompt, and for an encoder-decoder
the encoder's frames), ``serve_decode`` (one token per sequence after
it) and ``forward_train`` (the mean token loss of a batch, which autograd
differentiates; ``repro_torch.training`` builds the train step on it).
The reference scans one superblock over stacked parameters; here the
layers are a plain Python loop over a ``ModuleList``, layer ``li`` of
kind ``block_pattern[li % period]``, and the encoder's layers another.
Training rematerialises each layer (``torch.utils.checkpoint``), where the
reference rematerialises each superblock: the same values.

Weights keep the reference's ``(in, out)`` layout and are applied as
``x @ W`` (not transposed to ``nn.Linear``'s ``(out, in)``), so a
parameter tree of the reference converts leaf by leaf
(``from_jax_params``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, CROSS, MAMBA, MLSTM, SLSTM,
                                     ModelConfig)
from repro_torch.core import trace as tracing
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (AttentionFn, DecodeAttentionFn,
                                          KVCache)
from repro_torch.models.common import (constrain, cross_entropy_loss,
                                       dense_init, embed_init, gather_params,
                                       local_op, resolve_device, rms_norm,
                                       swiglu_mlp, unshard_dims)
from repro_torch.models.ssm import MambaState, SSMFn
from repro_torch.models.xlstm import MLSTMFn, MLSTMState, SLSTMState

LayerState = Union[KVCache, MambaState, MLSTMState, SLSTMState]
# (block kind, MLP kind) pairs the port implements
PORTED_KINDS = {(ATTN, "dense"), (ATTN, "moe"), (CROSS, "dense"),
                (MAMBA, "dense"), (MAMBA, "moe"), (MLSTM, "none"),
                (SLSTM, "none")}
# a CROSS layer's cross-attention leaves carry this prefix in its flat
# parameter dict (``cross_wq`` ... beside the self-attention's ``wq``)
CROSS_PREFIX = "cross_"


class ModelCache(NamedTuple):
    layers: List[LayerState]  # one state per layer, of the layer's kind
    pos: int                  # tokens already processed
    # encoder-decoder: per layer, a CROSS layer's encoder K/V (B, S_enc,
    # KVH, hd), computed once by the prefill and read by every decode
    # step (None for other layers); None for a decoder-only model
    cross: Optional[List[Optional[KVCache]]] = None


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
    if not kinds <= PORTED_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: only ATTN blocks with a dense or MoE MLP, CROSS "
            f"blocks with a dense MLP, MAMBA blocks with a dense or MoE MLP "
            f"and MLSTM/SLSTM blocks without one are ported, not "
            f"{sorted(kinds - PORTED_KINDS)}")


def _attn_shapes(cfg: ModelConfig) -> dict:
    """Names and shapes of one attention's projections (and biases and
    qk-norm scales, where the config has them)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    shapes = dict(wq=(d, h * hd), wk=(d, kvh * hd), wv=(d, kvh * hd),
                  wo=(h * hd, d))
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kvh * hd,), bv=(kvh * hd,))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


def _layer_shapes(cfg: ModelConfig, kind: str, mlp_kind: str) -> dict:
    """Parameter names and shapes of one layer of ``kind``."""
    d = cfg.d_model
    shapes = {"norm1": (d,)}
    if kind in (ATTN, CROSS):
        shapes.update(_attn_shapes(cfg))
        if kind == CROSS:
            shapes["norm_cross"] = (d,)
            shapes.update({CROSS_PREFIX + n: s
                           for n, s in _attn_shapes(cfg).items()})
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


def cross_params(p: Mapping[str, torch.Tensor]) -> dict:
    """A CROSS layer's cross-attention leaves under the names
    ``attention.cross_attn_forward`` reads (``cross_wq`` -> ``wq``)."""
    return {n[len(CROSS_PREFIX):]: t for n, t in p.items()
            if n.startswith(CROSS_PREFIX)}


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
    if cfg.encoder_decoder:
        total += nbytes((d,), dtype) + cfg.num_encoder_layers * sum(
            nbytes(s, dtype)
            for s in _layer_shapes(cfg, ATTN, "dense").values())
    return total


class Transformer(nn.Module):
    """Parameters of one model, and its prefill and decode entry points.

    Constructed from a seed (``torch.Generator`` on the target device) or,
    through ``from_jax_params``, from the reference's parameters.
    ``device=None`` means the card and raises without one.  Parameters are
    made with ``requires_grad=False``: serving never builds a graph, and
    the train step (``training.make_train_step``) turns them on.
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
            if name.startswith(CROSS_PREFIX):
                name = name[len(CROSS_PREFIX):]
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
        # the encoder (encoder-decoder only): ATTN layers with a dense MLP,
        # run without a mask, then a final norm
        n_enc = cfg.num_encoder_layers if cfg.encoder_decoder else 0
        enc_shapes = _layer_shapes(cfg, ATTN, "dense")
        self.enc_layers = nn.ModuleList(
            nn.ParameterDict({n: make(n, s, mlp_kind="dense")
                              for n, s in enc_shapes.items()})
            for _ in range(n_enc))
        self.enc_final_norm = make("enc_final_norm", (d,)) if n_enc \
            else None

    # ---- embedding / head ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Token embeddings; with ``learned_pos_emb`` the sinusoidal table
        at ``positions`` added, as the reference does (no learned
        table)."""
        # on DTensors the lookup runs shard-local over the whole table
        h = local_op(_lookup, tokens, self._top("embed"), replicate=(1,))
        if self.cfg.learned_pos_emb and positions is not None:
            h = h + sinusoidal_pos(positions, self.cfg.d_model).to(h.dtype)
        return h

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self._top("embed").T if self.cfg.tie_embeddings \
            else self._top("lm_head")
        return constrain(h @ head, "logits")

    def _top(self, name: str) -> torch.Tensor:
        """A top-level parameter, FSDP-gathered in a sharded training
        launch (``common.gather_params``)."""
        return gather_params({name: getattr(self, name)})[name]

    # ---- forward --------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> List[LayerState]:
        """Each layer's empty state: a KV cache sized for ``seq_len``, or
        a zero recurrent state (the mLSTM's and sLSTM's m at -1e30)."""
        cfg = self.cfg
        s_cache = decode_cache_len(cfg, seq_len)
        caches: List[LayerState] = []
        for kind, _ in self.kinds:
            if kind in (ATTN, CROSS):
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
               cross_kv: Optional[KVCache] = None,
               attention: AttentionFn = ops.flash_attention,
               decode_attention: DecodeAttentionFn = ops.decode_attention,
               mlstm: MLSTMFn = ops.mlstm_chunk, ssm: SSMFn = ops.ssm_scan):
        """One layer, ``mode`` "prefill" (the segment), "train" (the
        segment from a fresh zero recurrent state, no cache) or "decode"
        (one token at position ``pos``).  A CROSS layer attends to
        ``cross_kv`` (the encoder's K/V) after its causal self-attention.
        Returns (h, the layer's new state, the MoE load-balance loss or
        None)."""
        cfg = self.cfg
        p = gather_params(p)
        # sequence parallelism: the sequence is gathered entering attention
        # and the MLP (a no-op on one device)
        x = unshard_dims(rms_norm(h, p["norm1"], cfg.norm_eps), (1,))
        decode = mode == "decode"
        if mode == "train":
            b = x.shape[0]
            if kind == MAMBA:
                cache = ssm_mod.make_mamba_state(b, cfg, x.dtype, x.device)
            elif kind == MLSTM:
                cache = xlstm_mod.make_mlstm_state(b, cfg, x.dtype, x.device)
            elif kind == SLSTM:
                cache = xlstm_mod.make_slstm_state(b, cfg, x.device)
        if kind in (ATTN, CROSS):
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
        # each branch's output joins the residual stream in its layout (a
        # reduce-scatter under sequence parallelism, as XLA's from the
        # reference's "residual" constraint; a no-op on one device)
        h = h + constrain(out, "residual")
        if kind == CROSS:
            xc = unshard_dims(rms_norm(h, p["norm_cross"], cfg.norm_eps),
                              (1,))
            h = h + constrain(attn_mod.cross_attn_forward(
                xc, cross_params(p), cfg, cross_kv, mode=mode,
                attention=attention, decode_attention=decode_attention),
                "residual")
        aux = None
        if mlp_kind == "dense":
            x2 = unshard_dims(rms_norm(h, p["norm2"], cfg.norm_eps), (1,))
            h = h + constrain(swiglu_mlp(x2, p["w_gate"], p["w_up"],
                                         p["w_down"]), "residual")
        elif mlp_kind == "moe":
            x2 = rms_norm(h, p["norm2"], cfg.norm_eps)
            if decode:
                h = h + moe_mod.moe_forward_decode(x2, p, cfg)
            else:
                out2, aux = moe_mod.moe_forward(x2, p, cfg)
                h = h + constrain(out2, "residual")
        return h, new_cache, aux

    def _enc_layer(self, h: torch.Tensor, p: Mapping[str, torch.Tensor],
                   attention: AttentionFn) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = h.shape
        p = gather_params(p)
        x = unshard_dims(rms_norm(h, p["norm1"], cfg.norm_eps), (1,))
        q, k, v = attn_mod.project_qkv(x, p, cfg, None)
        out = attn_mod.segment_attention(attention, q, k, v, causal=False,
                                         window=None)
        h = h + out.reshape(b, s, -1) @ p["wo"]
        x2 = unshard_dims(rms_norm(h, p["norm2"], cfg.norm_eps), (1,))
        return h + swiglu_mlp(x2, p["w_gate"], p["w_up"], p["w_down"])

    def encode(self, frames: torch.Tensor,
               attention: AttentionFn = ops.flash_attention,
               remat: bool = False) -> torch.Tensor:
        """The encoder: frames (B, S_enc, d), the stubbed front end's
        embeddings, plus the sinusoidal table at 0..S_enc-1, then per
        layer RMSNorm -> QKV -> attention with no mask -> ``wo`` ->
        residual, RMSNorm -> SwiGLU -> residual; then ``enc_final_norm``.
        ``attention`` is called with ``causal=False``.  ``remat``
        rematerialises each layer in the backward."""
        cfg = self.cfg
        if not cfg.encoder_decoder:
            raise ValueError(f"{cfg.name} has no encoder")
        s = frames.shape[1]
        positions = torch.arange(s, device=frames.device)[None]
        h = frames + sinusoidal_pos(positions, cfg.d_model).to(frames.dtype)
        for p in self.enc_layers:
            h = _maybe_remat(remat, self._enc_layer, h, p, attention)
        return rms_norm(h, self._top("enc_final_norm"), cfg.norm_eps)

    def serve_prefill(self, tokens: torch.Tensor,
                      cache_len: Optional[int] = None,
                      frames: Optional[torch.Tensor] = None,
                      attention: AttentionFn = ops.flash_attention,
                      mlstm: MLSTMFn = ops.mlstm_chunk,
                      ssm: SSMFn = ops.ssm_scan):
        """Process the prompt (B, S) and build the decode cache.

        Returns (last-token logits (B, V), ModelCache with pos = S).  An
        encoder-decoder model needs ``frames`` (B, S_enc, d): the encoder
        runs once, and each CROSS layer's K/V of its output go to the
        cache's ``cross``; under the process's tracer
        (``core.trace.PROCESS``), when it is on, the encoder's dispatch is
        an ``encode`` span.  ``attention``, ``mlstm`` and ``ssm`` replace
        the attention op (every call: the encoder's, the self- and the
        cross-attention), the mLSTM chunk op and the selective-scan op
        (same signatures as ``ops.flash_attention``, ``ops.mlstm_chunk``
        and ``ops.ssm_scan``), e.g. by their plain versions for a
        check."""
        cfg = self.cfg
        if cfg.encoder_decoder != (frames is not None):
            raise ValueError(
                f"{cfg.name}: an encoder-decoder prefill needs the "
                f"encoder's frames, and only it takes them")
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None]
        caches = self.init_cache(b, cache_len if cache_len is not None
                                 else s)
        enc_out = None
        if frames is not None:
            tr = tracing.PROCESS
            if tr.on:
                t0 = tr.now()
            enc_out = self.encode(frames, attention)
            if tr.on:
                tr.span("encode", t0, tr.now())
        h = self.embed_tokens(tokens, positions)
        new_caches, cross = [], []
        for p, (kind, mlp_kind), cache in zip(self.layers, self.kinds,
                                               caches):
            ckv = attn_mod.encode_cross_kv(enc_out, cross_params(p), cfg) \
                if kind == CROSS else None
            h, c, _ = self._block(h, p, kind, mlp_kind, mode="prefill",
                                  positions=positions, cache=cache,
                                  cross_kv=ckv, attention=attention,
                                  mlstm=mlstm, ssm=ssm)
            h = constrain(h, "residual")
            new_caches.append(c)
            cross.append(ckv)
        h = rms_norm(unshard_dims(h, (1,))[:, -1:], self.final_norm,
                     cfg.norm_eps)
        logits = self.lm_logits(h)[:, 0]
        return logits, ModelCache(layers=new_caches, pos=s,
                                  cross=cross if enc_out is not None
                                  else None)

    def serve_decode(self, tokens: torch.Tensor, cache: ModelCache,
                     decode_attention: DecodeAttentionFn =
                     ops.decode_attention):
        """One decode step.  tokens: (B,) -> (logits (B, V), ModelCache
        with pos + 1).

        Runs after ``serve_prefill`` (with ``cache_len`` = prompt + new
        tokens, or any length for a sliding-window model, whose cache is a
        ring of the window's size).  The new token sits at absolute
        position ``cache.pos``: RoPE (or the sinusoidal table) takes that
        position, and its k/v go to ring slot ``pos % S_cache``.  Each
        attention layer's KV cache is updated in place, so the ``cache``
        handed in is advanced too and must not be used again; the
        recurrent layers get new states.  A CROSS layer reads the encoder
        K/V the prefill left in ``cache.cross`` (the encoder never runs
        again).  ``decode_attention`` replaces the decode attention op
        (same signature as ``ops.decode_attention``; every call, the
        cross-attention's too), e.g. by its plain version for a check."""
        pos = cache.pos
        positions = torch.full((1, 1), pos, dtype=torch.long,
                               device=tokens.device)
        h = self.embed_tokens(tokens[:, None], positions)
        cross = cache.cross or [None] * len(self.layers)
        new_caches = []
        for p, (kind, mlp_kind), state, ckv in zip(
                self.layers, self.kinds, cache.layers, cross):
            h, c, _ = self._block(h, p, kind, mlp_kind, mode="decode",
                                  positions=positions, cache=state, pos=pos,
                                  cross_kv=ckv,
                                  decode_attention=decode_attention)
            h = constrain(h, "residual")
            new_caches.append(c)
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        logits = self.lm_logits(h)[:, 0]
        return logits, ModelCache(layers=new_caches, pos=pos + 1,
                                  cross=cache.cross)

    def _train_layer(self, h: torch.Tensor, enc_out: Optional[torch.Tensor],
                     p: Mapping[str, torch.Tensor], kind: str, mlp_kind: str,
                     positions: torch.Tensor, attention: AttentionFn,
                     mlstm: MLSTMFn, ssm: SSMFn):
        ckv = attn_mod.encode_cross_kv(enc_out, cross_params(p), self.cfg) \
            if kind == CROSS else None
        h, _, aux = self._block(h, p, kind, mlp_kind, mode="train",
                                positions=positions, cache=None,
                                cross_kv=ckv, attention=attention,
                                mlstm=mlstm, ssm=ssm)
        return constrain(h, "residual"), aux

    def forward_train(self, tokens: torch.Tensor, labels: torch.Tensor,
                      frames: Optional[torch.Tensor] = None,
                      remat: bool = True,
                      attention: AttentionFn = ops.flash_attention,
                      mlstm: MLSTMFn = ops.mlstm_chunk,
                      ssm: SSMFn = ops.ssm_scan) -> torch.Tensor:
        """The training loss of a batch (twin of the reference's
        ``forward_train``): tokens, labels (B, S) -> the mean token cross
        entropy (fp32) plus the MoE layers' load-balance losses.

        Every layer runs in "train" mode: attention causal over the
        segment, the recurrent mixers from a zero state; an
        encoder-decoder model needs ``frames`` (B, S_enc, d), which its
        encoder runs over in the model's dtype (cast here; the reference
        promotes the encoder to the frames' fp32), and each CROSS layer
        attends to the K/V of the encoder's output.  ``remat``
        rematerialises each layer (and each encoder layer) in the backward
        through ``torch.utils.checkpoint``.  ``attention``, ``mlstm`` and
        ``ssm`` replace the ops, as in ``serve_prefill`` (on the card each
        of the three default ops has a backward kernel)."""
        cfg = self.cfg
        if cfg.encoder_decoder != (frames is not None):
            raise ValueError(
                f"{cfg.name}: an encoder-decoder loss needs the encoder's "
                f"frames, and only it takes them")
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)[None]
        enc_out = None if frames is None else self.encode(
            frames.to(self.dtype), attention, remat=remat)
        h = constrain(self.embed_tokens(tokens, positions), "residual")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p, (kind, mlp_kind) in zip(self.layers, self.kinds):
            layer = functools.partial(
                self._train_layer, p=p, kind=kind, mlp_kind=mlp_kind,
                positions=positions, attention=attention, mlstm=mlstm,
                ssm=ssm)
            h, a = _maybe_remat(remat, layer, h, enc_out)
            if a is not None:
                aux = aux + a
        h = unshard_dims(rms_norm(h, self.final_norm, cfg.norm_eps), (1,))
        return cross_entropy_loss(self.lm_logits(h), labels) + aux


def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def _maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward when ``remat`` and
    grad is enabled (non-reentrant ``torch.utils.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (..., S) -> (..., S, d) fp32: sin then cos of the
    positions at the frequencies exp(-log(1e4) i / max(d/2 - 1, 1)), i <
    d/2, the reference's ``_sinusoidal_pos`` (the table both the encoder's
    frames and, with ``learned_pos_emb``, the tokens get)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _flat_block(blk: Mapping) -> dict:
    """One pattern position's subtree of the reference, flattened to the
    port's parameter names."""
    flat = {"norm1": blk["norm1"], **blk["mix"]}
    if "cross" in blk:
        flat["norm_cross"] = blk["norm_cross"]
        flat.update({CROSS_PREFIX + n: leaf
                     for n, leaf in blk["cross"].items()})
    if "mlp" in blk:
        flat.update(norm2=blk["norm2"], **blk["mlp"])
    return flat


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
    ``mix`` tree (and ``mlp``, where it has one; a CROSS layer's
    ``norm_cross`` and ``cross`` tree, as ``cross_*``) flatten into its
    parameter dict.  An encoder-decoder's ``enc_blocks`` are stacked over
    the encoder's layers, and ``enc_final_norm`` follows them.  Weights
    stay ``(in, out)``.  A missing or extra leaf raises ``ValueError``.
    """
    model = Transformer(cfg, device=device, dtype=dtype, init=False)

    def put(param: nn.Parameter, leaf) -> None:
        arr = np.array(leaf, dtype=np.float32)     # a writable copy
        if arr.shape != tuple(param.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr))

    def put_layer(p: nn.ParameterDict, flat: dict, i: int, where: str):
        if set(flat) != set(p.keys()):
            raise ValueError(f"{where}: keys {sorted(flat)} != "
                             f"{sorted(p.keys())}")
        for name, leaf in flat.items():
            put(p[name], np.asarray(leaf)[i])

    top = {"embed", "final_norm", "blocks"}
    if model.lm_head is not None:
        top.add("lm_head")
    if cfg.encoder_decoder:
        top |= {"enc_blocks", "enc_final_norm"}
    if set(tree) != top:
        raise ValueError(f"top-level keys {sorted(tree)} != {sorted(top)}")
    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    period = len(cfg.block_pattern)
    for li, p in enumerate(model.layers):
        i, j = divmod(li, period)
        put_layer(p, _flat_block(tree["blocks"][j]), i, f"layer {li}")
    if cfg.encoder_decoder:
        enc = _flat_block(tree["enc_blocks"])
        for li, p in enumerate(model.enc_layers):
            put_layer(p, enc, li, f"encoder layer {li}")
        put(model.enc_final_norm, tree["enc_final_norm"])
    return model


def _nest_block(flat: Mapping, cfg: ModelConfig, kind: str,
                mlp_kind: str) -> dict:
    """One layer's flat leaves regrouped into the reference's subtree
    (the inverse of ``_flat_block``)."""
    mix = {ATTN: _attn_shapes, CROSS: _attn_shapes,
           MAMBA: ssm_mod.mamba_param_shapes,
           MLSTM: xlstm_mod.mlstm_param_shapes,
           SLSTM: xlstm_mod.slstm_param_shapes}[kind](cfg)
    blk = {"norm1": flat["norm1"], "mix": {n: flat[n] for n in mix}}
    if kind == CROSS:
        blk["norm_cross"] = flat["norm_cross"]
        blk["cross"] = cross_params(flat)
    if mlp_kind != "none":
        mlp = ("w_gate", "w_up", "w_down") if mlp_kind == "dense" \
            else moe_mod.moe_param_shapes(cfg)
        blk["norm2"] = flat["norm2"]
        blk["mlp"] = {n: flat[n] for n in mlp}
    return blk


def to_jax_params(model: Transformer,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> dict:
    """The model's parameters as the reference's tree: the inverse of
    ``from_jax_params``.

    ``tensors`` maps the model's parameter names (``named_parameters``)
    to tensors of their shapes, e.g. their gradients; by default the
    parameters themselves.  Leaves are float32 numpy arrays (a bf16 value
    is exact in float32), each pattern position's layers stacked on a
    leading superblock axis as the reference stacks them, the encoder's
    over its layers; so ``to_jax_params(from_jax_params(tree, cfg))``
    equals ``tree`` (cast to float32) bit for bit."""
    cfg = model.cfg
    named = dict(model.named_parameters()) if tensors is None else tensors

    def leaf(name: str) -> np.ndarray:
        return named[name].detach().float().cpu().numpy()

    def stacked(layers: List[int], prefix: str, kind: str,
                mlp_kind: str) -> dict:
        shapes = _layer_shapes(cfg, kind, mlp_kind)
        flat = {n: np.stack([leaf(f"{prefix}.{li}.{n}") for li in layers])
                for n in shapes}
        return _nest_block(flat, cfg, kind, mlp_kind)

    tree: Dict[str, object] = {"embed": leaf("embed"),
                               "final_norm": leaf("final_norm")}
    if model.lm_head is not None:
        tree["lm_head"] = leaf("lm_head")
    period = len(cfg.block_pattern)
    tree["blocks"] = tuple(
        stacked(list(range(j, cfg.num_layers, period)), "layers", kind,
                mlp_kind)
        for j, (kind, mlp_kind) in enumerate(model.kinds[:period]))
    if cfg.encoder_decoder:
        tree["enc_blocks"] = stacked(list(range(len(model.enc_layers))),
                                     "enc_layers", ATTN, "dense")
        tree["enc_final_norm"] = leaf("enc_final_norm")
    return tree
