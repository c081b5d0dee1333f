"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential) [arXiv:2405.04517].

The port of ``repro/models/xlstm.py``, prefill and decode.  The mLSTM
recurrence runs in the chunkwise form, each chunk through
``kernels.ops.mlstm_chunk`` (the Hopper kernel on the card, its plain
version on the CPU) unless the caller hands another function of the same
signature as ``mlstm``; the carry (C, n, m) crosses chunks in fp32.  The
sLSTM keeps its sequential scan as a plain Python loop over the sequence:
it is no Pallas kernel in the reference either.  A decode step
(``mlstm_decode``, ``slstm_decode``) is the single-step recurrence in plain
torch, as in the reference, which has no kernel for it.

Parameters are the reference's, in its layout; the gate weights and
biases (``FP32_PARAMS``) stay float32 in a bf16 model, as there.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (causal_conv, constrain, local_op,
                                       rms_norm)

MLSTM_CHUNK = 256
NEG_INF = -1e30
# parameters kept in float32 whatever the model's dtype
FP32_PARAMS = frozenset({"w_i", "w_f", "b_i", "b_f", "b"})

MLSTMFn = Callable[..., tuple]


# ==========================================================================
# mLSTM
# ==========================================================================

class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, hd, hd) stabilised matrix memory, fp32
    n: torch.Tensor     # (B, H, hd)     stabilised normaliser, fp32
    m: torch.Tensor     # (B, H)         log-space stabiliser, fp32
    conv: torch.Tensor  # (B, ck-1, inner) causal-conv tail, model dtype


def _mlstm_dims(cfg: ModelConfig):
    inner = cfg.xlstm_expand * cfg.d_model
    h = cfg.xlstm_num_heads
    return inner, h, inner // h


def mlstm_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    inner, h, hd = _mlstm_dims(cfg)
    return {"in_proj": (d, 2 * inner), "conv_w": (cfg.xlstm_conv_dim, inner),
            "conv_b": (inner,), "wq": (h, hd, hd), "wk": (h, hd, hd),
            "wv": (h, hd, hd), "w_i": (inner, h), "w_f": (inner, h),
            "b_i": (h,), "b_f": (h,), "out_norm": (inner,),
            "out_proj": (inner, d)}


def make_mlstm_state(batch: int, cfg: ModelConfig, dtype=torch.bfloat16,
                     device=None) -> MLSTMState:
    inner, h, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros(batch, h, hd, hd, **f32),
        n=torch.zeros(batch, h, hd, **f32),
        m=torch.full((batch, h), NEG_INF, **f32),
        conv=torch.zeros(batch, cfg.xlstm_conv_dim - 1, inner, dtype=dtype,
                         device=device))


def _mlstm_qkv_gates(x_m, xc, p, cfg: ModelConfig):
    """x_m, xc: (B, S, inner) -> q, k, v (B, H, S, hd); i_raw, f_raw
    (B, H, S) in fp32.  k is scaled by hd^-0.5 here, as in the reference."""
    b, s, _ = x_m.shape
    _, h, hd = _mlstm_dims(cfg)
    xh = xc.reshape(b, s, h, hd)
    xmh = x_m.reshape(b, s, h, hd)
    q = torch.einsum("bshd,hde->bhse", xh, p["wq"])
    k = torch.einsum("bshd,hde->bhse", xh, p["wk"]) * (hd ** -0.5)
    v = torch.einsum("bshd,hde->bhse", xmh, p["wv"])
    xc32 = xc.float()
    i_raw = torch.einsum("bsi,ih->bhs", xc32, p["w_i"]) + p["b_i"][None, :, None]
    f_raw = torch.einsum("bsi,ih->bhs", xc32, p["w_f"]) + p["b_f"][None, :, None]
    return q, k, v, i_raw, f_raw


def mlstm_mix(x: torch.Tensor, p, cfg: ModelConfig, state: MLSTMState,
              chunk: int = MLSTM_CHUNK, mlstm: MLSTMFn = ops.mlstm_chunk
              ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full-segment mLSTM block body.  x: (B, S, d) (post-norm residual
    branch).  Runs ceil(S / min(chunk, S)) chunk steps through ``mlstm``."""
    b, s, _ = x.shape
    inner, h, hd = _mlstm_dims(cfg)
    x_m, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    x_m = constrain(x_m, "xlstm_inner")
    z = constrain(z, "xlstm_inner")
    xc, new_tail = causal_conv(x_m, state.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(x_m, xc, p, cfg)
    # the chunk loop runs shard-local (batch, heads) on DTensors: the
    # chunk op's plain version has no sharding strategy
    hseq, c, n, m = local_op(_mlstm_chunks, q, k, v, i_raw, f_raw, state.c,
                             state.n, state.m, local_dims=(0, 1), n_out=4,
                             chunk=chunk, mlstm=mlstm)
    hflat = hseq.transpose(1, 2).reshape(b, s, inner).to(x.dtype)
    hflat = rms_norm(hflat, p["out_norm"], cfg.norm_eps)
    hflat = hflat * F.silu(z.float()).to(x.dtype)
    return hflat @ p["out_proj"], MLSTMState(c=c, n=n, m=m, conv=new_tail)


def _mlstm_chunks(q, k, v, i_raw, f_raw, c, n, m, *, chunk: int,
                  mlstm: MLSTMFn):
    """q, k, v (B, H, S, hd), gates (B, H, S) through ``mlstm`` chunk by
    chunk from the carry (c, n, m): returns h (B, H, S, hd) fp32 and the
    last carry."""
    b, h, s, _ = q.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # zero-input steps: i -> -1e30 (no write), f -> +30 (log f ~ 0, no
        # decay) keep them inert; their rows are dropped below
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, pad), value=NEG_INF)
        f_raw = F.pad(f_raw, (0, pad), value=30.0)
    nch = (s + pad) // chunk

    def chunks(t):      # (B, H, S+pad, ...) -> (nch, B, H, chunk, ...)
        t = t.reshape(b, h, nch, chunk, *t.shape[3:])
        return t.movedim(2, 0).contiguous()

    qs, ks, vs, is_, fs = map(chunks, (q, k, v, i_raw, f_raw))
    hs = []
    for ci in range(nch):
        hb, (c, n, m) = mlstm(qs[ci], ks[ci], vs[ci], is_[ci], fs[ci],
                              c, n, m)
        hs.append(hb)
    return torch.cat(hs, dim=2)[:, :, :s], c, n, m       # (B, H, S, hd)


def mlstm_decode(x: torch.Tensor, p, cfg: ModelConfig, state: MLSTMState
                 ) -> Tuple[torch.Tensor, MLSTMState]:
    """Single-token recurrent step.  x: (B, 1, d).  Returns a new state
    (the one handed in is left as it was)."""
    b = x.shape[0]
    inner = _mlstm_dims(cfg)[0]
    x_m, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, new_tail = causal_conv(x_m, state.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(x_m, xc, p, cfg)
    q32, k32, v32 = (t[:, :, 0].float() for t in (q, k, v))   # (B, H, hd)
    i_r, f_r = i_raw[..., 0], f_raw[..., 0]                   # (B, H)
    logf = F.logsigmoid(f_r)
    m_new = torch.maximum(logf + state.m, i_r)
    f_s = torch.exp(logf + state.m - m_new)
    i_s = torch.exp(i_r - m_new)
    c = f_s[..., None, None] * state.c + i_s[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n = f_s[..., None] * state.n + i_s[..., None] * k32
    num = torch.einsum("bhe,bhef->bhf", q32, c)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", q32, n).abs(),
                        torch.exp(-m_new))
    hvec = (num / den[..., None]).reshape(b, 1, inner).to(x.dtype)
    hvec = rms_norm(hvec, p["out_norm"], cfg.norm_eps)
    hvec = hvec * F.silu(z.float()).to(x.dtype)
    return hvec @ p["out_proj"], MLSTMState(c=c, n=n, m=m_new,
                                            conv=new_tail)


# ==========================================================================
# sLSTM
# ==========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, d) cell
    n: torch.Tensor     # (B, d) normaliser
    m: torch.Tensor     # (B, d) stabiliser
    h: torch.Tensor     # (B, d) hidden (recurrent input)


def slstm_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    nh = cfg.xlstm_num_heads
    hd = d // nh
    d_ffn = int(d * 4 / 3)
    return {"w_in": (d, 4 * d), "r": (nh, hd, 4 * hd), "b": (4 * d,),
            "out_norm": (d,), "ff_gate": (d, d_ffn), "ff_up": (d, d_ffn),
            "ff_down": (d_ffn, d)}


def make_slstm_state(batch: int, cfg: ModelConfig,
                     device=None) -> SLSTMState:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros(batch, d, **f32)
    return SLSTMState(c=z, n=z, m=torch.full((batch, d), NEG_INF, **f32),
                      h=z)


def _slstm_step(p, cfg: ModelConfig, state: SLSTMState,
                wx_t: torch.Tensor) -> Tuple[SLSTMState, torch.Tensor]:
    """wx_t: (B, 4d) precomputed input projection for one timestep.

    The recurrent product is (B, nh, 4·hd), flattened to (B, 4d) and only
    then split into z, i, f, o, as in the reference: with nh = 4 and
    4·hd = d each gate is one head's whole output block."""
    d = cfg.d_model
    nh = cfg.xlstm_num_heads
    b = wx_t.shape[0]
    hprev = state.h.reshape(b, nh, d // nh)
    rec = torch.einsum("bhe,hef->bhf", hprev.to(p["r"].dtype), p["r"])
    gates = wx_t.float() + rec.reshape(b, 4 * d).float() + p["b"]
    zg, ig, fg, og = gates.chunk(4, dim=-1)
    z = torch.tanh(zg)
    o = torch.sigmoid(og)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state.m, ig)
    f_s = torch.exp(logf + state.m - m_new)
    i_s = torch.exp(ig - m_new)
    c = f_s * state.c + i_s * z
    n = torch.maximum(f_s * state.n + i_s, torch.exp(-m_new))
    h = o * (c / n)
    return SLSTMState(c=c, n=n, m=m_new, h=h), h


def _slstm_scan_local(wx: torch.Tensor, state: SLSTMState, r, bias,
                      cfg: ModelConfig):
    """The per-timestep recurrence over wx (B, S, 4d); returns hs
    (S, B, d) and the final state."""
    p = {"r": r, "b": bias}
    hs = []
    for t in range(wx.shape[1]):
        state, h = _slstm_step(p, cfg, state, wx[:, t])
        hs.append(h)
    return torch.stack(hs), state


def _slstm_scan_bsd(wx, c, n, m, h, r, bias, *, cfg: ModelConfig):
    """``_slstm_scan_local`` with hs batch-major (B, S, d), then the
    final state's c, n, m, h."""
    hs, st = _slstm_scan_local(wx, SLSTMState(c, n, m, h), r, bias, cfg)
    return (hs.transpose(0, 1), *st)


def slstm_mix(x: torch.Tensor, p, cfg: ModelConfig, state: SLSTMState
              ) -> Tuple[torch.Tensor, SLSTMState]:
    """Sequential scan over the segment.  x: (B, S, d)."""
    wx = x @ p["w_in"]                                   # (B, S, 4d)
    # gathered once before the per-timestep scan, which runs shard-local
    # (batch) on DTensors, as the reference's shard_map
    wx = constrain(wx, "slstm_seq")
    hs, *st = local_op(_slstm_scan_bsd, wx, *state, p["r"], p["b"],
                       replicate=(5, 6), n_out=5, cfg=cfg)
    state_f = SLSTMState(*st)
    h = hs.to(x.dtype)                                   # (B, S, d)
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    # GEGLU FFN; jax.nn.gelu's default is the tanh approximation
    g = h @ p["ff_gate"]
    u = h @ p["ff_up"]
    hf = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    return hf @ p["ff_down"], state_f


def slstm_decode(x: torch.Tensor, p, cfg: ModelConfig, state: SLSTMState
                 ) -> Tuple[torch.Tensor, SLSTMState]:
    """Single-token step: ``slstm_mix`` over one step, as in the
    reference.  x: (B, 1, d)."""
    return slstm_mix(x, p, cfg, state)
