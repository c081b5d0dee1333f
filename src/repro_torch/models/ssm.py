"""Mamba selective-SSM block (Jamba's sequence mixer) [arXiv:2312.00752].

The port of ``repro/models/ssm.py``, prefill and decode.  A segment runs
in chunks of ``SSM_CHUNK`` steps, one after the other, carrying the
(B, inner, state) fp32 state, as the reference's ``lax.scan`` does: the
(B, chunk, inner, state) transients of one chunk are the largest tensors,
never the whole sequence's.  Within a chunk the inclusive scan goes
through ``kernels.ops.ssm_scan`` (the Hopper kernel on the card, its
plain version on the CPU) unless the caller hands another function of the
same signature as ``ssm``; the carried state is folded in afterwards with
``cumprod(da)`` and the C contraction follows, both in plain torch outside
the kernel, as in the reference.  A decode step (``mamba_decode``) is the
single-step recurrence in plain torch, as in the reference, which has no
kernel for it.

Parameters are the reference's, in its layout; ``dt_bias``, ``A_log`` and
``D`` (``FP32_PARAMS``) stay float32 in a bf16 model, as there.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import causal_conv, constrain, local_op

SSM_CHUNK = 256
# parameters kept in float32 whatever the model's dtype
FP32_PARAMS = frozenset({"dt_bias", "A_log", "D"})

SSMFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class MambaState(NamedTuple):
    h: torch.Tensor     # (B, inner, state) fp32 SSM state
    conv: torch.Tensor  # (B, conv_k - 1, inner) causal-conv tail


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def mamba_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    st, ck, dr = cfg.ssm_state_dim, cfg.ssm_conv_dim, dt_rank(cfg)
    return {"in_proj": (d, 2 * inner), "conv_w": (ck, inner),
            "conv_b": (inner,), "x_proj": (inner, dr + 2 * st),
            "dt_proj": (dr, inner), "dt_bias": (inner,),
            "A_log": (inner, st), "D": (inner,), "out_proj": (inner, d)}


def make_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.bfloat16,
                     device=None) -> MambaState:
    inner = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros(batch, inner, cfg.ssm_state_dim, dtype=torch.float32,
                      device=device),
        conv=torch.zeros(batch, cfg.ssm_conv_dim - 1, inner, dtype=dtype,
                         device=device))


def _ssm_inputs(xc: torch.Tensor, p, cfg: ModelConfig):
    """Post-conv activations -> discretised (dA, dBx, C) in fp32.

    xc: (B, S, inner) -> dA, dBx: (B, S, inner, state); C: (B, S, state).
    The x projection runs in the model's dtype and is cast to fp32
    after, as in the reference."""
    st, dr = cfg.ssm_state_dim, dt_rank(cfg)
    proj = (xc @ p["x_proj"]).float()
    dt_raw, bmat, cmat = proj.split([dr, st, st], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])                               # (inner, st)
    da = torch.exp(dt[..., None] * a)                        # (B,S,inner,st)
    dbx = (dt * xc.float())[..., None] * bmat[:, :, None, :]
    return da, dbx, cmat


def mamba_mix(x: torch.Tensor, p, cfg: ModelConfig, state: MambaState,
              chunk: int = SSM_CHUNK, ssm: SSMFn = ops.ssm_scan
              ) -> Tuple[torch.Tensor, MambaState]:
    """Sequence-mix a full segment (prefill, or training from a zero
    state, where autograd differentiates it on the CPU).  x: (B, S, d).  Runs
    ceil(S / min(chunk, S)) chunks, each scanned through ``ssm``; the
    padded steps of the last chunk are identity transitions (da = 1,
    dbx = 0)."""
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xin = constrain(xin, "ssm_inner")
    z = constrain(z, "ssm_inner")
    xc, new_tail = causal_conv(xin, state.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    # the chunked scan runs shard-local (batch) on DTensors: the scan's
    # plain version and the carried-state fold have no sharding strategy
    y, h = local_op(_scan_segment, xc, state.h, p["x_proj"], p["dt_proj"],
                    p["dt_bias"], p["A_log"], replicate=(2, 3, 4, 5),
                    n_out=2, cfg=cfg, chunk=chunk, ssm=ssm)
    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p["out_proj"], MambaState(h=h, conv=new_tail)


def _scan_segment(xc, h, x_proj, dt_proj, dt_bias, A_log, *,
                  cfg: ModelConfig, chunk: int, ssm: SSMFn):
    """The selective scan of xc (B, S, inner) from state h, chunk by
    chunk: returns y (B, S, inner) in xc's dtype and the last state."""
    p = {"x_proj": x_proj, "dt_proj": dt_proj, "dt_bias": dt_bias,
         "A_log": A_log}
    b, s, _ = xc.shape
    chunk = min(chunk, s)
    nch = -(-s // chunk)
    ys = []
    for ci in range(nch):
        xcb = xc[:, ci * chunk:(ci + 1) * chunk]
        n_valid = xcb.shape[1]
        if n_valid < chunk:
            xcb = F.pad(xcb, (0, 0, 0, chunk - n_valid))
        da, dbx, cmat = _ssm_inputs(xcb, p, cfg)
        if n_valid < chunk:
            # out of place (autograd keeps exp's output for its backward)
            valid = (torch.arange(chunk, device=xc.device)
                     < n_valid)[None, :, None, None]
            da = torch.where(valid, da, 1.0)
            dbx = torch.where(valid, dbx, 0.0)
        hs = ssm(da, dbx)                                    # (B,L,inner,st)
        # fold in the carried state: h_t += (prod_{r<=t} da_r) * h_in
        hs = hs + torch.cumprod(da, dim=1) * h[:, None]
        y = torch.einsum("blis,bls->bli", hs, cmat)
        h = hs[:, -1].clone()          # not a view that keeps hs alive
        ys.append(y[:, :n_valid].to(xc.dtype))
    return torch.cat(ys, dim=1), h


def mamba_decode(x: torch.Tensor, p, cfg: ModelConfig, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token recurrent step.  x: (B, 1, d).  Returns a new state
    (the one handed in is left as it was)."""
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, new_tail = causal_conv(xin, state.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    da, dbx, cmat = _ssm_inputs(xc, p, cfg)                  # (B,1,inner,st)
    h = da[:, 0] * state.h + dbx[:, 0]
    y = torch.einsum("bis,bs->bi", h, cmat[:, 0])[:, None, :].to(x.dtype)
    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p["out_proj"], MambaState(h=h, conv=new_tail)
