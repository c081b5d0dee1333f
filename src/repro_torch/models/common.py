"""Shared layers: norms, RoPE, causal conv, SwiGLU MLP, the training loss,
seeded init, device resolution."""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: the
    port's entry points never drop quietly to the CPU; pass
    ``device="cpu"`` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: repro_torch runs on the GPU "
                               "unless the caller passes device='cpu'")
        device = "cuda"
    return torch.device(device)


# --------------------------------------------------------------------------
# Initialisation (seeded through an explicit torch.Generator)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, in_axis: int = -2) -> torch.Tensor:
    """LeCun-normal-ish init, fan-in on ``in_axis``."""
    std = 1.0 / shape[in_axis] ** 0.5
    return (torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    return (torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Norms (fp32 internals, cast back)
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: normalise over the head dim of (..., H, hd)."""
    return rms_norm(x, scale, eps)


# --------------------------------------------------------------------------
# RoPE (split-half convention)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    # a Python-scalar base: no host-to-device copy, which would make the
    # host wait for the stream at every layer
    return 1.0 / torch.pow(theta, exponents)                 # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Causal depthwise conv (the mLSTM and Mamba blocks)
# --------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor):
    """x: (B, S, inner); tail: (B, ck-1, inner) history; w: (ck, inner).
    Returns the depthwise causal conv output (B, S, inner) and the new
    tail."""
    ck = w.shape[0]
    s = x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(ck))
    new_tail = xp[:, -(ck - 1):] if ck > 1 else tail
    return out + b, new_tail


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Weights are (in, out): ``x @ W`` as in the reference."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy in fp32 (twin of the reference's
    ``cross_entropy_loss``): logits (B, S, V) in any dtype, labels (B, S).
    The row max is detached (the reference's ``stop_gradient``) and
    subtracted in the logits' dtype, the rest runs in fp32; the gold logit
    is gathered, where the reference takes it by an iota match (the same
    value and gradient)."""
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - lmax).float()
    sumexp = shifted.exp().sum(dim=-1)
    gold = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return (sumexp.log() - gold).mean()
