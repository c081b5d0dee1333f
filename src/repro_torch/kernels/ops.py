"""Public attention op in the models' BSHD layout.

``flash_attention`` dispatches on the tensor's device: a CUDA tensor goes
to the hand-written kernel (``flash_attention_bhsd``), a CPU tensor to its
plain version (``attention_plain``).  There is no other switch, and a CUDA
tensor never reaches the plain version through this function.
``flash_attention_plain`` runs the plain version on any device, for
holding the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention_bhsd)


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()


def _bshd(fn, q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    out = fn(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), num_heads=h,
             num_kv_heads=kvh, causal=causal, window=window)
    return out.reshape(b, h, sq, hd).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd)."""
    if q.device.type == "cuda":
        return _bshd(flash_attention_bhsd, q, k, v, causal, window)
    if q.device.type == "cpu":
        return _bshd(attention_plain, q, k, v, causal, window)
    raise ValueError(f"no attention path for device {q.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` through the plain version on any device."""
    return _bshd(attention_plain, q, k, v, causal, window)
