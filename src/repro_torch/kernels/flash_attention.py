"""Prefill attention: the hand-written Hopper kernel and its plain version.

``flash_attention_bhsd`` launches ``csrc/flash_attention.cu`` (the port of
the TPU kernel ``repro/kernels/flash_attention.py:flash_attention_bhsd``)
on CUDA tensors and counts each launch in ``LAUNCHES``.  It takes no CPU
tensor and never falls back: a failed build or launch raises.

``attention_plain`` is the same function in plain PyTorch, the twin of the
reference oracle ``repro/kernels/ref.py:attention_ref``: the CPU path of
``kernels.ops`` and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535            # B*H rides the grid's y axis

# launches of the CUDA kernel since the last reset (``LAUNCHES = 0``)
LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None


def _entry():
    """The C entry point, with its argument types declared (a pointer
    passed without ``c_void_p`` would be cut to 32 bits)."""
    global _fn
    if _fn is None:
        fn = _build.load().repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, num_heads: int, num_kv_heads: int,
           window: Optional[int]) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (rows, seq, head_dim)")
    bh, sq, hd = q.shape
    bkv, skv, hdk = k.shape
    if v.shape != k.shape or hdk != hd:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if num_heads % num_kv_heads or bh % num_heads:
        raise ValueError(f"bad head counts H={num_heads} KVH={num_kv_heads} "
                         f"for {bh} query rows")
    if bkv != bh // num_heads * num_kv_heads:
        raise ValueError(f"k has {bkv} rows, expected "
                         f"{bh // num_heads * num_kv_heads}")
    if sq == 0 or skv == 0:
        raise ValueError("empty sequence")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, num_heads: int, num_kv_heads: int,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B·H, Sq, hd); k, v: (B·KVH, Skv, hd) -> (B·H, Sq, hd) in q's
    dtype, by the CUDA kernel on the current stream."""
    global LAUNCHES
    _check(q, k, v, num_heads, num_kv_heads, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd runs on CUDA tensors, got "
                         f"{q.device}; the CPU path is attention_plain")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    bh, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if bh > MAX_GRID_Y:
        raise ValueError(f"B*H = {bh} exceeds the grid limit {MAX_GRID_Y}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    skv = k.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), bh, sq, skv, num_heads, num_kv_heads,
                       hd, int(causal), -1 if window is None else window,
                       1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        LAUNCHES += 1
    return out


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, num_kv_heads: int, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch, full score matrix in fp32
    (twin of ``attention_ref``).  q: (B·H, Sq, hd); k, v: (B·KVH, Skv, hd)."""
    _check(q, k, v, num_heads, num_kv_heads, window)
    bh, sq, hd = q.shape
    _, skv, _ = k.shape
    g = num_heads // num_kv_heads
    b = bh // num_heads
    k = k.reshape(b, num_kv_heads, skv, hd).repeat_interleave(g, dim=1)
    v = v.reshape(b, num_kv_heads, skv, hd).repeat_interleave(g, dim=1)
    k = k.reshape(bh, skv, hd).float()
    v = v.reshape(bh, skv, hd).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), k) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)
