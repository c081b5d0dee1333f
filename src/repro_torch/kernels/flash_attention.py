"""Prefill attention: the hand-written Hopper kernels and their plain version.

``flash_attention_bhsd`` ((B·H, S, hd), the TPU op's layout) and
``flash_attention_bshd`` ((B, S, H, hd), the model's layout, read and
written in place through its strides) launch ``csrc/flash_attention.cu``
(the port of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_bhsd``) on CUDA tensors
and count each launch in ``LAUNCHES``: bf16 runs the tensor-core kernel
(its q, k, v read by TMA through tensor maps made from the strides), fp32
the exact CUDA-core kernel.  They take no CPU tensor and never fall back:
a failed build or launch raises.

``attention_plain`` is the same function in plain PyTorch, the twin of the
reference oracle ``repro/kernels/ref.py:attention_ref``: the CPU path of
``kernels.ops`` and the yardstick the kernels are held against on the card.
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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
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


def _check_bshd(q, k, v, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (batch, seq, heads, head_dim)")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"bad head counts H={h} KVH={k.shape[2]}")
    if b == 0 or sq == 0 or k.shape[1] == 0:
        raise ValueError("empty batch or sequence")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _require_cuda(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA tensors, got "
                         f"{q.device}; the CPU path is attention_plain")


def _launch(q, k, v, out, causal: bool, window: Optional[int]) -> None:
    """Run the kernel on (B, H, Sq, hd) q and out and (B, KVH, Skv, hd) k
    and v, any views whose head_dim is contiguous and whose rows are
    16-byte aligned; ``out`` is written in place."""
    global LAUNCHES
    _require_cuda(q)
    if any(t.device != q.device for t in (k, v, out)):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in (k, v, out)):
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit {MAX_GRID_Y}")
    vec = 16 // q.element_size()          # the kernel's 16-byte rows
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: head_dim must be contiguous and every "
                             f"row 16-byte aligned, strides {t.stride()}")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, kvh, sq, skv, hd, strides,
                       int(causal), -1 if window is None else window,
                       1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        LAUNCHES += 1


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, num_heads: int, num_kv_heads: int,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B·H, Sq, hd); k, v: (B·KVH, Skv, hd), contiguous -> (B·H, Sq,
    hd) in q's dtype, by the CUDA kernel on the current stream."""
    _check(q, k, v, num_heads, num_kv_heads, window)
    _require_cuda(q)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    bh, sq, hd = q.shape
    b = bh // num_heads
    out = torch.empty_like(q)
    _launch(q.view(b, num_heads, sq, hd),
            k.view(b, num_kv_heads, k.shape[1], hd),
            v.view(b, num_kv_heads, v.shape[1], hd),
            out.view(b, num_heads, sq, hd), causal, window)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd), any strides with hd
    contiguous and rows 16-byte aligned -> (B, Sq, H, hd) contiguous in
    q's dtype, by the CUDA kernel on the current stream.  Nothing is
    copied: the kernel reads the inputs and writes the output in place."""
    _check_bshd(q, k, v, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), causal, window)
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
