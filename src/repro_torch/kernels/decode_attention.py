"""Decode attention: the hand-written Hopper kernel and its plain version.

``decode_attention_packed`` launches ``csrc/decode_attention.cu`` (the port
of the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention_packed``) on CUDA tensors and counts each launch in
``LAUNCHES`` (one per call: the entry point runs the kernel and its
combine pass).  bf16 runs the tensor-core kernel (P rounded to bf16 for
PV), fp32 the exact CUDA-core kernel; the dtype alone decides.  It takes
no CPU tensor and never falls back: a failed build or launch raises.

One query token per sequence: q (B·KVH, G, hd), the G query heads of one
KV head packed as rows (query head ``h = kvh * G + g``).  A block of the
kernel packs at most ``GROUP`` of them (one 16-row tile of the tensor
cores); a larger G, up to ``MAX_G`` (granite-34b's 48 heads over one KV
head), is cut into ``groups(G)`` blocks of rows over the same slots.
The cache is the model's (B, Sc, KVH, hd), which the kernel reads in
place through its strides (the TPU kernel takes it transposed to
(B·KVH, Sc, hd), which here would copy every layer's cache at every
step).
``valid`` is a host int, the number of leading cache slots that hold
tokens (``min(pos + 1, Sc)`` in a decode step); slots past it are masked
and skipped, so ``valid == 0`` gives zeros, as the TPU kernel's
``acc / max(l, 1e-30)`` does (the reference oracle ``decode_attention_ref``
would give the mean of V there).

``decode_attention_plain`` is the same function in plain PyTorch, in
fp32: the CPU path of ``kernels.ops`` and the yardstick the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
GROUP = 16                    # query heads a block packs
MAX_G = 48                    # query heads per KV head: 3 groups
TILE = 32                     # slots per tile (a warp's in the bf16 kernel)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel since the last reset (``LAUNCHES = 0``)
LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None
_resident_blocks: dict = {}


def _entry():
    """The C entry point, with its argument types declared (a pointer
    passed without ``c_void_p`` would be cut to 32 bits)."""
    global _fn
    if _fn is None:
        fn = _build.load().repro_decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, valid, num_heads: int, num_kv_heads: int):
    """Validates the shapes; returns (B, KVH, Sc, hd) views of k, v (no
    copy)."""
    if q.dim() != 3:
        raise ValueError("q must be (B·KVH, G, hd)")
    bkv, g, hd = q.shape
    if num_heads % num_kv_heads or num_heads // num_kv_heads != g:
        raise ValueError(f"q packs {g} heads per KV head; H={num_heads}, "
                         f"KVH={num_kv_heads}")
    if bkv == 0 or bkv % num_kv_heads:
        raise ValueError(f"{bkv} query rows for KVH={num_kv_heads}")
    if isinstance(valid, bool) or not isinstance(valid, int) or valid < 0:
        raise ValueError(f"valid must be a non-negative host int, got "
                         f"{valid!r}")
    b = bkv // num_kv_heads
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != (num_kv_heads, hd):
        raise ValueError(f"the cache must be (B={b}, Sc, KVH={num_kv_heads}, "
                         f"hd={hd}) for q{tuple(q.shape)}: k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("empty cache")
    return k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def groups(g: int) -> int:
    """The blocks of at most ``GROUP`` query heads that a row's ``g``
    heads are cut into."""
    return -(-g // GROUP)


def _resident(hd: int, g: int, dtype: torch.dtype,
              device: torch.device) -> int:
    """The blocks of the kernel for (hd, g, dtype) that the card holds at
    once: the blocks per SM the library reports for it, times the SMs."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, hd, g, dtype)
    if key not in _resident_blocks:
        fn = _build.load().repro_decode_attention_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        per_sm = ctypes.c_int()
        with torch.cuda.device(idx):
            err = fn(hd, g, _DTYPE_CODES[dtype], ctypes.byref(per_sm))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"decode attention kernel (hd {hd}, G {g}, "
                               f"{dtype}) cannot run: CUDA error {err}, "
                               f"{per_sm.value} blocks per SM")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _resident_blocks[key] = per_sm.value * sms
    return _resident_blocks[key]


def splits(n: int, bkv: int, resident: int) -> tuple:
    """(nsplit, chunk): cut the n valid slots of each of the bkv block
    rows (B·KVH · ``groups(G)``) into chunks of whole tiles, so that bkv *
    nsplit blocks about fill ``resident`` block slots (none past
    ``valid``, none empty)."""
    if n == 0:
        return 1, TILE
    tiles = math.ceil(n / TILE)
    per_row = min(tiles, max(1, resident // bkv))
    chunk = math.ceil(tiles / per_row) * TILE
    return math.ceil(n / chunk), chunk


def decode_attention_packed(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid: int, *, num_heads: int,
                            num_kv_heads: int) -> torch.Tensor:
    """q: (B·KVH, G, hd); k, v: (B, Sc, KVH, hd), hd contiguous; valid:
    host int -> (B·KVH, G, hd) in q's dtype, by the CUDA kernel on the
    current stream."""
    global LAUNCHES
    k4, v4 = _check(q, k, v, valid, num_heads, num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_packed runs on CUDA tensors, "
                         f"got {q.device}; the CPU path is "
                         f"decode_attention_plain")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    bkv, g, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if g > MAX_G:
        raise ValueError(f"{g} query heads per KV head; the kernel packs at "
                         f"most {MAX_G}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    vec = 16 // q.element_size()          # the kernel's 16-byte loads
    for name, t in (("k", k4), ("v", v4)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: head_dim must be contiguous and every "
                             f"row 16-byte aligned, strides {t.stride()}")
    sc = k4.shape[2]
    n = min(valid, sc)
    nsplit, chunk = splits(n, bkv * groups(g),
                           _resident(hd, g, q.dtype, q.device))
    out = torch.empty_like(q)
    # the splits' partial (acc, m, l), from torch's allocator on this stream
    ws = torch.empty(bkv * nsplit * g * (hd + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                       out.data_ptr(), ws.data_ptr(),
                       bkv, num_kv_heads, g, hd, n, nsplit, chunk,
                       k4.stride(0), k4.stride(1), k4.stride(2),
                       v4.stride(0), v4.stride(1), v4.stride(2),
                       1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        LAUNCHES += 1
    return out


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: int, *, num_heads: int,
                           num_kv_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch, all fp32: softmax over the
    first ``min(valid, Sc)`` slots, zeros when there are none."""
    k4, v4 = _check(q, k, v, valid, num_heads, num_kv_heads)
    bkv, g, hd = q.shape
    n = min(valid, k4.shape[2])
    if n == 0:
        return torch.zeros_like(q)
    qf = q.float().view(-1, num_kv_heads, g, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,bkcd->bkgc", qf, k4[:, :, :n].float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", p, v4[:, :, :n].float())
    return out.reshape(bkv, g, hd).to(q.dtype)
