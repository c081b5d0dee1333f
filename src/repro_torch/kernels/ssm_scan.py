"""The Mamba within-chunk selective scan: the hand-written Hopper kernel and
its plain version.

``ssm_chunk_scan`` launches ``csrc/ssm_scan.cu`` (the port of the TPU
kernel ``repro/kernels/ssm_scan.py:ssm_chunk_scan``) on CUDA tensors and
counts each launch in ``LAUNCHES``.  It takes no CPU tensor and never
falls back: a failed build or launch raises.

The contract: da, dbx (B, L, D, ST) fp32 -> h (B, L, D, ST) fp32, the
inclusive scan h_t = da_t * h_{t-1} + dbx_t from h_0 = 0 along L.  The
carried state of earlier chunks is folded in by the caller
(``models/ssm.py:mamba_mix``), as in the reference.

``ssm_chunk_scan_plain`` is the same function in plain PyTorch, a loop
over L in fp32 (the twin of ``repro/kernels/ref.py:ssm_chunk_scan_ref``):
the CPU path of ``kernels.ops`` and the yardstick the kernel is held
against on the card.  Both round the product and the sum of each step to
fp32 separately, so on the same inputs they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

MAX_BATCH = 65535             # B rides the grid's y axis

# launches of the CUDA kernel since the last reset (``LAUNCHES = 0``)
LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None


def _entry():
    """The C entry point, with its argument types declared (a pointer
    passed without ``c_void_p`` would be cut to 32 bits)."""
    global _fn
    if _fn is None:
        fn = _build.load().repro_ssm_chunk_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(da: torch.Tensor, dbx: torch.Tensor) -> None:
    if da.dim() != 4:
        raise ValueError(f"da must be (B, L, D, ST), got {tuple(da.shape)}")
    if dbx.shape != da.shape:
        raise ValueError(f"dbx has shape {tuple(dbx.shape)}, expected "
                         f"{tuple(da.shape)}")
    if da.numel() == 0:
        raise ValueError(f"empty scan {tuple(da.shape)}")


def ssm_chunk_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """da, dbx: (B, L, D, ST) fp32, contiguous, on one CUDA device.
    Returns h (B, L, D, ST) fp32, by the CUDA kernel on the current
    stream."""
    global LAUNCHES
    _check(da, dbx)
    if da.dtype != torch.float32 or dbx.dtype != torch.float32:
        raise ValueError(f"dtypes {da.dtype}/{dbx.dtype}: the kernel takes "
                         f"float32")
    if da.device.type != "cuda":
        raise ValueError(f"ssm_chunk_scan runs on CUDA tensors, got "
                         f"{da.device}; the CPU path is ssm_chunk_scan_plain")
    if dbx.device != da.device:
        raise ValueError("da and dbx must be on one device")
    if not (da.is_contiguous() and dbx.is_contiguous()):
        raise ValueError("da and dbx must be contiguous")
    b, l, d, st = da.shape
    if b > MAX_BATCH:
        raise ValueError(f"B = {b} exceeds the grid limit {MAX_BATCH}")
    h = torch.empty_like(da)
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        err = _entry()(da.data_ptr(), dbx.data_ptr(), h.data_ptr(), b, l,
                       d * st, stream)
    if err != 0:
        raise RuntimeError(f"ssm scan kernel launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return h


def ssm_chunk_scan_plain(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, a loop over L in fp32, on any
    device."""
    _check(da, dbx)
    da, dbx = da.float(), dbx.float()
    h = torch.zeros_like(da[:, 0])
    hs = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
