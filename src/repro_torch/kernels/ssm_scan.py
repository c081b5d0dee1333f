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

The gradient.  ``SSMScanFn`` is the scan with its backward: on CUDA
tensors its forward launches ``ssm_chunk_scan`` and its backward
``ssm_chunk_scan_bwd`` (``csrc/ssm_scan_bwd.cu``, counted in
``BWD_LAUNCHES``), on CPU tensors the plain versions of both.  With
g_t = dh_t + da_{t+1} g_{t+1} the reverse scan from g_L = dh_L, the
gradients are d dbx_t = g_t and d da_t = g_t h_{t-1} (h_0 = 0), which is
what the reference takes by XLA's autodiff of
``repro/kernels/ref.py:ssm_chunk_scan_ref``.  ``ssm_chunk_scan_bwd_plain``
is that backward in plain PyTorch: it forms the same products and
two-term sums as autograd through ``ssm_chunk_scan_plain``, and so does
the kernel, so all three agree bit for bit.  Memory: the Function keeps
the scan's output h for its backward, one (B, L, D, ST) fp32 tensor per
chunk (537 MB at Jamba's B 4, L 256, D 8192, ST 16); under the model's
remat only the layer being replayed holds it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

MAX_BATCH = 65535             # B rides the grid's y axis

# the kernels' symbols, for the profiler's sums (each is a template on
# float4 / float, so a profile's names carry these as prefixes)
KERNEL = "ssm_scan_kernel"
BWD_KERNEL = "ssm_scan_bwd_kernel"

# launches of the forward and of the backward kernel since the last reset
# (``LAUNCHES = 0``, ``BWD_LAUNCHES = 0``)
LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


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


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().repro_ssm_chunk_scan_bwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _check(da: torch.Tensor, dbx: torch.Tensor) -> None:
    if da.dim() != 4:
        raise ValueError(f"da must be (B, L, D, ST), got {tuple(da.shape)}")
    if dbx.shape != da.shape:
        raise ValueError(f"dbx has shape {tuple(dbx.shape)}, expected "
                         f"{tuple(da.shape)}")
    if da.numel() == 0:
        raise ValueError(f"empty scan {tuple(da.shape)}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What both kernels take: fp32, contiguous, on one CUDA device, B on
    the grid's y axis."""
    da = tensors[0]
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: the kernel "
                         f"takes float32")
    if da.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {da.device}; "
                         f"the CPU path is {name}_plain")
    if any(t.device != da.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if da.shape[0] > MAX_BATCH:
        raise ValueError(f"B = {da.shape[0]} exceeds the grid limit "
                         f"{MAX_BATCH}")


def ssm_chunk_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """da, dbx: (B, L, D, ST) fp32, contiguous, on one CUDA device.
    Returns h (B, L, D, ST) fp32, by the CUDA kernel on the current
    stream."""
    global LAUNCHES
    _check(da, dbx)
    _check_cuda("ssm_chunk_scan", da, dbx)
    b, l, d, st = da.shape
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


def ssm_chunk_scan_bwd(da: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The scan's gradient: da, the forward's output h and the upstream
    gradient dh, all (B, L, D, ST) fp32 contiguous on one CUDA device ->
    (d da, d dbx), by ``csrc/ssm_scan_bwd.cu`` on the current stream."""
    global BWD_LAUNCHES
    _check(da, h)
    _check(da, dh)
    _check_cuda("ssm_chunk_scan_bwd", da, h, dh)
    b, l, d, st = da.shape
    dda = torch.empty_like(da)
    ddbx = torch.empty_like(da)
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        err = _bwd_entry()(da.data_ptr(), h.data_ptr(), dh.data_ptr(),
                           dda.data_ptr(), ddbx.data_ptr(), b, l, d * st,
                           stream)
    if err != 0:
        raise RuntimeError(f"ssm scan backward launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        BWD_LAUNCHES += 1
    return dda, ddbx


def ssm_chunk_scan_bwd_plain(da: torch.Tensor, h: torch.Tensor,
                             dh: torch.Tensor):
    """The same gradient in plain PyTorch on any device: the reverse scan
    g_t = dh_t + da_{t+1} g_{t+1}, d dbx_t = g_t, d da_t = g_t h_{t-1}."""
    _check(da, h)
    _check(da, dh)
    da, h, dh = da.float(), h.float(), dh.float()
    l = da.shape[1]
    g = dh[:, l - 1]
    gs = [g]
    for t in range(l - 2, -1, -1):
        g = dh[:, t] + da[:, t + 1] * g
        gs.append(g)
    ddbx = torch.stack(gs[::-1], dim=1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return ddbx * h_prev, ddbx


class SSMScanFn(torch.autograd.Function):
    """The scan with its gradient: on CUDA tensors the forward and backward
    kernels, on CPU tensors their plain versions.  The forward keeps da
    and its output h (see the module's note on memory); under
    ``torch.utils.checkpoint`` it runs again in the backward, and the
    tensors of that run are the ones its backward reads."""

    @staticmethod
    def forward(ctx, da, dbx):
        cuda = da.device.type == "cuda"
        h = (ssm_chunk_scan if cuda else ssm_chunk_scan_plain)(da, dbx)
        ctx.save_for_backward(da, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        da, h = ctx.saved_tensors
        dh = dh.contiguous()
        bwd = ssm_chunk_scan_bwd if da.device.type == "cuda" \
            else ssm_chunk_scan_bwd_plain
        dda, ddbx = bwd(da, h, dh)
        return dda, ddbx
