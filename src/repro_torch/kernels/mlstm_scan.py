"""One chunkwise-mLSTM step: the hand-written Hopper kernel and its plain
version.

``mlstm_chunk_step`` launches ``csrc/mlstm_chunk.cu`` (the port of the TPU
kernel ``repro/kernels/mlstm_scan.py:mlstm_chunk_step``) on CUDA tensors
and counts each launch in ``LAUNCHES`` (one per call: ``passes`` names
the kernels it runs, one pass for a chunk of at most ``MAX_SHORT`` steps,
else a gates pass and a state pass, the latter on the tensor cores for
bf16 q, k, v with C, k w_j and W each split into two bf16 parts).  It takes no CPU tensor and never falls
back: a failed build or launch raises.  As in the model, k arrives scaled by
``hd ** -0.5``; neither version scales it again.

``mlstm_chunk_plain`` is the same function in plain PyTorch, all fp32,
the twin of ``repro/models/xlstm.py:mlstm_chunk`` in the kernel's
(B·H, ...) layout: the CPU path of ``kernels.ops`` and the yardstick the
kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_CHUNK = 256               # the kernel's largest L (= MLSTM_CHUNK)
HEAD_DIMS = (8, 16, 64, 128, 1024)     # the tests' and the path's
# the one-pass kernel's largest L: it holds MAX_SHORT steps of v and h in
# registers (the C entry's MAX_SHORT)
MAX_SHORT = 16
# the kernels of each route, by their symbols' names
ONE_PASS = ("mlstm_short_kernel",)
TWO_PASS_TC = ("mlstm_gates_tc_kernel", "mlstm_state_tc_kernel")
TWO_PASS = ("mlstm_gates_kernel", "mlstm_state_kernel")
KERNELS = ONE_PASS + TWO_PASS_TC + TWO_PASS
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
        fn = _build.load().repro_mlstm_chunk_fwd
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in) -> None:
    if q.dim() != 3:
        raise ValueError("q, k, v must be (rows, L, head_dim)")
    bh, l, hd = q.shape
    want = {"k": (k, (bh, l, hd)), "v": (v, (bh, l, hd)),
            "i_raw": (i_raw, (bh, l)), "f_raw": (f_raw, (bh, l)),
            "c_in": (c_in, (bh, hd, hd)), "n_in": (n_in, (bh, hd)),
            "m_in": (m_in, (bh,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} for q{tuple(q.shape)}")
    if bh == 0 or l == 0:
        raise ValueError("empty chunk")


def passes(l: int, hd: int, dtype: torch.dtype) -> tuple:
    """The kernels one ``mlstm_chunk_step`` call launches, in order, as
    the C entry chooses them: the one pass for at most ``MAX_SHORT`` steps
    at hd a multiple of 64, else the gates and state passes (on the tensor
    cores for bf16 q, k, v at hd a multiple of 64)."""
    if hd % 64 == 0 and l <= MAX_SHORT:
        return ONE_PASS
    if hd % 64 == 0 and dtype == torch.bfloat16:
        return TWO_PASS_TC
    return TWO_PASS


def mlstm_chunk_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_raw: torch.Tensor, f_raw: torch.Tensor,
                     c_in: torch.Tensor, n_in: torch.Tensor,
                     m_in: torch.Tensor):
    """q, k, v: (B·H, L, hd), fp32 or bf16 alike; i_raw, f_raw: (B·H, L);
    carry c (B·H, hd, hd), n (B·H, hd), m (B·H,), all fp32 and contiguous.
    Returns (h (B·H, L, hd), c_out, n_out, m_out) in fp32, by the CUDA
    kernel on the current stream.  c_out is a new tensor (never c_in)."""
    global LAUNCHES
    _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    tensors = (q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk_step runs on CUDA tensors, got "
                         f"{q.device}; the CPU path is mlstm_chunk_plain")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes q, k, v in float32 or bfloat16, all alike")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise ValueError("gates and carry must be float32")
    bh, l, hd = q.shape
    if not 1 <= l <= MAX_CHUNK:
        raise ValueError(f"chunk length L = {l} outside 1..{MAX_CHUNK}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if bh > MAX_GRID_Y:
        raise ValueError(f"B*H = {bh} exceeds the grid limit {MAX_GRID_Y}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, c_in, n_in)):
        raise ValueError("q, k, v, c_in and n_in must be 16-byte aligned "
                         "(the kernel copies them in 16-byte pieces)")
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty(bh, l, hd, **f32)
    c_out = torch.empty(bh, hd, hd, **f32)
    n_out = torch.empty(bh, hd, **f32)
    m_out = torch.empty(bh, **f32)
    # scratch between the two passes (none for one pass); the caching
    # allocator reuses it only after this stream's later work, so no
    # reference need outlive the call
    scratch = []
    if passes(l, hd, q.dtype) != ONE_PASS:
        scratch = [torch.empty(bh, l, l, **f32),
                   torch.empty(bh, 3, l, **f32), torch.empty(bh, **f32)]
    scratch_ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(*(t.data_ptr() for t in tensors),
                       h.data_ptr(), c_out.data_ptr(), n_out.data_ptr(),
                       m_out.data_ptr(), *scratch_ptrs,
                       bh, l, hd, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mLSTM chunk kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        LAUNCHES += 1
    return h, c_out, n_out, m_out


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_raw: torch.Tensor, f_raw: torch.Tensor,
                      c_in: torch.Tensor, n_in: torch.Tensor,
                      m_in: torch.Tensor):
    """The same function in plain PyTorch, all fp32 (twin of
    ``repro.models.xlstm.mlstm_chunk``), on any device and any L."""
    _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    q, k, v = q.float(), k.float(), v.float()
    i_raw, f_raw = i_raw.float(), f_raw.float()
    l = q.shape[1]
    logf = F.logsigmoid(f_raw)                           # (BH, L)
    b_cum = torch.cumsum(logf, dim=-1)
    a = i_raw - b_cum
    g = torch.cummax(a, dim=-1).values
    m_t = torch.maximum(m_in[:, None], g)                # M_t (BH, L)
    dmat = torch.exp(a[:, None, :] - m_t[:, :, None])    # (BH, L(t), L(j))
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal, dmat, torch.zeros((), device=q.device))
    w = (q @ k.transpose(1, 2)) * dmat
    num = w @ v
    n_vec = dmat @ k
    inter = torch.exp(m_in[:, None] - m_t)               # (BH, L)
    num = num + inter[..., None] * (q @ c_in)
    n_vec = n_vec + inter[..., None] * n_in[:, None, :]
    den = torch.maximum((q * n_vec).sum(-1).abs(),
                        torch.exp(-(b_cum + m_t)))
    h = num / den[..., None]
    m_l = b_cum[:, -1] + torch.maximum(m_in, g[:, -1])
    w_in = torch.exp(m_in - m_l + b_cum[:, -1])
    w_j = torch.exp(a + b_cum[:, -1:] - m_l[:, None])    # (BH, L)
    kw = k * w_j[..., None]
    c_out = w_in[:, None, None] * c_in + kw.transpose(1, 2) @ v
    n_out = w_in[:, None] * n_in + kw.sum(1)
    return h, c_out, n_out, m_l
