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

The gradient.  ``MLSTMChunkFn`` is the chunk step with its backward: on
CUDA tensors its forward launches ``mlstm_chunk_step`` and its backward
``mlstm_chunk_bwd`` (``csrc/mlstm_chunk_bwd.cu``, counted as one launch in
``BWD_LAUNCHES``: five passes on the tensor cores for bf16 q, k, v at hd a
multiple of 64, four on the CUDA cores otherwise; ``bwd_passes`` names
those of a call), on CPU
tensors the plain versions of both.  The backward takes (dh, dc_out,
dn_out) and gives (dq, dk, dv, di, df, dc_in, dn_in).  It holds the
stabilisers m_in, M_t and m_out constant: h and the carried state
c e^m, n e^m do not depend on them (every stabilised quantity, the floor
of ``den`` too, carries the same factor e^-(b_t + M_t), and c_out, n_out
carry e^-m_out), so a loss that reads the carry only through c e^m, n e^m
gets from them no gradient beyond what cancels.  In the model every m_in
is the constant first state or the previous chunk's m_out, so the
Function marks m_out non-differentiable and gives m_in no gradient: the
exact gradient of every chain of chunks whose last carry is read that
way.  (A single chunk's derivative through e^m_in alone would be
<dc_in, c_in> + <dn_in, n_in>, which the CPU tests hold to ``jax.vjp``
of the reference under dm_out = <dc_out, c_out> + <dn_out, n_out>.)
XLA's autodiff of the reference walks the ``maximum`` and ``cummax``
branches instead; those terms cancel to rounding.  ``mlstm_chunk_bwd_plain`` is that
backward in plain PyTorch, the explicit formulas the kernel computes:
its specification.  The Function keeps the forward's inputs and h (one
(B·H, L, hd) fp32 tensor) and rebuilds every gate scalar in the backward.
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
# the backward's passes, in launch order: bf16 q, k, v at hd a multiple of
# 64 on the tensor cores (``BWD_TC``), fp32 and hd 8, 16 on the CUDA cores
# (``BWD_CC``); ``bwd_passes`` names those of one launch, ``BWD_PASSES``
# every kernel of both routes
BWD_TC = ("mlstm_bwd_rows_tc_kernel", "mlstm_bwd_state_tc_kernel",
          "mlstm_bwd_dv_tc_kernel", "mlstm_bwd_dcin_tc_kernel",
          "mlstm_bwd_gates_kernel")
BWD_CC = ("mlstm_bwd_rows_kernel", "mlstm_bwd_state_kernel",
          "mlstm_bwd_dv_kernel", "mlstm_bwd_gates_kernel")
BWD_PASSES = BWD_TC + BWD_CC[:3]
BWD_ROWS = 32                 # rows t of the L x L part per rows-pass block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535            # B*H rides the grid's y axis

# launches of the forward and of the backward (its four passes count as
# one) since the last reset (``LAUNCHES = 0``, ``BWD_LAUNCHES = 0``)
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
        fn = _build.load().repro_mlstm_chunk_fwd
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().repro_mlstm_chunk_bwd
        fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


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


def bwd_passes(l: int, hd: int, dtype: torch.dtype) -> tuple:
    """The kernels one ``mlstm_chunk_bwd`` call launches, in order, as the
    C entry chooses them: on dtype and hd alone (every L from 1 to
    ``MAX_CHUNK``), the tensor cores for bf16 q, k, v at hd a multiple of
    64, else the CUDA cores."""
    del l                     # every chunk length takes the same route
    if dtype == torch.bfloat16 and hd % 64 == 0:
        return BWD_TC
    return BWD_CC


def bwd_scratch_shapes(bh: int, l: int, hd: int, dtype: torch.dtype) -> dict:
    """The scratch one backward launch allocates, by the C entry's names,
    as (shape, dtype), None where the route takes none: the rows pass's
    per-t scalars (den, inter, inter dqn, the floor's db, w_j) and w_in,
    its column sums of dW o W per block of ``BWD_ROWS`` rows, the state
    pass's sums per column tile (dw_j w_j, then dw_in); the CUDA-core
    route's dS and W (L x L fp32), or the tensor-core route's bf16 hi/lo
    planes with rows padded to lp = L rounded up to 16: ``sw`` dS and W
    (lp x lp each), ``rr`` r = dh / den and ri = inter r (lp x hd each)."""
    f32, b16 = torch.float32, torch.bfloat16
    tc = bwd_passes(l, hd, dtype) == BWD_TC
    lp = -(-l // 16) * 16
    tiles = hd // (64 if tc else min(hd, 32))
    return {"dS": None if tc else ((bh, l, l), f32),
            "Wm": None if tc else ((bh, l, l), f32),
            "rows": ((bh, 5, l), f32), "w_in": ((bh,), f32),
            "colpart": ((bh, -(-l // BWD_ROWS), l), f32),
            "epart": ((bh, tiles, l + 1), f32),
            "sw": ((bh, 4, lp, lp), b16) if tc else None,
            "rr": ((bh, 4, lp, hd), b16) if tc else None}


def _check_cuda(name: str, plain: str, tensors) -> None:
    """What the forward and backward kernels take (``tensors`` begins with
    q, k, v, i_raw, f_raw, c_in, n_in, m_in)."""
    q, k, v = tensors[:3]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {q.device}; "
                         f"the CPU path is {plain}")
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
    if any(t.data_ptr() % 16 for t in tensors[:3] + tensors[5:7]):
        raise ValueError("q, k, v, c_in and n_in must be 16-byte aligned "
                         "(the kernel copies them in 16-byte pieces)")


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
    _check_cuda("mlstm_chunk_step", "mlstm_chunk_plain", tensors)
    bh, l, hd = q.shape
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


def _gate_scalars(i_raw, f_raw, m_in):
    """The chunk's gate scalars (BH, L) or (BH,): b_t, the cumsum of
    log f; a_j = i_j - b_j; the stabiliser M_t; the carry's m_l and
    weights w_in, w_j."""
    logf = F.logsigmoid(f_raw)
    b_cum = torch.cumsum(logf, dim=-1)
    a = i_raw - b_cum
    g = torch.cummax(a, dim=-1).values
    m_t = torch.maximum(m_in[:, None], g)
    m_l = b_cum[:, -1] + torch.maximum(m_in, g[:, -1])
    w_in = torch.exp(m_in - m_l + b_cum[:, -1])
    w_j = torch.exp(a + b_cum[:, -1:] - m_l[:, None])
    return b_cum, a, m_t, m_l, w_in, w_j


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_raw: torch.Tensor, f_raw: torch.Tensor,
                      c_in: torch.Tensor, n_in: torch.Tensor,
                      m_in: torch.Tensor):
    """The same function in plain PyTorch, all fp32 (twin of
    ``repro.models.xlstm.mlstm_chunk``), on any device and any L."""
    _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    q, k, v = q.float(), k.float(), v.float()
    l = q.shape[1]
    b_cum, a, m_t, m_l, w_in, w_j = _gate_scalars(i_raw.float(),
                                                  f_raw.float(), m_in)
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
    kw = k * w_j[..., None]
    c_out = w_in[:, None, None] * c_in + kw.transpose(1, 2) @ v
    n_out = w_in[:, None] * n_in + kw.sum(1)
    return h, c_out, n_out, m_l


def mlstm_chunk_bwd_plain(q, k, v, i_raw, f_raw, c_in, n_in, m_in, h, dh,
                          dc_out, dn_out):
    """The chunk's gradient in plain PyTorch, all fp32, on any device: the
    explicit formulas ``csrc/mlstm_chunk_bwd.cu`` computes (its
    specification), the stabilisers held constant (see the module's
    note).  Takes the forward's inputs, its output h and the upstream
    (dh, dc_out, dn_out); returns (dq, dk, dv, di, df, dc_in, dn_in) in
    fp32."""
    _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    q, k, v, h, dh = (t.float() for t in (q, k, v, h, dh))
    l = q.shape[1]
    b_cum, a, m_t, _, w_in, w_j = _gate_scalars(i_raw, f_raw, m_in)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal, torch.exp(a[:, None, :] - m_t[:, :, None]),
                       torch.zeros((), device=q.device))
    w = (q @ k.transpose(1, 2)) * dmat
    inter = torch.exp(m_in[:, None] - m_t)
    qn_in = (q @ n_in[:, :, None])[..., 0]                 # q_t . n_in
    qn = w.sum(-1) + inter * qn_in
    floor = torch.exp(-(b_cum + m_t))
    den = torch.maximum(qn.abs(), floor)
    # h_t = num_t / den_t: dnum_t = r_t, dden_t = -r_t . h_t
    r = dh / den[..., None]
    dden = -(r * h).sum(-1)
    on_abs = qn.abs() >= floor
    dqn = torch.where(on_abs, torch.sign(qn) * dden, torch.zeros_like(dden))
    db_floor = torch.where(on_abs, torch.zeros_like(dden), -floor * dden)
    # the L x L part: W = S o D feeds num (W v) and qn (row sums of W)
    dw = torch.where(causal, r @ v.transpose(1, 2) + dqn[..., None],
                     torch.zeros((), device=q.device))
    ds = dw * dmat
    ri = inter[..., None] * r                              # inter_t r_t
    cq = inter * dqn
    dq = (ri @ c_in.transpose(1, 2) + cq[..., None] * n_in[:, None, :]
          + ds @ k)
    dk_carry = w_j[..., None] * (v @ dc_out.transpose(1, 2)
                                 + dn_out[:, None, :])
    dk = dk_carry + ds.transpose(1, 2) @ q
    dv = w_j[..., None] * (k @ dc_out) + w.transpose(1, 2) @ r
    dc_in = w_in[:, None, None] * dc_out + q.transpose(1, 2) @ ri
    dn_in = w_in[:, None] * dn_out + (cq[..., None] * q).sum(1)
    # the gates: a_j feeds D's column j and w_j; b_t feeds a_t, the floor
    # and (at t = L-1) w_in and every w_j
    dww = (k * dk_carry).sum(-1)                           # dw_j w_j
    dwin_w = w_in * ((c_in * dc_out).sum((1, 2)) + (n_in * dn_out).sum(-1))
    da = (dw * w).sum(1) + dww
    db = db_floor - da
    db[:, -1] += dwin_w + dww.sum(-1)
    dlogf = db.flip(-1).cumsum(-1).flip(-1)
    df = dlogf * torch.sigmoid(-f_raw)
    return dq, dk, dv, da, df, dc_in, dn_in


def mlstm_chunk_bwd(q, k, v, i_raw, f_raw, c_in, n_in, m_in, h, dh, dc_out,
                    dn_out):
    """The chunk's gradient by ``csrc/mlstm_chunk_bwd.cu`` on the current
    stream: the arguments of ``mlstm_chunk_bwd_plain`` on one CUDA device,
    contiguous, h, dh, dc_out and dn_out in fp32.  Returns (dq, dk, dv,
    di, df, dc_in, dn_in), dq, dk, dv in q's dtype, the rest fp32."""
    global BWD_LAUNCHES
    _check(q, k, v, i_raw, f_raw, c_in, n_in, m_in)
    tensors = (q, k, v, i_raw, f_raw, c_in, n_in, m_in, h, dh, dc_out,
               dn_out)
    _check_cuda("mlstm_chunk_bwd", "mlstm_chunk_bwd_plain", tensors)
    bh, l, hd = q.shape
    for name, t, shape in (("h", h, q.shape), ("dh", dh, q.shape),
                           ("dc_out", dc_out, c_in.shape),
                           ("dn_out", dn_out, n_in.shape)):
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if any(t.data_ptr() % 16 for t in (h, dh, dc_out)):
        raise ValueError("h, dh and dc_out must be 16-byte aligned (the "
                         "kernel reads them in 16-byte pieces)")
    f32 = dict(dtype=torch.float32, device=q.device)
    grads = [torch.empty(bh, l, hd, **f32) for _ in range(3)] + [
        torch.empty(bh, l, **f32), torch.empty(bh, l, **f32),
        torch.empty(bh, hd, hd, **f32), torch.empty(bh, hd, **f32)]
    # scratch between the passes; the caching allocator reuses it only
    # after this stream's later work
    scratch = [None if spec is None
               else torch.empty(spec[0], dtype=spec[1], device=q.device)
               for spec in bwd_scratch_shapes(bh, l, hd, q.dtype).values()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_entry()(*(t.data_ptr() for t in tensors),
                           *(t.data_ptr() for t in grads),
                           *(None if t is None else t.data_ptr()
                             for t in scratch),
                           bh, l, hd, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mLSTM chunk backward launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        BWD_LAUNCHES += 1
    grads[:3] = [g.to(q.dtype) for g in grads[:3]]
    return tuple(grads)


class MLSTMChunkFn(torch.autograd.Function):
    """The chunk step with its gradient in the (B·H, ...) layout: on CUDA
    tensors the forward and backward kernels, on CPU tensors their plain
    versions.  The forward keeps its inputs and h; under
    ``torch.utils.checkpoint`` it runs again in the backward, and the
    tensors of that run are the ones its backward reads.  m_out is not
    differentiable and m_in gets no gradient (see the module's note)."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_raw, c_in, n_in, m_in):
        cuda = q.device.type == "cuda"
        out = (mlstm_chunk_step if cuda else mlstm_chunk_plain)(
            q, k, v, i_raw, f_raw, c_in, n_in, m_in)
        ctx.save_for_backward(q, k, v, i_raw, f_raw, c_in, n_in, m_in,
                              out[0])
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, dh, dc_out, dn_out, _dm_out):
        # an output's unused gradient arrives as zeros (materialised)
        saved = ctx.saved_tensors
        bwd = mlstm_chunk_bwd if saved[0].device.type == "cuda" \
            else mlstm_chunk_bwd_plain
        grads = bwd(*saved, dh.contiguous(), dc_out.contiguous(),
                    dn_out.contiguous())
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)
