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

``flash_attention_bshd`` is differentiable: when grad is enabled and an
input requires it, it runs through ``FlashAttentionFn``, whose forward
also writes each row's log-sum-exp and whose backward launches
``csrc/flash_attention_bwd.cu`` (counted in ``BWD_LAUNCHES``), the gradient
the reference takes by XLA's autodiff of ``models/attention.py:flash_attn``.
Serving (no grad) launches the forward alone, without the log-sum-exp.

``attention_plain`` is the same function in plain PyTorch, the twin of the
reference oracle ``repro/kernels/ref.py:attention_ref``: the CPU path of
``kernels.ops`` and the yardstick the kernels are held against on the card;
autograd through it is the plain version of the backward.
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

# the backward's kernels, by their symbols' names: each launch runs the
# delta pass, then dK/dV and dQ on wgmma (bf16 at hd 64 and 128; with the
# reduction of the dK/dV partials where the query heads of a KV head are
# split over blocks) or on the CUDA cores (fp32, and bf16 at hd 8-32);
# ``bwd_passes`` names those of one launch, the pass that runs once in
# every launch first; ``REDUCE`` is that reduction
REDUCE = "bwd_dkdv_reduce_kernel"
BWD_TC = ("bwd_dq_wgmma_kernel", "bwd_dkdv_wgmma_kernel", "bwd_delta_kernel",
          REDUCE)
BWD_CC = ("bwd_dq_kernel", "bwd_dkdv_kernel", "bwd_delta_kernel")
BWD_KERNELS = BWD_TC[:2] + BWD_TC[3:] + BWD_CC
# the wgmma dK/dV pass: keys a block; the H100's SMs, of which it wants
# about two blocks each before it splits the query heads of a KV head
DKDV_KEYS = 128
SMS = 132
# rows of the backward's rowstats scratch (lse and D) per (b, head): Sq
# rounded up to this
ROW_PAD = 128

# launches of the forward kernel and of the backward (its three passes
# count as one) since the last reset (``LAUNCHES = 0``, ``BWD_LAUNCHES = 0``)
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
        fn = _build.load().repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_argtypes() -> list:
    """q, k, v, out, dout, lse, the two scratch tensors, dq, dk, dv; the
    sizes; the strides; causal, window, scale, splits, dtype; the
    stream."""
    return ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _bwd_entry():
    """The backward's C entry point, its argument types declared."""
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().repro_flash_attention_bwd
        fn.argtypes = _bwd_argtypes()
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _wgmma_route(hd: int, dtype: torch.dtype) -> bool:
    return dtype == torch.bfloat16 and hd >= 64


def bwd_splits(b: int, kvh: int, skv: int, g: int) -> int:
    """Over how many blocks the wgmma dK/dV pass splits the ``g`` query
    heads of each KV head: 1 when its B·KVH·⌈Skv / 128⌉ blocks give the
    card about two an SM, else the smallest divisor of ``g`` that does
    (``g`` if none does)."""
    blocks = b * kvh * -(-skv // DKDV_KEYS)
    if blocks >= 2 * SMS:
        return 1
    want = -(-2 * SMS // blocks)
    return min((d for d in range(want, g + 1) if g % d == 0), default=g)


def bwd_passes(hd: int, dtype: torch.dtype, splits: int = 1) -> tuple:
    """The kernels one backward launch runs at head dim ``hd`` with the
    dK/dV pass's head ``splits`` (``bwd_splits``)."""
    if not _wgmma_route(hd, dtype):
        return BWD_CC
    return BWD_TC if splits > 1 else BWD_TC[:3]


def bwd_scratch_shapes(b: int, h: int, kvh: int, sq: int, skv: int, hd: int,
                       dtype: torch.dtype) -> dict:
    """The fp32 scratch one backward launch takes, name -> shape:
    ``rowstats`` (each row's lse in the exp2 domain and D, rows padded to
    ``ROW_PAD``) and, where the dK/dV pass splits the query heads of a KV
    head, ``partial`` (each split's dK and dV), else None."""
    splits = bwd_splits(b, kvh, skv, h // kvh) if _wgmma_route(hd, dtype) \
        else 1
    sq_pad = -(-sq // ROW_PAD) * ROW_PAD
    return {"rowstats": (2, b * h, sq_pad),
            "partial": (2, splits, b * kvh, skv, hd) if splits > 1 else None}


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


def has_empty_rows(sq: int, skv: int, window: Optional[int]) -> bool:
    """Whether some query row sees no key: row i sees keys j < Skv with
    j > i - window (and j <= i when causal, which key 0 always meets), so
    only a window can empty a row, the last ones, when Sq >= Skv +
    window."""
    return window is not None and sq >= skv + window


def _require_cuda(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA tensors, got "
                         f"{q.device}; the CPU path is attention_plain")


def _check_launch(q, k, v, tensors) -> None:
    """The kernels' common refusals: (B, H, Sq, hd) q and (B, KVH, Skv, hd)
    k, v on one CUDA device, float32 or bfloat16 alike, a head dim they
    take, and every tensor of ``tensors`` (name -> view) with hd contiguous
    and rows 16-byte aligned."""
    _require_cuda(q)
    if any(t.device != q.device for t in tensors.values()):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors.values()):
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         f"takes float32 or bfloat16, all alike")
    b, h, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit {MAX_GRID_Y}")
    vec = 16 // q.element_size()          # the kernel's 16-byte rows
    for name, t in tensors.items():
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: head_dim must be contiguous and every "
                             f"row 16-byte aligned, strides {t.stride()}")


def _launch(q, k, v, out, causal: bool, window: Optional[int],
            lse: Optional[torch.Tensor] = None) -> None:
    """Run the kernel on (B, H, Sq, hd) q and out and (B, KVH, Skv, hd) k
    and v, any views whose head_dim is contiguous and whose rows are
    16-byte aligned; ``out`` is written in place, and so is ``lse`` ((B, H,
    Sq) fp32 contiguous, each row's log-sum-exp) where one is given."""
    global LAUNCHES
    _check_launch(q, k, v, {"q": q, "k": k, "v": v, "out": out})
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (b, h, sq) or not lse.is_contiguous()
                            or lse.dtype != torch.float32
                            or lse.device != q.device):
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32 contiguous "
                         f"on {q.device}")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), None if lse is None else lse.data_ptr(),
                       b, h, kvh, sq, skv, hd, strides,
                       int(causal), -1 if window is None else window,
                       1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        LAUNCHES += 1


def _launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal: bool,
                window: Optional[int]) -> None:
    """Run the backward on (B, H, Sq, hd) q, out, dout, dq and (B, KVH,
    Skv, hd) k, v, dk, dv views (hd contiguous, rows 16-byte aligned) and
    the forward's (B, H, Sq) lse; dq, dk, dv are written in place.  The
    scratch of ``bwd_scratch_shapes`` is allocated here and handed to the
    kernel, which allocates nothing."""
    global BWD_LAUNCHES
    _check_launch(q, k, v, {"q": q, "k": k, "v": v, "out": out,
                            "dout": dout, "dq": dq, "dk": dk, "dv": dv})
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    scratch = {name: None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=q.device)
        for name, shape in bwd_scratch_shapes(b, h, kvh, sq, skv, hd,
                                              q.dtype).items()}
    partial = scratch["partial"]
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch["rowstats"].data_ptr(),
            None if partial is None else partial.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, skv, hd, strides,
            int(causal), -1 if window is None else window,
            1.0 / math.sqrt(hd), 1 if partial is None else partial.shape[1],
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        BWD_LAUNCHES += 1


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


class FlashAttentionFn(torch.autograd.Function):
    """Prefill attention with its gradient, both by the CUDA kernels, in
    the model's layout.  The forward launches ``flash_attention.cu`` and
    keeps q, k, v, the output and each row's log-sum-exp; the backward
    launches ``flash_attention_bwd.cu`` and returns dq, dk, dv (B, S, H,
    hd) contiguous in q's dtype.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward, and the tensors of that run are
    the ones its backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        b, sq, h, _ = q.shape
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
        _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                out.transpose(1, 2), causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a no-op for the contiguous gradient autograd hands back from the
        # contiguous output; the kernel then reads it through its strides
        dout = dout.contiguous()
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        _launch_bwd(*(t.transpose(1, 2) for t in (q, k, v, out, dout)), lse,
                    *(t.transpose(1, 2) for t in (dq, dk, dv)),
                    ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd), any strides with hd
    contiguous and rows 16-byte aligned -> (B, Sq, H, hd) contiguous in
    q's dtype, by the CUDA kernel on the current stream.  Nothing is
    copied: the kernel reads the inputs and writes the output in place.
    When grad is enabled and an input requires it, the call goes through
    ``FlashAttentionFn`` (its backward a kernel too); otherwise the
    forward alone runs, writing no log-sum-exp."""
    _check_bshd(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if has_empty_rows(q.shape[1], k.shape[1], window):
            raise ValueError(
                f"Sq {q.shape[1]} >= Skv {k.shape[1]} + window {window} "
                f"leaves query rows with no key: their output is the mean "
                f"of V, whose gradient the backward kernel does not give; "
                f"no gradient through such a call")
        return FlashAttentionFn.apply(q, k, v, causal, window)
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
