"""AdamW's update of every leaf of a training step: the hand-written
multi-tensor kernels and their plain version.

The reference updates its parameters in its jitted step
(``repro/training/optimizer.py:adamw_update``), which XLA fuses; there is
no TPU kernel to port.  ``adamw_step_plain`` is the port's leaf loop: leaf
by leaf in fp32 through two scratch tensors the size of the leaf, with the
elementary operations of the reference's functional form in its order,
each rounded to fp32.  It is the CPU path of
``training/optimizer.py:adamw_update`` and the yardstick the kernels are
held against on the card.

On CUDA tensors ``leaf_table`` packs every leaf (its parameter, gradient
and fp32 moments) into one table of 8 int64 a leaf, copied to the card
from pinned memory without a wait; then ``grad_norm`` launches
``csrc/adamw.cu``'s sum of squares and its finishing step (the global
gradient norm and the clip scale as 0-d device tensors, with no host
sync) and ``adamw_step`` its update, one pass that reads each element's
g, p, m, v once and writes m, v, p once, bit for bit the leaf loop's
values given the same scale.  Each launch is counted in ``LAUNCHES``.
They take no CPU tensor and never fall back: a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# a chunk: the update kernel's block and the norm's unit of work (a
# constant of csrc/adamw.cu too)
CHUNK = 32768
# the norm's fixed grid: blocks per SM, each writing one fp64 partial
SUMSQ_BLOCKS_PER_SM = 4
# a leaf's flags in the table (csrc/adamw.cu): bf16 parameter and
# gradient, decayed, all four addresses 16-byte aligned (else the
# kernels take the leaf element by element)
BF16, DECAY, VEC = 1, 2, 4
# the kernels' symbols, for the profiler's sums: the norm's two, then the
# update's
KERNELS = ("adamw_sumsq_kernel", "adamw_finish_kernel", "adamw_update_kernel")
# a dtype's bf16 bit
_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the three kernels since the last reset (``LAUNCHES = 0``)
LAUNCHES = 0
_count_lock = threading.Lock()
_norm_fn = None
_update_fn = None


class Hyper(NamedTuple):
    """One step's scalars, as Python floats: the learning rate, the betas,
    eps, the weight decay and the bias corrections 1 - beta^step (fp32
    values, as ``optimizer.adamw_update`` computes them)."""
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    bc1: float
    bc2: float


class LeafTable(NamedTuple):
    """Every leaf of one update, packed for the kernels (``leaf_table``).
    ``keep`` holds the tensors whose addresses the table carries until
    the launches are enqueued."""
    table: torch.Tensor               # (leaves * 8,) int64 on the card
    leaves: int
    chunks: int
    keep: tuple


def decays(p: torch.Tensor) -> bool:
    """Whether weight decay applies to a per-layer leaf: its matrices (and
    stacks of matrices, as the MoE experts), not its norm scales and
    biases."""
    return p.dim() >= 2


def _norm_entry():
    """The C entry points, with their argument types declared (a pointer
    passed without ``c_void_p`` would be cut to 32 bits)."""
    global _norm_fn
    if _norm_fn is None:
        fn = _build.load().repro_adamw_grad_norm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _norm_fn = fn
    return _norm_fn


def _update_entry():
    global _update_fn
    if _update_fn is None:
        fn = _build.load().repro_adamw_update
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_void_p] + [ctypes.c_float] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _update_fn = fn
    return _update_fn


def _count(n: int) -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += n


def _refusal(name: str, p, g, m, v) -> str:
    """Why the kernels refuse leaf ``name``."""
    if p.dtype not in _CODES or g.dtype != p.dtype:
        return (f"{name}: dtypes {p.dtype}/{g.dtype}; the kernels take "
                f"float32 and bfloat16 parameters with gradients of the "
                f"same dtype")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        return f"{name}: the moments must be float32"
    if g.shape != p.shape or m.numel() != p.numel() \
            or v.numel() != p.numel():
        return (f"{name}: shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                f"{tuple(m.shape)}, {tuple(v.shape)} differ")
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        return (f"{name}: parameters and moments must be contiguous: the "
                f"update writes them in place")
    return (f"{name}: the AdamW kernels run on CUDA tensors on one device, "
            f"got {p.device}, {g.device}, {m.device}, {v.device}; the CPU "
            f"path is adamw_step_plain")


def leaf_table(grads: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               mu: Mapping[str, torch.Tensor],
               nu: Mapping[str, torch.Tensor]) -> LeafTable:
    """The leaves named by ``grads`` (bf16 or fp32 parameters with
    gradients of their dtype, fp32 moments; parameters and moments contiguous, on one
    CUDA device), packed for ``grad_norm`` and ``adamw_step``.  An empty
    leaf is left out; a strided gradient is copied contiguous first, at
    the cost of a copy of its leaf (the models' gradients come
    contiguous).  The table goes to the card from pinned memory on
    the current stream, without a wait.  Its host work is a few
    attribute reads a leaf, kept to the checks the kernels need."""
    flat, keep, first = [], [], 0
    f32 = torch.float32
    for n, g in grads.items():
        p, m, v = params[n], mu[n], nu[n]
        k = p.numel()
        if k == 0:
            continue
        if not g.is_contiguous():
            g = g.contiguous()
        code, dev = _CODES.get(p.dtype), p.get_device()
        if (code is None or g.dtype != p.dtype or m.dtype != f32
                or v.dtype != f32
                or g.shape != p.shape or m.numel() != k or v.numel() != k
                or not (p.is_contiguous() and m.is_contiguous()
                        and v.is_contiguous())
                or dev < 0 or not (dev == g.get_device() == m.get_device()
                                   == v.get_device())):
            raise ValueError(_refusal(n, p, g, m, v))
        a, b, c, d = p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()
        flat += (a, b, c, d, k, first,
                 code * BF16 | DECAY * decays(p)
                 | VEC * (not (a | b | c | d) & 15), 0)
        keep.append(g)
        first += -(-k // CHUNK)
    if not keep:
        raise ValueError("no leaf to update")
    host = torch.from_numpy(np.array(flat, dtype=np.int64)).pin_memory()
    device = keep[0].device
    with torch.cuda.device(device):
        table = host.to(device, non_blocking=True)
    return LeafTable(table, len(keep), first, tuple(keep))


def grad_norm(t: LeafTable, clip_norm: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global norm of the table's gradients, the clip scale
    min(clip_norm / max(norm, 1e-9), 1)), 0-d fp32 tensors on the card,
    by two launches on the current stream.  The sum of squares is taken
    in fp64 in an order fixed by the card's SM count, so it is the same
    run to run."""
    device = t.table.device
    blocks = SUMSQ_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    partials = torch.empty(blocks, dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _norm_entry()(t.table.data_ptr(), t.leaves, t.chunks,
                            partials.data_ptr(), blocks, clip_norm,
                            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"AdamW norm launch failed: CUDA error {err}")
    _count(2)
    return out[0], out[1]


def adamw_step(t: LeafTable, scale: torch.Tensor, h: Hyper) -> None:
    """Every leaf of the table updated in place (parameters and both
    moments), given the clip ``scale`` (a 0-d fp32 tensor on the card),
    by one launch on the current stream."""
    device = t.table.device
    if scale.dtype != torch.float32 or scale.numel() != 1 \
            or scale.device != device:
        raise ValueError(f"scale must be one float32 on {device}")
    f32 = np.float32
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _update_entry()(
            t.table.data_ptr(), t.leaves, t.chunks, scale.data_ptr(),
            h.lr, h.beta1, float(f32(1 - h.beta1)), h.beta2,
            float(f32(1 - h.beta2)),
            # ATen divides by a Python scalar as a multiplication by its
            # fp32 reciprocal
            float(f32(1) / f32(h.bc1)), float(f32(1) / f32(h.bc2)),
            h.eps, h.weight_decay, stream)
    if err != 0:
        raise RuntimeError(f"AdamW update launch failed: CUDA error {err}")
    _count(1)


def adamw_step_plain(grads: Dict[str, torch.Tensor],
                     params: Mapping[str, torch.Tensor],
                     mu: Mapping[str, torch.Tensor],
                     nu: Mapping[str, torch.Tensor],
                     scale: torch.Tensor, h: Hyper) -> None:
    """The same update in plain PyTorch on any device, leaf by leaf in
    fp32 through two scratch tensors the size of the leaf (its transient
    memory: two fp32 copies of the largest leaf).  ``grads`` is consumed:
    each leaf's gradient is popped once its leaf is done, so its memory
    can go back."""
    b1, b2 = h.beta1, h.beta2
    with torch.no_grad():
        for n in list(grads):
            p, m, v = params[n], mu[n], nu[n]
            a = torch.empty_like(p, dtype=torch.float32)
            b = torch.empty_like(a)
            a.copy_(grads.pop(n))
            a.mul_(scale)                   # g = g scale
            m.mul_(b1)
            torch.mul(a, 1 - b1, out=b)
            m.add_(b)                       # m = b1 m + (1 - b1) g
            v.mul_(b2)
            torch.square(a, out=b)
            b.mul_(1 - b2)
            v.add_(b)                       # v = b2 v + (1 - b2) g^2
            torch.div(v, h.bc2, out=b)
            b.sqrt_()
            b.add_(h.eps)
            torch.div(m, h.bc1, out=a)
            a.div_(b)                       # delta = m^ / (sqrt(v^) + eps)
            if decays(p):
                b.copy_(p)
                b.mul_(h.weight_decay)
                a.add_(b)                   # delta = delta + wd p
            a.mul_(h.lr)
            b.copy_(p)
            b.sub_(a)                       # p - lr delta, cast back below
            p.copy_(b)
            del a, b        # freed before the next leaf's are allocated
