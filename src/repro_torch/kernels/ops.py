"""Public kernel ops in the models' layouts.

``flash_attention`` (BSHD), ``decode_attention`` (one query token over the
(B, Sc, KVH, hd) cache), ``mlstm_chunk`` ((B, H, L, hd)) and ``ssm_scan``
((B, L, D, ST)) dispatch on the tensor's device: a CUDA tensor goes to the
hand-written kernel (``flash_attention_bshd``, ``decode_attention_packed``,
``mlstm_chunk_step``, ``ssm_chunk_scan``), a CPU tensor to its plain
version (``attention_plain``, ``decode_attention_plain``,
``mlstm_chunk_plain``, ``ssm_chunk_scan_plain``).  There is no other
switch, and a CUDA tensor never reaches a plain version through these
functions.  Under grad, with an input that requires it, prefill
attention, the mLSTM chunk and the selective scan go through their
``torch.autograd.Function``s (``FlashAttentionFn``, ``MLSTMChunkFn``,
``SSMScanFn``), whose backwards are kernels too on the card
(``flash_attention_bwd.cu``, ``mlstm_chunk_bwd.cu``,
``ssm_scan_bwd.cu``); on the CPU the mLSTM and scan Functions run the
plain backwards, and autograd differentiates plain attention.  Decode
attention has no backward: training never decodes, and the reference
takes no gradient through a decode step, so a CUDA call to it under grad
raises ``NotImplementedError`` rather than return an output that
autograd cannot see through.  ``flash_attention_plain``,
``decode_attention_plain``, ``mlstm_chunk_plain`` and ``ssm_scan_plain``
run the plain version on any device, for holding the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import mlstm_scan
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention_bshd)


def _wants_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


def _no_backward(name: str, *inputs) -> None:
    """Raise when a kernel without a backward is asked for a gradient."""
    if _wants_grad(*inputs):
        raise NotImplementedError(
            f"{name} has no backward kernel: training never decodes and the "
            f"reference takes no gradient through it; call it under "
            f"torch.no_grad() or on CPU tensors")


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    """The plain version's (B·H, S, hd) copy of a (B, S, H, hd) tensor."""
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
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd).  On
    the card the kernel reads q, k, v and writes the output in this layout
    in place, and under grad its backward kernel gives dq, dk, dv
    (``FlashAttentionFn``); the plain version works on (B·H, S, hd)
    copies."""
    if q.device.type == "cuda":
        return flash_attention_bshd(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _bshd(attention_plain, q, k, v, causal, window)
    raise ValueError(f"no attention path for device {q.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` through the plain version on any device."""
    return _bshd(attention_plain, q, k, v, causal, window)


def _packed(fn, q, k, v, valid: int) -> torch.Tensor:
    """Run a packed decode function on the model's tensors: q (B, 1, H, hd)
    becomes the view (B·KVH, G, hd) (head h = kvh·G + g); the cache stays
    (B, Sc, KVH, hd) and is read in place, never transposed or copied."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    out = fn(q.reshape(b * kvh, h // kvh, hd), k, v, valid, num_heads=h,
             num_kv_heads=kvh)
    return out.reshape(b, 1, h, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: int) -> torch.Tensor:
    """q: (B, 1, H, hd); k, v: (B, Sc, KVH, hd); valid: host int, the
    number of leading valid cache slots -> (B, 1, H, hd)."""
    if q.device.type == "cuda":
        _no_backward("decode attention", q, k, v)
        return _packed(decode_mod.decode_attention_packed, q, k, v, valid)
    if q.device.type == "cpu":
        return _packed(decode_mod.decode_attention_plain, q, k, v, valid)
    raise ValueError(f"no decode attention path for device {q.device}")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: int) -> torch.Tensor:
    """``decode_attention`` through the plain version on any device."""
    return _packed(decode_mod.decode_attention_plain, q, k, v, valid)


def _bh(fn, q, k, v, i_raw, f_raw, c, n, m):
    """Run a (B·H, ...) mLSTM step on the model's (B, H, ...) tensors.
    Flattening is a view for contiguous inputs; a strided one (a chunk
    sliced out of a longer sequence) is copied by ``.contiguous()``."""
    b, h, l, hd = q.shape

    def flat(t, *shape):
        return t.reshape(b * h, *shape).contiguous()
    hs, c2, n2, m2 = fn(flat(q, l, hd), flat(k, l, hd), flat(v, l, hd),
                        flat(i_raw, l), flat(f_raw, l), flat(c, hd, hd),
                        flat(n, hd), flat(m))
    return hs.reshape(b, h, l, hd), (c2.reshape(b, h, hd, hd),
                                     n2.reshape(b, h, hd), m2.reshape(b, h))


def mlstm_chunk(q, k, v, i_raw, f_raw, c, n, m):
    """One chunk of the stabilised chunkwise mLSTM in the model's layout:
    q, k, v (B, H, L, hd); i_raw, f_raw (B, H, L); carry c (B, H, hd, hd),
    n (B, H, hd), m (B, H).  Returns (h (B, H, L, hd) fp32, (c, n, m)).
    Under grad it runs through ``MLSTMChunkFn`` (on the card its backward
    is ``mlstm_chunk_bwd.cu``, one launch a call)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no mLSTM path for device {q.device}")
    if _wants_grad(q, k, v, i_raw, f_raw, c, n, m):
        return _bh(mlstm_scan.MLSTMChunkFn.apply, q, k, v, i_raw, f_raw,
                   c, n, m)
    step = mlstm_scan.mlstm_chunk_step if q.device.type == "cuda" \
        else mlstm_scan.mlstm_chunk_plain
    return _bh(step, q, k, v, i_raw, f_raw, c, n, m)


def mlstm_chunk_plain(q, k, v, i_raw, f_raw, c, n, m):
    """``mlstm_chunk`` through the plain version on any device."""
    return _bh(mlstm_scan.mlstm_chunk_plain, q, k, v, i_raw, f_raw, c, n, m)


def ssm_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """The within-chunk selective scan: da, dbx (B, L, D, ST) fp32 -> all
    h_t (B, L, D, ST) fp32, h_t = da_t * h_{t-1} + dbx_t from h_0 = 0.
    Under grad it runs through ``SSMScanFn`` (on the card its backward is
    ``ssm_scan_bwd.cu``, one launch a call)."""
    if da.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no ssm scan path for device {da.device}")
    if _wants_grad(da, dbx):
        return scan_mod.SSMScanFn.apply(da, dbx)
    if da.device.type == "cuda":
        return scan_mod.ssm_chunk_scan(da, dbx)
    return scan_mod.ssm_chunk_scan_plain(da, dbx)


def ssm_scan_plain(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """``ssm_scan`` through the plain version on any device."""
    return scan_mod.ssm_chunk_scan_plain(da, dbx)
