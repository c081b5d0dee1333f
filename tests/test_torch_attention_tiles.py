"""The rounding budget of the tensor-core prefill-attention kernel.

The bf16 kernel (``kernels/csrc/flash_attention.cu``) walks 128-key tiles
with an online softmax in fp32 and rounds P to bf16 before the PV
product, a rounding the reference keeps out (its P stays fp32,
``repro/kernels/flash_attention.py``).  ``_kernel_numerics`` below repeats
that arithmetic in plain PyTorch on the CPU: the same tiles and tile
skipping, the scale folded into exp2, m, l and the accumulator in fp32,
l summed from the unrounded p, P rounded to bf16 for PV.  It is held
against the reference's oracle (and its Pallas kernel in interpret mode)
on the same numpy inputs, under the bounds ``chip_smoke.py`` holds the
kernel to on the card: |diff| <= TOL + TOL |ref| and |diff| <= ROW_TOL
times the row's largest |ref|.

The layout change (the kernel reads the model's (B, S, H, hd) tensors in
place) leaves the CPU path alone: ``ops.flash_attention`` on CPU tensors
is checked to equal the plain version on (B·H, S, hd) copies bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# chip_smoke.py's bounds for bf16 (TOL, ROW_TOL)
TOL = 2e-2
ROW_TOL = 2.0 ** -6
BQ = BKV = 128            # the kernel's query-row block and key tile
MASKED = -1e30


def _inputs(seed, b, sq, skv, h, kvh, hd):
    """The same bf16 q, k, v (BSHD) for both packages, from numpy fp32."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _tiles(q_first, q_last, skv, causal, window):
    """The key tiles a block of query rows visits (the kernel's
    ``tile_range``): all of them once its last row has no key left."""
    def lo(qp):
        return max(0, qp - window + 1) if window else 0

    def hi(qp):
        return min(skv - 1, qp) if causal else skv - 1
    if lo(q_last) > hi(q_last):
        return range(0, math.ceil(skv / BKV))
    return range(lo(q_first) // BKV, hi(q_last) // BKV + 1)


def _kernel_numerics(q, k, v, *, causal, window, round_p=True):
    """The bf16 kernel's arithmetic in plain PyTorch: q (B, Sq, H, hd), k,
    v (B, Skv, KVH, hd) bf16 -> (B, Sq, H, hd) bf16."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale_log2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    qf = q.float().permute(0, 2, 1, 3)                   # (B, H, Sq, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    out = torch.empty(b, h, sq, hd)
    for q_first in range(0, sq, BQ):
        q_last = min(q_first + BQ, sq) - 1
        rows = torch.arange(q_first, q_last + 1)[:, None]
        m = torch.full((b, h, len(rows), 1), MASKED)
        l = torch.zeros(b, h, len(rows), 1)
        acc = torch.zeros(b, h, len(rows), hd)
        for t in _tiles(q_first, q_last, skv, causal, window):
            keys = torch.arange(t * BKV, min((t + 1) * BKV, skv))[None, :]
            s = qf[:, :, q_first:q_last + 1] @ kf[:, :, keys[0]].transpose(
                -1, -2) * scale_log2
            mask = torch.ones(len(rows), keys.shape[1], dtype=torch.bool)
            if causal:
                mask &= keys <= rows
            if window:
                mask &= keys > rows - window
            s = s.masked_fill(~mask, MASKED)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = p.bfloat16().float() if round_p else p
            acc = acc * corr + pv @ vf[:, :, keys[0]]
            m = m_new
        out[:, :, q_first:q_last + 1] = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _within_bounds(out, ref, name):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    diff = np.abs(out - ref)
    row_max = np.abs(ref).max(-1, keepdims=True)
    assert np.all(diff <= TOL + TOL * np.abs(ref)), \
        f"{name}: max error {diff.max()} over TOL {TOL}"
    assert np.all(diff <= ROW_TOL * row_max), \
        f"{name}: max error over row max {(diff / row_max).max()} > {ROW_TOL}"


@pytest.mark.parametrize("h,kvh,hd", [(16, 8, 128), (16, 16, 64),
                                      (32, 8, 128)])
def test_bf16_p_stays_within_the_bounds_at_served_geometries(h, kvh, hd):
    """qwen3-0.6b (16/8/128), qwen1.5-0.5b (16/16/64) and jamba-v0.1-52b
    (32/8/128), causal over three key tiles, the last one ragged."""
    jq, tq = _inputs(hd + h, 1, 300, 300, h, kvh, hd)
    out = _kernel_numerics(*tq, causal=True, window=None)
    ref = ref_ops.flash_attention(*jq, causal=True, impl="ref")
    _within_bounds(out.float().numpy(), ref, f"{h}/{kvh}/{hd}")


@pytest.mark.parametrize("sq,skv,causal,window", [
    (300, 300, True, 64),      # a window inside the tiles
    (300, 300, True, 7),
    (200, 200, False, 7),      # a window without causal
    (300, 100, True, 64),      # rows >= 163 see no key: mean of V
    (1, 300, True, None),      # one query row
])
def test_bf16_p_stays_within_the_bounds_with_masks(sq, skv, causal, window):
    jq, tq = _inputs(sq + skv, 2, sq, skv, 4, 2, 64)
    out = _kernel_numerics(*tq, causal=causal, window=window)
    ref = ref_ops.flash_attention(*jq, causal=causal, window=window,
                                  impl="ref")
    _within_bounds(out.float().numpy(), ref, "vs ref")


def test_bf16_p_stays_within_the_bounds_against_pallas():
    """The TPU kernel itself, in interpret mode, with a window and GQA."""
    jq, tq = _inputs(5, 1, 160, 160, 4, 2, 32)
    out = _kernel_numerics(*tq, causal=True, window=48)
    pal = ref_ops.flash_attention(*jq, causal=True, window=48,
                                  impl="pallas_interpret")
    _within_bounds(out.float().numpy(), pal, "vs pallas")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, 7)])
def test_emulation_without_rounding_is_the_plain_softmax(causal, window):
    """With P kept in fp32 the tiled arithmetic is the plain softmax up to
    fp32 summation order: the tiles, skips and masks lose nothing."""
    _, tq = _inputs(7, 1, 260, 260, 4, 2, 32)
    tq = [t.float() for t in tq]
    out = _kernel_numerics(*tq, causal=causal, window=window, round_p=False)
    ref = ops.flash_attention(*tq, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_plain_version_on_bhsd_copies(dtype):
    """``ops.flash_attention`` on CPU tensors: the plain version on (B·H,
    S, hd) copies, its output transposed back, as before the kernel read
    the (B, S, H, hd) layout in place."""
    _, tq = _inputs(11, 2, 70, 70, 8, 2, 16)
    q, k, v = (t.to(dtype) for t in tq)

    def bhsd(x):
        b, s, h, hd = x.shape
        return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    old = fa.attention_plain(bhsd(q), bhsd(k), bhsd(v), num_heads=8,
                             num_kv_heads=2, causal=True, window=9)
    old = old.reshape(2, 8, 70, 16).transpose(1, 2)
    new = ops.flash_attention(q, k, v, causal=True, window=9)
    assert new.shape == q.shape
    assert torch.equal(new, old)


def test_bshd_wrapper_checks_before_it_launches():
    """The model-layout entry point refuses what the kernel cannot take,
    and a CPU tensor, before any launch."""
    fa.LAUNCHES = 0
    _, (q, k, v) = _inputs(0, 1, 9, 9, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd(q, k, v)
    with pytest.raises(ValueError, match="head counts"):
        fa.flash_attention_bshd(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention_bshd(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bshd(q, k, v, window=0)
    with pytest.raises(ValueError, match="batch, seq, heads"):
        fa.flash_attention_bshd(q[0], k[0], v[0])
    assert fa.LAUNCHES == 0
