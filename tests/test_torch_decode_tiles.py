"""The rounding budget of the tensor-core decode-attention kernel.

The bf16 kernel (``decode_attention_bf16_kernel`` in
``kernels/csrc/decode_attention.cu``) cuts the valid slots of each
(B·KVH) row into splits (``decode_attention.splits`` for the card's 132
SMs, one block of 192 KB of shared memory each; a row's G > 16 query heads
are cut into groups of at most 16, each its own block over the same
slots, so the splits are sized for B·KVH · ``groups(G)`` block rows and
every head's arithmetic is that of G <= 16), gives every fourth
32-slot tile of a split to each of its four warps, and has each warp keep
its own online softmax: bf16 products accumulated in fp32, the scale
folded into exp2, P rounded to bf16 for PV (the TPU kernel's p stays
fp32), l summed from the unrounded p.  Each block merges its warps'
states, and the combine pass merges the splits' partials.  ``_kernel_numerics`` repeats that arithmetic in
plain PyTorch on the CPU and is held to the reference's oracle and its
Pallas kernel in interpret mode on the same numpy inputs, under the bound
``chip_smoke.py`` holds the kernel to on the card (``DECODE_TOL``):
|diff| <= TOL + TOL |ref|, and under a bound scaled to each output row.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as ref_ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops

TOL = 2e-2                 # chip_smoke.py's DECODE_TOL for bf16
# and a bound scaled to each output row: |diff| <= ROW_TOL max|ref| of the
# row (chip_smoke.py's ROW_TOL for prefill attention).  Reference and
# emulation each round the output to bf16 (2^-8 of a value at most), and
# P's bf16 rounding averages out over the slots; a coarser P biases the
# output by a share of itself, which the fixed TOL misses where outputs
# are small (means over thousands of slots)
ROW_TOL = 2.0 ** -6
SMS = 132                  # an H100's SMs, one bf16 block on each
WARPS = 4                  # the bf16 kernel's warps, a softmax state each
M_INIT = -1e30


def _inputs(seed, b, sc, h, kvh, hd):
    """The same bf16 q (B, 1, H, hd) and cache (B, Sc, KVH, hd) for both
    packages, from numpy fp32."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, 1, h, hd), (b, sc, kvh, hd), (b, sc, kvh, hd))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _kernel_numerics(q, k, v, valid, *, round_p=True):
    """The bf16 kernel's arithmetic: q (B, 1, H, hd), k, v (B, Sc, KVH, hd)
    bf16 -> (B, 1, H, hd) bf16."""
    b, _, h, hd = q.shape
    sc, kvh = k.shape[1], k.shape[2]
    g, bkv = h // kvh, b * kvh
    n = min(valid, sc)
    if n == 0:
        return torch.zeros_like(q)
    # the grouped kernel's block rows; a head's arithmetic does not depend
    # on the other heads of its block
    nsplit, chunk = dec.splits(n, bkv * dec.groups(g), SMS)
    tile = dec.TILE
    tpc = chunk // tile                           # tiles per split
    tpw = math.ceil(tpc / WARPS)                  # tiles per warp
    qf = q.float().reshape(bkv, g, hd)

    def tiles(x):
        """(B, Sc, KVH, hd) -> (bkv, nsplit, WARPS, tpw, tile, hd): warp w
        of split s takes tiles w, w + WARPS, ... of its chunk."""
        x = x.float().permute(0, 2, 1, 3).reshape(bkv, sc, hd)[:, :n]
        x = F.pad(x, (0, 0, 0, nsplit * chunk - n))
        x = F.pad(x.view(bkv, nsplit, tpc, tile, hd),
                  (0, 0, 0, 0, 0, tpw * WARPS - tpc))
        return x.view(bkv, nsplit, tpw, WARPS, tile, hd).transpose(2, 3)
    kt, vt = tiles(k), tiles(v)
    ti = torch.arange(tpw)[None, :] * WARPS + torch.arange(WARPS)[:, None]
    pos = (torch.arange(nsplit)[:, None, None, None] * chunk
           + ti[None, :, :, None] * tile + torch.arange(tile))
    live = (ti[None, :, :, None] < tpc) & (pos < n)   # (nsplit, W, tpw, t)
    scale = 1.0 / math.sqrt(hd)
    sl2 = scale * math.log2(math.e)
    m = torch.full((bkv, nsplit, WARPS, g), M_INIT)
    l = torch.zeros(bkv, nsplit, WARPS, g)
    acc = torch.zeros(bkv, nsplit, WARPS, g, hd)
    for i in range(tpw):
        s = torch.einsum("rgd,rswtd->rswgt", qf, kt[:, :, :, i])
        s = s.masked_fill(~live[None, :, :, i, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * sl2)
        p = torch.exp2((s - m_new[..., None]) * sl2)
        l = l * corr + p.sum(-1)
        pv = p.bfloat16().float() if round_p else p
        acc = acc * corr[..., None] + torch.einsum(
            "rswgt,rswtd->rswgd", pv, vt[:, :, :, i])
        m = m_new
    # each block merges its warps' states, then the combine pass merges
    # the splits' partials (m scaled to natural units)
    m_blk = m.amax(2).clamp_min(M_INIT)                  # (bkv, nsplit, g)
    wt = torch.exp2((m - m_blk[:, :, None]) * sl2)
    acc = (wt[..., None] * acc).sum(2)
    l = (wt * l).sum(2)
    ms = m_blk * scale
    w = torch.exp(ms - ms.amax(1, keepdim=True).clamp_min(M_INIT))
    num = (w[..., None] * acc).sum(1)
    den = (w * l).sum(1)
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _within_bound(out, ref, name):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    diff = np.abs(out - ref)
    assert np.all(diff <= TOL + TOL * np.abs(ref)), \
        f"{name}: max error {diff.max()}, worst ratio " \
        f"{(diff / (TOL + TOL * np.abs(ref))).max()}"
    row_max = np.abs(ref).max(-1, keepdims=True)
    assert np.all(diff <= ROW_TOL * row_max), \
        f"{name}: max error over row max {(diff / row_max).max()}"


def _check(jq, tq, valid, pallas=True):
    out = _kernel_numerics(*tq, valid).float().numpy()
    jvalid = jnp.asarray(valid, jnp.int32)
    _within_bound(out, ref_ops.decode_attention(*jq, jvalid, impl="ref"),
                  f"valid {valid} vs ref")
    if pallas:
        _within_bound(out, ref_ops.decode_attention(
            *jq, jvalid, impl="pallas_interpret"), f"valid {valid} vs pallas")


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 12, 24, 48])
def test_bf16_p_stays_within_the_bound(g, hd):
    """G 1 / 2 / 4 (jamba) / 12 (starcoder2-3b) / 24 (two groups of
    heads, the second full) / 48 (granite-34b: three groups), valid 1, a
    count that ends inside a tile, and the whole cache."""
    jq, tq = _inputs(g * hd, 2, 300, 2 * g, 2, hd)
    for valid in (1, 203, 300):
        _check(jq, tq, valid)


@pytest.mark.parametrize("b,sc,h,kvh,hd,valid", [
    (4, 2080, 16, 8, 128, 2049),     # qwen3-0.6b's step: 4-5 tiles a warp
    (4, 2080, 16, 16, 64, 2080),     # qwen1.5-0.5b's
    (4, 4096, 24, 2, 128, 4096),     # starcoder2-3b's ring
    (4, 2080, 48, 1, 128, 2049),     # granite-34b's MQA step: G 48
])
def test_bf16_p_stays_within_the_bound_at_decode_shapes(b, sc, h, kvh, hd,
                                                        valid):
    jq, tq = _inputs(sc + h, b, sc, h, kvh, hd)
    _check(jq, tq, valid, pallas=sc <= 2080)


def test_bf16_p_stays_within_the_bound_on_a_strided_cache():
    """The cache cut out of a larger buffer, strided in every axis but hd,
    as the kernel reads it in place; the same values as a contiguous one."""
    jq, tq = _inputs(3, 2, 100, 8, 2, 128)
    q, k, v = tq

    def cut(t):
        buf = torch.zeros(3, 103, 3, 128, dtype=t.dtype)
        buf[1:, 2:102, 1:] = t
        return buf[1:, 2:102, 1:]
    out = _kernel_numerics(q, cut(k), cut(v), 61)
    assert torch.equal(out, _kernel_numerics(q, k, v, 61))
    _check(jq, tq, 61)


@pytest.mark.parametrize("valid", [1, 77, 2080])
def test_emulation_without_rounding_is_the_plain_softmax(valid):
    """With P kept in fp32 the splits, warp tiles, masks and combine are
    the plain softmax up to fp32 summation order: they lose nothing."""
    _, tq = _inputs(5, 2, 2080, 8, 4, 64)
    tq = [t.float() for t in tq]
    out = _kernel_numerics(*tq, valid, round_p=False)
    ref = ops.decode_attention(*tq, valid)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6,
                               rtol=1e-5)


def test_splits_cover_the_valid_slots_in_whole_tiles():
    """No split past ``valid``, none empty, every chunk whole tiles, and
    about one block per SM."""
    for n in range(0, 5000, 37):
        for bkv in (4, 8, 32, 64, 200):
            nsplit, chunk = dec.splits(n, bkv, SMS)
            assert chunk % dec.TILE == 0 and nsplit >= 1
            if n == 0:
                assert nsplit == 1
                continue
            assert (nsplit - 1) * chunk < n <= nsplit * chunk
            assert bkv * nsplit <= max(SMS, bkv)
