"""The rounding budget of the mLSTM chunk kernel's tensor-core passes.

For bf16 q, k, v and chunks longer than the one-pass limit, the state
pass (``mlstm_state_tc_kernel`` in ``kernels/csrc/mlstm_chunk.cu``) runs
its three products on the tensor cores, bf16 in and fp32 accumulated: h +=
q C, c_out = w_in C + kw^T v (kw = k w_j), and h = inter h + W v.  q and v
are bf16 already; each fp32 operand (C, kw, W) is split into bf16 hi and
lo (x - hi is exact in fp32), two products each.  The gates pass computes
q k^T from bf16 inputs, whose products are exact in fp32.
``_kernel_numerics`` repeats that arithmetic in plain PyTorch on the CPU
and is held to the reference's oracle ``mlstm_chunk_ref`` and its Pallas
kernel in interpret mode on the same numpy inputs, under the bounds
``chip_smoke.py`` holds the kernel to on the card (``MLSTM_TOL``, the
repo's tolerances for the Pallas kernel against its oracle).  It is also
held to the same arithmetic without the splits, closer than one bf16
rounding of C, kw or W could stay: the carried state of 42 layers must not
move by a rounding (random bf16 xlstm-1.3b decorrelates under any).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as ref_ops
from repro_torch.kernels import mlstm_scan

# chip_smoke.py's MLSTM_TOL: |diff| <= atol + rtol |ref|
MLSTM_TOL = {"h": (2e-3, 2e-2), "c": (2e-3, 2e-2), "n": (2e-3, 2e-2),
             "m": (1e-4, 1e-4)}
# the split products against unsplit fp32 ones, over each output's largest
# magnitude: hi + lo keeps ~16 mantissa bits (2^-17 of each operand), a
# plain bf16 rounding 8 (2^-9)
SPLIT_REL = 2.0 ** -13


def _split(x):
    """x = hi + lo, each a bf16 value (as fp32)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _kernel_numerics(q, k, v, i_raw, f_raw, c_in, n_in, m_in, *,
                     split=True):
    """The two tensor-core passes' arithmetic: q, k, v (BH, L, hd) bf16,
    gates and carry fp32 -> (h, c_out, n_out, m_out) fp32."""
    q, k, v = q.float(), k.float(), v.float()
    l = q.shape[1]
    # gates pass: scalars, then W = (q k^T) o D and den
    b_cum = torch.cumsum(F.logsigmoid(f_raw), dim=-1)
    a = i_raw - b_cum
    g = torch.cummax(a, dim=-1).values
    m_t = torch.maximum(m_in[:, None], g)
    causal = torch.ones(l, l, dtype=torch.bool).tril()
    dmat = torch.where(causal, torch.exp(a[:, None, :] - m_t[:, :, None]),
                       torch.zeros(()))
    w = (q @ k.transpose(1, 2)) * dmat
    inter = torch.exp(m_in[:, None] - m_t)
    qn = (q * n_in[:, None, :]).sum(-1)
    den = torch.maximum((w.sum(-1) + inter * qn).abs(),
                        torch.exp(-(b_cum + m_t)))
    m_l = b_cum[:, -1] + torch.maximum(m_in, g[:, -1])
    w_in = torch.exp(m_in - m_l + b_cum[:, -1])
    w_j = torch.exp(a + b_cum[:, -1:] - m_l[:, None])
    kw = k * w_j[..., None]

    def prod(x, y):
        """x @ y with x fp32 split into two bf16 parts (or not)."""
        if not split:
            return x @ y
        hi, lo = _split(x)
        return hi @ y + lo @ y

    def prod_r(x, y):
        """x @ y with y fp32 split into two bf16 parts (or not)."""
        if not split:
            return x @ y
        hi, lo = _split(y)
        return x @ hi + x @ lo
    # state pass
    h = (inter[..., None] * prod_r(q, c_in) + prod(w, v)) / den[..., None]
    c_out = w_in[:, None, None] * c_in + prod(kw.transpose(1, 2), v)
    n_out = w_in[:, None] * n_in + kw.sum(1)
    return h, c_out, n_out, m_l


def _inputs(seed, bh, l, hd, pad=0):
    """bf16 q, k (pre-scaled), v and fp32 gates as numpy fp32 values."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, l, hd), dtype=np.float32)
               for _ in range(3))
    k = k / np.sqrt(hd)
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in (q, k, v))
    i_raw = rng.standard_normal((bh, l), dtype=np.float32)
    f_raw = rng.standard_normal((bh, l), dtype=np.float32) + 2.0
    if pad:
        for t in (q, k, v):
            t[:, l - pad:] = 0.0
        i_raw[:, l - pad:] = -1e30
        f_raw[:, l - pad:] = 30.0
    return q, k, v, i_raw, f_raw


def _carry(bh, hd):
    """The state one random chunk leaves (the reference's own)."""
    zero = (np.zeros((bh, hd, hd), np.float32),
            np.zeros((bh, hd), np.float32), np.full((bh,), -1e30, np.float32))
    xs = _inputs(99, bh, 64, hd)
    _, *state = ref_ops.mlstm_chunk(*map(jnp.asarray, xs),
                                    *map(jnp.asarray, zero), impl="ref")
    return tuple(np.array(s, np.float32) for s in state)


def _run(xs, carry, **kw):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs[:3])
    rest = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (*xs[3:], *carry)]
    return _kernel_numerics(q, k, v, *rest, **kw)


def _within(out, ref, name):
    for key, a, b in zip("hcnm", out, ref):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        atol, rtol = MLSTM_TOL[key]
        diff = np.abs(a - b)
        assert a.shape == b.shape and np.isfinite(a).all(), (name, key)
        assert np.all(diff <= atol + rtol * np.abs(b)), \
            f"{name} {key}: max error {diff.max()}"


@pytest.mark.parametrize("pad", [0, 37])
def test_split_products_stay_within_the_bounds(pad):
    """B·H 2, L 256 (the prefill's chunk), hd 1024, a carried state; and
    a padded tail, as ``mlstm_mix`` pads the last chunk."""
    bh, l, hd = 2, 256, 1024
    xs = _inputs(pad, bh, l, hd, pad)
    carry = _carry(bh, hd)
    out = _run(xs, carry)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs[:3]] \
        + [jnp.asarray(x) for x in (*xs[3:], *carry)]
    _within(out, ref_ops.mlstm_chunk(*jx, impl="ref"), "vs ref")
    _within(out, ref_ops.mlstm_chunk(*jx, impl="pallas_interpret"),
            "vs pallas")


def test_split_products_keep_the_fp32_accuracy_class():
    """The split products against the same arithmetic with the fp32
    operands unsplit: within 2^-13 of each output's largest magnitude,
    where one bf16 rounding of C, kw or W moves them by ~2^-9."""
    bh, l, hd = 2, 256, 1024
    xs = _inputs(5, bh, l, hd)
    carry = _carry(bh, hd)
    out = _run(xs, carry)
    exact = _run(xs, carry, split=False)
    for key, a, b in zip("hcn", out[:3], exact[:3]):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= SPLIT_REL, f"{key}: {err} of max |{key}|"
    assert torch.equal(out[3], exact[3])


def test_unsplit_emulation_is_the_plain_version():
    """Without the splits the two passes are ``mlstm_chunk_plain`` up to
    fp32 summation order: the pass structure loses nothing."""
    bh, l, hd = 2, 100, 128
    xs = _inputs(3, bh, l, hd, 11)
    carry = _carry(bh, hd)
    out = _run(xs, carry, split=False)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs[:3])
    rest = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (*xs[3:], *carry)]
    plain = mlstm_scan.mlstm_chunk_plain(q, k, v, *rest)
    for key, a, b in zip("hcnm", out, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
