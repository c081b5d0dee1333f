"""The port's prefill attention against the reference's.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the plain
version (``attention_plain``); it is held against the reference's oracle
(``impl="ref"``) and its Pallas kernel in interpret mode, on the same
inputs made with numpy.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # degrade to deterministic example sweeps
    from _hypothesis_fallback import given, settings, st

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

SETTINGS = dict(max_examples=12, deadline=None)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, sq, skv, h, kvh, hd, dtype="float32"):
    """The same q, k, v (BSHD) for both packages: numpy fp32, rounded to
    ``dtype`` by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _cmp(a, b, name, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


def _port(tq, **kw):
    out = ops.flash_attention(*tq, **kw)
    return out.float().numpy()


@settings(**SETTINGS)
@given(
    b=st.integers(1, 3),
    sq=st.integers(1, 80),
    kvh=st.sampled_from([1, 2, 4]),
    g=st.sampled_from([1, 2, 4]),
    hd=st.sampled_from([8, 16, 32]),
    causal=st.booleans(),
    dtype=st.sampled_from(["float32", "bfloat16"]),
)
def test_plain_attention_sweep(b, sq, kvh, g, hd, causal, dtype):
    h = kvh * g
    jq, tq = _inputs(b * 1000 + sq, b, sq, sq, h, kvh, hd, dtype)
    out = _port(tq, causal=causal)
    ref = ref_ops.flash_attention(*jq, causal=causal, impl="ref")
    pal = ref_ops.flash_attention(*jq, causal=causal,
                                  impl="pallas_interpret")
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    _cmp(out, ref, "vs ref", tol)
    _cmp(out, pal, "vs pallas", tol)


@pytest.mark.parametrize("h,kvh,hd", [(16, 8, 128), (16, 16, 64)])
def test_plain_attention_path_geometry(h, kvh, hd):
    """The serving path's heads: qwen3-0.6b (16/8/128), qwen1.5-0.5b
    (16/16/64)."""
    jq, tq = _inputs(hd, 2, 40, 40, h, kvh, hd, "bfloat16")
    out = _port(tq, causal=True)
    _cmp(out, ref_ops.flash_attention(*jq, causal=True, impl="ref"),
         "vs ref", 2e-2)
    _cmp(out, ref_ops.flash_attention(*jq, causal=True,
                                      impl="pallas_interpret"),
         "vs pallas", 2e-2)


@pytest.mark.parametrize("window", [1, 7, 16, 64])
def test_plain_attention_window(window):
    jq, tq = _inputs(window, 2, 48, 48, 4, 2, 16)
    out = _port(tq, causal=True, window=window)
    _cmp(out, ref_ops.flash_attention(*jq, causal=True, window=window,
                                      impl="ref"), "vs ref", 3e-3)
    _cmp(out, ref_ops.flash_attention(*jq, causal=True, window=window,
                                      impl="pallas_interpret"),
         "vs pallas", 3e-3)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (40, 70, True, None),      # queries see the first kv positions only
    (70, 40, True, None),      # rows past Skv see every key
    (30, 50, False, 7),        # window without causal
    (77, 16, True, 7),         # rows >= 22 have no key: mean of V
])
def test_plain_attention_sq_ne_skv(sq, skv, causal, window):
    """Sq != Skv keeps the reference's top-left causal alignment (no
    offset); a row with no key left averages V as the oracle does."""
    jq, tq = _inputs(sq * skv, 2, sq, skv, 4, 2, 32)
    out = _port(tq, causal=causal, window=window)
    _cmp(out, ref_ops.flash_attention(*jq, causal=causal, window=window,
                                      impl="ref"), "vs ref", 2e-3)


def test_cpu_tensors_launch_no_kernel():
    fa.LAUNCHES = 0
    _, tq = _inputs(0, 1, 9, 9, 4, 2, 16)
    ops.flash_attention(*tq, causal=True)
    ops.flash_attention_plain(*tq, causal=True)
    assert fa.LAUNCHES == 0


def test_kernel_wrapper_refuses_cpu_and_bad_shapes():
    _, (q, k, v) = _inputs(0, 1, 9, 9, 4, 2, 16)
    qf = q.transpose(1, 2).reshape(4, 9, 16)
    kf = k.transpose(1, 2).reshape(2, 9, 16).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bhsd(qf, kf, kf, num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError, match="rows"):
        fa.attention_plain(qf, kf, kf, num_heads=4, num_kv_heads=1)
    with pytest.raises(ValueError, match="window"):
        fa.attention_plain(qf, kf, kf, num_heads=4, num_kv_heads=2,
                           window=0)
