"""The recurrent ops' backwards against the reference's gradients, on the
CPU.

``ssm_chunk_scan_bwd_plain`` and ``mlstm_chunk_bwd_plain`` are the
specifications of the backward kernels (``csrc/ssm_scan_bwd.cu``,
``csrc/mlstm_chunk_bwd.cu``): here they are held to ``jax.vjp`` of the
reference's functions (``repro.kernels.ref.ssm_chunk_scan_ref``, the
associative ``repro.models.ssm._chunk_scan``, ``repro.models.xlstm.
mlstm_chunk``) on the same numpy inputs, and to autograd through the
plain forwards.  ``ops.mlstm_chunk`` and ``ops.ssm_scan`` under grad run
through ``MLSTMChunkFn`` / ``SSMScanFn`` on the CPU too, with the plain
backwards: ``mlstm_mix`` and ``mamba_mix`` over three chained chunks (the
last padded) are held to ``jax.vjp`` of the reference's blocks, which
shows that holding the mLSTM's stabilisers constant gives the exact
gradient of a chain.  The kernels themselves are held to these plain
backwards on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ref import ssm_chunk_scan_ref
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config
from repro_torch.kernels import mlstm_scan, ops
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.models import (make_mamba_state, make_mlstm_state,
                                mamba_mix, mlstm_mix)

# fp32 on both sides, summed in other orders: the scan's gradients
# measured within 1.4e-7 of the reference's largest entry, the mLSTM
# chunk's within 2.9e-6 (the gate chain's reverse cumsum adds terms of
# either sign), the blocks' within 2.2e-6, on a CPU run.  A missing or
# doubled term (a gate path, a carry, a chunk) is O(1) of the leaf's
# largest entry.
SCAN_TOL = 1e-5
CHUNK_TOL = 1e-4
MIX_TOL = 1e-4
# the plain backward's seven, then the single chunk's derivative through
# e^m_in (``_dm_in``), which the Function does not give
GRADS = ("dq", "dk", "dv", "di", "df", "dc_in", "dn_in", "dm_in")


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref| (0 when both are 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    return diff / scale if scale > 0 else float(diff > 0)


# --------------------------------------------------------------------------
# the selective scan
# --------------------------------------------------------------------------

def _scan_case(seed, b, l, d, st):
    rng = np.random.default_rng(seed)
    da = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, l, d, st))))
    dbx = rng.standard_normal((b, l, d, st)) * 0.1
    dh = rng.standard_normal((b, l, d, st))
    return [x.astype(np.float32) for x in (da, dbx, dh)]


SCAN_SHAPES = [(1, 1, 3, 5), (2, 7, 8, 4), (2, 17, 12, 16), (1, 33, 100, 16)]


@pytest.mark.parametrize("b,l,d,st", SCAN_SHAPES)
def test_scan_bwd_plain_equals_autograd_of_plain_scan(b, l, d, st):
    """The plain backward forms the products and two-term sums autograd
    forms through the plain loop: equal bit for bit (as the kernel is on
    the card)."""
    da, dbx, dh = map(torch.from_numpy, _scan_case(b * l, b, l, d, st))
    leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
    h = scan_mod.ssm_chunk_scan_plain(*leaves)
    ref = torch.autograd.grad(h, leaves, dh)
    got = scan_mod.ssm_chunk_scan_bwd_plain(da, h.detach(), dh)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@jax.jit
def _scan_vjps(da, dbx, dh):
    """``jax.vjp`` of both references in one jitted program a shape."""
    return {name: jax.vjp(fn, da, dbx)[1](dh)
            for name, fn in (("sequential", ssm_chunk_scan_ref),
                             ("associative", ref_ssm._chunk_scan))}


@pytest.mark.parametrize("b,l,d,st", SCAN_SHAPES)
@pytest.mark.parametrize("reference", ["sequential", "associative"])
def test_scan_bwd_plain_matches_reference_vjp(b, l, d, st, reference):
    """Against ``jax.vjp`` of ``ssm_chunk_scan_ref`` (the same recurrence)
    and of the model's associative ``_chunk_scan`` (another order)."""
    da, dbx, dh = _scan_case(b + l, b, l, d, st)
    ref = _scan_vjps(jnp.asarray(da), jnp.asarray(dbx),
                     jnp.asarray(dh))[reference]
    h = scan_mod.ssm_chunk_scan_plain(torch.from_numpy(da),
                                      torch.from_numpy(dbx))
    got = scan_mod.ssm_chunk_scan_bwd_plain(torch.from_numpy(da), h,
                                            torch.from_numpy(dh))
    for name, g, r in zip(("dda", "ddbx"), got, ref):
        assert _rel(g.numpy(), r) <= SCAN_TOL, name


def test_ops_ssm_scan_under_grad_runs_the_function_on_cpu():
    """``ops.ssm_scan`` under grad goes through ``SSMScanFn`` (the plain
    backward on the CPU): its forward is the plain scan bit for bit and
    its gradients are the plain backward's; without grad it returns the
    plain scan and builds no graph."""
    da, dbx, dh = map(torch.from_numpy, _scan_case(3, 2, 9, 6, 4))
    leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
    h = ops.ssm_scan(*leaves)
    assert h.grad_fn is not None and "SSMScanFn" in type(h.grad_fn).__name__
    assert torch.equal(h.detach(), scan_mod.ssm_chunk_scan_plain(da, dbx))
    got = torch.autograd.grad(h, leaves, dh)
    want = scan_mod.ssm_chunk_scan_bwd_plain(da, h.detach(), dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.ssm_scan(da, dbx).grad_fn is None
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.ssm_chunk_scan_bwd(da, h.detach(), dh)


# --------------------------------------------------------------------------
# the mLSTM chunk
# --------------------------------------------------------------------------

def _chunk_case(seed, bh, l, hd, state):
    """One chunk's inputs as numpy fp32 (q, k pre-scaled, v, gates, the
    carry) and the upstream (dh, dc_out, dn_out).  ``state``: "first" (the
    zero carry, m = -1e30), "carried" (a random carry), "padded" (a random
    carry and the model's padding on the last steps: zeros, i = -1e30,
    f = +30)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((bh, l, hd), dtype=f32)
    k = rng.standard_normal((bh, l, hd), dtype=f32) / np.sqrt(hd)
    v = rng.standard_normal((bh, l, hd), dtype=f32)
    i_raw = rng.standard_normal((bh, l), dtype=f32)
    f_raw = rng.standard_normal((bh, l), dtype=f32) + 2.0
    if state == "padded":
        pad = min(5, l - 1)
        for t in (q, k, v):
            t[:, l - pad:] = 0.0
        i_raw[:, l - pad:] = -1e30
        f_raw[:, l - pad:] = 30.0
    if state == "first":
        carry = [np.zeros((bh, hd, hd), f32), np.zeros((bh, hd), f32),
                 np.full((bh,), -1e30, f32)]
    else:
        carry = [rng.standard_normal((bh, hd, hd), dtype=f32),
                 rng.standard_normal((bh, hd), dtype=f32),
                 (rng.standard_normal((bh,)) * 2).astype(f32)]
    ups = [rng.standard_normal((bh, l, hd), dtype=f32),
           rng.standard_normal((bh, hd, hd), dtype=f32),
           rng.standard_normal((bh, hd), dtype=f32)]
    return [q, k, v, i_raw, f_raw, *carry], ups


def _ref_chunk(q, k, v, i_raw, f_raw, c, n, m):
    """The reference's chunk on the (B·H, ...) layout (H = 1)."""
    h, (c2, n2, m2) = ref_xlstm.mlstm_chunk(
        *(x[:, None] for x in (q, k, v, i_raw, f_raw, c, n, m)))
    return h[:, 0], c2[:, 0], n2[:, 0], m2[:, 0]


@jax.jit
def _ref_chunk_vjp(xs, ups):
    out, vjp = jax.vjp(_ref_chunk, *xs)
    dh, dc, dn = ups
    dm = (dc * out[1]).sum((1, 2)) + (dn * out[2]).sum(-1)
    return vjp((dh, dc, dn, dm))


def _ref_chunk_grads(xs, ups):
    """``jax.vjp`` of the reference's chunk (one jitted program a shape)
    under the cotangent a chain of chunks hands back: dm_out =
    <dc_out, c_out> + <dn_out, n_out>."""
    return _ref_chunk_vjp(tuple(map(jnp.asarray, xs)),
                          tuple(map(jnp.asarray, ups)))


def _dm_in(grads, c_in, n_in):
    """A single chunk's derivative through e^m_in alone, <dc_in, c_in> +
    <dn_in, n_in>: what the reference's dm_in is under the chain's
    cotangent dm_out = <dc_out, c_out> + <dn_out, n_out>."""
    return (grads[5] * c_in).sum((1, 2)) + (grads[6] * n_in).sum(-1)


def _assert_chunk_grads(got, ref, tol, where):
    """Each gradient within ``tol`` of its leaf's largest |ref| entry; di
    and df over the larger of the two (at L 1 from a zero carry the chunk
    does not depend on f: df is 0 in exact arithmetic, rounding here)."""
    gate = max(np.abs(np.asarray(ref[3])).max(),
               np.abs(np.asarray(ref[4])).max())
    for name, g, r in zip(GRADS, got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        assert g.shape == r.shape, (where, name)
        scale = gate if name in ("di", "df") else np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= tol * scale if scale > 0 else err == 0, \
            (where, name, err, scale)


# (hd, L, state): every hd and every L, each hd with each state (a padded
# chunk needs L > 1), one jitted reference program a shape
CHUNK_CASES = [(8, 1, "first"), (8, 7, "carried"), (8, 16, "padded"),
               (8, 17, "first"), (16, 1, "first"), (16, 7, "padded"),
               (16, 17, "carried"), (64, 1, "carried"), (64, 16, "padded"),
               (64, 17, "first")]


@pytest.mark.parametrize("hd,l,state", CHUNK_CASES)
def test_mlstm_bwd_plain_matches_reference_vjp(hd, l, state):
    """The seven gradients of ``mlstm_chunk_bwd_plain`` against ``jax.vjp``
    of ``repro.models.xlstm.mlstm_chunk``, which walks the max and cummax
    branches the plain backward holds constant, and the reference's dm_in
    against ``_dm_in`` of them."""
    xs, ups = _chunk_case(hd * 100 + l, 3, l, hd, state)
    ref = _ref_chunk_grads(xs, ups)
    t = [torch.from_numpy(x) for x in xs]
    h = mlstm_scan.mlstm_chunk_plain(*t)[0]
    got = mlstm_scan.mlstm_chunk_bwd_plain(
        *t, h, *(torch.from_numpy(u) for u in ups))
    got = (*got, _dm_in(got, t[5], t[6]))
    _assert_chunk_grads([g.numpy() for g in got], ref, CHUNK_TOL,
                        (hd, l, state))


@pytest.mark.parametrize("state", ["first", "carried", "padded"])
def test_mlstm_bwd_plain_matches_autograd_of_plain_chunk(state):
    """The same against autograd through ``mlstm_chunk_plain`` (the card's
    yardstick for the kernel)."""
    xs, ups = _chunk_case(7, 2, 17, 16, state)
    t = [torch.from_numpy(x) for x in xs]
    leaves = [x.clone().requires_grad_(True) for x in t]
    out = mlstm_scan.mlstm_chunk_plain(*leaves)
    dh, dc, dn = map(torch.from_numpy, ups)
    dm = (dc * out[1]).sum((1, 2)) + (dn * out[2]).sum(-1)
    ref = torch.autograd.grad(out, leaves, (dh, dc, dn, dm.detach()))
    got = mlstm_scan.mlstm_chunk_bwd_plain(*t, out[0].detach(), dh, dc, dn)
    got = (*got, _dm_in(got, t[5], t[6]))
    _assert_chunk_grads([g.numpy() for g in got], [r.numpy() for r in ref],
                        CHUNK_TOL, state)


def test_ops_mlstm_chunk_under_grad_runs_the_function_on_cpu():
    """``ops.mlstm_chunk`` under grad goes through ``MLSTMChunkFn`` in the
    model's (B, H, ...) layout: the forward equal to the plain chunk, the
    gradients the plain backward's; m_out is not differentiable and m_in
    gets none; without grad no graph; the kernel wrapper refuses CPU
    tensors."""
    xs, ups = _chunk_case(11, 6, 9, 16, "carried")
    t = [torch.from_numpy(x) for x in xs]
    model = [x.reshape(2, 3, *x.shape[1:]) for x in t]
    leaves = [x.clone().requires_grad_(True) for x in model]
    h, (c, n, m) = ops.mlstm_chunk(*leaves)
    # h is a view of the Function's (B·H, L, hd) output
    assert "MLSTMChunkFn" in type(h.grad_fn.next_functions[0][0]).__name__
    plain = mlstm_scan.mlstm_chunk_plain(*t)
    assert torch.equal(h.detach().reshape(6, 9, 16), plain[0])
    assert not m.requires_grad
    dh, dc, dn = map(torch.from_numpy, ups)
    got = torch.autograd.grad(
        (h, c, n), leaves,
        (dh.reshape(h.shape), dc.reshape(c.shape), dn.reshape(n.shape)),
        allow_unused=True)
    want = mlstm_scan.mlstm_chunk_bwd_plain(*t, plain[0], dh, dc, dn)
    assert len(want) == 7 and got[7] is None
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    assert ops.mlstm_chunk(*model)[0].grad_fn is None
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan.mlstm_chunk_bwd(*t, plain[0], dh, dc, dn)


# --------------------------------------------------------------------------
# three chained chunks: the blocks against jax.vjp of the reference's
# --------------------------------------------------------------------------

def _np_tree(tree):
    return {n: np.array(a, np.float32) for n, a in tree.items()}


def _perturb(params, seed):
    """Noise on every vector leaf (init makes norms, biases and gate biases
    constants), so their gradients are exercised away from the init."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


def _configs(arch):
    return (dataclasses.replace(ref_get_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32"))


_MIX_VJPS = {}


def _mix_vjp(ref_mix, ref_cfg, names):
    """``jax.vjp`` of the reference's block, jitted once per block and
    shared by the zero-state and carried-state cases (the state is an
    argument)."""
    key = (ref_mix, tuple(names))
    if key not in _MIX_VJPS:
        def run(g, state, x_, *leaves):
            def fn(x2, *l2):
                out, _ = ref_mix(x2, dict(zip(names, l2)), ref_cfg, state,
                                 chunk=8)
                return out
            return jax.vjp(fn, x_, *leaves)[1](g)
        _MIX_VJPS[key] = jax.jit(run)
    return _MIX_VJPS[key]


def _mix_grads(ref_mix, port_mix, ref_state, port_state, p, ref_cfg,
               port_cfg, x, g_out):
    """Gradients of <out, g_out> with respect to x and every parameter:
    ``jax.vjp`` of the reference's block, autograd of the port's (its op
    under grad: the Function with the plain backward)."""
    names = sorted(p)
    ref = _mix_vjp(ref_mix, ref_cfg, names)(
        jnp.asarray(g_out), ref_state, jnp.asarray(x),
        *(jnp.asarray(p[n]) for n in names))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(p[n].copy()).requires_grad_(True) for n in names]
    out, _ = port_mix(leaves[0], dict(zip(names, leaves[1:])), port_cfg,
                      port_state, chunk=8)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g_out))
    return ["x"] + names, got, ref


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_mix_gradients_over_three_chunks_match_reference(carried):
    """S 20 in chunks of 8: three chunks, the last with four padded steps,
    so the carry's gradient is chained twice through the Function; from
    the zero state (training's) and from the state a first segment
    leaves."""
    ref_cfg, port_cfg = _configs("xlstm-1.3b")
    p = _np_tree(_perturb(ref_xlstm.init_mlstm_params(
        jax.random.PRNGKey(3), ref_cfg, dtype=jnp.float32), 3))
    rng = np.random.default_rng(3)
    st_r = ref_xlstm.make_mlstm_state(2, ref_cfg, jnp.float32)
    st_t = make_mlstm_state(2, port_cfg, torch.float32, "cpu")
    if carried:
        # the state the port leaves after a first segment, given to both
        x0 = rng.standard_normal((2, 20, ref_cfg.d_model), dtype=np.float32)
        with torch.no_grad():
            _, st_t = mlstm_mix(torch.from_numpy(x0),
                                {n: torch.from_numpy(a) for n, a in p.items()},
                                port_cfg, st_t, chunk=8)
        st_r = type(st_r)(*(jnp.asarray(t.numpy()) for t in st_t))
    x = rng.standard_normal((2, 20, ref_cfg.d_model), dtype=np.float32)
    g_out = rng.standard_normal((2, 20, ref_cfg.d_model), dtype=np.float32)
    calls = []
    chunk_op = ops.mlstm_chunk

    def counting(*a):
        calls.append(a[0].shape)
        return chunk_op(*a)
    names, got, ref = _mix_grads(
        ref_xlstm.mlstm_mix,
        lambda *a, **kw: mlstm_mix(*a, **kw, mlstm=counting),
        st_r, st_t, p, ref_cfg, port_cfg, x, g_out)
    assert len(calls) == 3
    for name, g, r in zip(names, got, ref):
        assert _rel(g.numpy(), r) <= MIX_TOL, name


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_mix_gradients_over_three_chunks_match_reference(carried):
    """The same for the Mamba block: S 20 in chunks of 8, the last padded
    with identity steps, each chunk's scan through ``SSMScanFn``; from the
    zero state and from a random carried state."""
    ref_cfg, port_cfg = _configs("jamba-v0.1-52b")
    p = _np_tree(_perturb(ref_ssm.init_mamba_params(
        jax.random.PRNGKey(4), ref_cfg, dtype=jnp.float32), 4))
    rng = np.random.default_rng(4)
    st_r = ref_ssm.make_mamba_state(2, ref_cfg, jnp.float32)
    st_t = make_mamba_state(2, port_cfg, torch.float32, "cpu")
    if carried:
        h = rng.standard_normal(st_t.h.shape).astype(np.float32)
        conv = rng.standard_normal(st_t.conv.shape).astype(np.float32)
        st_r = ref_ssm.MambaState(h=jnp.asarray(h), conv=jnp.asarray(conv))
        st_t = type(st_t)(h=torch.from_numpy(h.copy()),
                          conv=torch.from_numpy(conv.copy()))
    x = rng.standard_normal((2, 20, ref_cfg.d_model), dtype=np.float32)
    g_out = rng.standard_normal((2, 20, ref_cfg.d_model), dtype=np.float32)
    calls = []

    def counting(da, dbx):
        calls.append(da.shape)
        return ops.ssm_scan(da, dbx)
    names, got, ref = _mix_grads(
        ref_ssm.mamba_mix,
        lambda *a, **kw: mamba_mix(*a, **kw, ssm=counting),
        st_r, st_t, p, ref_cfg, port_cfg, x, g_out)
    assert len(calls) == 3
    for name, g, r in zip(names, got, ref):
        assert _rel(g.numpy(), r) <= MIX_TOL, name
