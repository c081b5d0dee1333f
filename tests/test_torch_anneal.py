"""The port's annealing walk (``SAConfig(mode="torch")``,
``repro_torch/core/anneal_torch.py``) against the reference's jitted kernel
(``repro/core/anneal_jax.py``) on the CPU.

* the draws: the port's stream is ``jax.random``'s, bit for bit;
* the step: the reference's own ``jax.random`` draws, drawn here, fed to
  the port's step body in fp32 for 24 steps on every ``multitenant_suite``
  workload: walkers and incumbents equal to the reference kernel's, the
  history and scores within 1e-5 relative;
* the whole anneal: ``tests/test_solver_scale.py``'s contract (mode, the
  feasibility of "vectorized", objective ratio >= 0.98) and the
  reference's mode "jax" result, solve for solve."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.allocator as ref_allocator
import repro.core.predictor as ref_predictor
import repro.core.types as ref_types
import repro.sim.workloads as ref_workloads
import repro_torch.core.allocator as port_allocator
import repro_torch.core.predictor as port_predictor
import repro_torch.core.types as port_types
import repro_torch.sim.workloads as port_workloads
from repro.core import anneal_jax
from repro_torch.camelot import SolverSpec
from repro_torch.core import anneal_torch

SUITE = tuple(port_workloads.multitenant_suite())
STEPS = 24
RTOL = 1e-5


def _solver(ref: bool, name: str, mode: str, iterations=400, seed=3,
            objective_tenants=None):
    al, pr, ty, wl = ((ref_allocator, ref_predictor, ref_types,
                       ref_workloads) if ref else
                      (port_allocator, port_predictor, port_types,
                       port_workloads))
    tenants = objective_tenants(ty) if objective_tenants else \
        wl.multitenant_suite()[name]
    ts = ty.TenantSet(tenants)
    pred = pr.PipelinePredictor.from_graph(ts.union_graph, ty.RTX_2080TI,
                                           seed=0)
    kw = {} if ref else {"device": "cpu"}
    sa = al.SAConfig(iterations=iterations, seed=seed, mode=mode, **kw)
    return al.MultiTenantAllocator(ts, pred, ty.RTX_2080TI, 4, sa=sa)


def solve_data(res):
    a = res.allocation
    return {"objective": res.objective, "feasible": res.feasible,
            "load": res.load, "warm": res.warm_started,
            "history": list(res.history),
            "stages": [(s.n_instances, s.quota, s.batch) for s in a.stages],
            "placement": None if a.placement is None
            else [list(map(tuple, p)) for p in a.placement.per_stage]}


def jax_draws(seed, steps, pb):
    """The reference kernel's draws, with jax.random from its key sequence
    (anneal_jax.py:102-108, :125-126, :136)."""
    key = jax.random.PRNGKey(seed & 0x7FFFFFFF)
    out = [[] for _ in range(6)]
    for _ in range(steps):
        key, k1, k2, k3, k4, k5, k6 = jax.random.split(key, 7)
        for o, x in zip(out, (
                jax.random.randint(k1, (pb.K,), 1, pb.n_mut + 1),
                jax.random.randint(k2, (pb.n_mut, pb.K), 0, pb.n),
                jax.random.randint(k3, (pb.n_mut, pb.K), 0, 6),
                jax.random.randint(k4, (pb.W,), 0, pb.C),
                jax.random.uniform(k5, (pb.W,)),
                jax.random.uniform(k6, (pb.W,)))):
            o.append(np.asarray(x))
    return [np.stack(o) for o in out]


def _captured_problem(name, **kw):
    """The Problem, start and temperatures of the port's real solve."""
    seen = {}
    real = anneal_torch.walk

    def spy(pb, st, draws, temps):
        seen.update(pb=pb, st=st)
        return real(pb, st, draws, temps)
    anneal_torch.walk = spy
    try:
        _solver(False, name, "torch", **kw).solve_max_load(4)
    finally:
        anneal_torch.walk = real
    return seen["pb"], seen["st"]


def _ref_kernel(pb, st0, temps, seed):
    engine_gq = pb.A.shape[0]
    kern = anneal_jax._build_kernel(pb.n, pb.W, pb.C, pb.n_mut, pb.g,
                                    engine_gq, pb.E, pb.bw_on, pb.maxload)

    def j(t, dt=jnp.float32):
        return jnp.asarray(t.numpy(), dt)
    i32 = jnp.int32
    out = kern(jax.random.PRNGKey(seed & 0x7FFFFFFF), j(st0.NS, i32),
               j(st0.QI, i32), jnp.asarray(temps, jnp.float32), j(pb.dur),
               j(pb.bwt), j(pb.tht), j(pb.foots), j(pb.gridv), j(pb.norm),
               j(pb.A), j(pb.B), j(pb.g_nodes, i32), j(pb.ge_src, i32),
               j(pb.ge_dst, i32), j(pb.ge_tc), j(pb.ge_th), j(pb.targets),
               i32(pb.max_inst), j(pb.cap_quota), i32(pb.cap_inst),
               j(pb.cap_bw), j(pb.cap_mem), j(pb.req))
    return [np.asarray(x) for x in out]


def _port_walk(pb, st0, temps, draws):
    d = anneal_torch.Draws(*(torch.as_tensor(x).to(
        torch.int64 if x.dtype.kind in "iu" else torch.float32)
        for x in draws))
    st, hist = anneal_torch.walk(pb, st0, d, torch.as_tensor(temps))
    return [x.numpy() for x in (st.NS, st.QI, st.bNS, st.bQI, st.bS)] + [
        hist.numpy()]


def _first_divergence(pb, st0, temps, draws, seed):
    """Names the first step and row where the port leaves the reference."""
    for t in range(1, len(temps) + 1):
        ref = _ref_kernel(pb, st0, temps[:t], seed)
        port = _port_walk(pb, st0, temps[:t], [x[:t] for x in draws])
        for name, r, p in zip(("NS", "QI", "bNS", "bQI"), ref, port):
            bad = np.flatnonzero((r != p).any(axis=1))
            if bad.size:
                return f"step {t - 1}: {name} row {int(bad[0])}"
    return "no divergence found stepwise"


# ---- the draws ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, 123456789])
def test_draws_are_the_reference_stream(seed):
    pb = type("P", (), {"K": 96, "W": 13, "C": 8, "n_mut": 4, "n": 23})()
    ref = jax_draws(seed, 6, pb)
    port = anneal_torch.draw(seed, 6, pb, "cpu")
    for r, p in zip(ref, port):
        assert p.dtype == (torch.int64 if r.dtype.kind in "iu"
                           else torch.float32)
        np.testing.assert_array_equal(p.numpy(), r)


# ---- the step ----------------------------------------------------------------

@pytest.mark.parametrize("name", SUITE)
def test_step_matches_reference_kernel(name):
    pb, st0 = _captured_problem(name)
    seed = 3
    temps = np.asarray(1.0 * (1e-3 / 1.0) ** (np.arange(STEPS)
                                               / (STEPS - 1)), np.float32)
    draws = jax_draws(seed, STEPS, pb)
    ref = _ref_kernel(pb, st0, temps, seed)
    port = _port_walk(pb, st0, temps, draws)
    for key, r, p in zip(("NS", "QI", "bNS", "bQI"), ref, port):
        if not np.array_equal(r, p):
            pytest.fail(f"{name}: {key} differs; first divergence at "
                        + _first_divergence(pb, st0, temps, draws, seed))
    for key, r, p in zip(("bS", "history"), ref[4:], port[4:]):
        fin = np.isfinite(r)
        np.testing.assert_array_equal(fin, np.isfinite(p), err_msg=key)
        np.testing.assert_allclose(p[fin], r[fin], rtol=RTOL, err_msg=key)
    # the walk found feasible candidates
    assert np.isfinite(ref[5]).any()


def test_walk_with_no_edges_equal_to_reference():
    """``E == 0``: the reference passes empty edge arrays and skips the
    edge term; two one-node tenants make a union graph with no edge."""
    def tenants(ty):
        wl = ref_workloads if ty is ref_types else port_workloads
        g = wl.camelot_suite()["img-to-img"]
        one = ty.ServiceGraph("one", [g.nodes[0]], [],
                              qos_target=g.qos_target)
        return [ty.Tenant(f"t{i}", one) for i in range(2)]
    ref = _solver(True, "", "jax", objective_tenants=tenants)\
        .solve_max_load(4)
    port = _solver(False, "", "torch", objective_tenants=tenants)
    assert port.tenants.union_graph.edges == []
    res = port.solve_max_load(4)
    assert ref.mode == "jax" and res.mode == "torch"
    assert solve_data(res) == solve_data(ref)


# ---- the whole anneal --------------------------------------------------------

@pytest.mark.parametrize("name", SUITE)
def test_torch_mode_within_tolerance_and_equal_to_reference(name):
    out = {m: _solver(False, name, m).solve_max_load(4)
           for m in ("vectorized", "torch")}
    assert out["torch"].mode == "torch", name
    assert out["torch"].feasible == out["vectorized"].feasible, name
    ratio = out["torch"].objective / out["vectorized"].objective
    assert ratio >= 0.98, f"{name}: torch objective ratio {ratio:.4f}"
    ref = _solver(True, name, "jax").solve_max_load(4)
    assert ref.mode == "jax"
    assert solve_data(out["torch"]) == solve_data(ref)


def test_min_resource_and_warm_start_equal_to_reference():
    def run(ref):
        a = _solver(ref, "two-chains", "jax" if ref else "torch")
        peak = a.solve_max_load(4)
        warm = a.solve_max_load(4, warm_start=peak.allocation)
        lo = a.solve_min_resource(4, peak.objective * 0.5)
        return [solve_data(r) for r in (peak, warm, lo)], [
            r.mode for r in (peak, warm, lo)]
    (ref, ref_modes), (port, port_modes) = run(True), run(False)
    assert ref_modes == ["jax"] * 3 and port_modes == ["torch"] * 3
    assert port == ref
    assert port[1]["warm"]


def test_utility_curves_fall_back_as_the_reference():
    """Non-linear utilities: the walk declines and the vectorized walk
    runs, in both packages."""
    def tenants(ty):
        wl = ref_workloads if ty is ref_types else port_workloads
        return [dataclasses.replace(t, utility="log")
                for t in wl.multitenant_suite()["two-chains"]]
    ref = _solver(True, "", "jax", objective_tenants=tenants)\
        .solve_max_load(4)
    port = _solver(False, "", "torch", objective_tenants=tenants)\
        .solve_max_load(4)
    assert port.mode == ref.mode == "vectorized"
    assert solve_data(port) == solve_data(ref)


def test_torch_mode_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = _solver(False, "two-chains", "torch")
    a.sa = dataclasses.replace(a.sa, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.solve_max_load(4)
    assert port_allocator.SAConfig().device == "cuda"


def test_mode_and_device_round_trip():
    res = _solver(False, "two-chains", "torch").solve_max_load(4)
    back = port_allocator.SolveResult.from_dict(res.to_dict())
    assert back.mode == "torch" and back.objective == res.objective
    spec = SolverSpec(mode="torch", device="cpu", iterations=400, seed=3)
    assert SolverSpec.from_dict(spec.to_dict()) == spec
    assert spec.sa_config().device == "cpu"
    assert spec.sa_config().mode == "torch"
    # other modes serialise as the reference's spec does
    assert "device" not in SolverSpec(mode="vectorized").to_dict()
    with pytest.raises(ValueError, match="unknown solver mode"):
        SolverSpec(mode="cuda")
