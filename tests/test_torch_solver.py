"""The port's solver against the reference's under the same ``SAConfig``
seeds: the contracts of tests/test_core.py, tests/test_multitenant.py and
tests/test_solver_scale.py run on both packages.  The port's copies run
the same numpy code, so solves are held equal: objective, feasibility,
load, per-stage (instances, quota, batch) and placement, bit for bit."""
import math
import types

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # degrade to deterministic example sweeps
    from _hypothesis_fallback import given, settings, st

import repro.core.allocator as ref_allocator
import repro.core.deployment as ref_deployment
import repro.core.hierarchy as ref_hierarchy
import repro.core.incremental as ref_incremental
import repro.core.predictor as ref_predictor
import repro.core.types as ref_types
import repro.sim.baselines as ref_baselines
import repro.sim.workloads as ref_workloads
import repro_torch.core.allocator as port_allocator
import repro_torch.core.deployment as port_deployment
import repro_torch.core.hierarchy as port_hierarchy
import repro_torch.core.incremental as port_incremental
import repro_torch.core.predictor as port_predictor
import repro_torch.core.types as port_types
import repro_torch.sim.baselines as port_baselines
import repro_torch.sim.workloads as port_workloads
from repro.core.comm import CommModel as RefCommModel
from repro_torch.core.comm import CommModel as PortCommModel

PKGS = {
    "ref": types.SimpleNamespace(
        alloc=ref_allocator, dep=ref_deployment, hier=ref_hierarchy,
        inc=ref_incremental,
        pred=ref_predictor, types=ref_types, base=ref_baselines,
        wl=ref_workloads, CommModel=RefCommModel),
    "port": types.SimpleNamespace(
        alloc=port_allocator, dep=port_deployment, hier=port_hierarchy,
        inc=port_incremental,
        pred=port_predictor, types=port_types, base=port_baselines,
        wl=port_workloads, CommModel=PortCommModel),
}
# the reference's deadline-free twin of its hypothesis settings: one
# example of the incremental-vs-dense body takes ~0.3 s here
SETTINGS = settings(max_examples=8, deadline=None)


def alloc_data(a):
    """An Allocation as package-independent data."""
    return {"stages": [(s.n_instances, s.quota, s.batch) for s in a.stages],
            "placement": None if a.placement is None
            else [list(map(tuple, p)) for p in a.placement.per_stage],
            "predicted": (a.predicted_min_throughput, a.predicted_latency)}


def solve_data(res):
    """Everything of a SolveResult but its wall times."""
    pods = None if res.pods is None else [
        {k: v for k, v in p.items() if k != "solve_time"} for p in res.pods]
    return {"objective": res.objective, "feasible": res.feasible,
            "load": res.load, "mode": res.mode, "pods": pods,
            "warm": res.warm_started, "iterations": res.iterations,
            "history": list(res.history),
            "allocation": alloc_data(res.allocation)}


def both(fn):
    """``fn(pk)`` on the reference and on the port; asserts equal results
    and returns the port's."""
    ref, port = fn(PKGS["ref"]), fn(PKGS["port"])
    assert port == ref
    return port


def _graph(pk, name):
    return (pk.wl.camelot_suite() | pk.wl.dag_suite())[name]


def _allocator(pk, name, n_devices, mode, iterations=300, seed=0, **kw):
    g = _graph(pk, name)
    pred = pk.pred.PipelinePredictor.from_graph(
        g, pk.types.RTX_2080TI, batches=(1, 4, 8, 16),
        tabulate=mode != "scalar")
    return pk.alloc.CamelotAllocator(
        g, pred, pk.types.RTX_2080TI, n_devices,
        comm=pk.CommModel(pk.types.RTX_2080TI),
        sa=pk.alloc.SAConfig(iterations=iterations, seed=seed, mode=mode,
                             **kw))


# ---- single-service solves --------------------------------------------------

@pytest.mark.parametrize("mode", ["scalar", "vectorized", "incremental"])
@pytest.mark.parametrize("name,n_devices", [("img-to-img", 2),
                                            ("text-to-text", 1),
                                            ("diamond", 4)])
def test_solve_max_load_equal(name, n_devices, mode):
    out = both(lambda pk: solve_data(_allocator(
        pk, name, n_devices, mode).solve_max_load(8)))
    assert out["feasible"] and out["mode"] == mode


@pytest.mark.parametrize("mode", ["scalar", "vectorized", "incremental"])
@pytest.mark.parametrize("name", ["img-to-text", "diamond"])
def test_solve_min_resource_equal(name, mode):
    def run(pk):
        a = _allocator(pk, name, 4, mode)
        peak = a.solve_max_load(16)
        res = a.solve_min_resource(16, peak.objective * 0.3)
        return [solve_data(peak), solve_data(res),
                a.min_devices(16, 50.0), a.min_devices(16, 5000.0)]
    peak, res, lo, hi = both(run)
    assert res["feasible"] and lo <= hi


def test_warm_started_solve_equal():
    def run(pk):
        a = _allocator(pk, "img-to-img", 2, "vectorized")
        cold = a.solve_max_load(8)
        warm = a.solve_max_load(8, warm_start=cold.allocation)
        return [solve_data(cold), solve_data(warm)]
    cold, warm = both(run)
    assert warm["warm"] and warm["objective"] >= cold["objective"]


def test_masked_solve_equal():
    both(lambda pk: solve_data(_allocator(pk, "img-to-text", 3,
                                          "vectorized").solve_max_load(
        8, device_mask=[True, False, True])))


def test_eval_many_equal():
    def run(pk):
        a = _allocator(pk, "diamond", 4, "vectorized")
        tab = a._policy_tables(8)
        rng = np.random.default_rng(0)
        ns = rng.integers(1, 7, size=(64, 4))
        qi = rng.integers(0, 8, size=(64, 4))
        return [np.asarray(x).tolist() for x in a._eval_many(ns, qi, tab, 4)]
    both(run)


def test_jax_mode_raises_not_implemented():
    a = _allocator(PKGS["port"], "img-to-img", 2, "jax")
    with pytest.raises(NotImplementedError, match="mode='torch'"):
        a.solve_max_load(8)
    with pytest.raises(NotImplementedError, match="mode='torch'"):
        a.solve_min_resource(8, 10.0)


# ---- deployment and baselines -----------------------------------------------

def test_pack_instances_equal():
    def run(pk):
        g = _graph(pk, "img-to-img")
        pred = pk.pred.PipelinePredictor.from_profiles(
            g.stages, pk.types.RTX_2080TI)
        t = pk.types
        out = []
        for stages, nd in (([t.StageAlloc(4, 0.25, 16),
                             t.StageAlloc(2, 0.5, 16)], 2),
                           ([t.StageAlloc(3, 0.65, 16),
                             t.StageAlloc(1, 0.3, 16)], 2),
                           ([t.StageAlloc(6, 0.15, 32),
                             t.StageAlloc(5, 0.2, 8)], 3)):
            p = pk.dep.pack_instances(t.Allocation(stages=stages), g, pred,
                                      t.RTX_2080TI, nd)
            out.append(None if p is None else
                       [p.per_stage, pk.dep.placement_summary(p, nd)])
        return out
    out = both(run)
    assert out[0] is not None and out[1] is None


def _comm_data(c):
    return (c.global_memory_enabled, c.crossover_bytes())


@pytest.mark.parametrize("policy", ["even_allocation", "standalone",
                                    "laius", "camelot", "camelot_nc",
                                    "camelot_min_resource"])
@pytest.mark.parametrize("name", ["img-to-img", "diamond"])
def test_baselines_equal(policy, name):
    def run(pk):
        g = _graph(pk, name)
        dev = pk.types.RTX_2080TI
        pred = pk.pred.PipelinePredictor.from_graph(g, dev,
                                                    batches=(1, 4, 8, 16))
        sa = pk.alloc.SAConfig(iterations=200, seed=1)
        n_dev = max(2, g.n_nodes)
        fn = getattr(pk.base, policy)
        if policy in ("even_allocation", "standalone"):
            out = fn(g, dev, n_dev, 16)
        elif policy == "laius":
            out = fn(g, pred, dev, n_dev, 16)
        elif policy == "camelot_min_resource":
            out = fn(g, pred, dev, n_dev, 16, 40.0, sa=sa)
        else:
            out = fn(g, pred, dev, n_dev, 16, sa=sa)
        data = [alloc_data(out[0]), _comm_data(out[1])]
        if len(out) == 3:
            data.append(solve_data(out[2]))
        return data
    out = both(run)
    assert all(len(p) > 0 for p in out[0]["placement"])


# ---- multi-tenant, incremental and hierarchical solves ----------------------

def _tenants(pk, name="3-tenant-mixed"):
    ts = pk.types.TenantSet(pk.wl.multitenant_suite()[name])
    pred = pk.pred.PipelinePredictor.from_graph(ts.union_graph,
                                                pk.types.RTX_2080TI, seed=0)
    return ts, pred


@pytest.mark.parametrize("mode", ["vectorized", "incremental"])
@pytest.mark.parametrize("name", ["two-chains", "3-tenant-mixed"])
def test_multitenant_allocator_equal(name, mode):
    def run(pk):
        ts, pred = _tenants(pk, name)
        a = pk.alloc.MultiTenantAllocator(
            ts, pred, pk.types.RTX_2080TI, 4,
            sa=pk.alloc.SAConfig(iterations=300, seed=3, mode=mode))
        peak = a.solve_max_load(4)
        loads = [0.4 * peak.objective * w for w in ts.weights]
        res = a.solve_min_resource(4, loads)
        parts = [alloc_data(p)
                 for p in a.per_tenant_allocations(peak.allocation, 4)]
        return [solve_data(peak), solve_data(res), parts]
    peak, res, parts = both(run)
    assert peak["feasible"] and res["feasible"] and len(parts) >= 2


def test_split_join_allocation_equal():
    def run(pk):
        t = pk.types
        ts = t.TenantSet([t.Tenant("img-to-img",
                                   pk.wl.camelot_suite()["img-to-img"]),
                          t.Tenant("diamond", pk.wl.dag_suite()["diamond"])])
        pred = pk.pred.PipelinePredictor.from_graph(ts.union_graph,
                                                    t.RTX_2080TI, seed=0)
        res = pk.alloc.MultiTenantAllocator(
            ts, pred, t.RTX_2080TI, 3,
            sa=pk.alloc.SAConfig(iterations=300, seed=0)).solve_max_load(8)
        parts = ts.split_allocation(res.allocation)
        joined = ts.join_allocations(parts)
        return [solve_data(res), [alloc_data(p) for p in parts],
                alloc_data(joined), ts.offsets, list(ts.node_tenant)]
    both(run)


def test_incremental_evaluator_equal():
    def run(pk):
        ts, pred = _tenants(pk)
        a = pk.alloc.MultiTenantAllocator(
            ts, pred, pk.types.RTX_2080TI, 4,
            sa=pk.alloc.SAConfig(iterations=10, seed=5, mode="incremental"))
        tab = a._policy_tables(4)
        engine = pk.inc.IncrementalEvaluator(a, tab, 4)
        rng = np.random.default_rng(5)
        n, g = ts.n_nodes, len(tab.grid)
        ns = rng.integers(1, 4, size=(4, n))
        qi = rng.integers(0, g, size=(4, n))
        engine.rebase(ns, qi)
        base = np.repeat(np.arange(4), 2)
        ns2, qi2 = ns[base].copy(), qi[base].copy()
        ns2[::2, 0] = 3
        qi2[1::2, -1] = 0
        return [np.asarray(x).tolist()
                for x in engine.eval(ns2, qi2, base)]
    both(run)


@SETTINGS
@given(seed=st.integers(0, 10_000), steps=st.integers(1, 6))
def test_incremental_eval_matches_dense_on_random_mutations(seed, steps):
    """The port's incremental evaluator equals its dense ``_eval_many`` on
    random walker states and mutation rows, across commits (the
    reference's contract, without its 200 ms deadline)."""
    ts, pred = _tenants(PKGS["port"])
    sa = port_allocator.SAConfig(iterations=10, seed=seed,
                                 mode="incremental")
    alloc = port_allocator.MultiTenantAllocator(
        ts, pred, port_types.RTX_2080TI, 4, sa=sa)
    tab = alloc._policy_tables(4)
    engine = port_incremental.IncrementalEvaluator(alloc, tab, 4)
    assert engine.usable
    rng = np.random.default_rng(seed)
    n, g = ts.n_nodes, len(tab.grid)
    W, C = 5, 2
    NS_w = rng.integers(1, 4, size=(W, n))
    QI_w = rng.integers(0, g, size=(W, n))
    engine.rebase(NS_w, QI_w)
    base = np.repeat(np.arange(W), C)
    for _ in range(steps):
        NS, QI = NS_w[base].copy(), QI_w[base].copy()
        for r in range(W * C):
            for i in rng.integers(0, n, size=rng.integers(
                    1, sa.max_mutations + 1)):
                if rng.random() < 0.5:
                    NS[r, i] = rng.integers(1, 4)
                else:
                    QI[r, i] = rng.integers(0, g)
        t_i, q_i, l_i, f_i = engine.eval(NS, QI, base)
        t_d, q_d, l_d, f_d = alloc._eval_many(NS, QI, tab, 4)
        np.testing.assert_allclose(t_i, t_d, rtol=1e-9)
        np.testing.assert_allclose(q_i, q_d, rtol=1e-9)
        np.testing.assert_allclose(l_i, l_d, rtol=1e-9)
        np.testing.assert_array_equal(f_i, f_d)
        acc = np.flatnonzero(rng.random(W) < 0.5)
        if acc.size:
            picked = acc * C + rng.integers(0, C, size=acc.size)
            engine.commit(acc, picked)
            NS_w[acc], QI_w[acc] = NS[picked], QI[picked]


def test_hierarchical_one_pod_equal_and_flat():
    def run(pk):
        ts, pred = _tenants(pk)
        sa = pk.alloc.SAConfig(iterations=300, seed=3, mode="incremental")
        flat = pk.alloc.MultiTenantAllocator(
            ts, pred, pk.types.RTX_2080TI, 4, sa=sa).solve_max_load(4)
        hier = pk.hier.HierarchicalSolver(
            ts, pred, pk.types.RTX_2080TI, 4, sa=sa,
            pods=pk.types.PodConfig(pod_size=4)).solve_max_load(4)
        return [solve_data(flat), solve_data(hier)]
    flat, hier = both(run)
    assert hier["objective"] == flat["objective"]
    assert hier["allocation"]["stages"] == flat["allocation"]["stages"]
    assert len(hier["pods"]) == 1


@pytest.mark.parametrize("objective", ["max_load", "min_resource"])
def test_hierarchical_multi_pod_equal(objective):
    def run(pk):
        ts = pk.wl.synthetic_tenant_set(8, seed=7)
        pred = pk.wl.synthetic_predictor(ts)
        solver = pk.hier.HierarchicalSolver(
            ts, pred, pk.types.RTX_2080TI, 8,
            sa=pk.alloc.SAConfig(iterations=200, seed=0, mode="incremental"),
            pods=pk.types.PodConfig(pod_size=4, repair_rounds=1))
        if objective == "max_load":
            return solve_data(solver.solve_max_load(4))
        return solve_data(solver.solve_min_resource(4, 5.0))
    out = both(run)
    assert out["mode"] == "hierarchical" and len(out["pods"]) == 2
    assert out["feasible"]


def test_solve_result_dict_round_trip_across_packages():
    """A result the reference saved loads in the port to the same data."""
    a = _allocator(PKGS["ref"], "diamond", 4, "vectorized")
    d = a.solve_max_load(8).to_dict()
    back = port_allocator.SolveResult.from_dict(d)
    assert back.to_dict() == d
    assert math.isfinite(back.objective)
