"""The port's online runtime and tenant lifecycle against the reference's:
the contracts of tests/test_runtime.py and tests/test_lifecycle.py, and the
runtime-side cases of tests/test_fault.py (``HealthMonitor``, the degraded
re-solve, kill-and-restart resume), run on both packages.  The port's
copies run the same numpy code, so reallocation histories, admission
decisions and quotes, preemption and eviction results are held equal
(``==`` on floats) under the same seeds."""
import dataclasses
import math
import types

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # degrade to deterministic example sweeps
    from _hypothesis_fallback import given, settings, st

import repro.camelot as ref_camelot
import repro.core as ref_core
import repro.core.runtime as ref_runtime
import repro.core.types as ref_types
import repro.sim as ref_sim
import repro.sim.workloads as ref_workloads
import repro_torch.camelot as port_camelot
import repro_torch.core as port_core
import repro_torch.core.runtime as port_runtime
import repro_torch.core.types as port_types
import repro_torch.sim as port_sim
import repro_torch.sim.workloads as port_workloads

PKGS = {
    "ref": types.SimpleNamespace(
        cm=ref_camelot, core=ref_core, rt=ref_runtime, types=ref_types,
        sim=ref_sim, wl=ref_workloads),
    "port": types.SimpleNamespace(
        cm=port_camelot, core=port_core, rt=port_runtime, types=port_types,
        sim=port_sim, wl=port_workloads),
}
SIM = dict(duration=3.0, warmup=0.5, seed=0)


def alloc_data(a):
    """An Allocation as package-independent data."""
    return {"stages": [(s.n_instances, s.quota, s.batch) for s in a.stages],
            "placement": None if a.placement is None
            else [list(map(tuple, p)) for p in a.placement.per_stage]}


def solve_data(res):
    """Everything of a SolveResult but its wall times and comm model."""
    return {"objective": res.objective, "feasible": res.feasible,
            "load": res.load, "mode": res.mode, "warm": res.warm_started,
            "allocation": alloc_data(res.allocation)}


def events(hist):
    return [e.to_dict() for e in hist]


def lifecycle_events(mgr):
    """The lifecycle log without its wall times."""
    out = []
    for e in mgr.events:
        d = e.to_dict()
        d["detail"] = {k: v for k, v in d["detail"].items()
                       if k != "solve_time"}
        out.append(d)
    return out


def decision_data(dec):
    return {"admitted": dec.admitted, "tenant": dec.tenant,
            "result": None if dec.result is None else solve_data(dec.result),
            "quotes": [q.to_dict() for q in dec.quotes],
            "warm": dec.warm_started, "reason": dec.reason}


def both(fn):
    """``fn(pk)`` on the reference and on the port; asserts equal results
    and returns the port's."""
    ref, port = fn(PKGS["ref"]), fn(PKGS["port"])
    assert port == ref
    return port


def sa(pk, iterations=500, seed=0):
    return pk.core.SAConfig(iterations=iterations, seed=seed)


# --------------------------------------------------------------------------
# tests/test_runtime.py: diurnal tracking, EWMA, warm starts
# --------------------------------------------------------------------------

def _runtime(pk, iterations=800, **rt_kw):
    pipe = pk.wl.camelot_suite()["img-to-img"]
    dev = pk.core.RTX_2080TI
    pred = pk.core.PipelinePredictor.from_profiles(pipe.stages, dev)
    rt_kw = rt_kw or dict(reallocate_every=600.0, ewma_alpha=0.5)
    return pk.rt.CamelotRuntime(pipe, pred, dev, n_devices=2, batch=16,
                                rt=pk.rt.RuntimeConfig(**rt_kw),
                                sa=sa(pk, iterations))


def test_quota_tracks_diurnal_load():
    def run(pk):
        rt = _runtime(pk)
        load = pk.rt.diurnal_load(rt.peak_qps * 0.9, period=3600.0)
        hist = rt.run_trace(load, duration=3600.0, sample_every=60.0)
        # near capacity the peak allocation is used outright
        rt._load_est = rt.peak_qps * 0.95
        peak = rt.reallocate(now=4000.0)
        return (rt.peak_qps, rt.peak_result.allocation.total_quota(),
                events(hist), peak.total_quota())
    peak_qps, peak_quota, hist, at_peak = both(run)
    assert len(hist) >= 5
    quotas = np.array([h["total_quota"] for h in hist])
    loads = np.array([h["load_estimate"] for h in hist])
    assert np.corrcoef(loads[1:], quotas[1:])[0, 1] > 0.5
    assert quotas.min() < peak_quota * 0.7
    assert at_peak == pytest.approx(peak_quota)


def test_ewma_smoothing_and_diurnal_shape():
    def run(pk):
        rt = pk.rt.CamelotRuntime.__new__(pk.rt.CamelotRuntime)
        rt.rt = pk.rt.RuntimeConfig()
        rt._load_est = 0.0
        rt.observe(100.0)
        rt.observe(40.0)
        fn = pk.rt.diurnal_load(1000.0, period=86400.0, low_frac=0.25)
        return rt.load_estimate, [fn(t) for t in (0, 20000, 43200, 70000)]
    est, shape = both(run)
    assert 0 < est < 100.0
    assert shape[0] == pytest.approx(250.0, rel=0.01)
    assert shape[2] == pytest.approx(1000.0, rel=0.01)
    assert 250 <= shape[1] <= 1000


def test_warm_start_objective_ge_cold():
    def run(pk):
        rt = _runtime(pk)
        load = rt.peak_qps * 0.4
        cold = rt.allocator.solve_min_resource(rt.batch, load=load)
        warm = rt.allocator.solve_min_resource(
            rt.batch, load=load, warm_start=rt.peak_result.allocation)
        return solve_data(cold), solve_data(warm)
    cold, warm = both(run)
    assert not cold["warm"] and warm["warm"]
    assert warm["feasible"] == cold["feasible"]
    assert warm["objective"] >= cold["objective"] - 1e-9


def test_runtime_warm_starts_diurnal_resolves():
    def run(pk):
        rt = _runtime(pk, iterations=400)
        load = pk.rt.diurnal_load(rt.peak_qps * 0.9, period=3600.0)
        hist = rt.run_trace(load, duration=3600.0, sample_every=60.0)
        colds = [rt.allocator.solve_min_resource(
            rt.batch, load=max(e.provisioned_for, 1.0)).objective
            for e in hist if e.warm_started]
        return events(hist), colds
    hist, colds = both(run)
    warm = [e for e in hist if e["warm_started"]]
    assert warm and len(warm) == len(colds)
    for ev, cold in zip(warm, colds):
        assert ev["objective"] >= cold - 1e-9


def test_warm_start_disabled_by_config():
    def run(pk):
        rt = _runtime(pk, iterations=400, warm_start=False)
        rt._load_est = rt.peak_qps * 0.3
        rt.reallocate(now=0.0)
        return events(rt.history), rt.last_result.warm_started
    hist, warm = both(run)
    assert not hist[-1]["warm_started"] and not warm


# --------------------------------------------------------------------------
# tests/test_lifecycle.py: validation, isolation bounds, utilities
# --------------------------------------------------------------------------

def _chain(pk, name, kinds, qos=0.3, **kw):
    return pk.types.Tenant(name, pk.types.Pipeline(
        name, [pk.wl.artifact_stage(k, l) for k, l in kinds],
        qos_target=qos), **kw)


def _pred(pk, tenants, seed=0):
    return pk.core.PipelinePredictor.from_graph(
        pk.types.TenantSet(tenants).union_graph, pk.core.RTX_2080TI,
        seed=seed)


def test_tenant_validation_errors():
    def run(pk):
        g = pk.types.Pipeline("p", [pk.wl.artifact_stage("c", 1)],
                              qos_target=0.3)
        bad = pk.types.Pipeline("p", [pk.wl.artifact_stage("c", 1)],
                                qos_target=0.0)
        msgs = []
        for graph, kw in ((g, {"weight": 0.0}), (bad, {}),
                          (g, {"required_load": 0.0}),
                          (g, {"quota_floor": -0.1}),
                          (g, {"quota_floor": 1.0, "quota_cap": 0.5}),
                          (g, {"utility": "cubic"})):
            with pytest.raises(ValueError) as ei:
                pk.types.Tenant("t", graph, **kw)
            msgs.append(str(ei.value))
        assert pk.types.Tenant("t", g, priority=3, quota_floor=0.5,
                               quota_cap=2.0, utility="log").isolated
        return msgs
    both(run)


def test_tenant_spec_validation_and_roundtrip():
    def run(pk):
        svc = pk.cm.ServiceSpec.from_graph(
            pk.wl.camelot_suite()["img-to-img"])
        for kw in ({"quota_floor": -1.0},
                   {"quota_floor": 2.0, "quota_cap": 1.0},
                   {"utility": "exp"}):
            with pytest.raises(ValueError):
                pk.cm.TenantSpec(svc, **kw)
        s = pk.cm.TenantSpec(svc, pk.cm.QoSSpec(), weight=1.5, priority=2,
                             quota_floor=0.5, quota_cap=2.5, utility="sqrt")
        back = pk.cm.TenantSpec.from_dict(s.to_dict())
        assert back == s
        t = back.build()
        return s.to_dict(), (t.priority, t.quota_floor, t.quota_cap,
                             t.utility)
    assert both(run)[1] == (2, 0.5, 2.5, "sqrt")


def _iso_tenants(pk):
    return [_chain(pk, "floor", [("c", 1), ("m", 1)], qos=0.35,
                   quota_floor=1.0),
            _chain(pk, "cap", [("p", 1), ("c", 1)], qos=0.35,
                   quota_cap=0.8),
            _chain(pk, "free", [("m", 1), ("p", 1)], qos=0.35)]


def _tenant_quotas(ts, alloc):
    return [sum(s.n_instances * s.quota
                for s in alloc.stages[off:off + t.graph.n_nodes])
            for t, off in zip(ts.tenants, ts.offsets)]


@pytest.mark.parametrize("mode", ["scalar", "vectorized", "incremental",
                                  "hierarchical"])
def test_iso_bounds_enforced_equal(mode):
    def run(pk):
        tenants = _iso_tenants(pk)
        ts = pk.types.TenantSet(tenants)
        pred = _pred(pk, tenants)
        if mode == "hierarchical":
            res = pk.core.HierarchicalSolver(
                ts, pred, pk.core.RTX_2080TI, 4, sa=sa(pk),
                pods=pk.core.PodConfig(pod_size=2)).solve_max_load(8)
        else:
            res = pk.core.MultiTenantAllocator(
                ts, pred, pk.core.RTX_2080TI, 4,
                sa=dataclasses.replace(sa(pk), mode=mode)).solve_max_load(8)
        return solve_data(res), _tenant_quotas(ts, res.allocation)
    res, tq = both(run)
    assert res["feasible"]
    assert tq[0] >= 1.0 - 1e-9 and tq[1] <= 0.8 + 1e-9, tq


def test_priority_floor_ladder_and_utilities_equal():
    """Priority alone never changes a solve; floors bound the
    min-resource ladder; a cap below the QoS need is infeasible; utility
    curves reshape max-peak only."""
    def run(pk):
        dev = pk.core.RTX_2080TI
        base = [_chain(pk, "a", [("c", 1), ("m", 1)]),
                _chain(pk, "b", [("p", 1), ("c", 2)])]
        pred = _pred(pk, base)
        solve = lambda ts, n=4: pk.core.MultiTenantAllocator(  # noqa: E731
            pk.types.TenantSet(ts), pred, dev, n, sa=sa(pk))
        r0 = solve(base).solve_max_load(8)
        r1 = solve([dataclasses.replace(base[0], priority=2),
                    dataclasses.replace(base[1], priority=1)]
                   ).solve_max_load(8)
        assert solve_data(r0) == solve_data(r1)
        log = solve([dataclasses.replace(t, utility="log")
                     for t in base]).solve_max_load(8)
        sq = solve([dataclasses.replace(base[0], utility="sqrt"), base[1]]
                   ).solve_min_resource(8, [20.0, 20.0])
        floors = [_chain(pk, "f1", [("c", 1)], quota_floor=1.5),
                  _chain(pk, "f2", [("m", 1)], quota_floor=1.5)]
        fl = pk.core.MultiTenantAllocator(
            pk.types.TenantSet(floors), _pred(pk, floors), dev, 6,
            sa=sa(pk)).solve_min_resource(8, [5.0, 5.0])
        starved = [_chain(pk, "starved", [("c", 3), ("c", 3)], qos=0.05,
                          quota_cap=pk.types.QUOTA_STEP)]
        st_res = pk.core.MultiTenantAllocator(
            pk.types.TenantSet(starved), _pred(pk, starved), dev, 2,
            sa=sa(pk)).solve_max_load(8)
        return (solve_data(r0), solve_data(log), solve_data(sq),
                solve_data(fl), len(fl.allocation.placement.devices_used()),
                st_res.feasible)
    lin, log, sq, fl, used, starved = both(run)
    assert log["objective"] == pytest.approx(math.log1p(lin["objective"]),
                                             rel=0.05)
    assert log["load"] is None and lin["load"] == lin["objective"]
    assert sq["objective"] == pytest.approx(
        -sum(n * q for n, q, _ in sq["allocation"]["stages"]), abs=1e-9)
    assert fl["feasible"] and used >= 3
    assert not starved


# --------------------------------------------------------------------------
# tests/test_lifecycle.py: admission, preemption, history, mutations
# --------------------------------------------------------------------------

def _manager(pk, n_devices=6, iterations=500, tenants=None):
    tenants = tenants if tenants is not None else pk.wl.churn_suite()
    ts = pk.types.TenantSet(tenants)
    pred = pk.core.PipelinePredictor.from_graph(ts.union_graph,
                                                pk.core.RTX_2080TI, seed=0)
    return pk.core.LifecycleManager(ts, pred, pk.core.RTX_2080TI, n_devices,
                                    8, sa=sa(pk, iterations))


def test_admission_accept_preserves_incumbent_verdicts():
    def run(pk):
        mgr = _manager(pk)
        before = list(mgr.tenant_names)
        t = pk.wl.churn_tenant(0, np.random.default_rng(1))
        dec = mgr.admit(1.0, t)
        return (before, decision_data(dec), mgr.qos_verdicts(),
                lifecycle_events(mgr), alloc_data(mgr.current))
    before, dec, verdicts, _, _ = both(run)
    assert dec["admitted"] and dec["result"]["feasible"]
    assert set(verdicts) == set(before) | {dec["tenant"]}
    assert all(verdicts.values()), verdicts


def test_admission_warm_not_worse_than_cold():
    def run(pk):
        t = pk.wl.churn_tenant(0, np.random.default_rng(1))
        return (decision_data(_manager(pk).admit(1.0, t, warm=True)),
                decision_data(_manager(pk).admit(1.0, t, warm=False)))
    warm, cold = both(run)
    assert warm["admitted"] and cold["admitted"]
    assert warm["result"]["objective"] >= cold["result"]["objective"] - 1e-9


def test_denial_quotes_are_certified():
    """A denial carries quotes, equal in both packages; each is
    re-certified by an independent cold solve in the port."""
    def run(pk):
        mgr = _manager(pk, n_devices=4)
        big = dataclasses.replace(
            pk.wl.churn_tenant(0, np.random.default_rng(2)),
            required_load=5000.0, quota_floor=0.0, quota_cap=None)
        return mgr, big, decision_data(mgr.admit(1.0, big))
    ref_dec = run(PKGS["ref"])[2]
    mgr, big, dec = run(PKGS["port"])
    assert dec == ref_dec
    assert not dec["admitted"] and dec["quotes"]
    for q in dec["quotes"]:
        assert q["certified"]
        cand = list(mgr.tenants.tenants)
        loads = mgr._required_loads(cand) + [big.required_load]
        n_dev, newcomer = mgr.n_devices, big
        if q["kind"] == "reduce_load":
            loads[-1] = q["load"]
        elif q["kind"] == "relax_qos":
            newcomer = dataclasses.replace(big, graph=port_types.Pipeline(
                big.graph.name, big.graph.nodes,
                qos_target=q["qos_target"]))
        else:
            n_dev += q["extra_devices"]
        ts = port_types.TenantSet(cand + [newcomer])
        res = port_core.MultiTenantAllocator(
            ts, port_core.PipelinePredictor.from_graph(
                ts.union_graph, port_core.RTX_2080TI, seed=0),
            port_core.RTX_2080TI, n_dev, sa=sa(PKGS["port"])
        ).solve_min_resource(8, loads)
        assert res.feasible, q


def test_duplicate_admission_rejected():
    def run(pk):
        with pytest.raises(ValueError, match="already admitted") as ei:
            _manager(pk, iterations=300).admit(0.0, pk.wl.churn_suite()[0])
        return str(ei.value)
    both(run)


def test_preemption_sheds_in_strict_priority_order():
    def run(pk):
        tenants = [_chain(pk, "gold", [("c", 1), ("m", 1)], priority=2,
                          required_load=20.0),
                   _chain(pk, "bronze", [("p", 1), ("c", 1)], priority=0,
                          required_load=20.0),
                   _chain(pk, "silver", [("m", 1), ("p", 1)], priority=1,
                          required_load=20.0)]
        mgr = _manager(pk, n_devices=3, tenants=tenants)
        spike = mgr.preempt(1.0, targets=[4000.0, 4000.0, 4000.0])
        calm = _manager(pk).preempt(1.0, targets=[10.0, 10.0, 10.0])
        return (events(mgr.runtime.history), lifecycle_events(mgr),
                alloc_data(spike), alloc_data(calm))
    hist, log, _, _ = both(run)
    ev = hist[-1]
    assert ev["reason"] == "preempted"
    assert ev["shed"][:2] == ["bronze", "silver"] or ev["shed"] == ["bronze"]
    assert log[-1]["op"] == "preempt" and log[-1]["detail"]["shed"] == \
        ev["shed"]


def test_runtime_history_is_bounded():
    def run(pk):
        ts = pk.types.TenantSet(pk.wl.churn_suite()[:1])
        pred = pk.core.PipelinePredictor.from_graph(
            ts.union_graph, pk.core.RTX_2080TI, seed=0)
        rt = pk.rt.MultiTenantRuntime(ts, pred, pk.core.RTX_2080TI, 2, 8,
                                      rt=pk.rt.RuntimeConfig(history_limit=5),
                                      sa=sa(pk, 300))
        for k in range(9):
            rt.observe([10.0])
            rt.reallocate(float(k))
        return events(rt.history)
    hist = both(run)
    assert len(hist) == 5 and hist[0]["time"] == 4.0


def test_mutations_roundtrip_through_save_load(tmp_path):
    """admit, scale, retarget, save, load, evict through the facade: the
    same specs, joint results and lifecycle log in both packages."""
    def run(pk, path):
        sess = pk.cm.MultiServiceSession(
            pk.wl.churn_suite(), pk.cm.ClusterSpec(devices=6),
            solver=pk.cm.SolverSpec(iterations=500, seed=0))
        sess.profile()
        t = pk.wl.churn_tenant(0, np.random.default_rng(1))
        dec = sess.admit(t, now=1.0)
        scaled = sess.scale_tenant("base-lo", required_load=25.0, now=2.0)
        retargeted = sess.retarget_qos("base-mid", 0.5, now=3.0)
        sess.save(str(path))
        back = pk.cm.MultiServiceSession.load(str(path))
        back.profile()
        ops = [(e.op, e.tenant) for e in back.lifecycle().events]
        evicted = sess.evict(t.name, now=4.0)
        return (decision_data(dec), solve_data(scaled),
                solve_data(retargeted), back.spec.to_dict(), ops,
                solve_data(evicted), sess.spec.to_dict(),
                len(sess.predictor.stages), sess.tenant_set.n_nodes,
                solve_data(sess.last_result), t.name)
    out = run(PKGS["port"], tmp_path / "port.json")
    assert out == run(PKGS["ref"], tmp_path / "ref.json")
    (dec, scaled, retargeted, back, ops, evicted, spec, n_pred, n_nodes,
     _, name) = out
    assert dec["admitted"] and scaled["feasible"] and retargeted["feasible"]
    assert back["tenants"][0]["qos"]["load"]["qps"] == 25.0
    assert back["tenants"][1]["qos"]["latency_target"] == 0.5
    assert ops == [("admit", name), ("scale", "base-lo"),
                   ("retarget", "base-mid")]
    assert evicted["feasible"] and n_pred == n_nodes
    assert name not in [t["service"]["name"] for t in spec["tenants"]]


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 6))
def test_churn_replay_equal(seed):
    """A seeded churn script replays to the same lifecycle log in both
    packages, keeping the reference's invariants after every step."""
    def run(pk):
        mgr = _manager(pk, iterations=300)
        for ev in pk.wl.churn_trace(n_events=6, seed=seed):
            if ev["op"] == "admit":
                dec = mgr.admit(ev["t"], ev["tenant"],
                                quote_kinds=("reduce_load",))
                if dec.admitted:
                    assert all(mgr.qos_verdicts().values())
                else:
                    assert all(q.certified for q in dec.quotes)
            elif ev["op"] == "remove":
                if ev["name"] in mgr.tenant_names:
                    mgr.remove(ev["t"], ev["name"])
            elif ev["op"] == "scale":
                if ev["name"] in mgr.tenant_names:
                    mgr.scale_tenant(ev["t"], ev["name"],
                                     required_load=max(
                                         1.0, 30.0 * ev["factor"]))
            else:
                mgr.preempt(ev["t"], targets=[ev["factor"] * 30.0]
                            * len(mgr.tenant_names))
            names = mgr.tenant_names
            assert len(set(names)) == len(names)
            assert len(mgr.predictor.stages) == mgr.tenants.n_nodes
        return lifecycle_events(mgr), alloc_data(mgr.current)
    log, _ = both(run)
    assert log


# --------------------------------------------------------------------------
# tests/test_fault.py: the runtime side of the fault plane
# --------------------------------------------------------------------------

def _stub_runtime(pk, weights, feasible_after_sheds):
    """A MultiTenantRuntime wired to a stub allocator whose min-resource
    solve goes feasible only once ``feasible_after_sheds`` targets have
    been floored — isolates the degradation loop from the SA solver."""
    g = pk.wl.camelot_suite()["img-to-img"]
    tenants = pk.types.TenantSet([pk.types.Tenant(f"t{i}", g, weight=w)
                                  for i, w in enumerate(weights)])
    alloc = pk.types.Allocation(
        stages=[pk.types.StageAlloc(1, 0.5, 8)],
        placement=pk.types.Placement(per_stage=[[(0, 0.5)]]))

    class _Stub:
        def __init__(self):
            self.min_calls = []

        def solve_max_load(self, batch, warm_start=None, device_mask=None):
            return types.SimpleNamespace(
                feasible=True, objective=100.0, allocation=alloc,
                warm_started=warm_start is not None, solve_time=0.0)

        def solve_min_resource(self, batch, targets, warm_start=None,
                               device_mask=None):
            self.min_calls.append(list(targets))
            ok = sum(1 for t in targets if t <= 1.0) >= feasible_after_sheds
            return types.SimpleNamespace(
                feasible=ok, objective=-1.0 if ok else 0.0,
                allocation=alloc, warm_started=warm_start is not None,
                solve_time=0.0)

    rt = pk.rt.MultiTenantRuntime.__new__(pk.rt.MultiTenantRuntime)
    rt.tenants = tenants
    rt.rt = pk.rt.RuntimeConfig(ewma_alpha=1.0, headroom=1.0)
    rt.n_devices = 3
    rt.batch = 8
    rt.allocator = _Stub()
    rt.peak_result = rt.allocator.solve_max_load(8)
    rt.peak_lambda = 100.0
    rt._load_est = [50.0] * len(weights)
    rt.current = alloc
    rt.last_result = rt.peak_result
    rt.history = []
    rt._engine = None
    return rt


@pytest.mark.parametrize("weights,after,reason,shed,floored",
                         [([1.0, 0.25, 0.5], 2, "degraded", ["t1", "t2"],
                           [[], [1], [1, 2]]),
                          ([1.0, 0.25], 0, "device_failure", [], [[]])])
def test_degradation_sheds_in_weight_order(weights, after, reason, shed,
                                           floored):
    def run(pk):
        rt = _stub_runtime(pk, weights, after)
        rt.on_device_failure(5.0, [2])
        return events(rt.history), rt.allocator.min_calls
    hist, calls = both(run)
    assert hist[-1]["reason"] == reason and hist[-1]["shed"] == shed
    # lowest weight first, strictly one tenant at a time
    assert [[i for i, t in enumerate(c) if t <= 1.0] for c in calls] == \
        floored


def test_device_failure_resolve_equal():
    """The real masked re-solves: one service and a joint pair lose a
    device and re-solve on the survivors, to the same events."""
    def run(pk):
        rt = _runtime(pk, iterations=400)
        rt.observe(rt.peak_qps * 0.4)
        rt.on_device_failure(1.0, 1)
        dev = pk.core.RTX_2080TI
        ts = pk.types.TenantSet(
            [pk.types.Tenant("img-to-img", pk.wl.camelot_suite()[
                "img-to-img"]),
             pk.types.Tenant("diamond", pk.wl.dag_suite()["diamond"])])
        pred = pk.core.PipelinePredictor.from_graph(ts.union_graph, dev,
                                                    seed=0)
        mt = pk.rt.MultiTenantRuntime(ts, pred, dev, 3, 8,
                                      rt=pk.rt.RuntimeConfig(ewma_alpha=1.0),
                                      sa=sa(pk, 400))
        mt.observe([0.3 * mt.peak_lambda * t.weight for t in ts.tenants])
        mt.on_device_failure(2.0, [2])
        mt.preempt(3.0, targets=[4000.0, 4000.0])
        return (events(rt.history), alloc_data(rt.current),
                events(mt.history), alloc_data(mt.current))
    single, s_alloc, joint, j_alloc = both(run)
    assert single[-1]["reason"] in ("device_failure", "degraded")
    assert {d for p in s_alloc["placement"] for d, _ in p} <= {0}
    assert joint[0]["reason"] in ("device_failure", "degraded")
    assert joint[1]["reason"] == "preempted"


def test_reallocation_event_roundtrip():
    def run(pk):
        ev = pk.rt.ReallocationEvent(time=3.0, load_estimate=50.0,
                                     provisioned_for=55.0, total_quota=1.5,
                                     feasible=True, objective=-1.5,
                                     warm_started=True, reason="degraded",
                                     shed=("a", "b"))
        assert pk.rt.ReallocationEvent.from_dict(ev.to_dict()) == ev
        old = pk.rt.ReallocationEvent.from_dict(
            {"time": 1.0, "load_estimate": 2.0, "provisioned_for": 3.0,
             "total_quota": 0.5, "feasible": True})
        return ev.to_dict(), old.to_dict()
    _, old = both(run)
    assert old["reason"] == "load" and old["shed"] == []


def test_health_monitor_equal():
    def run(pk):
        mon = pk.rt.HealthMonitor(range(3), heartbeat_timeout=0.4)
        mon.observe(1.0, {0: 0.9, 1: 0.95, 2: 0.99})
        out = [mon.dead_devices(1.0)]
        mon.observe(2.0, {0: 1.9, 1: 1.1, 2: 1.95})
        out.append(mon.dead_devices(2.0))
        mon.mark_dead(2)
        out.append(mon.dead_devices(2.0))
        mon.reset_device(1)
        out.append(mon.dead_devices(2.0))
        slow = pk.rt.HealthMonitor(range(3), heartbeat_timeout=10.0,
                                   ewma_alpha=1.0, straggle_factor=3.0)
        for k in range(1, 6):
            slow.observe(k * 1.0, {0: k * 0.1, 1: k * 0.1, 2: k * 0.5})
        return (out, slow.straggle_scores(), slow.stragglers(),
                slow.dead_devices(5.0))
    dead, scores, stragglers, slow_dead = both(run)
    assert dead == [[], [1], [1, 2], [2]]
    assert scores[2] > scores[0] and stragglers == [2] and slow_dead == []


@pytest.fixture(scope="module")
def joint():
    """chain + diamond on 3 shared devices, solved once per package."""
    out = {}
    for k, pk in PKGS.items():
        sess = pk.cm.MultiServiceSession(
            [pk.types.Tenant("img-to-img",
                             pk.wl.camelot_suite()["img-to-img"]),
             pk.types.Tenant("diamond", pk.wl.dag_suite()["diamond"])],
            pk.cm.ClusterSpec(devices=3), batch=8, name="fault-fixture")
        res = sess.solve(policy="max-peak", sa=sa(pk, 400))
        assert res.feasible
        out[k] = (sess, res, [0.3 * res.objective * w for w in sess.weights])
    return out


def test_kill_and_restart_resumes_without_cold_solve(joint, tmp_path,
                                                     monkeypatch):
    def run(pk, k):
        sess, res, loads = joint[k]
        path = str(tmp_path / f"{k}.json")
        sess.save(path)
        back = pk.cm.MultiServiceSession.load(path)

        def _boom(self, *a, **kw):
            raise AssertionError("cold solve after restart")

        with monkeypatch.context() as m:
            m.setattr(pk.core.MultiTenantAllocator, "solve_max_load", _boom)
            rt = back.runtime(rt=pk.rt.RuntimeConfig(ewma_alpha=1.0),
                              sa=sa(pk, 400), resume=True)
        assert rt.peak_lambda == res.objective
        sim = pk.sim.SimConfig(**SIM)
        a = [(r.p99, r.mean_latency, r.completed)
             for r in sess.simulate(loads, sim=sim).per_tenant]
        b = [(r.p99, r.mean_latency, r.completed)
             for r in back.simulate(loads, sim=sim).per_tenant]
        assert a == b
        return alloc_data(rt.current), a
    assert run(PKGS["port"], "port") == run(PKGS["ref"], "ref")


def test_runtime_without_resume_still_solves(joint, monkeypatch):
    calls = []
    real = port_core.MultiTenantAllocator.solve_max_load

    def _spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(port_core.MultiTenantAllocator, "solve_max_load",
                        _spy)
    fresh = port_camelot.MultiServiceSession(
        [port_types.Tenant("img-to-img",
                           port_workloads.camelot_suite()["img-to-img"]),
         port_types.Tenant("diamond", port_workloads.dag_suite()["diamond"])],
        port_camelot.ClusterSpec(devices=3), batch=8, name="cold")
    fresh.profile()
    fresh.runtime(sa=sa(PKGS["port"], 400))
    assert calls
