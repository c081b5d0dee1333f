"""The port's ``camelot`` facade against the reference's: the contracts of
tests/test_api.py and tests/test_system.py run on both packages — spec
round-trips, the policy registry, session parity with the hand-wired
layers, ``fit_from_samples``, ``save``/``load``, multi-service
solve/split/partition, and ``session.serve()``.  The port's copies run the
same numpy code, so every solve and simulation is held bit-equal (``==``
on floats) under the same seeds."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.camelot as ref_camelot
import repro.core as ref_core
import repro.core.predictor as ref_predictor
import repro.serving as ref_serving
import repro.sim as ref_sim
import repro.sim.baselines as ref_baselines
import repro_torch.camelot as port_camelot
import repro_torch.core as port_core
import repro_torch.core.predictor as port_predictor
import repro_torch.serving as port_serving
import repro_torch.sim as port_sim
import repro_torch.sim.baselines as port_baselines
from repro_torch.configs import get_config
from repro_torch.core import H100

PKGS = {
    "ref": types.SimpleNamespace(
        cm=ref_camelot, core=ref_core, pred=ref_predictor, sim=ref_sim,
        base=ref_baselines, serving=ref_serving),
    "port": types.SimpleNamespace(
        cm=port_camelot, core=port_core, pred=port_predictor, sim=port_sim,
        base=port_baselines, serving=port_serving),
}
SPEC_NAMES = sorted(port_sim.workload_specs(include_artifacts=True))
ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b")


def alloc_data(a):
    """An Allocation as package-independent data."""
    return {"stages": [(s.n_instances, s.quota, s.batch) for s in a.stages],
            "placement": None if a.placement is None
            else [list(map(tuple, p)) for p in a.placement.per_stage],
            "predicted": (a.predicted_min_throughput, a.predicted_latency)}


def solve_data(res):
    """Everything of a SolveResult but its wall times and comm model."""
    return {"objective": res.objective, "feasible": res.feasible,
            "load": res.load, "mode": res.mode, "policy": res.policy,
            "warm": res.warm_started, "iterations": res.iterations,
            "pods": None if res.pods is None else [
                {k: v for k, v in p.items() if k != "solve_time"}
                for p in res.pods],
            "allocation": alloc_data(res.allocation)}


def sim_data(r):
    return (r.p99, r.mean_latency, r.completed)


def both(fn):
    """``fn(pk)`` on the reference and on the port; asserts equal results
    and returns the port's."""
    ref, port = fn(PKGS["ref"]), fn(PKGS["port"])
    assert port == ref
    return port


def sa(pk, iterations=500, seed=0):
    return pk.cm.SAConfig(iterations=iterations, seed=seed)


def spec(pk, name):
    return pk.sim.workload_specs(include_artifacts=True)[name]


# --------------------------------------------------------------------------
# Spec round-tripping
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES)
def test_service_spec_roundtrip(name):
    def run(pk):
        s = spec(pk, name)
        assert pk.cm.ServiceSpec.from_dict(s.to_dict()) == s
        assert pk.cm.ServiceSpec.from_dict(json.loads(json.dumps(
            s.to_dict()))) == s
        return s.to_dict()
    both(run)


def test_workload_specs_equal():
    both(lambda pk: {n: s.to_dict()
                     for n, s in pk.sim.workload_specs().items()})


@pytest.mark.parametrize("name", sorted(port_sim.dag_suite()))
def test_dag_spec_build_matches_source_graph(name):
    def run(pk):
        graph = pk.sim.dag_suite()[name]
        s = pk.cm.ServiceSpec.from_dict(
            pk.cm.ServiceSpec.from_graph(graph).to_dict())
        built = s.build()
        assert built.nodes == list(graph.nodes)
        assert built.edges == list(graph.edges)
        assert built.topo_order == graph.topo_order
        return (built.name, built.qos_target, list(built.topo_order),
                [dataclasses.asdict(e) for e in built.edges])
    both(run)


def test_chain_shorthand_and_payload_override():
    def run(pk):
        nodes = list(spec(pk, "img-to-img").nodes)
        s = pk.cm.ServiceSpec.chain("c", nodes, qos_target=0.2)
        assert s.is_chain
        d = s.to_dict()
        d["edges"] = "chain"
        assert pk.cm.ServiceSpec.from_dict(d) == s
        del d["edges"]
        assert pk.cm.ServiceSpec.from_dict(d) == s
        assert isinstance(s.build(), pk.core.Pipeline)
        with pytest.raises(ValueError):
            pk.cm.ServiceSpec.from_dict({**s.to_dict(), "edges": "ring"})
        p = pk.cm.ServiceSpec("p", nodes,
                              (pk.core.ServiceEdge(0, 1, 123.0),))
        back = pk.cm.ServiceSpec.from_dict(p.to_dict())
        return (s.to_dict(), back.edges[0].payload_bytes_per_query,
                back.build().edge_nbytes(0, 1, 4))
    assert both(run)[1:] == (123.0, 123.0 * 4)


def test_cluster_spec_roundtrip_and_quantize():
    def run(pk):
        c = pk.cm.ClusterSpec(devices=4, quota_step=0.05, pcie_total=10e9,
                              global_memory=False)
        assert pk.cm.ClusterSpec.from_dict(c.to_dict()) == c
        assert pk.cm.ClusterSpec.from_dict(
            json.loads(json.dumps(c.to_dict()))) == c
        assert not c.comm_model().global_memory_enabled
        with pytest.raises(ValueError):
            pk.cm.ClusterSpec(devices=0)
        with pytest.raises(ValueError):
            pk.cm.ClusterSpec.from_dict({"device": "h100-does-not-exist"})
        return (c.to_dict(), c.device_spec.host_link_total,
                [c.quantize(q) for q in (1 / 3, 0.05, 0.001, 7.0)])
    out = both(run)
    assert out[0]["device"] == "rtx2080ti" and out[1] == 10e9
    assert out[2] == pytest.approx([0.30, 0.05, 0.05, 1.0])


def test_port_names_the_h100_and_refuses_tpu_v5e():
    """The port's cluster knows the paper's GPUs and its own card; a TPU
    (the reference's third device) is not a deployment of the port."""
    assert sorted(port_camelot.KNOWN_DEVICES) == \
        ["h100", "rtx2080ti", "v100"]
    c = port_camelot.ClusterSpec(devices=1, device=H100)
    assert c.to_dict()["device"] == "h100"
    assert port_camelot.ClusterSpec.from_dict(c.to_dict()) == c
    assert port_camelot.ClusterSpec().device == port_core.RTX_2080TI
    with pytest.raises(ValueError, match="tpu-v5e.*known.*h100"):
        port_camelot.ClusterSpec.from_dict({"device": "tpu-v5e"})
    ref_camelot.ClusterSpec.from_dict({"device": "tpu-v5e"})   # reference


def test_qos_spec_roundtrip_and_load_model():
    def run(pk):
        q = pk.cm.QoSSpec(latency_target=0.3, percentile=95.0,
                          load=pk.cm.LoadSpec(kind="diurnal", qps=500.0,
                                              period=3600.0))
        assert pk.cm.QoSSpec.from_dict(json.loads(json.dumps(
            q.to_dict()))) == q
        with pytest.raises(ValueError):
            pk.cm.LoadSpec(kind="sawtooth")
        s = spec(pk, "diamond")
        fn = q.load.fn()
        return (q.to_dict(), [fn(t) for t in (0, 900, 1800, 2700)],
                pk.cm.LoadSpec(qps=42.0).fn()(123.0),
                pk.cm.QoSSpec().resolve_target(s),
                pk.cm.QoSSpec(latency_target=0.5).resolve_target(s))
    out = both(run)
    assert out[1][0] == pytest.approx(125.0, rel=0.01)
    assert out[1][2] == pytest.approx(500.0, rel=0.01)
    assert out[2] == 42.0 and out[4] == 0.5


def test_serve_spec_roundtrip_and_engine_kwargs():
    """The ServeSpec is the reference's data; the port's engine takes the
    threads knobs and refuses the process backend when it reaches it."""
    def run(pk):
        s = pk.cm.ServeSpec(backend="processes", max_retries=2,
                            retry_backoff=0.1, deadline=3.0)
        assert pk.cm.ServeSpec.from_dict(s.to_dict()) == s
        with pytest.raises(ValueError):
            pk.cm.ServeSpec(backend="gpu")
        return s.to_dict()
    both(run)
    kw = port_camelot.ServeSpec(max_retries=2).engine_kwargs()
    ref_kw = ref_camelot.ServeSpec(max_retries=2).engine_kwargs()
    assert kw == {k: v for k, v in ref_kw.items()
                  if k not in ("start_method", "shm_slots", "shm_slot_bytes",
                               "supervise_timeout")}


# --------------------------------------------------------------------------
# Session end-to-end parity with the hand-wired path
# --------------------------------------------------------------------------

def _hand_wired(pk, graph, n_devices, batch):
    dev = pk.core.RTX_2080TI
    pred = pk.core.PipelinePredictor.from_graph(graph, dev, seed=0)
    comm = pk.core.CommModel(dev)
    alloc = pk.core.CamelotAllocator(graph, pred, dev, n_devices, comm=comm,
                                     sa=sa(pk))
    res = alloc.solve_max_load(batch)
    sim = pk.sim.PipelineSimulator(
        graph, res.allocation, dev, comm,
        sim=pk.sim.SimConfig(duration=4.0, warmup=0.5, seed=0))
    return res, sim.run(max(res.objective * 0.5, 1.0))


def _facade(pk, s, n_devices, batch):
    sess = pk.cm.CamelotSession(s, pk.cm.ClusterSpec(devices=n_devices),
                                batch=batch)
    res = sess.solve(policy="max-peak", sa=sa(pk))
    r = sess.simulate(load=max(res.objective * 0.5, 1.0),
                      sim=pk.sim.SimConfig(duration=4.0, warmup=0.5, seed=0))
    return res, r


@pytest.mark.parametrize("name,n_devices", [("img-to-img", 2),
                                            ("diamond", 4)])
def test_session_parity_with_hand_wired(name, n_devices):
    def run(pk):
        s = spec(pk, name)
        hand_res, hand_sim = _hand_wired(pk, s.build(), n_devices, 8)
        face_res, face_sim = _facade(pk, s, n_devices, 8)
        hand = solve_data(hand_res)
        face = solve_data(face_res)
        assert face.pop("policy") == "max-peak" and hand.pop("policy") == ""
        assert face == hand
        assert sim_data(face_sim) == sim_data(hand_sim)
        return face, sim_data(face_sim)
    assert both(run)[0]["feasible"]


def test_session_accepts_graph_and_dict():
    def run(pk):
        graph = pk.sim.dag_suite()["diamond"]
        s = pk.cm.ServiceSpec.from_graph(graph)
        from_graph = pk.cm.CamelotSession(graph)
        from_dict = pk.cm.CamelotSession(s.to_dict())
        assert from_graph.service == s == from_dict.service
        return s.to_dict()
    both(run)


def test_session_fit_from_samples_matches_profile():
    def run(pk):
        s = spec(pk, "img-to-img")
        auto = pk.cm.CamelotSession(
            s, pk.cm.ClusterSpec(devices=2)).profile().stages
        manual = pk.cm.CamelotSession(
            s, pk.cm.ClusterSpec(devices=2)).fit_from_samples(
            [pk.pred.collect_samples(node, pk.core.RTX_2080TI, seed=i)
             for i, node in enumerate(s.nodes)]).stages
        out = []
        for a, m in zip(auto, manual):
            assert a.duration(8, 0.5) == m.duration(8, 0.5)
            out.append((a.duration(8, 0.5), a.throughput(8, 0.5)))
        return out
    both(run)


# --------------------------------------------------------------------------
# Policy registry
# --------------------------------------------------------------------------

def test_builtin_policies_registered():
    names = both(lambda pk: pk.cm.available_policies())
    for expect in ("max-peak", "min-resource", "even", "standalone",
                   "laius", "camelot-nc"):
        assert expect in names


def test_unknown_policy_error():
    def run(pk):
        with pytest.raises(pk.cm.UnknownPolicyError) as ei:
            pk.cm.get_policy("does-not-exist")
        sess = pk.cm.CamelotSession(spec(pk, "img-to-img"))
        with pytest.raises(pk.cm.UnknownPolicyError):
            sess.solve(policy="does-not-exist")
        return str(ei.value)
    msg = both(run)
    assert "does-not-exist" in msg and "max-peak" in msg


@pytest.mark.parametrize("policy", ["even", "standalone", "laius",
                                    "camelot-nc"])
def test_policy_solves_equal(policy):
    def run(pk):
        s = spec(pk, "img-to-img")
        sess = pk.cm.CamelotSession(s, pk.cm.ClusterSpec(devices=2),
                                    batch=8)
        kw = {"sa": sa(pk)} if policy == "camelot-nc" else {}
        res = sess.solve(policy=policy, **kw)
        return solve_data(res), res.comm.global_memory_enabled
    out = both(run)
    assert out[0]["policy"] == policy and out[0]["feasible"]


def test_even_policy_matches_baseline():
    def run(pk):
        s = spec(pk, "img-to-img")
        res = pk.cm.CamelotSession(s, pk.cm.ClusterSpec(devices=2),
                                   batch=8).solve(policy="even")
        base, comm = pk.base.even_allocation(s.build(), pk.core.RTX_2080TI,
                                             2, 8)
        assert [(a.n_instances, a.quota) for a in res.allocation.stages] \
            == [(a.n_instances, a.quota) for a in base.stages]
        assert res.comm.global_memory_enabled == comm.global_memory_enabled
        return res.mode, res.objective
    assert both(run)[0] == "closed-form"


def test_min_resource_policy_load_resolution():
    def run(pk):
        s = spec(pk, "img-to-img")
        sess = pk.cm.CamelotSession(s, pk.cm.ClusterSpec(devices=2), batch=8)
        with pytest.raises(ValueError):
            sess.solve(policy="min-resource", sa=sa(pk))
        sess2 = pk.cm.CamelotSession(
            s, pk.cm.ClusterSpec(devices=2),
            pk.cm.QoSSpec(load=pk.cm.LoadSpec(qps=50.0)), batch=8)
        return solve_data(sess2.solve(policy="min-resource", sa=sa(pk)))
    res = both(run)
    assert res["feasible"] and res["policy"] == "min-resource"
    assert sum(n * q for n, q, _ in res["allocation"]["stages"]) < 2.0


def test_register_custom_policy_dispatch():
    class FixedPolicy:
        name = "fixed-even"

        def solve(self, s, predictor, cluster, qos, batch=8):
            alloc, comm = port_baselines.even_allocation(
                s.build(qos), cluster.device_spec, cluster.devices, batch)
            res = port_core.SolveResult(allocation=alloc, objective=1.0,
                                        feasible=True, solve_time=0.0,
                                        iterations=0)
            res.comm, res.policy = comm, self.name
            return res

    registry = port_camelot.policies._REGISTRY
    try:
        port_camelot.register_policy(FixedPolicy())
        assert "fixed-even" in port_camelot.available_policies()
        assert "fixed-even" not in ref_camelot.available_policies()
        sess = port_camelot.CamelotSession(spec(PKGS["port"], "img-to-img"),
                                           port_camelot.ClusterSpec(
                                               devices=2))
        res = sess.solve(policy="fixed-even")
        assert res.policy == "fixed-even" and res.feasible
        with pytest.raises(ValueError):
            port_camelot.register_policy(FixedPolicy())
        port_camelot.register_policy(FixedPolicy(), overwrite=True)
    finally:
        registry.pop("fixed-even", None)


def test_solver_policies_reject_off_lattice_quota_step():
    def run(pk):
        sess = pk.cm.CamelotSession(spec(pk, "img-to-img"),
                                    pk.cm.ClusterSpec(devices=2,
                                                      quota_step=0.1))
        with pytest.raises(ValueError, match="QUOTA_STEP"):
            sess.solve(policy="max-peak", sa=sa(pk))
        return pk.cm.ClusterSpec(quota_step=0.1).quantize(0.17)
    assert both(run) == pytest.approx(0.1)


def test_session_runtime_inherits_cluster_comm():
    def run(pk):
        cluster = pk.cm.ClusterSpec(devices=2, global_memory=False,
                                    ici_bandwidth=9e9)
        rt = pk.cm.CamelotSession(spec(pk, "img-to-img"), cluster,
                                  batch=8).runtime(sa=sa(pk))
        assert rt.allocator.comm is rt.comm
        return (rt.comm.global_memory_enabled, rt.comm.ici_bandwidth,
                rt.peak_qps, alloc_data(rt.current))
    assert both(run)[:2] == (False, 9e9)


def test_policy_instance_passthrough():
    def run(pk):
        pol = pk.cm.MaxPeakPolicy(sa=sa(pk), name="local-max")
        res = pk.cm.CamelotSession(spec(pk, "img-to-img"),
                                   pk.cm.ClusterSpec(devices=2),
                                   batch=8).solve(policy=pol)
        assert "local-max" not in pk.cm.available_policies()
        return solve_data(res)
    assert both(run)["policy"] == "local-max"


def test_session_save_load_round_trip(tmp_path):
    """A session saved by either package loads in the port to the same
    specs and allocation, and simulates without a solve."""
    def run(pk, path):
        sess = pk.cm.CamelotSession(spec(pk, "diamond"),
                                    pk.cm.ClusterSpec(devices=3,
                                                      device=pk.core.V100),
                                    pk.cm.QoSSpec(load=pk.cm.LoadSpec(
                                        qps=20.0)), batch=8, seed=3)
        sess.solve(sa=sa(pk))
        sess.save(str(path))
        back = pk.cm.CamelotSession.load(str(path))
        return (back.service.to_dict(), back.cluster.to_dict(),
                back.qos.to_dict(), solve_data(back.last_result),
                sim_data(back.simulate(sim=pk.sim.SimConfig(
                    duration=2.0, warmup=0.5, seed=0))))
    ref = run(PKGS["ref"], tmp_path / "ref.json")
    assert run(PKGS["port"], tmp_path / "port.json") == ref
    back = port_camelot.CamelotSession.load(str(tmp_path / "ref.json"))
    assert solve_data(back.last_result) == ref[3]
    with open(tmp_path / "bad.json", "w") as f:
        json.dump({"kind": "other"}, f)
    with pytest.raises(ValueError, match="not a saved CamelotSession"):
        port_camelot.CamelotSession.load(str(tmp_path / "bad.json"))


# --------------------------------------------------------------------------
# Multi-service sessions
# --------------------------------------------------------------------------

def _multi(pk, **kw):
    return pk.cm.MultiServiceSession(
        [pk.core.Tenant("img-to-img", pk.sim.camelot_suite()["img-to-img"]),
         pk.core.Tenant("diamond", pk.sim.dag_suite()["diamond"],
                        weight=2.0)],
        pk.cm.ClusterSpec(devices=3), batch=8, name="pair", **kw)


@pytest.mark.parametrize("policy", ["max-peak", "min-resource",
                                    "camelot-nc"])
def test_multi_service_solve_and_split_equal(policy):
    def run(pk):
        sess = _multi(pk)
        res = sess.solve(policy=policy, sa=sa(pk, 400), loads=[10.0, 20.0])
        out = [solve_data(res), [alloc_data(a) for a in sess.split()]]
        if policy == "max-peak":
            out.append([sim_data(r) for r in sess.simulate(
                [0.3 * res.objective * w for w in sess.weights],
                sim=pk.sim.SimConfig(duration=2.0, warmup=0.5,
                                     seed=0)).per_tenant])
        return out
    assert both(run)[0]["feasible"]


def test_multi_service_partition_and_hierarchical_equal(tmp_path):
    def run(pk, path):
        sess = _multi(pk, solver=pk.cm.SolverSpec(mode="incremental",
                                                  iterations=300,
                                                  pod_size=2))
        lam, parts = sess.solve_partitioned([1, 2], sa=sa(pk, 300))
        best, part, results = sess.best_static_partition(sa=sa(pk, 300))
        hier = sess.solve()
        sess.save(str(path))
        back = pk.cm.MultiServiceSession.load(str(path))
        assert back.solver == sess.solver
        return (lam, [solve_data(r) for r in parts], best, part,
                [solve_data(r) for r in results], solve_data(hier),
                solve_data(back.last_result))
    out = run(PKGS["port"], tmp_path / "port.json")
    assert out == run(PKGS["ref"], tmp_path / "ref.json")
    assert out[5]["mode"] == "hierarchical" and out[5]["feasible"]
    with pytest.raises(ValueError, match="no static partition"):
        port_camelot.MultiServiceSession(
            [port_sim.camelot_suite()["img-to-img"],
             port_sim.dag_suite()["diamond"]],
            port_camelot.ClusterSpec(devices=1)).best_static_partition()


def test_multi_service_rejects_unknown_joint_policy():
    def run(pk):
        with pytest.raises(ValueError, match="unknown joint policy"):
            _multi(pk).solve(policy="even")
        return True
    both(run)


# --------------------------------------------------------------------------
# tests/test_system.py: the loop end to end and the headline claims
# --------------------------------------------------------------------------

def test_live_profile_to_allocation_roundtrip():
    """The port's reduced stages profiled live on the CPU; both packages
    fit the same timings and solve to the same placed allocation."""
    stages = [port_serving.ModelStageServer(n, a, seq_len=16, reduced=True,
                                            device="cpu")
              for n, a in zip(("sum", "tr"), ARCHS)]
    timings = [st.profile_stage_timings(batches=(1, 2, 4), repeats=2)
               for st in stages]

    def run(pk):
        dev = pk.core.DeviceSpec(**dataclasses.asdict(H100))
        profs = [pk.core.profile_from_engine(
            st.name, t, weights_bytes=1e9, act_bytes_per_query=2e7,
            device=dev, host_bytes_per_query=1e6)
            for st, t in zip(stages, timings)]
        pipe = pk.core.Pipeline("live", profs, qos_target=30.0)
        pred = pk.core.PipelinePredictor.from_profiles(profs, dev)
        return solve_data(pk.core.CamelotAllocator(
            pipe, pred, dev, n_devices=2, sa=sa(pk, 600)).solve_max_load(8))
    res = both(run)
    assert res["feasible"] and res["allocation"]["placement"] is not None


def test_headline_claim_peak_load_gain():
    def run(pk):
        dev = pk.core.RTX_2080TI
        scfg = pk.sim.SimConfig(duration=8.0, warmup=1.0, seed=0)
        peaks = []
        for name in ("img-to-img", "text-to-text"):
            pipe = pk.sim.camelot_suite()[name]
            pred = pk.core.PipelinePredictor.from_profiles(pipe.stages, dev)
            a_ea, c_ea = pk.sim.even_allocation(pipe, dev, 2, 16)
            a_cm, c_cm, _ = pk.sim.camelot(pipe, pred, dev, 2, 16)
            p_ea, _ = pk.sim.find_peak_load(
                lambda a=a_ea, c=c_ea: pk.sim.PipelineSimulator(
                    pipe, a, dev, c, scfg), pipe.qos_target)
            p_cm, _ = pk.sim.find_peak_load(
                lambda a=a_cm, c=c_cm: pk.sim.PipelineSimulator(
                    pipe, a, dev, c, scfg), pipe.qos_target)
            peaks.append((p_ea, p_cm))
        return peaks
    peaks = both(run)
    assert max(cm / max(ea, 1e-9) - 1 for ea, cm in peaks) > 0.10, peaks


def test_headline_claim_resource_saving_and_nc():
    def run(pk):
        dev = pk.core.RTX_2080TI
        pipe = pk.sim.camelot_suite()["img-to-img"]
        pred = pk.core.PipelinePredictor.from_profiles(pipe.stages, dev)
        _, _, res = pk.sim.camelot(pipe, pred, dev, 2, 16)
        low = res.objective * 0.3
        a_mr, c_mr, res_mr = pk.sim.camelot_min_resource(pipe, pred, dev, 2,
                                                         16, load=low)
        r = pk.sim.PipelineSimulator(
            pipe, a_mr, dev, c_mr,
            pk.sim.SimConfig(duration=8.0, warmup=1.0, seed=1)).run(low)
        pipe2 = pk.sim.camelot_suite()["img-to-text"]
        pred2 = pk.core.PipelinePredictor.from_profiles(pipe2.stages, dev)
        _, _, nc = pk.sim.camelot_nc(pipe2, pred2, dev, 2, 16)
        _, _, cm = pk.sim.camelot(pipe2, pred2, dev, 2, 16)
        return (res_mr.feasible, a_mr.total_quota(), r.p99,
                pipe.qos_target, nc.objective, cm.objective)
    feasible, quota, p99, target, nc, cm = both(run)
    assert feasible and 1 - quota / 2.0 > 0.3
    assert p99 <= target * 1.05
    assert nc >= cm - 1e-6


# --------------------------------------------------------------------------
# Session serving: the live engine wiring
# --------------------------------------------------------------------------

class _Recording:
    """Wraps a stage server of either package and records every call as
    (input rows, output ids) in numpy."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.seq_len, self.cfg = inner.name, inner.seq_len, \
            inner.cfg
        self.device = getattr(inner, "device", None)
        self.calls = []

    def warmup(self, batch):
        self.inner.warmup(batch)

    def process(self, tokens):
        out = self.inner.process(tokens)
        to_np = (lambda x: x.numpy()) if isinstance(out, torch.Tensor) \
            else np.asarray
        self.calls.append((to_np(tokens).copy(), to_np(out).copy()))
        return out


def _fp32_pair(name, arch, seed):
    """The reference's stage server with its parameters cast to fp32, and
    the port's server holding the same parameters."""
    ref = ref_serving.ModelStageServer(name, arch, seq_len=16, seed=seed)
    ref.params = jax.tree.map(lambda x: x.astype(jnp.float32), ref.params)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), ref.params)
    port = port_serving.ModelStageServer(
        name, arch, seq_len=16, seed=seed, reduced=True, device="cpu",
        dtype=torch.float32, params=tree)
    return ref, port


def _outputs(stage):
    """Input row (as bytes) -> output id over every recorded call."""
    return {row.tobytes(): int(i) for toks, ids in stage.calls
            for row, i in zip(toks, ids)}


def test_session_serve_matches_reference_query_for_query():
    """Both sessions solve the same allocation and serve it on stage
    servers holding the same fp32 parameters: the same queries complete
    and every stage maps every input row to the same output id."""
    pairs = [_fp32_pair(n.name, n.arch, i) for i, n in
             enumerate(spec(PKGS["ref"], "img-to-img").nodes)]
    recorded = {"ref": [_Recording(r) for r, _ in pairs],
                "port": [_Recording(p) for _, p in pairs]}

    def run(pk):
        sess = pk.cm.CamelotSession(spec(pk, "img-to-img"),
                                    pk.cm.ClusterSpec(devices=1), batch=4)
        res = sess.solve(policy="max-peak", sa=sa(pk, 300))
        stages = recorded["ref" if pk is PKGS["ref"] else "port"]
        eng = sess.serve(stages=stages, result=res, batch_timeout=0.5)
        assert [len(p) for p in eng.alloc.placement.per_stage] == \
            [len(p) for p in res.allocation.placement.per_stage]
        trace = sess.make_trace(8, qps=1e6, seed=1)
        s = eng.run_trace(trace).summary()
        return (solve_data(res), s["completed"], s["failed"],
                sorted(q.qid for q in trace if q.done is not None))
    out = both(run)
    assert out[1] == 8 and out[2] == 0
    for st, ref_st in zip(recorded["port"], recorded["ref"]):
        got, want = _outputs(st), _outputs(ref_st)
        assert got.keys() == want.keys() and got == want


def test_session_serve_builds_reduced_stages_on_the_cpu():
    """``serve()`` with no stage servers builds the port's own, here
    reduced on the CPU, and completes the trace; the process backend
    reaches the engine and is refused there."""
    s = spec(PKGS["port"], "img-to-img")
    sess = port_camelot.CamelotSession(s, port_camelot.ClusterSpec(
        devices=2), batch=4)
    res = sess.solve(policy="max-peak", sa=sa(PKGS["port"]))
    eng = sess.serve(result=res, reduced=True, device="cpu")
    assert [st.cfg for st in eng.stages] == \
        [get_config(a, reduced=True) for a in ARCHS]
    assert all(st.device.type == "cpu" for st in eng.stages)
    stats = eng.run_trace(sess.make_trace(6, qps=30.0, seed=1))
    assert stats.summary()["completed"] == 6
    with pytest.raises(NotImplementedError, match="CUDA IPC"):
        sess.serve(stages=eng.stages, result=res,
                   spec=port_camelot.ServeSpec(backend="processes"))


def test_multi_session_serve_builds_reduced_stages_on_the_cpu():
    sess = port_camelot.MultiServiceSession(
        [spec(PKGS["port"], "img-to-img"), spec(PKGS["port"],
                                                "text-to-img")],
        port_camelot.ClusterSpec(devices=2), batch=4)
    sess.solve(sa=sa(PKGS["port"], 300))
    eng = sess.serve(reduced=True, device="cpu")
    assert [[st.cfg for st in t.stages] for t in eng.tenants] == \
        [[get_config(a, reduced=True) for a in archs]
         for archs in (ARCHS, ("xlstm-1.3b", "qwen1.5-0.5b"))]
    stats = eng.run_traces(sess.make_traces(4, [30.0, 30.0], seed=2))
    assert [s.summary()["completed"] for s in stats] == [4, 4]
