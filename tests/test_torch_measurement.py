"""The port's measurement plane against the reference's, on the same numpy
inputs and seeds: the contracts of tests/test_measurement.py,
tests/test_simulator.py, tests/test_policy_fastpath.py and
tests/test_graph.py run on both packages.  The port's copies run the same
numpy code, so every result is held bit-equal (``==`` on floats)."""
import dataclasses
import math
import types

import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core.faults as ref_faults
import repro.core.mlmodels as ref_mlmodels
import repro.core.predictor as ref_predictor
import repro.core.types as ref_types
import repro.sim as ref_sim
import repro.sim.baselines as ref_baselines
import repro.sim.simulator as ref_simulator
import repro.sim.workloads as ref_workloads
import repro_torch.configs as port_configs
import repro_torch.core.faults as port_faults
import repro_torch.core.mlmodels as port_mlmodels
import repro_torch.core.predictor as port_predictor
import repro_torch.core.types as port_types
import repro_torch.sim as port_sim
import repro_torch.sim.baselines as port_baselines
import repro_torch.sim.simulator as port_simulator
import repro_torch.sim.workloads as port_workloads
from repro.core.comm import CommModel as RefCommModel
from repro_torch.core.comm import CommModel as PortCommModel

PKGS = {
    "ref": types.SimpleNamespace(
        configs=ref_configs, faults=ref_faults, ml=ref_mlmodels,
        pred=ref_predictor, types=ref_types, sim=ref_sim,
        base=ref_baselines, simulator=ref_simulator, wl=ref_workloads,
        CommModel=RefCommModel),
    "port": types.SimpleNamespace(
        configs=port_configs, faults=port_faults, ml=port_mlmodels,
        pred=port_predictor, types=port_types, sim=port_sim,
        base=port_baselines, simulator=port_simulator, wl=port_workloads,
        CommModel=PortCommModel),
}
# the H100's figures, built in each package (the reference has no H100)
H100_FIELDS = dataclasses.asdict(port_types.H100)
DEVICES = ("rtx2080ti", "v100", "h100")


def device(pk, name):
    if name == "h100":
        return pk.types.DeviceSpec(**H100_FIELDS)
    return {"rtx2080ti": pk.types.RTX_2080TI, "v100": pk.types.V100}[name]


def plain(x):
    """Package-independent data: dataclasses as dicts, arrays as lists,
    tuples as lists (so results of both packages compare with ==)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def both(fn):
    """``fn(pk)`` on the reference and on the port; asserts the two
    results are equal and returns the port's."""
    ref, port = (plain(fn(PKGS[k])) for k in ("ref", "port"))
    assert port == ref
    return port


def graph_data(g):
    return {"name": g.name, "qos": g.qos_target,
            "nodes": [plain(n) for n in g.nodes],
            "edges": [plain(e) for e in g.edges],
            "entries": g.entries, "exits": g.exits, "topo": g.topo_order}


# ---- profiles, graphs, workloads -------------------------------------------

@pytest.mark.parametrize("dev", DEVICES)
def test_profile_physics_bit_equal(dev):
    def run(pk):
        profs = [n for g in pk.wl.camelot_suite().values() for n in g.nodes]
        profs += [pk.wl.artifact_stage(k, lv) for k in "cmp"
                  for lv in (1, 2, 3)]
        d = device(pk, dev)
        return [[p.flops(b), p.mem_bytes(b), p.footprint(b),
                 p.duration(b, q, d), p.bandwidth(b, q, d),
                 p.throughput(b, q, d)]
                for p in profs for b in (1, 3, 8, 64)
                for q in (0.05, 0.25, 0.6, 1.0)]
    assert len(both(run)) == (8 + 9) * 16


@pytest.mark.parametrize("suite", ["camelot_suite", "dag_suite",
                                   "artifact_pipelines"])
def test_workload_profiles_bit_equal(suite):
    out = both(lambda pk: {k: graph_data(g) for k, g in
                           getattr(pk.wl, suite)().items()})
    assert out


def test_camelot_suite_text_to_text_sizes_whisper_medium():
    """The suite's text-to-text service is sized from whisper-medium's
    configuration, which the port now registers."""
    out = both(lambda pk: plain(pk.wl.camelot_suite()["text-to-text"]
                                .nodes[1]))
    assert out["arch"] == "whisper-medium"


@pytest.mark.parametrize("n,seed", [(5, 0), (12, 7)])
def test_synthetic_tenant_set_bit_equal(n, seed):
    def run(pk):
        ts = pk.wl.synthetic_tenant_set(n, seed=seed)
        return {"tenants": [(t.name, t.weight, graph_data(t.graph))
                            for t in ts.tenants],
                "offsets": ts.offsets, "union": graph_data(ts.union_graph)}
    both(run)


def test_multitenant_suite_bit_equal():
    both(lambda pk: {k: [(t.name, t.weight, graph_data(t.graph))
                         for t in v]
                     for k, v in pk.wl.multitenant_suite().items()})


@pytest.mark.parametrize("suite", ["camelot_suite", "dag_suite"])
def test_service_graph_critical_paths_bit_equal(suite):
    def run(pk):
        d = pk.types.RTX_2080TI
        out = {}
        rng = np.random.default_rng(6)
        for name, g in getattr(pk.wl, suite)().items():
            def node_cost(i, g=g):
                return g.nodes[i].duration(8, 0.25, d)

            def edge_cost(e, g=g):
                return g.edge_nbytes(e.src, e.dst, 8) / d.host_link_stream
            nc = rng.uniform(0.1, 1.0, size=(16, g.n_nodes))
            ec = rng.uniform(0.0, 0.3, size=(16, len(g.edges)))
            out[name] = {
                "critical_path": g.critical_path(node_cost, edge_cost),
                "arrays": g.critical_path_arrays(nc, ec),
                "nodes": g.critical_path_nodes(nc),
                "count_paths": g.count_paths(),
                "paths": g.enumerate_paths(),
                "is_chain": g.is_chain,
                "compiled": plain(g.compiled)}
        return out
    both(run)


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_param_counts_bit_equal(arch):
    counts = both(lambda pk: [pk.configs.param_count(c)
                              for c in (pk.configs.get_config(arch),
                                        pk.configs.get_config(
                                            arch, reduced=True))]
                  + [pk.configs.active_param_count(
                      pk.configs.get_config(arch))])
    assert counts[0] >= counts[2] > 0


def test_whisper_medium_stage_builds_pickles_and_serves():
    """The suite's text-to-text second stage on the CPU (reduced): its
    pickled replica (the process workers' rebuild) gives the same ids."""
    import pickle
    import torch
    from repro_torch.serving import ModelStageServer
    stage = ModelStageServer("text-translation", "whisper-medium",
                             seq_len=16, reduced=True, device="cpu")
    replica = pickle.loads(pickle.dumps(stage))
    assert dataclasses.asdict(replica.cfg) == dataclasses.asdict(stage.cfg)
    assert len(replica.model.enc_layers) == stage.cfg.num_encoder_layers
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, stage.cfg.vocab_size, (3, 16)).astype(np.int32))
    ids = stage.process(toks)
    assert ids.dtype == torch.int32 and ids.shape == (3,)
    assert torch.equal(replica.process(toks), ids)


# ---- ML models and predictors -----------------------------------------------

def _toy(seed=0, n=300):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 2))
    y = np.sin(x[:, 0] * 8) * np.cos(x[:, 1] * 5) + rng.normal(0, 0.05, n)
    return x, y


@pytest.mark.parametrize("kind", ["lr", "dt", "rf"])
def test_ml_model_predictions_bit_equal(kind):
    def run(pk):
        x, y = _toy()
        m = {"lr": lambda: pk.ml.LinearRegression(),
             "dt": lambda: pk.ml.DecisionTreeRegressor(max_depth=8, seed=3),
             "rf": lambda: pk.ml.RandomForestRegressor(n_trees=7,
                                                       max_depth=6, seed=3)
             }[kind]().fit(x, y)
        xq = np.random.default_rng(1).uniform(-0.2, 1.2, size=(200, 2))
        pred = m.predict(xq)
        return [pred, pk.ml.mean_absolute_percentage_error(y, m.predict(x))]
    both(run)


@pytest.mark.parametrize("dev", DEVICES)
def test_collect_samples_bit_equal(dev):
    out = both(lambda pk: pk.pred.collect_samples(
        pk.wl.artifact_stage("c", 2), device(pk, dev), seed=7))
    assert len(out) == 8 * 20 * 3


@pytest.mark.parametrize("kind", ["lr", "dt", "rf"])
@pytest.mark.parametrize("tabulated", [False, True])
def test_stage_predictor_tables_bit_equal(kind, tabulated):
    def run(pk):
        prof = pk.wl.artifact_stage("m", 2)
        samples = pk.pred.collect_samples(prof, pk.types.RTX_2080TI,
                                          batches=(1, 2, 4, 8, 16), seed=7)
        cls = pk.pred.TabulatedStagePredictor if tabulated \
            else pk.pred.StagePredictor
        sp = cls("s", kind, seed=7).fit(samples, profile=prof)
        grid = pk.types.QUOTA_GRID
        out = {"errors": sp.fit_errors,
               "rows": [sp.quota_row(k, b, grid)
                        for k in ("duration", "bandwidth", "throughput")
                        for b in (1, 4, 5, 16)],
               "off_grid": [sp.duration(7, 0.17), sp.throughput(8, 0.33)],
               "linear": [sp.flops(b) for b in (4, 32)]
               + [sp.footprint(b) for b in (4, 32)]}
        if tabulated:
            out["tables"] = sp._tables
            out["grid_batches"] = sp.grid_batches
        return out
    both(run)


def test_pipeline_predictor_from_graph_bit_equal():
    def run(pk):
        g = pk.wl.dag_suite()["diamond"]
        pp = pk.pred.PipelinePredictor.from_graph(
            g, pk.types.RTX_2080TI, batches=(1, 4, 8, 16), seed=2)
        return [[s._tables, s.fit_errors] for s in pp.stages]
    both(run)


@pytest.mark.parametrize("dev", DEVICES)
def test_profile_from_engine_bit_equal(dev):
    timings = [(1, 0.0482), (2, 0.0517), (4, 0.0589), (8, 0.0771)]
    out = both(lambda pk: pk.pred.profile_from_engine(
        "stage0", timings, weights_bytes=1.19e9, act_bytes_per_query=2e7,
        device=device(pk, dev), host_bytes_per_query=2e6))
    assert out["overhead"] > 0 and out["flops_per_query"] > 0


def test_tabulate_physics_bit_equal():
    both(lambda pk: pk.pred.tabulate_physics(
        pk.wl.artifact_stage("p", 3), pk.types.V100, 16,
        [0.05, 0.25, 0.25, 0.7]))


# ---- faults -----------------------------------------------------------------

def _fault_dict():
    return {"device_failures": [{"time": 1.5, "device": 1}],
            "straggles": [{"time": 0.5, "device": 0, "factor": 2.5,
                           "until": 2.0},
                          {"time": 1.0, "device": 1, "factor": 4.0,
                           "until": None}],
            "transient": {"rate": 0.05, "start": 0.2, "until": None},
            "seed": 3, "max_retries": 1}


@pytest.mark.parametrize("d", [_fault_dict(), {}, {"transient": {
    "rate": 0.0}}], ids=["full", "empty", "zero-rate"])
def test_fault_spec_round_trips(d):
    def run(pk):
        spec = pk.faults.FaultSpec.from_dict(d)
        back = pk.faults.FaultSpec.from_dict(spec.to_dict())
        assert back == spec
        return [spec.to_dict(), spec.active()]
    out = both(run)
    # a dict written by one package loads in the other unchanged
    ref = ref_faults.FaultSpec.from_dict(d).to_dict()
    assert port_faults.FaultSpec.from_dict(ref).to_dict() == ref
    assert out[0] == ref


# ---- the simulator ----------------------------------------------------------

def sim_data(r):
    return {"p99": r.p99, "mean": r.mean_latency, "completed": r.completed,
            "offered": r.offered_qps, "achieved": r.achieved_qps,
            "failed": r.failed, "retries": r.retries, "events": r.events,
            "aborted": r.aborted, "busy": r.device_busy,
            "latencies": list(r.qos.latencies)}


def _sim_cfg(pk, fast):
    return pk.simulator.SimConfig(duration=4.0, warmup=1.0, seed=0,
                                  fast=fast)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("suite,qps", [("camelot_suite", 20.0),
                                       ("camelot_suite", 150.0),
                                       ("dag_suite", 60.0)])
def test_pipeline_simulator_bit_equal(suite, qps, fast):
    def run(pk):
        out = {}
        for name, g in getattr(pk.wl, suite)().items():
            alloc, comm = pk.base.even_allocation(g, pk.types.RTX_2080TI,
                                                  2, batch=8)
            out[name] = sim_data(pk.simulator.PipelineSimulator(
                g, alloc, pk.types.RTX_2080TI, comm,
                _sim_cfg(pk, fast)).run(qps))
        return out
    out = both(run)
    assert all(r["completed"] > 0 for r in out.values())


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_pipeline_simulator_with_faults_bit_equal(fast):
    def run(pk):
        g = pk.wl.camelot_suite()["img-to-img"]
        alloc, comm = pk.base.even_allocation(g, pk.types.RTX_2080TI, 2,
                                              batch=8)
        sim = pk.simulator.PipelineSimulator(g, alloc, pk.types.RTX_2080TI,
                                             comm, _sim_cfg(pk, fast))
        return sim_data(sim.run(
            80.0, faults=pk.faults.FaultSpec.from_dict(_fault_dict())))
    out = both(run)
    assert out["failed"] + out["retries"] > 0


@pytest.mark.parametrize("name", ["chain+diamond", "two-chains",
                                  "3-tenant-mixed"])
def test_multitenant_simulator_bit_equal(name):
    def run(pk):
        tenants = pk.wl.multitenant_suite()[name]
        ts = pk.types.TenantSet(tenants)
        devices = {"chain+diamond": 3, "two-chains": 3,
                   "3-tenant-mixed": 4}[name]
        allocs = [pk.base.even_allocation(t.graph, pk.types.RTX_2080TI,
                                          devices, batch=8)[0]
                  for t in tenants]
        comm = pk.CommModel(pk.types.RTX_2080TI)
        r = pk.simulator.MultiTenantSimulator(
            ts, allocs, pk.types.RTX_2080TI, comm,
            sim=_sim_cfg(pk, True)).run([80.0 * w for w in ts.weights])
        return {"per_tenant": [sim_data(t) for t in r.per_tenant],
                "busy": r.device_busy, "events": r.events,
                "heartbeats": r.heartbeats, "aborted": r.aborted}
    both(run)


def test_find_peak_load_bit_equal():
    def run(pk):
        g = pk.wl.camelot_suite()["img-to-img"]
        alloc, comm = pk.base.even_allocation(g, pk.types.RTX_2080TI, 2,
                                              batch=16)
        cfg = pk.simulator.SimConfig(duration=8.0, warmup=1.0, seed=0)

        def mk():
            return pk.simulator.PipelineSimulator(
                g, alloc, pk.types.RTX_2080TI, comm, cfg)
        peak, res = pk.sim.find_peak_load(mk, g.qos_target)
        return [peak, sim_data(res)]
    peak = both(run)[0]
    assert 1.0 < peak < 4096.0


def test_bracketed_peak_search_bit_equal():
    def run(pk):
        probes = []

        def probe(x):
            probes.append(x)
            return x

        peak, _ = pk.simulator.bracketed_peak_search(
            probe, lambda x: x <= 123.4, seed_load=300.0)
        return [peak, probes]
    peak, probes = both(run)
    assert peak <= 123.4 and len(probes) > 3


def test_simulated_latency_follows_the_critical_path():
    """The simulator's low-load mean latency on a diamond is the port's
    predicted critical path (tests/test_graph.py's contract), and the
    reference's number."""
    def run(pk):
        g = pk.wl.dag_suite()["diamond"]
        d = pk.types.RTX_2080TI
        per_stage = [[(0, 0.25)] for _ in range(g.n_nodes)]
        a = pk.types.Allocation(
            stages=[pk.types.StageAlloc(1, 0.25, 1)
                    for _ in range(g.n_nodes)],
            placement=pk.types.Placement(per_stage=per_stage))
        comm = pk.CommModel(d)
        r = pk.simulator.PipelineSimulator(
            g, a, d, comm, pk.simulator.SimConfig(
                duration=8.0, warmup=1.0, seed=0,
                contention_noise=0.0)).run(3.0)
        cp = g.critical_path(
            lambda i: g.nodes[i].duration(1, 0.25, d),
            lambda e: comm.transfer_time(g.edge_nbytes(e.src, e.dst, 1),
                                         same_device=True))
        return [r.mean_latency, cp]
    mean, cp = both(run)
    assert math.isclose(mean, cp, rel_tol=0.15)
