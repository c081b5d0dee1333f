"""The port's live serving engine on the CPU: the contracts of
tests/test_serving.py, and parity with the reference's engine — on the
chain, on a diamond DAG, and on an allocation that both packages' solvers
chose from the same stage timings (the slice's profile -> fit -> solve ->
serve path, and ``repro_torch.launch.serve`` end to end) — and the
engine's knobs (live allocation swaps, retries with driver-side backoff,
deadlines) against the reference's engine on stub stages: the contracts
of tests/test_exec.py and tests/test_fault.py."""
import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.runtime as ref_runtime
import repro.core.types as ref_types
import repro.serving as ref_serving
from repro.core.types import Allocation as RefAllocation
from repro.core.types import Placement as RefPlacement
from repro.core.types import ServiceEdge as RefServiceEdge
from repro.core.types import ServiceGraph as RefServiceGraph
from repro.core.types import StageAlloc as RefStageAlloc
from repro.serving import ModelStageServer as RefStageServer
from repro.serving import PipelineEngine as RefPipelineEngine
from repro.serving import make_trace as ref_make_trace
import repro_torch.core as port_core
import repro_torch.core.runtime as port_runtime
import repro_torch.core.types as port_types
import repro_torch.serving as port_serving
import repro_torch.sim as port_sim
from repro_torch.core import HOST_STAGED, EdgeChannel
from repro_torch.core.types import (H100, Allocation, Placement,
                                    ServiceEdge, ServiceGraph, StageAlloc)
from repro_torch.launch.serve import serve as launch_serve
from repro_torch.serving import (ModelStageServer, MultiTenantEngine,
                                 PipelineEngine, make_trace)

ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b")


@pytest.fixture(scope="module")
def stages():
    return [ModelStageServer("s0", ARCHS[0], seq_len=16, reduced=True,
                             device="cpu"),
            ModelStageServer("s1", ARCHS[1], seq_len=16, reduced=True,
                             device="cpu")]


def _fresh_trace(stages, n=10, qps=50):
    return make_trace(n, qps=qps, seq_len=16,
                      vocab=stages[0].cfg.vocab_size, seed=1)


def _two_instance_alloc(mod_alloc=Allocation, mod_stage=StageAlloc,
                        mod_place=Placement):
    return mod_alloc(
        stages=[mod_stage(2, 0.25, 4), mod_stage(1, 0.5, 4)],
        placement=mod_place(per_stage=[[(0, 0.25), (0, 0.25)], [(0, 0.5)]]))


def test_engine_completes_all_queries(stages):
    eng = PipelineEngine(stages, comm_mechanism="device", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    s = eng.run_trace(_fresh_trace(stages)).summary()
    assert s["completed"] == 10
    assert s["failed"] == 0
    assert s["p99"] > 0


def test_host_mechanism_moves_bytes(stages):
    eng = PipelineEngine(stages, comm_mechanism="host", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    stats = eng.run_trace(_fresh_trace(stages))
    assert stats.comm_time > 0
    assert eng.channels[0].bytes_moved > 0


def test_device_mechanism_zero_copy(stages):
    eng = PipelineEngine(stages, comm_mechanism="device", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    eng.run_trace(_fresh_trace(stages))
    assert eng.channels[0].transfers > 0
    assert eng.channels[0].bytes_moved == 0
    out = torch.arange(4, dtype=torch.int32)
    assert EdgeChannel(force="device").send(out) is out   # by reference
    staged = EdgeChannel(force="host").send(out)
    assert staged is not out and torch.equal(staged, out)


def test_edge_payload_is_int32_ids(stages):
    """The stage output is (B,) int32, as the reference's, so each edge is
    sized and routed alike."""
    out = stages[0].process(torch.zeros(4, 16, dtype=torch.int32))
    assert out.dtype == torch.int32 and out.shape == (4,)


def test_engine_consumes_allocation_with_placement(stages):
    eng = PipelineEngine(stages, allocation=_two_instance_alloc(),
                         comm_mechanism="auto", qos_target=2.0,
                         batch_timeout=0.02)
    stats = eng.run_trace(_fresh_trace(stages))
    assert stats.summary()["completed"] == 10
    # the (B,) int32 payload sits below the Fig. 11 crossover: host-staged
    assert eng.channels[0].picks[HOST_STAGED] > 0


def _fp32_pair(arch, seed=0):
    """The reference's stage server with its parameters cast to fp32, and
    the port's server holding the same parameters."""
    ref = RefStageServer(f"ref-{arch}", arch, seq_len=16, seed=seed)
    ref.params = jax.tree.map(lambda x: x.astype(jnp.float32), ref.params)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), ref.params)
    port = ModelStageServer(f"port-{arch}", arch, seq_len=16, seed=seed,
                            reduced=True, device="cpu", dtype=torch.float32,
                            params=tree)
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_output_ids_match_reference(arch):
    ref, port = _fp32_pair(arch)
    toks = np.random.default_rng(0).integers(
        0, ref.cfg.vocab_size, (4, 16)).astype(np.int32)
    ids_ref = np.asarray(ref.process(jnp.asarray(toks)))
    ids = port.process(torch.from_numpy(toks))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), ids_ref)


@pytest.mark.parametrize("mech", ["auto", "device"])
def test_engine_matches_reference_engine(mech):
    """The same trace through both engines: equal completions and equal
    per-edge mechanism picks (queries arrive at once and batches fill, so
    batching is deterministic)."""
    (r0, p0), (r1, p1) = _fp32_pair(ARCHS[0]), _fp32_pair(ARCHS[1], seed=1)
    kw = dict(comm_mechanism=mech, qos_target=2.0, batch_timeout=0.5)
    ref_eng = RefPipelineEngine(
        [r0, r1], allocation=_two_instance_alloc(
            RefAllocation, RefStageAlloc, RefPlacement), **kw)
    eng = PipelineEngine([p0, p1], allocation=_two_instance_alloc(), **kw)
    args = dict(n=12, qps=1e6, seq_len=16, vocab=r0.cfg.vocab_size, seed=3)
    s_ref = ref_eng.run_trace(ref_make_trace(**args)).summary()
    s = eng.run_trace(make_trace(**args)).summary()
    assert s["completed"] == s_ref["completed"] == 12
    assert eng.channels[0].picks == ref_eng.channels[0].picks


class _RaisingStage:
    """Wraps a stage server; its ``process`` always raises."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.seq_len, self.cfg = inner.name, inner.seq_len, \
            inner.cfg
        self.device = getattr(inner, "device", None)

    def warmup(self, batch):
        pass

    def process(self, tokens):
        raise RuntimeError("stage down")


@pytest.mark.parametrize("bad", [0, 1])
def test_raising_stage_fails_its_queries_like_reference(bad):
    """A stage that raises loses its batches: every query is counted
    failed, none completes and the trace still ends, in both engines."""
    (r0, p0), (r1, p1) = _fp32_pair(ARCHS[0]), _fp32_pair(ARCHS[1], seed=1)
    ref_stages, stages = [r0, r1], [p0, p1]
    ref_stages[bad] = _RaisingStage(ref_stages[bad])
    stages[bad] = _RaisingStage(stages[bad])
    kw = dict(comm_mechanism="auto", qos_target=2.0, batch_size=4,
              batch_timeout=0.02)
    args = dict(n=8, qps=1e6, seq_len=16, vocab=r0.cfg.vocab_size, seed=5)
    s_ref = RefPipelineEngine(ref_stages, **kw).run_trace(
        ref_make_trace(**args)).summary()
    s = PipelineEngine(stages, **kw).run_trace(make_trace(**args)).summary()
    assert s["failed"] == s_ref["failed"] == 8
    assert s["completed"] == s_ref["completed"] == 0


def test_stage_server_pickles_to_an_equal_replica(stages):
    import pickle
    replica = pickle.loads(pickle.dumps(stages[0]))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, stages[0].cfg.vocab_size, (2, 16)).astype(np.int32))
    assert torch.equal(replica.process(toks), stages[0].process(toks))
    assert dataclasses.asdict(replica.cfg) == dataclasses.asdict(
        stages[0].cfg)


# ---- the slice end to end: profile -> fit -> solve -> serve ----------------

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

    def row_map(self) -> dict:
        """Input row (as bytes) -> output id, over every call; a row seen
        twice must have given the same id."""
        m = {}
        for toks, ids in self.calls:
            for row, i in zip(toks, ids):
                assert m.setdefault(row.tobytes(), int(i)) == int(i)
        return m


# measured (batch, seconds) of one stage call, as profile_stage_timings
# returns them: the same numbers go to both packages
TIMINGS = ([(1, 0.0101), (2, 0.0123), (4, 0.0170), (8, 0.0262)],
           [(1, 0.0080), (2, 0.0091), (4, 0.0118), (8, 0.0177)])


def _solve(core, device):
    profiles = [core.profile_from_engine(
        f"stage{i}", t, weights_bytes=1e9, act_bytes_per_query=2e7,
        device=device, host_bytes_per_query=2e6)
        for i, t in enumerate(TIMINGS)]
    pipeline = core.Pipeline("serve", profiles, qos_target=1.0)
    pred = core.PipelinePredictor.from_profiles(profiles, device)
    return core.CamelotAllocator(pipeline, pred, device, 1,
                                 sa=core.SAConfig(iterations=300, seed=0)
                                 ).solve_max_load(4)


def _per_query(trace, stages):
    """Each query's final output id, followed through the recorded calls
    of a chain (a stage's input row is its predecessor's id, tiled)."""
    maps = [st.row_map() for st in stages]
    out = []
    for q in trace:
        row = q.tokens
        for st, m in zip(stages, maps):
            i = m[np.ascontiguousarray(row, np.int32).tobytes()]
            row = np.full(st.seq_len, i, np.int32)
        out.append(i)
    return out


def test_solved_allocation_serves_like_reference():
    """Both packages solve the same timings to the same allocation; served
    on both engines with shared fp32 parameters, every query gives the
    same output ids."""
    ref_res = _solve(ref_core, ref_core.DeviceSpec(
        **dataclasses.asdict(H100)))
    res = _solve(port_core, H100)
    assert res.feasible and res.objective == ref_res.objective
    shape = [(s.n_instances, s.quota, s.batch) for s in res.allocation.stages]
    assert shape == [(s.n_instances, s.quota, s.batch)
                     for s in ref_res.allocation.stages]
    assert res.allocation.placement.per_stage == \
        ref_res.allocation.placement.per_stage
    assert {d for placed in res.allocation.placement.per_stage
            for d, _ in placed} == {0}

    (r0, p0), (r1, p1) = _fp32_pair(ARCHS[0]), _fp32_pair(ARCHS[1], seed=1)
    ref_stages = [_Recording(r0), _Recording(r1)]
    stages = [_Recording(p0), _Recording(p1)]
    kw = dict(comm_mechanism="auto", qos_target=2.0, batch_timeout=0.5)
    args = dict(n=12, qps=1e6, seq_len=16, vocab=r0.cfg.vocab_size, seed=3)
    ref_trace, trace = ref_make_trace(**args), make_trace(**args)
    s_ref = RefPipelineEngine(ref_stages, allocation=ref_res.allocation,
                              **kw).run_trace(ref_trace).summary()
    s = PipelineEngine(stages, allocation=res.allocation,
                       **kw).run_trace(trace).summary()
    assert s["completed"] == s_ref["completed"] == 12
    assert s["failed"] == s_ref["failed"] == 0
    assert _per_query(trace, stages) == _per_query(ref_trace, ref_stages)


def _diamond_graph(mod_graph, mod_edge):
    return mod_graph("diamond", [None] * 4,
                     [mod_edge(0, 1), mod_edge(0, 2), mod_edge(1, 3),
                      mod_edge(2, 3)], qos_target=5.0)


def _diamond_alloc(mod_alloc, mod_stage, mod_place):
    return mod_alloc(stages=[mod_stage(1, 0.25, 4) for _ in range(4)],
                     placement=mod_place(
                         per_stage=[[(0, 0.25)] for _ in range(4)]))


def test_diamond_matches_reference_call_for_call():
    """A diamond of four reduced stages (fan-out from the first, fan-in at
    the last) with shared fp32 parameters: every stage sees the same
    inputs and gives the same outputs in both engines."""
    pairs = [_fp32_pair(a, seed=i)
             for i, a in enumerate(ARCHS + ARCHS)]
    ref_stages = [_Recording(r) for r, _ in pairs]
    stages = [_Recording(p) for _, p in pairs]
    kw = dict(comm_mechanism="auto", qos_target=5.0, batch_timeout=0.5)
    args = dict(n=8, qps=1e6, seq_len=16, vocab=pairs[0][0].cfg.vocab_size,
                seed=4)
    s_ref = RefPipelineEngine(
        ref_stages, graph=_diamond_graph(RefServiceGraph, RefServiceEdge),
        allocation=_diamond_alloc(RefAllocation, RefStageAlloc,
                                  RefPlacement), **kw).run_trace(
        ref_make_trace(**args)).summary()
    s = PipelineEngine(
        stages, graph=_diamond_graph(ServiceGraph, ServiceEdge),
        allocation=_diamond_alloc(Allocation, StageAlloc, Placement),
        **kw).run_trace(make_trace(**args)).summary()
    assert s["completed"] == s_ref["completed"] == 8
    for st, ref_st in zip(stages, ref_stages):
        assert len(st.calls) == len(ref_st.calls) == 2
        key = lambda c: c[0].tobytes()           # noqa: E731
        for (x, y), (rx, ry) in zip(sorted(st.calls, key=key),
                                    sorted(ref_st.calls, key=key)):
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)


def test_launch_serve_profiles_solves_and_serves(capsys):
    """The launcher's flow on reduced CPU stages: live profiles, a
    feasible solve, every query served.  The QoS target is the CPU's: a
    reduced stage call on a busy CPU can take longer than the card's
    whole 1.0 s budget, which Constraint-5 would then refuse."""
    out = launch_serve(list(ARCHS), queries=8, qps=50.0, qos=30.0,
                       reduced=True, device="cpu")
    res, served = out["solve"], out["served"]
    assert res.feasible and res.objective > 0
    assert served["completed"] == 8 and served["failed"] == 0
    text = capsys.readouterr().out
    assert "camelot allocation" in text and "served 8 queries" in text


# ---- the engine's knobs against the reference's, on stub stages ------------

KNOBS = {
    "ref": types.SimpleNamespace(core=ref_core, types=ref_types,
                                 rt=ref_runtime, serving=ref_serving),
    "port": types.SimpleNamespace(core=port_core, types=port_types,
                                  rt=port_runtime, serving=port_serving),
}


class SleepStage:
    """Deterministic stage that releases the interpreter lock: isolates the
    engine's scheduling from model compute.  Emits zero ids, as a torch
    tensor on the port's engine and a numpy array on the reference's."""

    def __init__(self, service_time=0.02, seq_len=8, vocab=16):
        self.service_time = service_time
        self.seq_len = seq_len
        self.cfg = types.SimpleNamespace(vocab_size=vocab)
        self.device = torch.device("cpu")
        self.calls = 0

    def warmup(self, batch):
        pass

    def process(self, tokens):
        time.sleep(self.service_time)
        self.calls += 1
        if isinstance(tokens, torch.Tensor):
            return torch.zeros(tokens.shape[0], dtype=torch.int32)
        return np.zeros((tokens.shape[0],), np.int32)


class FailingStage(SleepStage):
    """Raises on the first ``fail_first`` process calls, then succeeds."""

    def __init__(self, fail_first=10 ** 9, **kw):
        super().__init__(**kw)
        self.fail_first = fail_first
        self.tries = 0

    def process(self, tokens):
        self.tries += 1
        if self.tries <= self.fail_first:
            raise RuntimeError("injected stage fault")
        return super().process(tokens)


def _burst(pk, n):
    return [pk.serving.Query(qid=i, arrival=0.0,
                             tokens=np.zeros(8, np.int32))
            for i in range(n)]


def _n_alloc(pk, n, batch):
    return pk.types.Allocation(
        stages=[pk.types.StageAlloc(n, 1.0 / n, batch)],
        placement=pk.types.Placement(per_stage=[[(0, 1.0 / n)] * n]))


def _watchdog(fn, timeout=20.0):
    """Run a trace on a side thread, so an engine that deadlocks fails the
    test instead of hanging it."""
    box = {}
    th = threading.Thread(target=lambda: box.update(out=fn()), daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "engine deadlocked"
    return box["out"]


def _counts(stats):
    s = stats.summary()
    return {k: s[k] for k in ("completed", "failed", "retries")}


def both_engines(fn):
    """``fn(pk)`` on the reference's engine and on the port's; asserts
    equal counts and returns the port's result."""
    ref, port = fn(KNOBS["ref"]), fn(KNOBS["port"])
    assert port == ref
    return port


def test_live_reallocation_swap_mid_trace():
    """An allocation applied from another thread swaps between batches of
    a running trace, and the trace still completes."""
    def run(pk):
        eng = pk.serving.PipelineEngine(
            [SleepStage(service_time=0.04)],
            allocation=pk.core.default_allocation(1, batch=2),
            qos_target=5.0, batch_timeout=0.005)
        timer = threading.Timer(
            0.06, lambda: eng.apply_allocation(_n_alloc(pk, 2, 2)))
        timer.start()
        stats = _watchdog(lambda: eng.run_trace(_burst(pk, 12)))
        timer.join()
        return (_counts(stats), eng.swaps,
                len(eng.alloc.placement.per_stage[0]), eng.batch_size)
    assert both_engines(run) == ({"completed": 12, "failed": 0,
                                  "retries": 0}, 1, 2, 2)


def test_swap_between_traces_and_one_tenant_delegation():
    def run(pk):
        eng = pk.serving.PipelineEngine(
            [SleepStage()], allocation=pk.core.default_allocation(1, 2),
            qos_target=2.0, batch_timeout=0.005)
        assert isinstance(eng._inner, pk.serving.MultiTenantEngine)
        assert eng.alloc is eng._inner.tenants[0].alloc
        assert eng.channels is eng._inner.tenants[0].channels
        first = eng.run_trace(_burst(pk, 6))
        eng.apply_allocation(_n_alloc(pk, 2, 4))
        second = eng.run_trace(_burst(pk, 4))
        return (_counts(first), first.batches, _counts(second),
                second.batches, eng.swaps, eng.batch_size,
                eng.backend, eng.worker_restarts)
    assert both_engines(run)[1:] == (3, {"completed": 4, "failed": 0,
                                         "retries": 0}, 1, 1, 4, "threads",
                                     0)


def test_multi_tenant_swap_and_its_refusals():
    """``apply_allocations`` swaps every tenant between batches; the port
    refuses an unplaced allocation or a wrong count with ValueError."""
    def run(pk):
        g = pk.types.ServiceGraph.chain("t", [None])
        eng = pk.serving.MultiTenantEngine(
            [[SleepStage()], [SleepStage()]], [g, g],
            [pk.core.default_allocation(1, 2)] * 2, batch_timeout=0.005)
        eng.apply_allocations([_n_alloc(pk, 2, 2), _n_alloc(pk, 3, 1)])
        stats = eng.run_traces([_burst(pk, 4), _burst(pk, 3)])
        return ([_counts(s) for s in stats], eng.swaps,
                [len(t.alloc.placement.per_stage[0]) for t in eng.tenants],
                [s.batches for s in stats])
    assert both_engines(run)[1:] == (1, [2, 3], [2, 3])
    g = port_types.ServiceGraph.chain("t", [None])
    eng = MultiTenantEngine([[SleepStage()]], [g],
                            [port_core.default_allocation(1, 2)])
    with pytest.raises(ValueError, match="1 tenants"):
        eng.apply_allocations([_n_alloc(KNOBS["port"], 2, 2)] * 2)
    with pytest.raises(ValueError, match="placed"):
        eng.apply_allocations([Allocation(stages=[StageAlloc(1, 1.0, 2)])])
    assert eng.swaps == 0 and eng._pending_allocs is None


def test_runtime_pushes_allocation_into_attached_engine():
    """A CamelotRuntime's reallocation reaches the attached engine: the
    reference's stub contract, then a live re-solve mid-trace on stub
    stages of the img-to-img chain (the ``session`` phase of
    chip_smoke.py, here on the CPU)."""
    class _FakeEngine:
        def __init__(self):
            self.applied = []

        def apply_allocation(self, alloc):
            self.applied.append(alloc)

    rt = port_runtime.CamelotRuntime.__new__(port_runtime.CamelotRuntime)
    rt.rt = port_runtime.RuntimeConfig()
    rt.peak_qps = 100.0
    rt.peak_result = types.SimpleNamespace(
        allocation=Allocation(stages=[StageAlloc(1, 1.0, 4)],
                              placement=Placement(per_stage=[[(0, 1.0)]])),
        feasible=True, objective=100.0, warm_started=False)
    rt._load_est = 95.0
    rt.current = rt.peak_result.allocation
    rt.history = []
    rt._engine = _FakeEngine()
    alloc = rt.reallocate(now=0.0)
    assert rt._engine.applied == [alloc]

    pipe = port_sim.camelot_suite()["img-to-img"]
    pred = port_core.PipelinePredictor.from_profiles(pipe.stages,
                                                     port_core.RTX_2080TI)
    live = port_runtime.CamelotRuntime(
        pipe, pred, port_core.RTX_2080TI, 1, 4,
        sa=port_core.SAConfig(iterations=300, seed=0))
    peak = live.current
    eng = PipelineEngine([SleepStage(0.01), SleepStage(0.01)],
                         allocation=peak, qos_target=5.0,
                         batch_timeout=0.005)
    live.attach_engine(eng)

    def resolve():
        live.observe(20.0)
        live.reallocate(now=0.1)

    timer = threading.Timer(0.05, resolve)
    timer.start()
    # the trace outlasts the re-solve (tens of ms here) several times over
    trace = [port_serving.Query(qid=i, arrival=0.02 * i,
                                tokens=np.zeros(8, np.int32))
             for i in range(40)]
    stats = _watchdog(lambda: eng.run_trace(trace))
    timer.join()
    assert stats.summary()["completed"] == 40
    assert eng.swaps == 1 and eng.alloc is live.current
    assert live.current.total_quota() < peak.total_quota()
    assert live.history[-1].provisioned_for == 20.0 * 0.3 * 1.25


def test_worker_exception_drains_not_deadlocks():
    def run(pk):
        eng = pk.serving.PipelineEngine(
            [FailingStage()], allocation=pk.core.default_allocation(1, 2),
            qos_target=2.0, batch_timeout=0.005)
        return _counts(_watchdog(lambda: eng.run_trace(_burst(pk, 4))))
    assert both_engines(run) == {"completed": 0, "failed": 4, "retries": 0}


def test_worker_retry_recovers():
    def run(pk):
        stage = FailingStage(fail_first=2)
        eng = pk.serving.PipelineEngine(
            [stage], allocation=pk.core.default_allocation(1, 4),
            qos_target=5.0, batch_timeout=0.005, max_retries=2,
            retry_backoff=0.0)
        return _counts(_watchdog(lambda: eng.run_trace(_burst(pk, 4)))), \
            stage.tries, stage.calls
    assert both_engines(run) == ({"completed": 4, "failed": 0,
                                  "retries": 2}, 3, 1)


def test_retry_budget_spent_fails_the_batch():
    def run(pk):
        eng = pk.serving.PipelineEngine(
            [FailingStage(fail_first=3)],
            allocation=pk.core.default_allocation(1, 4), qos_target=5.0,
            batch_timeout=0.005, max_retries=2, retry_backoff=0.0)
        return _counts(_watchdog(lambda: eng.run_trace(_burst(pk, 4))))
    assert both_engines(run) == {"completed": 0, "failed": 4, "retries": 2}


def test_retry_backoff_does_not_idle_the_instance():
    """The failed batch waits out its backoff in the driver's retry queue,
    not in a worker slot: the three healthy single-query batches complete
    on the free instance during the backoff."""
    def run(pk):
        stage = FailingStage(fail_first=1, service_time=0.005)
        eng = pk.serving.PipelineEngine(
            [stage], allocation=pk.core.default_allocation(1, batch=1),
            qos_target=5.0, batch_timeout=0.0, max_retries=1,
            retry_backoff=0.3)
        stats = _watchdog(lambda: eng.run_trace(_burst(pk, 4)))
        lat = sorted(stats.qos.latencies)
        assert all(t < 0.25 for t in lat[:3]), lat
        assert lat[3] >= 0.3, lat
        return _counts(stats)
    assert both_engines(run) == {"completed": 4, "failed": 0, "retries": 1}


def test_deadline_abandons_stale_queries():
    def run(pk):
        stage = SleepStage()
        eng = pk.serving.PipelineEngine(
            [stage], allocation=pk.core.default_allocation(1, batch=4),
            qos_target=5.0, batch_timeout=0.5, deadline=0.05)
        # 2 queries never fill the 4-batch; the 0.5 s batch timeout sits
        # past the 50 ms deadline, so both are abandoned before dispatch
        return _counts(_watchdog(lambda: eng.run_trace(_burst(pk, 2)))), \
            stage.calls
    assert both_engines(run) == ({"completed": 0, "failed": 2,
                                  "retries": 0}, 0)
