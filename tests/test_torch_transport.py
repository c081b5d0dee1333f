"""The port's process serving plane on the CPU: the transport contracts of
tests/test_transport.py run on both packages through ``both(fn)`` and
compare equal (the host arena is a copy of the reference's, so its slot
decisions and payloads are bit-equal); then the port's own processes
backend — threads ≡ processes on a chain, a diamond and two tenants
(completions and per-edge picks, also against the reference's processes
backend on the same trace), the forced mechanisms, the unpicklable-stage
error, crash / restart / replay, the ``ServeSpec`` knobs, the reduced fp32
qwen chain in workers, and the workers' exit reports — and the device
arena's slot ring on a CPU buffer (on the card it is shared by CUDA IPC:
tests/test_torch_cuda.py).  Every pool here is small and starts within
seconds; a worker that dies during startup fails its test at once."""
import dataclasses
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.camelot as ref_camelot
import repro.core.types as ref_types
import repro.serving as ref_serving
import repro.serving.transport as ref_transport
import repro_torch.camelot as port_camelot
import repro_torch.core.types as port_types
import repro_torch.serving as port_serving
import repro_torch.serving.transport as port_transport
import repro_torch.serving.workers as port_workers
from repro.core.comm import CommModel as RefCommModel
from repro_torch.core.comm import GLOBAL_MEMORY, HOST_STAGED
from repro_torch.core.comm import CommModel as PortCommModel
from repro_torch.serving.engine import _fanin_combine
from repro_torch.serving.transport import (QUEUE, SHM, DeviceArena,
                                           ShmArena)

PKGS = {
    "ref": types.SimpleNamespace(tr=ref_transport, serving=ref_serving,
                                 types=ref_types, cm=ref_camelot,
                                 CommModel=RefCommModel),
    "port": types.SimpleNamespace(tr=port_transport, serving=port_serving,
                                  types=port_types, cm=port_camelot,
                                  CommModel=PortCommModel),
}


def plain(x):
    """Package-independent data (dataclasses as dicts, arrays and tuples as
    lists), so both packages' results compare with ==."""
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


def _ref_data(ref):
    """A ref without its arena's (random) segment name."""
    return (ref.slot, ref.dtype, ref.shape, ref.nbytes)


# --------------------------------------------------------------------------
# ShmArena slot ring (both packages)
# --------------------------------------------------------------------------

def test_arena_roundtrip_bit_identity():
    def run(pk):
        arena = pk.tr.ShmArena(slots=4, slot_bytes=1 << 16, create=True)
        out = []
        try:
            for dtype in (np.int32, np.float64, np.uint8, np.int64):
                arr = (np.arange(96, dtype=np.float64) * 3.7).astype(dtype)
                arr = arr.reshape(8, 12)
                ref = arena.try_put(arr)
                view = arena.get(ref)
                assert view.dtype == arr.dtype and view.shape == arr.shape
                np.testing.assert_array_equal(view, arr)
                out.append((_ref_data(ref), view.tobytes()))
                arena.free(ref)
        finally:
            arena.close()
            arena.unlink()
        return out
    assert len(both(run)) == 4


def test_arena_accepts_non_contiguous():
    def run(pk):
        arena = pk.tr.ShmArena(slots=2, slot_bytes=1 << 12, create=True)
        try:
            sliced = np.arange(64, dtype=np.int32).reshape(8, 8)[:, ::2]
            ref = arena.try_put(sliced)
            np.testing.assert_array_equal(arena.get(ref), sliced)
            out = (_ref_data(ref), arena.get(ref).tolist())
            arena.free(ref)
        finally:
            arena.close()
            arena.unlink()
        return out
    both(run)


def test_arena_wraparound_and_backpressure():
    def run(pk):
        arena = pk.tr.ShmArena(slots=3, slot_bytes=256, create=True)
        log = []
        try:
            refs = [arena.try_put(np.full((4,), i, np.int64))
                    for i in range(3)]
            log.append([r.slot for r in refs])
            log.append(arena.in_use())
            # full ring: backpressure, not blocking
            log.append(arena.try_put(np.zeros((4,), np.int64)) is None)
            # free one slot -> the NEXT put lands in it (cursor wraps)
            arena.free(refs[1])
            r = arena.try_put(np.full((4,), 9, np.int64))
            log.append((r.slot, arena.get(r).tolist(),
                        arena.get(refs[0]).tolist()))
            for i in range(20):
                arena.free(r)
                r = arena.try_put(np.full((4,), i, np.int64))
                log.append(r.slot)
        finally:
            arena.close()
            arena.unlink()
        return log
    log = both(run)
    assert log[:3] == [[0, 1, 2], 3, True] and log[3][0] == 1


def test_arena_rejects_oversized_payload():
    def run(pk):
        arena = pk.tr.ShmArena(slots=2, slot_bytes=64, create=True)
        try:
            return arena.try_put(np.zeros((100,), np.float64)) is None
        finally:
            arena.close()
            arena.unlink()
    assert both(run) is True


def test_arena_cross_attach_by_name():
    def run(pk):
        owner = pk.tr.ShmArena(slots=2, slot_bytes=512, create=True)
        try:
            arr = np.arange(10, dtype=np.float32)
            ref = owner.try_put(arr)
            amap = pk.tr.ArenaMap()
            amap.attach(owner.name, slots=2, slot_bytes=512)
            got = amap.get(ref).tolist()
            amap.free(ref)
            amap.close()
            return got, owner.in_use()
        finally:
            owner.close()
            owner.unlink()
    got, in_use = both(run)
    assert got == list(range(10)) and in_use == 0


# --------------------------------------------------------------------------
# Mechanism selection + measured crossover (both packages)
# --------------------------------------------------------------------------

def test_select_transport_matches_crossover_rule():
    def run(pk):
        cm = pk.CommModel(pk.types.RTX_2080TI)
        x = cm.crossover_bytes()
        st = pk.tr.select_transport
        return [st(cm, x / 2), st(cm, x * 2), st(cm, x * 2, shm_ok=False),
                st(cm, x / 2, force="device"), st(cm, x * 2, force="host"),
                st(None, x * 2)]
    assert both(run) == [QUEUE, SHM, QUEUE, SHM, QUEUE, QUEUE]


def test_measured_crossover_interpolates():
    def run(pk):
        mc = pk.tr.measured_crossover
        sizes = [100, 1000, 10_000]
        return [mc(sizes, [2.0, 1.0, 1.0], [1.0, 1.5, 10.0]),
                mc(sizes, [1, 1, 1], [2, 2, 2]),
                mc(sizes, [3, 3, 3], [1, 1, 1]),
                mc(sizes, [1.0, 3.0, 1.0], [2.0, 2.0, 2.0])]
    x, lo, never, late = both(run)
    assert 100 < x <= 1000 and lo == 100.0 and never > 10_000
    assert 1000 < late <= 10_000


def test_measure_transport_feeds_cluster_override():
    def run(pk):
        tr = pk.tr.measure_transport(sizes_bytes=[1 << 8, 1 << 14, 1 << 20],
                                     repeats=3)
        cluster = pk.cm.ClusterSpec(devices=1,
                                    crossover_bytes=tr["crossover_bytes"])
        d = pk.cm.ClusterSpec.from_dict(cluster.to_dict())
        return (tr["sizes"], len(tr["shm_s"]), len(tr["queue_s"]),
                cluster.comm_model().crossover_bytes()
                == tr["crossover_bytes"],
                d.crossover_bytes == cluster.crossover_bytes)
    assert both(run) == [[256, 16384, 1 << 20], 3, 3, True, True]


# --------------------------------------------------------------------------
# DeviceArena: the same slot ring, payloads in one torch buffer
# --------------------------------------------------------------------------

def test_device_arena_ring_decides_like_the_host_arena():
    """Puts, frees and refusals through a DeviceArena (on a CPU buffer
    here; on the card in tests/test_torch_cuda.py) take the same slots as
    the host arena's and give the payloads back bit for bit, bf16 and
    non-contiguous inputs included."""
    dev = DeviceArena(slots=3, slot_bytes=256, device="cpu")
    host = ShmArena(slots=3, slot_bytes=256, create=True)
    try:
        gen = torch.Generator().manual_seed(0)
        payloads = [torch.randn(4, 6, generator=gen).to(torch.bfloat16),
                    torch.arange(64, dtype=torch.int32).reshape(8, 8)[:, ::2],
                    torch.randn(3, generator=gen, dtype=torch.float64),
                    torch.zeros(0, dtype=torch.int32)]
        assert dev.try_put(torch.zeros(65, dtype=torch.float32)) is None
        refs_d, refs_h = [], []
        for t in payloads[:3]:
            refs_d.append(dev.try_put(t))
            refs_h.append(host.try_put(t.view(torch.int16).numpy()
                                       if t.dtype == torch.bfloat16
                                       else t.numpy()))
        for rd, rh, t in zip(refs_d, refs_h, payloads):
            assert (rd.slot, rd.nbytes, rd.shape) == \
                (rh.slot, rh.nbytes, rh.shape)
            got = dev.get(rd)
            assert got.dtype == t.dtype and got.shape == t.shape
            assert torch.equal(got, t)
        assert dev.try_put(payloads[3]) is None    # full: backpressure
        dev.free(refs_d[1])
        host.free(refs_h[1])
        r = dev.try_put(payloads[3])
        assert r.slot == host.try_put(payloads[3].numpy()).slot == 1
        assert dev.get(r).shape == (0,) and dev.in_use() == 3
        # another attachment by name sees the payload and frees the slot
        peer = DeviceArena(3, 256, name=dev.name, buffer=dev.buffer)
        assert torch.equal(peer.get(refs_d[0]), payloads[0])
        peer.free(refs_d[0])
        assert dev.in_use() == 2
        peer.close()
    finally:
        for a in (dev, host):
            a.close()
            a.unlink()
    with pytest.raises(ValueError, match="multiple"):
        DeviceArena(slots=2, slot_bytes=100, device="cpu")


def _map_and_reply(arena, ref, out_q):
    """A spawned process: map the driver's arena, read one slot, write a
    slot of its own and hand its ref back."""
    seen = arena.get(ref).clone()
    mine = arena.try_put(seen * 2)
    out_q.put((seen.numpy(), mine))


def test_device_arena_crosses_spawn_by_torch_multiprocessing():
    """The driver's arena reaches a spawned process through
    ``torch.multiprocessing``'s pickler (the buffer is shared, not
    copied): the child reads the driver's payload and writes a slot the
    driver then reads from its own buffer."""
    ctx = torch.multiprocessing.get_context("spawn")
    arena = DeviceArena(slots=2, slot_bytes=128, device="cpu")
    try:
        ref = arena.try_put(torch.arange(12, dtype=torch.int64))
        out_q = ctx.Queue()
        proc = ctx.Process(target=_map_and_reply, args=(arena, ref, out_q))
        proc.start()
        seen, mine = out_q.get(timeout=60)
        proc.join(timeout=30)
        assert not proc.is_alive() and proc.exitcode == 0
        np.testing.assert_array_equal(seen, np.arange(12))
        assert mine.slot == 1 and arena.in_use() == 2
        assert torch.equal(arena.get(mine), torch.arange(12) * 2)
    finally:
        arena.close()
        arena.unlink()


def test_measure_device_transport_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_transport.measure_device_transport([64], repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_workers.WorkerPool(b"", [4], 0.0, on_card=True)


def test_fanin_combine_mirrors_the_threads_backend():
    """The worker's combine gives the threads backend's result on a
    torch stage and the reference's numpy combine on a numpy stage."""
    stage = port_serving.CpuStageServer("c", seq_len=5, vocab=7)
    ins = {2: torch.tensor([3, 9], dtype=torch.int32),
           0: torch.tensor([1, 4], dtype=torch.int32)}
    got = port_workers._combine(stage, {p: v.numpy() for p, v in
                                        ins.items()})
    assert torch.equal(got, _fanin_combine([None, stage], 1, ins))

    class NumpyStage:
        seq_len, vocab_size = 5, 7
    ref = ref_serving.workers._combine_np(
        NumpyStage(), {p: v.numpy() for p, v in ins.items()})
    np.testing.assert_array_equal(
        port_workers._combine(NumpyStage(), ins), ref)


# --------------------------------------------------------------------------
# The processes backend (port): parity with threads and with the reference
# --------------------------------------------------------------------------

def _cpu_stages(pk, n, spin=80):
    return [pk.serving.CpuStageServer(f"s{i}", seq_len=8, vocab=64,
                                      spin=spin) for i in range(n)]


def _spread(pk, n_stages, batch, spread=True):
    """One instance per stage, stage i on device i (``spread``: one worker
    each) or all on device 0 (the threads backend's placement here: a
    co-located edge is routed by the crossover rule, as the workers route
    every edge, since they share one host)."""
    t = pk.types
    return t.Allocation(
        stages=[t.StageAlloc(n_instances=1, quota=1.0, batch=batch)
                for _ in range(n_stages)],
        placement=t.Placement(per_stage=[[(i if spread else 0, 1.0)]
                                         for i in range(n_stages)]))


def _diamond(pk):
    t = pk.types
    return t.ServiceGraph("diamond", [None] * 4,
                          [t.ServiceEdge(0, 1), t.ServiceEdge(0, 2),
                           t.ServiceEdge(1, 3), t.ServiceEdge(2, 3)],
                          qos_target=30.0)


def _serve(pk, backend, stages, n, seed, graph=None, **kw):
    """``n`` queries arriving at once (batches fill to 4, so batching is
    the same on every backend): the summary and each edge's picks."""
    trace = pk.serving.make_trace(n, qps=1e6, seq_len=8, vocab=64,
                                  seed=seed)
    with pk.serving.PipelineEngine(stages, batch_size=4, batch_timeout=0.5,
                                   qos_target=30.0, backend=backend,
                                   graph=graph, **kw) as eng:
        s = eng.run_trace(trace).summary()
        picks = [dict(eng.channels[i].picks)
                 for i in range(len(eng.graph.edges))]
    return s, picks


@pytest.mark.parametrize("topology", ["chain", "diamond"])
def test_threads_equal_processes_and_the_reference(topology):
    n, seed, nodes = (16, 3, 3) if topology == "chain" else (12, 4, 4)
    runs = {}
    for name, pk, backend in (("threads", PKGS["port"], "threads"),
                              ("processes", PKGS["port"], "processes"),
                              ("ref", PKGS["ref"], "processes")):
        graph = _diamond(pk) if topology == "diamond" else None
        kw = {} if backend == "threads" else \
            {"allocation": _spread(pk, nodes, 4)}
        runs[name] = _serve(pk, backend, _cpu_stages(pk, nodes), n, seed,
                            graph=graph, **kw)
    for s, _ in runs.values():
        assert (s["completed"], s["failed"]) == (n, 0)
    picks = runs["threads"][1]
    assert runs["processes"][1] == runs["ref"][1] == picks
    # the (B,) int32 ids sit below the crossover: host-staged
    assert all(p[HOST_STAGED] > 0 and p[GLOBAL_MEMORY] == 0 for p in picks)


def test_multi_tenant_processes_equal_threads():
    pk = PKGS["port"]
    t = pk.types
    graphs = [t.ServiceGraph.chain(f"t{i}", [None] * 2, qos_target=30.0)
              for i in range(2)]
    out = {}
    for backend in ("threads", "processes"):
        allocs = [_spread(pk, 2, 4, spread=backend == "processes")
                  for _ in range(2)]
        traces = [pk.serving.make_trace(8, qps=1e6, seq_len=8, vocab=64,
                                        seed=10 + i) for i in range(2)]
        with pk.serving.MultiTenantEngine(
                [_cpu_stages(pk, 2), _cpu_stages(pk, 2)], graphs, allocs,
                batch_timeout=0.5, backend=backend) as eng:
            stats = eng.run_traces(traces)
            out[backend] = ([s.summary()["completed"] for s in stats],
                            [dict(te.channels[0].picks)
                             for te in eng.tenants])
        if backend == "processes":
            assert sorted(eng.worker_reports) == [0, 1]
    assert out["threads"] == out["processes"]
    assert out["threads"][0] == [8, 8]


@pytest.mark.parametrize("mech,picked", [("device", GLOBAL_MEMORY),
                                         ("host", HOST_STAGED)])
def test_processes_respect_forced_mechanism(mech, picked):
    pk = PKGS["port"]
    s, (picks,) = _serve(pk, "processes", _cpu_stages(pk, 2), 8, 5,
                         comm_mechanism=mech, allocation=_spread(pk, 2, 4))
    assert (s["completed"], s["failed"]) == (8, 0)
    assert picks == {GLOBAL_MEMORY: 0, HOST_STAGED: 0, picked: 2}


def test_unpicklable_stage_raises_actionable_error():
    class Local:                        # locals never pickle
        device = torch.device("cpu")

        def warmup(self, b):
            pass

        def process(self, t):
            return t

    pk = PKGS["port"]
    trace = pk.serving.make_trace(4, qps=100.0, seq_len=8, vocab=64, seed=0)
    with pk.serving.PipelineEngine([Local()], batch_size=4,
                                   batch_timeout=0.01, qos_target=30.0,
                                   backend="processes") as eng:
        with pytest.raises(TypeError, match=r"\(Local\) is not picklable"):
            eng.run_trace(trace)
        assert eng._inner._pool is None


class CrashOnceStage:
    """Hard-kills its worker PROCESS on the first call; a sentinel file
    marks the crash so the replayed attempt (fresh process) proceeds.  The
    replacement's warm-up takes ``warm_s`` and each of its calls
    ``call_s`` (full-width models take seconds to build on the card, and
    tens of ms a call)."""

    def __init__(self, name, sentinel, seq_len=8, warm_s=0.0, call_s=0.0):
        self.name = name
        self.sentinel = sentinel
        self.seq_len = seq_len
        self.vocab_size = 64
        self.warm_s = warm_s
        self.call_s = call_s

    def warmup(self, batch):
        if os.path.exists(self.sentinel):
            time.sleep(self.warm_s)

    def process(self, tokens):
        if not os.path.exists(self.sentinel):
            open(self.sentinel, "w").close()
            os._exit(17)               # simulated segfault, not an exception
        time.sleep(self.call_s)
        t = np.asarray(tokens)
        return (t.reshape(t.shape[0], -1)[:, 0] % self.vocab_size).astype(
            np.int32)


def test_worker_crash_restarts_and_replays(tmp_path):
    """A worker killed mid-trace is restarted once and its batch replayed,
    though the replacement warms up for longer than the supervision
    timeout (the driver reads no heartbeat meanwhile)."""
    pk = PKGS["port"]
    stages = [pk.serving.CpuStageServer("s0", seq_len=8, vocab=64, spin=40),
              CrashOnceStage("boom", str(tmp_path / "crashed"),
                             warm_s=2.5, call_s=0.2)]
    trace = pk.serving.make_trace(8, qps=500.0, seq_len=8, vocab=64, seed=6)
    with pk.serving.PipelineEngine(stages, batch_size=4, batch_timeout=0.01,
                                   qos_target=60.0, backend="processes",
                                   allocation=_spread(pk, 2, 4),
                                   max_retries=2, retry_backoff=0.01,
                                   supervise_timeout=2.0) as eng:
        stats = eng.run_trace(trace)
        # the process died and came back, once: the replacement's warm-up
        # does not count as heartbeat silence
        assert eng.worker_restarts == 1
        assert stats.failed == 0              # no verdict lost
        assert stats.qos.count() == 8
        assert stats.retries >= 1             # replay rode the retry budget
    # the replacement reported on exit; the dead worker could not
    assert sorted(eng.worker_reports) == [0, 1]


def test_pool_keeps_completions_read_while_a_worker_warms_up(tmp_path):
    """A completion that arrives while the pool waits for a new worker's
    ready beacon is returned by the next ``poll``, not dropped (a dropped
    one would leave its batch in flight until the supervisor restarts a
    healthy worker)."""
    sentinel = tmp_path / "warm"
    sentinel.touch()                 # no crash: every warm-up takes 1 s
    stage = CrashOnceStage("slow-warm", str(sentinel), warm_s=1.0)
    pool = port_workers.WorkerPool(port_workers.stage_blob([[stage]]), [4],
                                   crossover_bytes=1e9, ready_timeout=60.0)
    try:
        pool.ensure([0])
        pool.submit(0, (7, 0, 0, np.zeros((4, 8), np.int32), None, 0))
        pool.ensure([1])             # worker 0 completes meanwhile
        (ev,) = pool.poll(5.0)
        assert ev[:2] == (0, 7) and ev[4] is None and ev[5] == QUEUE
        assert pool.pending(0) == set()
    finally:
        pool.close()


def test_servespec_drives_engine_knobs():
    pk = PKGS["port"]
    assert pk.serving.PipelineEngine(_cpu_stages(pk, 1)).backend == "threads"
    spec = pk.cm.ServeSpec(backend="processes", supervise_timeout=7.5,
                           max_retries=3, shm_slots=8, shm_slot_bytes=4096,
                           start_method="spawn")
    eng = pk.serving.PipelineEngine(_cpu_stages(pk, 1),
                                    **spec.engine_kwargs())
    inner = eng._inner
    assert eng.backend == "processes" and inner._pool is None
    assert (inner.supervise_timeout, inner.max_retries, inner.shm_slots,
            inner.shm_slot_bytes, inner.start_method) == \
        (7.5, 3, 8, 4096, "spawn")
    eng.close()
    with pytest.raises(ValueError, match="backend"):
        pk.serving.PipelineEngine(_cpu_stages(pk, 1), backend="fibers")


def test_exit_reports_count_every_call_in_the_workers():
    """Each worker warms every stage once and then runs its own stage's
    batches: summed over the workers, a stage's calls are its batches plus
    one warm-up per worker; on the CPU no kernel launches."""
    pk = PKGS["port"]
    with pk.serving.PipelineEngine(_cpu_stages(pk, 3), batch_size=4,
                                   batch_timeout=0.5, qos_target=30.0,
                                   backend="processes",
                                   allocation=_spread(pk, 3, 4)) as eng:
        stats = eng.run_trace(pk.serving.make_trace(
            16, qps=1e6, seq_len=8, vocab=64, seed=8))
    reports = eng.worker_reports
    assert sorted(reports) == [0, 1, 2] and stats.batches == 4
    calls = np.array([reports[w]["calls"][0] for w in range(3)])
    assert calls.sum(axis=0).tolist() == [4 + 3] * 3
    assert calls.tolist() == [[5, 1, 1], [1, 5, 1], [1, 1, 5]]
    assert all(set(r["launches"]) == set(port_workers.KERNEL_MODULES)
               and not any(r["launches"].values())
               for r in reports.values())


def _fp32_stage(arch, seed):
    """The port's stage server holding the reference's parameters in
    fp32 (as tests/test_torch_serving.py's ``_fp32_pair``)."""
    ref = ref_serving.ModelStageServer(f"ref-{arch}", arch, seq_len=16,
                                       seed=seed)
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                        ref.params)
    return port_serving.ModelStageServer(
        f"port-{arch}", arch, seq_len=16, seed=seed, reduced=True,
        device="cpu", dtype=torch.float32, params=tree)


def test_reduced_qwen_chain_serves_alike_in_processes():
    """The reduced fp32 qwen chain, each worker rebuilding both stage
    servers from their pickles (the reference's parameters ride along):
    the same completions and edge picks as the threads backend, and the
    ``process`` calls of each stage, summed over the workers, are its
    batches (a ``ModelStageServer`` warm-up is not a ``process`` call)."""
    stages = [_fp32_stage("qwen3-0.6b", 0), _fp32_stage("qwen1.5-0.5b", 1)]
    pk = PKGS["port"]
    out = {}
    for backend in ("threads", "processes"):
        trace = pk.serving.make_trace(12, qps=1e6, seq_len=16,
                                      vocab=stages[0].cfg.vocab_size, seed=3)
        alloc = _spread(pk, 2, 4, spread=backend == "processes")
        with pk.serving.PipelineEngine(stages, comm_mechanism="auto",
                                       qos_target=30.0, batch_timeout=0.5,
                                       allocation=alloc,
                                       backend=backend) as eng:
            s = eng.run_trace(trace).summary()
            out[backend] = (s["completed"], s["failed"],
                            dict(eng.channels[0].picks))
    assert out["threads"] == out["processes"] == \
        (12, 0, {GLOBAL_MEMORY: 0, HOST_STAGED: 3})
    calls = [r["calls"][0] for r in eng.worker_reports.values()]
    assert len(calls) == 2 and np.sum(calls, axis=0).tolist() == [3, 3]


def test_device_output_needs_a_device_arena():
    """A CUDA output in a worker without a device arena is an error, not a
    quiet hand-off through the host ring (checked on a stand-in tensor
    that reports ``is_cuda``)."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    out = torch.zeros(4, dtype=torch.int32).as_subclass(FakeCuda)
    cfg = port_workers._WorkerConfig("", 1, 64, 0.0, force="device")
    with pytest.raises(RuntimeError, match="no device arena"):
        port_workers._publish(out, cfg, None, None)
