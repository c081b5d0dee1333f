"""Live serving engine: runs real PyTorch models as microservice graphs.

The port of ``repro/serving/engine.py`` (threads backend).  It is driven by
the shared scheduling core (``repro_torch.core.exec.ExecCore``): the engine
consumes an ``Allocation`` + ``Placement`` and runs N_i concurrent
instances per node on a thread pool — which overlaps work because each
stage waits for its own CUDA event, and that wait releases the GIL — with
QoS-aware dynamic batching and per-edge communication-mechanism selection
(``CommModel.crossover_bytes``, paper Fig. 11): ``DeviceHandoff`` passes the
stage-output CUDA tensor by reference (global-memory mechanism, §VI-B);
``HostStagedChannel`` forces the device -> host -> device round trip
(§VI-A).

Topology is a ``ServiceGraph`` (``graph=``; default: the linear chain over
the given stage servers).  Fan-out sends one payload per out-edge; fan-in
waits on the core's join barrier and feeds the consumer a deterministic,
branch-order-independent combination of the predecessor outputs.

Two execution backends share this driver (``backend=``):

  * ``"threads"`` (default): stage instances dispatch onto one shared
    ``ThreadPoolExecutor``;
  * ``"processes"``: stage instances run in a persistent worker-process
    pool (``repro_torch.serving.workers``, one worker per placed device,
    spawned once and reused across traces), and inter-stage payloads
    travel over ``repro_torch.serving.transport`` — above the
    ``CommModel`` crossover through an arena written once and mapped
    zero-copy (on the card a device buffer shared by CUDA IPC, the
    paper's global-memory mechanism between processes; on the CPU a host
    shared-memory ring), below it pickled through the queues
    (host-staged).  The scheduling state machine stays here in the
    driver; a crashed worker process is detected, restarted, and its
    in-flight batches replayed within the retry budget.

Tracing (``trace=True``, off by default) records the spans of a served
query's life on ``repro_torch.core.trace``'s tracer, stamped where each
happens.  The processes backend records all of them: the driver loop's
``admit``, ``batch_wait``, ``queue``, ``from_worker`` and ``done`` go on
each run's ``ServeStats.spans``, the workers' ``to_worker``, ``resolve``,
``enqueue``, ``sync`` and ``publish`` (and the ``launches_per_call``
counter) come back in ``worker_reports``, and ``trace.link`` joins the
two.  The threads backend records the driver's ``admit``, ``batch_wait``,
``queue`` (to the pool's submit) and ``done``.

Retry backoff is driver-scheduled on both backends: a failing batch is
requeued with a timed wake (``retry_backoff × 2^attempt``) instead of
sleeping inside a worker slot, so a backing-off batch never idles an
otherwise-free instance.  ``apply_allocation`` makes
``CamelotRuntime.reallocate`` applicable to a running engine: allocations
swap between batches while in-flight work drains.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from heapq import heappop, heappush
from itertools import count
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import trace as tracing
from repro_torch.core.comm import (GLOBAL_MEMORY, HOST_STAGED, CommModel,
                                   EdgeChannel)
from repro_torch.core.exec import (BatchingPolicy, ExecCore, ReadyBatch,
                                   StageInstance, default_allocation)
from repro_torch.core.qos import QoSTracker
from repro_torch.core.types import RTX_2080TI, Allocation, ServiceGraph
from repro_torch.models import Transformer, from_jax_params
from repro_torch.models.common import resolve_device
from repro_torch.serving.transport import CUDA_IPC, SHM, PayloadRef
from repro_torch.serving.workers import (WorkerPool, WorkerSupervisor,
                                         stage_blob)


@dataclass
class Query:
    qid: int
    arrival: float
    tokens: np.ndarray                  # (S,) int32
    done: Optional[float] = None


class ModelStageServer:
    """One microservice stage: a model served via prefill scoring.

    The stage consumes a (B, seq_len) int32 token batch and emits the
    (B,) int32 next-token ids (argmax of the last-token logits); an
    encoder-decoder's prefill also runs its encoder, over zero frames of
    (B, ``encoder_seq_len``, d_model).
    ``process`` is thread-safe: several instances of one stage may run
    concurrently against the same (read-only) parameters.

    ``reduced=False`` serves the published width and depth;
    ``device=None`` means the card (raising without one); ``params``
    injects the reference's parameter tree, numpy leaves
    (``models.from_jax_params``), in place of the seeded init.
    """

    def __init__(self, name: str, arch: str, seq_len: int = 32,
                 seed: int = 0, *, reduced: bool = False, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 params: Optional[Mapping] = None):
        self.name = name
        self._arch = arch
        self._seed = seed
        self._reduced = reduced
        self._params = params
        self.seq_len = seq_len
        self.cfg: ModelConfig = get_config(arch, reduced=reduced)
        self.device = resolve_device(device)
        self.dtype = dtype
        if params is not None:
            self.model = from_jax_params(params, self.cfg,
                                         device=self.device, dtype=dtype)
        else:
            self.model = Transformer(self.cfg, device=self.device,
                                     dtype=dtype, seed=seed)
        self._stats_lock = threading.Lock()
        self.calls = 0
        self.busy_time = 0.0

    def __reduce__(self):
        """Rebuild from the construction arguments: the seeded init (or the
        injected parameters) reproduces the same model."""
        return (_rebuild_stage,
                (self.name, self._arch, self.seq_len, self._seed,
                 dict(reduced=self._reduced, device=str(self.device),
                      dtype=self.dtype, params=self._params)))

    def _run(self, tokens: torch.Tensor) -> torch.Tensor:
        """The ids of one call.  Under the process's tracer, when it is on,
        the host's dispatch of the call (up to the recorded event) is its
        ``enqueue`` span and the wait on the card its ``sync``; an
        encoder-decoder's prefill stamps its encoder's dispatch, inside
        ``enqueue``, as ``encode``."""
        cfg = self.cfg
        tr = tracing.PROCESS
        if tr.on:
            t0 = tr.now()
        with torch.inference_mode():
            # an encoder-decoder stage scores the tokens against zero
            # frames (the stubbed front end), as the reference's stage
            frames = torch.zeros(
                tokens.shape[0], cfg.encoder_seq_len, cfg.d_model,
                dtype=self.dtype, device=tokens.device) \
                if cfg.encoder_decoder else None
            logits, _ = self.model.serve_prefill(tokens, frames=frames)
            out = torch.argmax(logits, dim=-1).to(torch.int32)
            done = None
            if out.is_cuda:
                # wait for this stage's own work only (releases the GIL)
                done = torch.cuda.Event()
                done.record()
            if tr.on:
                t1 = tr.now()
                tr.span("enqueue", t0, t1)
            if done is not None:
                done.synchronize()
            if tr.on:
                tr.span("sync", t1, tr.now())
        return out

    def warmup(self, batch: int):
        self._run(torch.zeros(batch, self.seq_len, dtype=torch.int32,
                              device=self.device))

    def process(self, tokens: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self._run(tokens)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.busy_time += dt
            self.calls += 1
        return out

    def profile_stage_timings(self, batches: Sequence[int] = (1, 2, 4, 8),
                              repeats: int = 3) -> List[tuple]:
        """Measured (batch, seconds) pairs of one ``process`` call."""
        out = []
        for b in batches:
            self.warmup(b)
            t = torch.zeros(b, self.seq_len, dtype=torch.int32,
                            device=self.device)
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                self._run(t)
                ts.append(time.perf_counter() - t0)
            out.append((b, float(np.median(ts))))
        return out


def _rebuild_stage(name, arch, seq_len, seed, kw) -> ModelStageServer:
    return ModelStageServer(name, arch, seq_len, seed, **kw)


@dataclass
class ServeStats:
    qos: QoSTracker
    comm_time: float = 0.0
    compute_time: float = 0.0
    batches: int = 0
    failed: int = 0                    # queries lost (stage exceptions
                                       # past the retry budget, deadline
                                       # abandonment)
    retries: int = 0                   # retry attempts scheduled
    spans: List = field(default_factory=list)  # the driver's, traced

    def summary(self) -> dict:
        return {
            "p99": self.qos.tail_latency(),
            "mean": self.qos.mean(),
            "completed": self.qos.count(),
            "comm_time": self.comm_time,
            "compute_time": self.compute_time,
            "comm_frac": self.comm_time
                         / max(self.comm_time + self.compute_time, 1e-12),
            "failed": self.failed,
            "retries": self.retries,
        }


class _EdgeChannels(dict):
    """Per-edge live channels, addressable by ``(src, dst)`` or by position
    in the graph's edge list (``channels[0]`` is the first edge)."""

    def __init__(self, graph: ServiceGraph, comm: CommModel,
                 force: Optional[str]):
        super().__init__()
        self._order = [(e.src, e.dst) for e in graph.edges]
        for key in self._order:
            self[key] = EdgeChannel(comm, force=force)

    def __getitem__(self, key):
        if isinstance(key, int):
            key = self._order[key]
        return dict.__getitem__(self, key)


class PipelineEngine:
    """Executes a service graph of stage servers over a query trace: the
    one-tenant delegation into ``MultiTenantEngine``.

    ``graph`` gives the topology (node i is served by ``stages[i]``);
    omitted, the stages form the linear chain of the paper.
    ``allocation`` (placed) decides how many concurrent instances each
    node runs; omitted, one instance per node.  ``comm_mechanism``: "auto"
    routes each edge payload via the crossover rule; "device"/"host" pin
    the mechanism for A/B comparisons.  ``max_retries``/``retry_backoff``/
    ``deadline`` are the fault knobs, ``backend``/``start_method``/
    ``shm_slots``/``shm_slot_bytes``/``supervise_timeout`` the
    execution-backend knobs and ``trace`` the tracer's switch — see
    ``MultiTenantEngine``.
    """

    def __init__(self, stages: Sequence, comm_mechanism: str = "auto",
                 qos_target: float = 2.0, batch_size: int = 4,
                 batch_timeout: float = 0.2,
                 allocation: Optional[Allocation] = None,
                 comm_model: Optional[CommModel] = None,
                 graph: Optional[ServiceGraph] = None,
                 max_retries: int = 0, retry_backoff: float = 0.0,
                 deadline: Optional[float] = None,
                 backend: str = "threads", start_method: str = "spawn",
                 shm_slots: int = 32, shm_slot_bytes: int = 1 << 20,
                 supervise_timeout: float = 5.0, trace: bool = False):
        self.stages = list(stages)
        if graph is None:
            graph = ServiceGraph.chain(
                "engine", [None] * len(self.stages), qos_target=qos_target)
        if graph.n_nodes != len(self.stages):
            raise ValueError("graph nodes and stage servers must correspond "
                             "1:1")
        self.graph = graph
        self.comm_mechanism = comm_mechanism
        self.qos_target = qos_target
        self.batch_timeout = batch_timeout
        self.comm_model = comm_model or CommModel(RTX_2080TI)
        if allocation is None:
            allocation = default_allocation(len(self.stages), batch_size)
        self._inner = MultiTenantEngine(
            [self.stages], [graph], [allocation],
            comm_mechanism=comm_mechanism, batch_timeout=batch_timeout,
            comm_model=self.comm_model, qos_targets=[qos_target],
            max_retries=max_retries, retry_backoff=retry_backoff,
            deadline=deadline, backend=backend, start_method=start_method,
            shm_slots=shm_slots, shm_slot_bytes=shm_slot_bytes,
            supervise_timeout=supervise_timeout, trace=trace)
        self.channels = self._inner.tenants[0].channels

    @property
    def backend(self) -> str:
        return self._inner.backend

    @property
    def worker_restarts(self) -> int:
        return self._inner.worker_restarts

    @property
    def worker_reports(self) -> Dict[int, dict]:
        return self._inner.worker_reports

    def close(self) -> None:
        """Release the worker-process pool (processes backend); no-op for
        threads."""
        self._inner.close()

    def __enter__(self) -> "PipelineEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def alloc(self) -> Allocation:
        return self._inner.tenants[0].alloc

    @property
    def batch_size(self) -> int:
        return self._inner.tenants[0].batch_size

    @property
    def swaps(self) -> int:
        return self._inner.swaps

    def apply_allocation(self, allocation: Allocation) -> None:
        """Queue an Allocation(+Placement) swap.  A running trace applies it
        between batches — in-flight batches drain on the old instances, the
        next dispatch uses the new pool.  Safe to call from another thread
        (e.g. a CamelotRuntime reallocating against live load)."""
        self._inner.apply_allocations([allocation])

    def run_trace(self, queries: List[Query]) -> ServeStats:
        """Replay: queries arrive per their timestamps; the core forms
        batches on size/timeout and dispatches them to free stage
        instances; wall-clock latencies are recorded."""
        return self._inner.run_traces([queries])[0]


def make_trace(n: int, qps: float, seq_len: int, vocab: int,
               seed: int = 0) -> List[Query]:
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / qps, n))
    return [Query(qid=i, arrival=float(t[i]),
                  tokens=rng.integers(0, vocab, seq_len).astype(np.int32))
            for i in range(n)]


def _stack_tokens_np(tokens_list: List[np.ndarray],
                     batch_size: int) -> np.ndarray:
    """Pad a partial batch to the stage's fixed batch size with zero rows,
    staying in host memory."""
    stacked = np.stack(tokens_list)
    if len(tokens_list) < batch_size:
        pad = np.zeros((batch_size - len(tokens_list),) + stacked.shape[1:],
                       stacked.dtype)
        stacked = np.concatenate([stacked, pad])
    return stacked


def _stack_tokens(tokens_list: List[np.ndarray], batch_size: int,
                  device) -> torch.Tensor:
    """``_stack_tokens_np`` copied to ``device`` (the H2D copy of the
    batch's tokens) — the threads backend hands stages tensors."""
    return torch.from_numpy(_stack_tokens_np(tokens_list,
                                             batch_size)).to(device)


def _fanin_combine(stages: Sequence, node: int,
                   inputs: Dict[int, torch.Tensor]) -> torch.Tensor:
    """Consumer input from the joined predecessor outputs: the branch token
    ids are summed in predecessor-id order (independent of branch
    completion order), reduced ``% vocab`` and tiled to the consumer's
    ``seq_len`` — for a single predecessor this is the chain contract."""
    nxt = stages[node]
    arrs = [inputs[p] for p in sorted(inputs)]
    handed = arrs[0]
    for a in arrs[1:]:
        handed = handed + a
    vocab = getattr(nxt, "vocab_size", None)
    if vocab is None:
        vocab = nxt.cfg.vocab_size
    return (handed[:, None] % vocab).repeat(1, nxt.seq_len)


# --------------------------------------------------------------------------
# Multi-tenant live serving: N services sharing one worker pool
# --------------------------------------------------------------------------

@dataclass
class _TenantServe:
    """Per-tenant serving context of a MultiTenantEngine."""
    stages: List                       # one ModelStageServer per graph node
    graph: ServiceGraph
    alloc: Allocation
    channels: _EdgeChannels
    batch_size: int


class _RetryQueue:
    """Driver-side timed retry requeue.

    A failing batch does not sleep out its backoff inside a worker slot:
    the slot is released at once and the batch re-enters its ready queue
    once ``retry_backoff × 2^attempt`` has elapsed, so an otherwise-free
    instance keeps serving other batches meanwhile."""

    def __init__(self):
        self.heap: List[Tuple[float, int, int, ReadyBatch, int]] = []
        self._seq = count()
        self._attempts: Dict[Tuple[int, int], int] = {}

    def schedule(self, wake: float, ti: int, rb: ReadyBatch,
                 attempt: int) -> None:
        heappush(self.heap, (wake, next(self._seq), ti, rb, attempt))

    def due(self, now: float) -> List[Tuple[int, ReadyBatch, int]]:
        out = []
        while self.heap and self.heap[0][0] <= now:
            _, _, ti, rb, attempt = heappop(self.heap)
            out.append((ti, rb, attempt))
        return out

    def next_wake(self) -> Optional[float]:
        return self.heap[0][0] if self.heap else None

    def __bool__(self) -> bool:
        return bool(self.heap)

    # a requeued batch re-enters core.ready; its attempt count rides here
    # until the dispatch that re-submits it
    def mark(self, ti: int, rb: ReadyBatch, attempt: int) -> None:
        self._attempts[(ti, id(rb))] = attempt

    def take(self, ti: int, rb: ReadyBatch) -> int:
        return self._attempts.pop((ti, id(rb)), 0)


@dataclass
class _InFlight:
    """Driver-side record of one batch executing in a worker process."""
    ti: int
    inst: StageInstance
    rb: ReadyBatch
    attempt: int
    device: int
    input_refs: List = field(default_factory=list)


class MultiTenantEngine:
    """N tenant service graphs co-served from ONE shared worker pool.

    Each tenant gets its own ``ExecCore`` (admission, batching, ready
    queues against its slice of the joint ``Placement``) and its own
    per-edge channels; every dispatch lands in one shared pool — a
    ``ThreadPoolExecutor`` sized by the total placed instance count, or
    the worker processes of the placed devices.  ``apply_allocations``
    swaps all tenants' allocations between batches
    (``MultiTenantRuntime`` pushes the service-scoped slices of each joint
    re-solve here).

    Fault knobs:

    * ``max_retries`` — a batch whose stage raises is requeued (bounded,
      after ``retry_backoff × 2^attempt`` seconds, driver-side) before it
      counts as failed;
    * a batch past its retry budget is *abandoned* (its queries count in
      ``ServeStats.failed``) and the trace drains;
    * ``deadline`` — queries still waiting past this many seconds after
      arrival are abandoned at admission (counted failed), so a degraded
      pool sheds backlog instead of serving un-meetable requests.

    Backend knobs:

    * ``backend`` — ``"threads"`` (default) or ``"processes"`` (worker-
      process pool + arena transport; requires picklable stage servers;
      stages on the card get device arenas shared by CUDA IPC);
    * ``start_method`` — multiprocessing start method (``"spawn"``, which
      CUDA needs in the workers);
    * ``shm_slots``/``shm_slot_bytes`` — per-worker arena ring geometry
      (a full ring backpressures onto the queue mechanism);
    * ``supervise_timeout`` — heartbeat silence after which a worker
      process that still holds tasks is declared hung and restarted
      (a process that DIED is restarted as soon as it is seen);
      ``worker_restarts`` counts the restarts.

    ``trace`` turns the tracer on (see the module docstring): each run's
    ``ServeStats.spans`` holds the driver's spans of that tenant.

    ``close()`` shuts the pool down and keeps the workers' exit reports
    (their stage servers' ``calls``, kernels' ``LAUNCHES`` and, traced,
    their ``spans`` and ``counters``) in ``worker_reports``, by worker.
    """

    def __init__(self, tenant_stages: Sequence[Sequence],
                 graphs: Sequence[ServiceGraph],
                 allocations: Sequence[Allocation],
                 comm_mechanism: str = "auto", batch_timeout: float = 0.05,
                 comm_model: Optional[CommModel] = None,
                 qos_targets: Optional[Sequence[float]] = None,
                 max_retries: int = 0, retry_backoff: float = 0.0,
                 deadline: Optional[float] = None,
                 backend: str = "threads", start_method: str = "spawn",
                 shm_slots: int = 32, shm_slot_bytes: int = 1 << 20,
                 supervise_timeout: float = 5.0, trace: bool = False):
        if backend not in ("threads", "processes"):
            raise ValueError(f"unknown backend {backend!r}")
        if comm_mechanism not in ("auto", "device", "host"):
            raise ValueError(f"comm_mechanism {comm_mechanism!r}")
        if not len(tenant_stages) == len(graphs) == len(allocations):
            raise ValueError("need stages, graph and allocation per tenant")
        self.comm_model = comm_model or CommModel(RTX_2080TI)
        force = None if comm_mechanism == "auto" else comm_mechanism
        self.tenants: List[_TenantServe] = []
        for stages, g, alloc in zip(tenant_stages, graphs, allocations):
            _check_allocation(alloc, g.n_nodes)
            if g.n_nodes != len(stages):
                raise ValueError("graph nodes and stage servers must "
                                 "correspond 1:1")
            self.tenants.append(_TenantServe(
                stages=list(stages), graph=g, alloc=alloc,
                channels=_EdgeChannels(g, self.comm_model, force),
                batch_size=alloc.stages[0].batch))
        if qos_targets is None:
            qos_targets = [g.qos_target for g in graphs]
        if len(qos_targets) != len(self.tenants):
            raise ValueError("one QoS target per tenant")
        self.qos_targets = [float(t) for t in qos_targets]
        self.batch_timeout = batch_timeout
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.deadline = deadline
        self._pending_allocs: Optional[List[Allocation]] = None
        self._alloc_lock = threading.Lock()
        self.swaps = 0
        # process-backend state: the pool is spawned lazily on the first
        # trace (workers warm up at spawn) and reused across traces
        self.backend = backend
        self.comm_mechanism = comm_mechanism
        self.start_method = start_method
        self.shm_slots = int(shm_slots)
        self.shm_slot_bytes = int(shm_slot_bytes)
        self.supervise_timeout = float(supervise_timeout)
        self.worker_restarts = 0
        self.worker_reports: Dict[int, dict] = {}
        self._pool: Optional[WorkerPool] = None
        self._supervisor: Optional[WorkerSupervisor] = None
        self.tracer = tracing.Tracer(on=trace)
        # a run's time 0 on the tracer's clock, and the admission stamps of
        # its queries not yet batched (``_start_spans``)
        self._due0_ns = 0
        self._admitted: Dict[Tuple[int, int], int] = {}
        # task ids, unique over the engine's life: a worker's spans of
        # every trace come back together
        self._fid_gen = count()

    def close(self) -> None:
        """Shut down the worker-process pool (processes backend), keeping
        its exit reports in ``worker_reports``; no-op for threads.  The
        engine stays usable — the next trace respawns."""
        if self._pool is not None:
            self.worker_reports = self._pool.close()
            self._pool = None
            self._supervisor = None

    def __enter__(self) -> "MultiTenantEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- live joint re-allocation -------------------------------------

    def apply_allocations(self, allocations: Sequence[Allocation]) -> None:
        """Queue a per-tenant allocation swap (one placed Allocation per
        tenant — the split of a joint re-solve).  A running trace applies
        it between batches; safe to call from another thread."""
        allocations = list(allocations)
        if len(allocations) != len(self.tenants):
            raise ValueError(f"{len(allocations)} allocations for "
                             f"{len(self.tenants)} tenants")
        for a, t in zip(allocations, self.tenants):
            _check_allocation(a, t.graph.n_nodes)
        with self._alloc_lock:
            self._pending_allocs = allocations

    def _apply_pending(self, cores: List[ExecCore],
                       ex: Optional[ThreadPoolExecutor]) -> None:
        with self._alloc_lock:
            allocs = self._pending_allocs
            self._pending_allocs = None
        if allocs is None:
            return
        for t, core, alloc in zip(self.tenants, cores, allocs):
            t.alloc = alloc
            t.batch_size = alloc.stages[0].batch
            core.batching.batch_size = t.batch_size
            core.reset_instances(alloc.placement)
        # a swap to more instances grows the shared thread pool (the
        # process pool grows by device in ``_ensure_pool``)
        if ex is not None:
            total = sum(len(c.instances) for c in cores)
            ex._max_workers = max(ex._max_workers, total)
        self.swaps += 1

    # ---- trace replay --------------------------------------------------

    def run_traces(self, traces: Sequence[List[Query]]) -> List[ServeStats]:
        """Replay one query trace per tenant on the shared pool; returns
        one ``ServeStats`` per tenant (each against its own QoS target)."""
        if len(traces) != len(self.tenants):
            raise ValueError("one trace per tenant")
        if self.backend == "processes":
            return self._run_traces_processes(traces)
        stats = [ServeStats(qos=QoSTracker(qt)) for qt in self.qos_targets]
        for t in self.tenants:
            for st in t.stages:
                st.warmup(t.batch_size)
        cores = [ExecCore(t.graph, t.alloc.placement,
                          BatchingPolicy(t.batch_size, self.batch_timeout),
                          comm=self.comm_model)
                 for t in self.tenants]
        completions: queue.Queue = queue.Queue()
        retry = _RetryQueue()
        in_flight = 0
        idx = [0] * len(self.tenants)
        lens = [len(tr) for tr in traces]
        tracer = self._start_spans()
        start = time.perf_counter()
        total_inst = sum(len(c.instances) for c in cores)
        with ThreadPoolExecutor(max_workers=max(total_inst, 1)) as ex:
            while any(i < n for i, n in zip(idx, lens)) or in_flight \
                    or retry or any(c.has_work() for c in cores):
                now = time.perf_counter() - start
                self._apply_pending(cores, ex)
                self._requeue_due(retry, cores, now)
                for ti, (t, core, tr) in enumerate(
                        zip(self.tenants, cores, traces)):
                    idx[ti], formed = self._admit_due(ti, core, tr, idx[ti],
                                                      now, stats[ti])
                    for rb in formed:
                        rb.data = _stack_tokens(
                            [q.tokens for q in rb.items], t.batch_size,
                            t.stages[rb.stage].device)
                    for inst, rb in core.dispatch(now):
                        in_flight += 1
                        if tracer.on:
                            tracer.span("queue", rb.ready_ns, tracer.now(),
                                        {"ti": ti, "stage": rb.stage,
                                         "bid": rb.bid})
                        ex.submit(self._worker, ti, inst, rb, completions,
                                  retry.take(ti, rb))
                # sleep until the next event across ALL tenants
                wake = [traces[ti][idx[ti]].arrival
                        for ti in range(len(self.tenants))
                        if idx[ti] < lens[ti]]
                wake += [d for d in (c.batch_deadline() for c in cores)
                         if d is not None]
                rw = retry.next_wake()
                if rw is not None:
                    wake.append(rw)
                timeout = (min(wake) - now) if wake else 0.05
                timeout = min(max(timeout, 0.0005), 0.05)
                try:
                    ev = completions.get(timeout=timeout)
                except queue.Empty:
                    continue
                while True:
                    in_flight -= 1
                    self._complete(ev, cores, stats, start, retry)
                    try:
                        ev = completions.get_nowait()
                    except queue.Empty:
                        break
        self._hand_out_spans(stats)
        return stats

    # ---- tracing --------------------------------------------------------

    def _start_spans(self) -> tracing.Tracer:
        """Reset the run's tracing state; its time 0 is read before the
        run's clock starts, so no query is admitted before it is due."""
        tracer = self.tracer
        self._due0_ns = tracer.now() if tracer.on else 0
        self._admitted = {}
        return tracer

    def _due_ns(self, q: Query) -> int:
        return self._due0_ns + round(q.arrival * 1e9)

    def _hand_out_spans(self, stats: List[ServeStats]) -> None:
        """Each tenant's driver spans of the run onto its ``ServeStats``."""
        if self.tracer.on:
            for s in self.tracer.take()["spans"]:
                stats[s[3]["ti"]].spans.append(s)

    def _admit_due(self, ti: int, core: ExecCore, trace: List[Query],
                   i: int, now: float, stats: ServeStats
                   ) -> Tuple[int, List[ReadyBatch]]:
        """Admit tenant ``ti``'s queries of ``trace`` due by ``now`` (from
        index ``i``), abandon those that waited past the deadline, and form
        batches: (the next index, the newly formed batches).  Traced, each
        admitted query gets its ``admit`` span, each formed batch its ready
        stamp and each of its queries a ``batch_wait`` span."""
        tracer = self.tracer
        n = len(trace)
        if i < n and trace[i].arrival <= now:
            t = tracer.now() if tracer.on else 0
            while i < n and trace[i].arrival <= now:
                q = trace[i]
                core.admit(q, q.arrival)
                if tracer.on:
                    self._admitted[(ti, q.qid)] = t
                    tracer.span("admit", self._due_ns(q), t,
                                {"ti": ti, "qid": q.qid})
                i += 1
        if self.deadline is not None and core.pending:
            # per-query deadline: abandon arrivals that have already waited
            # past it instead of batching them
            keep = [(a, q) for a, q in core.pending
                    if now - a <= self.deadline]
            n_drop = len(core.pending) - len(keep)
            if n_drop:
                core.pending = keep
                stats.failed += n_drop
        formed = core.form_batches(now)
        if tracer.on and formed:
            t = tracer.now()
            for rb in formed:
                rb.ready_ns = t
                if rb.stage == core.entries[0]:
                    for q in rb.items:
                        tracer.span("batch_wait",
                                    self._admitted.pop((ti, q.qid)), t,
                                    {"ti": ti, "qid": q.qid, "bid": rb.bid})
        return i, formed

    # ---- process backend ----------------------------------------------

    def _ensure_pool(self, cores: List[ExecCore], now: float) -> None:
        """Spawn the worker pool on first use (workers warm up in their
        own processes) and add workers for any newly placed device.  Stages
        on the card give every worker a device arena."""
        if self._pool is None:
            force = (None if self.comm_mechanism == "auto"
                     else self.comm_mechanism)
            on_card = any(
                getattr(st, "device", None) is not None
                and torch.device(st.device).type == "cuda"
                for t in self.tenants for st in t.stages)
            self._pool = WorkerPool(
                stage_blob([t.stages for t in self.tenants]),
                [t.batch_size for t in self.tenants],
                self.comm_model.crossover_bytes(), force=force,
                shm_ok=self.comm_model.global_memory_enabled,
                start_method=self.start_method, slots=self.shm_slots,
                slot_bytes=self.shm_slot_bytes, on_card=on_card,
                trace=self.tracer.on)
            self._supervisor = WorkerSupervisor(
                self._pool, heartbeat_timeout=self.supervise_timeout)
        devices = sorted({inst.device for core in cores
                          for inst in core.instances})
        for d in self._pool.ensure(devices):
            self._supervisor.track(d, now)

    def _run_traces_processes(self, traces: Sequence[List[Query]]) \
            -> List[ServeStats]:
        """The multi-process twin of the threads driver loop.

        Scheduling (admission, deadlines, batching, dispatch, joins, QoS)
        is the SAME ``ExecCore`` flow; what differs is execution — batches
        run in worker processes keyed by placed device — and transport:
        stage outputs stay put in the producer's arena and only a
        ``PayloadRef`` travels through the driver when the payload is
        above the comm crossover (queue pickling below it).  The driver is
        the single freer of arena slots: a producer's output slot is
        pinned once per consumer edge and freed when the last consuming
        batch reaches a terminal state, so retries and out-of-order joins
        can always re-map their inputs."""
        stats = [ServeStats(qos=QoSTracker(qt)) for qt in self.qos_targets]
        cores = [ExecCore(t.graph, t.alloc.placement,
                          BatchingPolicy(t.batch_size, self.batch_timeout),
                          comm=self.comm_model)
                 for t in self.tenants]
        self._ensure_pool(cores, 0.0)
        pool, sup = self._pool, self._supervisor
        retry = _RetryQueue()
        inflight: Dict[int, _InFlight] = {}
        # slot refcounts: ref.key() -> [consumers_left, ref]; a bid's live
        # refs are also indexed by (ti, bid) so abandonment can reclaim
        # slots whose consumers will never run
        pins: Dict[Tuple[str, int], List] = {}
        bid_refs: Dict[Tuple[int, int], Set[Tuple[str, int]]] = {}

        def unpin(refs: List[PayloadRef]) -> None:
            for ref in refs:
                ent = pins.get(ref.key())
                if ent is None:            # already reclaimed via its bid
                    continue
                ent[0] -= 1
                if ent[0] <= 0:
                    del pins[ref.key()]
                    pool.free(ref)

        def drop_bid(ti: int, bid: int) -> None:
            for key in bid_refs.pop((ti, bid), ()):
                ent = pins.pop(key, None)
                if ent is not None:
                    pool.free(ent[1])

        def fail_or_retry(fl: _InFlight, now: float) -> None:
            core = cores[fl.ti]
            if fl.rb.bid in core._abandoned:
                return
            if self._fail_or_retry(fl.ti, fl.rb, fl.attempt, core,
                                   stats[fl.ti], retry, now):
                return                     # replay re-maps the input refs
            unpin(fl.input_refs)
            drop_bid(fl.ti, fl.rb.bid)

        idx = [0] * len(self.tenants)
        lens = [len(tr) for tr in traces]
        # workers (re-)tracked per run: supervisor heartbeats are
        # trace-relative times
        for d in pool.devices():
            sup.track(d, 0.0)
        tracer = self._start_spans()
        start = time.perf_counter()
        while any(i < n for i, n in zip(idx, lens)) or inflight \
                or retry or any(c.has_work() for c in cores):
            now = time.perf_counter() - start
            self._apply_pending(cores, None)
            self._ensure_pool(cores, now)
            # worker supervision: a dead/hung worker process is replaced
            # and its in-flight batches replayed within the retry budget
            for d in sup.dead_workers(now):
                self.worker_restarts += 1
                for fid in sorted(sup.restart(d, now)):
                    fl = inflight.pop(fid, None)
                    if fl is None:
                        continue
                    cores[fl.ti].release(fl.inst)
                    fail_or_retry(fl, now)
            self._requeue_due(retry, cores, now)
            for ti, (t, core, tr) in enumerate(
                    zip(self.tenants, cores, traces)):
                idx[ti], formed = self._admit_due(ti, core, tr, idx[ti], now,
                                                  stats[ti])
                for rb in formed:
                    # host-resident stacking: the worker moves it to its
                    # stage's device
                    rb.data = _stack_tokens_np(
                        [q.tokens for q in rb.items], t.batch_size)
                for inst, rb in core.dispatch(now):
                    fid = next(self._fid_gen)
                    refs = [v for v in (rb.inputs or {}).values()
                            if isinstance(v, PayloadRef)]
                    inflight[fid] = _InFlight(ti, inst, rb,
                                              retry.take(ti, rb),
                                              inst.device, refs)
                    if rb.inputs is not None:
                        task = (fid, ti, rb.stage, None, dict(rb.inputs),
                                inflight[fid].attempt)
                    else:
                        task = (fid, ti, rb.stage, rb.data, None,
                                inflight[fid].attempt)
                    # an idle worker is not a silent one: its liveness
                    # record starts at the submit that ends its idling,
                    # so only a call that alone outlasts the timeout
                    # looks hung (the reference counts the idle time
                    # too).  The clock is read afresh: a restart earlier
                    # in this round can have taken seconds since ``now``
                    if not pool.pending(inst.device):
                        sup.track(inst.device,
                                  time.perf_counter() - start)
                    if tracer.on:
                        tracer.span("queue", rb.ready_ns, tracer.now(),
                                    {"ti": ti, "stage": rb.stage,
                                     "bid": rb.bid, "fid": fid})
                    pool.submit(inst.device, task)
            wake = [traces[ti][idx[ti]].arrival
                    for ti in range(len(self.tenants))
                    if idx[ti] < lens[ti]]
            wake += [d for d in (c.batch_deadline() for c in cores)
                     if d is not None]
            rw = retry.next_wake()
            if rw is not None:
                wake.append(rw)
            timeout = (min(wake) - now) if wake else 0.05
            timeout = min(max(timeout, 0.0005), 0.05)
            for ev in pool.poll(timeout):
                self._complete_proc(ev, cores, stats, start, inflight,
                                    pins, bid_refs, unpin, drop_bid,
                                    fail_or_retry)
        self._hand_out_spans(stats)
        return stats

    def _complete_proc(self, ev, cores: List[ExecCore],
                       stats: List[ServeStats], start: float,
                       inflight: Dict[int, _InFlight],
                       pins: Dict, bid_refs: Dict,
                       unpin, drop_bid, fail_or_retry) -> None:
        """Fold one worker completion into the scheduling state — the
        process-backend mirror of ``_complete`` plus slot-lifecycle and
        mechanism accounting (each hand-off is recorded on its edge's
        ``EdgeChannel`` so per-edge stats read identically across
        backends)."""
        pool, sup = self._pool, self._supervisor
        wid, fid, payload, dt, err, mech, nbytes, t_comm = ev
        now = time.perf_counter() - start
        tracer = self.tracer
        if tracer.on:
            folded = tracer.now()
        sup.beat(wid, now)
        fl = inflight.pop(fid, None)
        if fl is None:
            # completion from a replaced worker generation — the batch was
            # already replayed or failed; reclaim an orphan arena payload
            if isinstance(payload, PayloadRef):
                pool.free(payload)
            return
        ti, rb = fl.ti, fl.rb
        if tracer.on:
            tracer.span("from_worker", None, folded,
                        {"ti": ti, "stage": rb.stage, "bid": rb.bid,
                         "fid": fid})
        t = self.tenants[ti]
        core = cores[ti]
        core.release(fl.inst)
        if err is not None:
            fail_or_retry(fl, now)
            return
        if rb.bid in core._abandoned:      # a sibling branch failed
            if isinstance(payload, PayloadRef):
                pool.free(payload)
            return
        stats[ti].compute_time += dt
        stats[ti].comm_time += t_comm
        # this batch is terminal for its inputs: release their slot pins
        unpin(fl.input_refs)
        u = rb.stage
        succs = core.succs[u]
        if succs:
            if isinstance(payload, PayloadRef):
                pins[payload.key()] = [len(succs), payload]
                bid_refs.setdefault((ti, rb.bid), set()).add(payload.key())
            mech_name = GLOBAL_MEMORY if mech in (SHM, CUDA_IPC) \
                else HOST_STAGED
            for v in succs:
                t.channels[(u, v)].record(mech_name, nbytes)
                # joined batches keep raw inputs: the CONSUMER's worker
                # resolves refs and runs the fan-in combine process-side
                joined = core.deliver(u, v, rb.bid, rb.items, now,
                                      data=payload)
                if tracer.on and joined is not None:
                    joined.ready_ns = folded
        else:
            if isinstance(payload, PayloadRef):
                pool.free(payload)
            if core.complete_exit(rb.bid, u):
                for q in rb.items:
                    q.done = now
                    stats[ti].qos.record(now - q.arrival)
                    if tracer.on:
                        tracer.span("done", self._due_ns(q), folded,
                                    {"ti": ti, "qid": q.qid, "bid": rb.bid})
                stats[ti].batches += 1
                drop_bid(ti, rb.bid)

    # ---- internals -----------------------------------------------------

    def _worker(self, ti: int, inst: StageInstance, rb: ReadyBatch,
                completions: queue.Queue, attempt: int) -> None:
        """ONE stage execution attempt; the outcome (output or exception)
        goes to the driver, which schedules any retry."""
        t0 = time.perf_counter()
        try:
            out, err = \
                self.tenants[ti].stages[inst.stage].process(rb.data), None
        except Exception as e:      # reported to the driver, never lost
            out, err = None, e
        completions.put((ti, inst, rb, out, time.perf_counter() - t0, err,
                         attempt))

    def _fail_or_retry(self, ti: int, rb: ReadyBatch, attempt: int,
                       core: ExecCore, stats: ServeStats,
                       retry: _RetryQueue, now: float) -> bool:
        """Shared failure policy for both backends: schedule a timed
        requeue while the retry budget lasts, else count the batch failed
        and abandon it, so its join/exit bookkeeping cannot strand the
        trace.  Returns True when a retry was scheduled."""
        if rb.bid in core._abandoned:
            return False
        if attempt < self.max_retries:
            stats.retries += 1
            retry.schedule(now + self.retry_backoff * (2 ** attempt),
                           ti, rb, attempt + 1)
            return True
        stats.failed += len(rb.items)
        core.abandon(rb.bid)
        return False

    def _requeue_due(self, retry: _RetryQueue, cores: List[ExecCore],
                     now: float) -> None:
        """Re-enter backed-off batches whose wake time has passed into
        their stage's ready queue (their attempt count rides in the retry
        queue until dispatch re-submits them)."""
        for ti, rb, attempt in retry.due(now):
            if rb.bid in cores[ti]._abandoned:
                continue
            retry.mark(ti, rb, attempt)
            if self.tracer.on:
                rb.ready_ns = self.tracer.now()
            cores[ti].ready[rb.stage].append(rb)

    def _complete(self, ev, cores: List[ExecCore],
                  stats: List[ServeStats], start: float,
                  retry: _RetryQueue) -> None:
        ti, inst, rb, out, dt, err, attempt = ev
        t = self.tenants[ti]
        core = cores[ti]
        core.release(inst)
        if err is not None:
            self._fail_or_retry(ti, rb, attempt, core, stats[ti], retry,
                                time.perf_counter() - start)
            return
        stats[ti].compute_time += dt
        u = rb.stage
        now = time.perf_counter() - start
        succs = core.succs[u]
        if succs:
            for v in succs:
                same = inst.device in core.consumer_devices(v)
                t0 = time.perf_counter()
                handed = t.channels[(u, v)].send(out, same_device=same)
                stats[ti].comm_time += time.perf_counter() - t0
                joined = core.deliver(u, v, rb.bid, rb.items, now,
                                      data=handed)
                if joined is not None:
                    joined.data = _fanin_combine(t.stages, v, joined.inputs)
                    if self.tracer.on:
                        joined.ready_ns = self.tracer.now()
        elif core.complete_exit(rb.bid, u):
            tracer = self.tracer
            if tracer.on:
                done = tracer.now()
            for q in rb.items:
                q.done = now
                stats[ti].qos.record(now - q.arrival)
                if tracer.on:
                    tracer.span("done", self._due_ns(q), done,
                                {"ti": ti, "qid": q.qid, "bid": rb.bid})
            stats[ti].batches += 1


def _check_allocation(alloc: Allocation, n_nodes: int) -> None:
    if alloc.placement is None:
        raise ValueError("allocation must be placed")
    if len(alloc.stages) != n_nodes:
        raise ValueError(f"allocation has {len(alloc.stages)} stages for "
                         f"{n_nodes} graph nodes")
