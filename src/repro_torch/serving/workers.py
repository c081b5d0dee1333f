"""Process workers for the live serving plane (paper §VI, multi-process).

The port of ``repro/serving/workers.py``.  The ``backend="processes"``
serving plane escapes the interpreter lock: stage ``process()`` calls run
in a pool of persistent OS processes — ONE worker per placed device, the
process-world realisation of the paper's spatially-shared GPU — while the
scheduling state machine (``ExecCore``) stays in the driver.  Only
execution and payload transport cross the process boundary:

  * tasks (batch descriptors, token batches as numpy) travel driver ->
    worker over a per-worker task queue; completions come back over one
    shared queue;
  * stage outputs travel worker -> consumer-worker via the
    ``repro_torch.serving.transport`` mechanisms: an arena hand-off above
    the comm crossover (written once, mapped zero-copy: a ``DeviceArena``
    slot shared by CUDA IPC for a device output, a ``ShmArena`` slot for a
    host one), pickle-over-queue below it (a device output copied to the
    host as numpy) — the same per-edge rule the ``CommModel`` prices.

On the card the driver owns every worker's ``DeviceArena`` (it allocates
the buffer and exports it to the workers through ``torch.multiprocessing``)
and every worker maps every arena; logical device d runs on card
``d % torch.cuda.device_count()``.  If the stages are on the card and an
arena cannot be created or mapped, the pool fails: there is no fallback to
the host ring.

Stage servers reach workers by pickle — anything picklable works;
``ModelStageServer`` reconstructs itself from its construction arguments
via ``__reduce__``, and ``CpuStageServer`` below is the picklable CPU-bound
stage of the tests.  A task's numpy data is moved to the stage's
``device`` (a stage without one is a numpy stage).

Supervision: ``WorkerSupervisor`` wraps
``repro_torch.core.runtime.HealthMonitor`` — completions are per-worker
heartbeats; a worker whose PROCESS died (``is_alive()`` false) or that
holds tasks but has been heartbeat-silent past the timeout is declared
dead.  The pool restarts it (fresh process, fresh output arenas — the dead
worker's old arenas stay alive so outstanding refs written before the
crash remain readable) and the engine replays its in-flight batches within
the existing retry budget.

Observability: on its stop sentinel a worker posts an exit report — its
stage servers' ``calls``, its kernels' launch counts, and the ``spans``
and ``counters`` of its tracer — which ``WorkerPool.close()`` collects by
worker, so a driver can show that the kernels ran in the workers.  With
``trace`` on, a worker turns on its process's tracer
(``repro_torch.core.trace.PROCESS``) once it has warmed up, and records
each task's ``to_worker``, ``resolve`` and ``publish`` spans; its stage
servers record ``enqueue`` and ``sync`` (and an encoder-decoder's
``encode``) under the task's ids.  On the card it first counts the device
kernels of a warm call of each stage (``launches_per_call``).
"""
from __future__ import annotations

import bisect
import importlib
import pickle
import queue as _queue
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.multiprocessing as tmp

from repro_torch.core import trace as tracing
from repro_torch.serving.transport import (CUDA_IPC, QUEUE, SHM, ArenaMap,
                                           DeviceArena, PayloadRef,
                                           ShmArena)

__all__ = ["CpuStageServer", "WorkerPool", "WorkerSupervisor",
           "WorkerTask", "WorkerDone", "KERNEL_MODULES"]

#: task tuple: (fid, tenant, stage, data, inputs, attempt)
WorkerTask = Tuple[int, int, int, object, Optional[dict], int]
#: completion tuple:
#: (worker, fid, payload, compute_s, err, mechanism, nbytes, comm_s)
WorkerDone = Tuple[int, int, object, float, Optional[str], Optional[str],
                   int, float]

# completion fids that are not tasks: the warm-up beacon, the exit report
_READY = -1
_EXIT = -2

#: the kernels whose launch counts a worker reports on exit, by name: the
#: module and its counter
KERNEL_MODULES = {
    "flash_attention_bhsd": ("repro_torch.kernels.flash_attention",
                             "LAUNCHES"),
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention",
                            "BWD_LAUNCHES"),
    "mlstm_chunk_step": ("repro_torch.kernels.mlstm_scan", "LAUNCHES"),
    "decode_attention_packed": ("repro_torch.kernels.decode_attention",
                                "LAUNCHES"),
    "ssm_chunk_scan": ("repro_torch.kernels.ssm_scan", "LAUNCHES"),
    "mlstm_chunk_bwd": ("repro_torch.kernels.mlstm_scan", "BWD_LAUNCHES"),
    "ssm_chunk_scan_bwd": ("repro_torch.kernels.ssm_scan", "BWD_LAUNCHES"),
}


class CpuStageServer:
    """A picklable, deterministic, GIL-bound CPU microservice stage.

    ``process`` runs ``spin`` rounds of pure-Python integer arithmetic per
    query — work that HOLDS the interpreter lock, so a thread pool of
    these stages serialises on one core while a process pool scales with
    the machine.

    The output is a deterministic function of the input tokens alone
    (no clocks, no RNG state), so thread- and process-backend runs of the
    same trace complete the same queries with identical payloads.  In the
    port's stage contract it lives on ``device`` "cpu": it takes a (B, S)
    int32 batch (a tensor or an array) and returns the (B,) int32 ids as a
    CPU tensor.
    """

    device = torch.device("cpu")

    def __init__(self, name: str, seq_len: int = 16, vocab: int = 256,
                 spin: int = 400):
        self.name = name
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab)
        self.spin = int(spin)
        self.calls = 0

    def warmup(self, batch: int) -> None:
        self.process(np.zeros((batch, self.seq_len), np.int32))

    def process(self, tokens) -> torch.Tensor:
        """The ids; under a tracer that is on, the whole call is its
        ``enqueue`` (the host does the work) and its ``sync`` is empty."""
        tr = tracing.PROCESS
        if tr.on:
            t0 = tr.now()
        tokens = np.asarray(tokens)
        self.calls += 1
        seeds = [int(r) for r in tokens.reshape(tokens.shape[0], -1)[:, 0]]
        out = np.empty((tokens.shape[0],), np.int32)
        for i, acc in enumerate(seeds):
            for _ in range(self.spin):          # GIL-bound by construction
                acc = (acc * 1103515245 + 12345) & 0x7FFFFFFF
            out[i] = acc % self.vocab_size
        if tr.on:
            t1 = tr.now()
            tr.span("enqueue", t0, t1)
            tr.span("sync", t1, t1)
        return torch.from_numpy(out)


# --------------------------------------------------------------------------
# Worker process main loop
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class _WorkerConfig:
    """Everything a spawned worker needs, picklable."""
    arena_name: str
    slots: int
    slot_bytes: int
    crossover_bytes: float
    shm_ok: bool = True
    force: Optional[str] = None        # None | "device" | "host"
    batch_sizes: Tuple[int, ...] = ()  # per-tenant warmup batch
    device_arena: Optional[str] = None  # its own DeviceArena (card pools)
    card: Optional[int] = None         # the CUDA device it runs on
    trace: bool = False                # turn on the process's tracer


def _resolve(payload, amap: ArenaMap, cfg: _WorkerConfig):
    """Materialise a task payload: refs map zero-copy (a device arena's as
    a tensor view, a host arena's as a numpy view), arrays pass as-is."""
    if isinstance(payload, PayloadRef):
        return amap.attach(payload.arena, cfg.slots,
                           cfg.slot_bytes).get(payload)
    return payload


def _to_stage(stage, x):
    """``x`` (numpy or tensor) as the stage consumes it: numpy for a stage
    without a ``device``, else a tensor on that device."""
    dev = getattr(stage, "device", None)
    if dev is None:
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.asarray(x)).to(dev)


def _combine(stage, inputs: Dict[int, object]):
    """Consumer-side fan-in combine on the consumer's device — the mirror
    of the threads backend's ``_fanin_combine`` (and, for a numpy stage,
    of the reference's ``_combine_np``): branch outputs summed in
    predecessor order, consumed as a token prefix tiled to the consumer's
    sequence length.  A stage may override with its own ``combine``."""
    if hasattr(stage, "combine"):
        return stage.combine(inputs)
    arrs = [_to_stage(stage, inputs[p]) for p in sorted(inputs)]
    handed = arrs[0]
    for a in arrs[1:]:
        handed = handed + a
    vocab = getattr(stage, "vocab_size", None)
    if vocab is None:
        vocab = stage.cfg.vocab_size
    if isinstance(handed, torch.Tensor):
        return (handed[:, None] % vocab).repeat(1, stage.seq_len)
    return np.tile(handed[:, None] % vocab, (1, stage.seq_len))


def _pick_mechanism(cfg: _WorkerConfig, nbytes: int) -> str:
    """The executed per-edge rule: exactly ``select_mechanism``'s
    same-device branch (queue below the crossover, an arena above),
    evaluated against the crossover constant the driver's ``CommModel``
    supplied.  ``SHM`` names the arena hand-off here; a device output
    takes the device arena (``CUDA_IPC``)."""
    if cfg.force == "host" or not cfg.shm_ok:
        return QUEUE
    if cfg.force == "device":
        return SHM
    return QUEUE if nbytes < cfg.crossover_bytes else SHM


def _publish(out, cfg: _WorkerConfig, arena: ShmArena,
             dev_arena: Optional[DeviceArena]) -> Tuple[object, str, int]:
    """Hand a stage output to its consumers: (payload, mechanism, nbytes).
    A full ring backpressures onto the queue."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        nbytes = out.numel() * out.element_size()
        if _pick_mechanism(cfg, nbytes) == SHM:
            if dev_arena is None:
                raise RuntimeError("a device output, but this worker has no "
                                   "device arena: the pool was not started "
                                   "on the card")
            ref = dev_arena.try_put(out)
            if ref is not None:
                return ref, CUDA_IPC, nbytes
        return out.cpu().numpy(), QUEUE, nbytes
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if _pick_mechanism(cfg, out.nbytes) == SHM:
        ref = arena.try_put(out)
        if ref is not None:
            return ref, SHM, int(out.nbytes)
    return out, QUEUE, int(out.nbytes)


def _calls(tenants) -> List[List[Optional[int]]]:
    return [[getattr(st, "calls", None) for st in stages]
            for stages in tenants]


def _exit_report(tenants, calls0) -> dict:
    """The calls this worker made to each stage server (per tenant, per
    stage; warm-ups included), its kernels' launches since it started, and
    its tracer's records (empty lists with the tracer off)."""
    return {"calls": [[None if c is None else c - c0
                       for c, c0 in zip(row, row0)]
                      for row, row0 in zip(_calls(tenants), calls0)],
            "launches": {name: getattr(importlib.import_module(mod), count)
                         for name, (mod, count) in KERNEL_MODULES.items()},
            **tracing.PROCESS.take()}


#: spin kernels launched before the counted calls: a profiler session can
#: lose its first device records
_LEAD_IN = 64
#: warm calls counted a stage: a session can lose records (three workers
#: profile at once), never add one, so the count is the largest
_COUNTED_CALLS = 3


def _launches_per_call(tenants, batch_sizes) -> List[Tuple[int, int, int]]:
    """(tenant, stage, kernels) of a warm call of each stage, from one
    ``torch.profiler`` session of CUDA activity (copies and fills left
    out): a call's kernels are those that start between the host's stamps
    before the call and after its synchronize, on the profiler's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    shift = tracing.clock_shift()
    calls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for ti, stages in enumerate(tenants):
            b = batch_sizes[ti] if ti < len(batch_sizes) else 1
            for si, st in enumerate(stages):
                for _ in range(_COUNTED_CALLS):
                    lo = time.time_ns() + shift
                    st.warmup(b)
                    torch.cuda.synchronize()
                    calls.append((ti, si, lo, time.time_ns() + shift))
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation()
                    and not e.name().startswith(("Memcpy", "Memset")))
    most: Dict[Tuple[int, int], int] = {}
    for ti, si, lo, hi in calls:
        n = bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo)
        most[(ti, si)] = max(most.get((ti, si), 0), n)
    return [(ti, si, n) for (ti, si), n in most.items()]


def _worker_main(wid: int, task_q, done_q, stages_blob: bytes,
                 cfg: _WorkerConfig,
                 device_arenas: Sequence[DeviceArena]) -> None:
    """Persistent worker loop: resolve payload -> combine -> process ->
    publish output via the selected mechanism -> report completion.  A
    ``DeviceArena`` on the task queue is a new worker's arena to map."""
    if cfg.card is not None:
        torch.cuda.set_device(cfg.card)
    tenants = pickle.loads(stages_blob)
    calls0 = _calls(tenants)
    arena = ShmArena(name=cfg.arena_name, slots=cfg.slots,
                     slot_bytes=cfg.slot_bytes, create=False)
    amap = ArenaMap()
    for a in device_arenas:
        amap.register(a)
    dev_arena = next((a for a in device_arenas
                      if a.name == cfg.device_arena), None)
    for ti, stages in enumerate(tenants):
        b = cfg.batch_sizes[ti] if ti < len(cfg.batch_sizes) else 1
        for st in stages:
            st.warmup(b)
    tr = tracing.PROCESS
    if cfg.trace:
        counted = _launches_per_call(tenants, cfg.batch_sizes) \
            if cfg.card is not None else []
        tr.enable()
        for ti, si, n in counted:
            tr.count("launches_per_call", n, {"ti": ti, "stage": si})
    done_q.put((wid, _READY, None, 0.0, None, None, 0, 0.0))
    while True:
        task = task_q.get()
        if tr.on:
            got = tr.now()
        if task is None:
            done_q.put((wid, _EXIT, _exit_report(tenants, calls0), 0.0,
                        None, None, 0, 0.0))
            break
        if isinstance(task, DeviceArena):
            amap.register(task)
            continue
        fid, ti, stage, data, inputs, _attempt = task
        if tr.on:
            tr.ids = {"ti": ti, "stage": stage, "fid": fid}
            tr.span("to_worker", None, got)
        # comm_s: the input's resolve and the output's publish; compute_s:
        # the stage's call alone
        dt = t_comm = 0.0
        try:
            st = tenants[ti][stage]
            t0 = time.perf_counter()
            if inputs is not None:
                x = _combine(st, {p: _resolve(v, amap, cfg)
                                  for p, v in inputs.items()})
            else:
                x = _to_stage(st, _resolve(data, amap, cfg))
            t1 = time.perf_counter()
            if tr.on:
                tr.span("resolve", got, tr.now())
            t_comm = t1 - t0
            out = st.process(x)
            t2 = time.perf_counter()
            dt = t2 - t1
            if tr.on:
                p0 = tr.now()
            payload, mech, nbytes = _publish(out, cfg, arena, dev_arena)
            if tr.on:
                tr.span("publish", p0, tr.now())
            t_comm += time.perf_counter() - t2
            done_q.put((wid, fid, payload, dt, None, mech, nbytes, t_comm))
        except Exception as e:  # noqa: BLE001 — report, never die
            done_q.put((wid, fid, None, dt, f"{type(e).__name__}: {e}",
                        None, 0, t_comm))
    arena.close()
    amap.close()


# --------------------------------------------------------------------------
# Driver-side pool
# --------------------------------------------------------------------------

@dataclass
class _Worker:
    device: int
    proc: object
    task_q: object
    arena: ShmArena                  # driver's attachment (freer side)
    pending: Set[int] = field(default_factory=set)
    ready: bool = False


class WorkerPool:
    """Persistent process pool, one worker pinned per placed device.

    The driver submits ``WorkerTask``s to a device's worker and drains
    ``WorkerDone`` completions from one shared queue.  Spawned once per
    ``serve()``/first trace and reused across traces and allocation swaps
    (``ensure`` adds workers for newly placed devices on demand).
    ``on_card`` gives every worker a ``DeviceArena`` on its card;
    ``trace`` turns on every worker's tracer (its records come back in
    the exit reports).
    """

    def __init__(self, stages_blob: bytes, batch_sizes: Sequence[int],
                 crossover_bytes: float, force: Optional[str] = None,
                 shm_ok: bool = True, start_method: str = "spawn",
                 slots: int = 32, slot_bytes: int = 1 << 20,
                 ready_timeout: float = 120.0, on_card: bool = False,
                 trace: bool = False):
        if on_card and not torch.cuda.is_available():
            raise RuntimeError("the stages are on the card, but there is no "
                               "CUDA device for their device arenas")
        self._blob = stages_blob
        self._cfg_proto = _WorkerConfig(
            arena_name="", slots=int(slots), slot_bytes=int(slot_bytes),
            crossover_bytes=float(crossover_bytes), shm_ok=bool(shm_ok),
            force=force, batch_sizes=tuple(int(b) for b in batch_sizes),
            trace=bool(trace))
        self._on_card = on_card
        # torch's context: its pickler shares CUDA tensors by IPC handle
        self._ctx = tmp.get_context(start_method)
        self._done = self._ctx.Queue()
        self._workers: Dict[int, _Worker] = {}
        self._old_arenas: List[ShmArena] = []
        self._dev_arenas: List[DeviceArena] = []   # every one, old included
        self._amap = ArenaMap()          # driver attachments for freeing
        self._ready_timeout = ready_timeout
        # completions read while waiting for a ready beacon; ``poll``
        # returns them first
        self._early: List[WorkerDone] = []
        self.exit_reports: Dict[int, dict] = {}

    # ---- lifecycle ----------------------------------------------------

    def devices(self) -> List[int]:
        return sorted(self._workers)

    def ensure(self, devices: Sequence[int]) -> List[int]:
        """Spawn workers for any device not yet in the pool; returns the
        newly spawned device ids."""
        new = [int(d) for d in devices if int(d) not in self._workers]
        for d in new:
            self._spawn(d)
        if new:
            self.wait_ready()
        return new

    def _spawn(self, device: int) -> _Worker:
        proto = self._cfg_proto
        arena = ShmArena(slots=proto.slots, slot_bytes=proto.slot_bytes,
                         create=True)
        self._amap.register(arena)
        dev_arena, card = None, None
        if self._on_card:
            card = device % torch.cuda.device_count()
            dev_arena = DeviceArena(proto.slots, proto.slot_bytes,
                                    device=torch.device("cuda", card))
            self._amap.register(dev_arena)
            self._dev_arenas.append(dev_arena)
            # the running workers map the new arena before any task that
            # refers to it (their task queues are FIFO)
            for w in self._workers.values():
                w.task_q.put(dev_arena)
        cfg = _WorkerConfig(
            arena_name=arena.name, slots=proto.slots,
            slot_bytes=proto.slot_bytes,
            crossover_bytes=proto.crossover_bytes, shm_ok=proto.shm_ok,
            force=proto.force, batch_sizes=proto.batch_sizes,
            device_arena=dev_arena.name if dev_arena else None, card=card,
            trace=proto.trace)
        task_q = self._ctx.Queue()
        proc = self._ctx.Process(
            target=_worker_main, name=f"serve-worker-{device}",
            args=(device, task_q, self._done, self._blob, cfg,
                  list(self._dev_arenas)), daemon=True)
        proc.start()
        w = _Worker(device=device, proc=proc, task_q=task_q, arena=arena)
        self._workers[device] = w
        return w

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every worker has warmed up and posted its ready
        beacon.  A worker beacons before its first task can be submitted,
        but the OTHER workers keep completing tasks while a new or
        replacement one warms up: those completions are kept for the next
        ``poll``, never dropped."""
        deadline = time.time() + (timeout or self._ready_timeout)
        while any(not w.ready for w in self._workers.values()):
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError("worker pool failed to come up")
            try:
                ev = self._done.get(timeout=min(remaining, 0.5))
            except _queue.Empty:
                dead = [d for d, w in self._workers.items()
                        if not w.ready and not w.proc.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"worker(s) {dead} died during startup")
                continue
            if ev[1] != _READY:
                self._early.append(ev)
            elif ev[0] in self._workers:
                self._workers[ev[0]].ready = True

    # ---- data plane ---------------------------------------------------

    def submit(self, device: int, task: WorkerTask) -> None:
        w = self._workers[device]
        w.pending.add(task[0])
        w.task_q.put(task)

    def poll(self, timeout: float) -> List[WorkerDone]:
        """Drain completions: block up to ``timeout`` for the first, then
        sweep everything immediately available (mirrors the threads
        driver's queue drain)."""
        out, self._early = self._early, []
        if not out:
            try:
                out.append(self._done.get(timeout=max(timeout, 1e-4)))
            except _queue.Empty:
                return out
        while True:
            try:
                out.append(self._done.get_nowait())
            except _queue.Empty:
                break
        cleaned = []
        for ev in out:
            wid, fid = ev[0], ev[1]
            if fid == _READY:                   # late ready beacon
                if wid in self._workers:
                    self._workers[wid].ready = True
                continue
            w = self._workers.get(wid)
            if w is not None:
                w.pending.discard(fid)
            cleaned.append(ev)
        return cleaned

    def free(self, ref: PayloadRef) -> None:
        self._amap.free(ref)

    # ---- supervision hooks --------------------------------------------

    def alive(self, device: int) -> bool:
        w = self._workers.get(device)
        return w is not None and w.proc.is_alive()

    def pending(self, device: int) -> Set[int]:
        w = self._workers.get(device)
        return set(w.pending) if w is not None else set()

    def restart(self, device: int) -> Set[int]:
        """Replace a dead/hung worker with a fresh process and FRESH output
        arenas (a crash can leave half-claimed slots; outputs the old
        worker already published stay readable through its old arenas,
        which are kept until ``close``).  Returns the in-flight fids the
        caller must replay or fail."""
        w = self._workers.pop(device)
        inflight = set(w.pending)
        if w.proc.is_alive():
            w.proc.kill()
        w.proc.join(timeout=5.0)
        w.task_q.close()
        self._old_arenas.append(w.arena)        # refs may still be pinned
        self._spawn(device)
        self.wait_ready()
        return inflight

    # ---- teardown -----------------------------------------------------

    def close(self) -> Dict[int, dict]:
        """Stop every worker and collect its exit report (by worker); then
        join them and release the arenas — the device buffers only after
        every process that mapped them has exited."""
        for w in self._workers.values():
            try:
                w.task_q.put(None)
            except (ValueError, OSError):  # pragma: no cover
                pass
        waiting = set(self._workers)
        deadline = time.time() + 30.0
        while waiting and time.time() < deadline:
            # a worker flushes its queue before it exits: once none was
            # alive before an empty read, nothing more is coming
            alive = any(self._workers[d].proc.is_alive() for d in waiting)
            try:
                wid, fid, payload, *_ = self._done.get(timeout=0.2)
            except _queue.Empty:
                if not alive:
                    break
                continue
            if fid == _EXIT and wid in waiting:
                self.exit_reports[wid] = payload
                waiting.discard(wid)
        for w in self._workers.values():
            w.proc.join(timeout=5.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5.0)
        self._amap.close()
        for w in self._workers.values():
            w.arena.unlink()
        for a in self._old_arenas + self._dev_arenas:
            a.unlink()
        self._workers.clear()
        self._old_arenas.clear()
        self._dev_arenas.clear()
        self._done.close()
        return self.exit_reports


class WorkerSupervisor:
    """HealthMonitor-driven worker supervision.

    Every completion is a heartbeat for its worker ("device" in monitor
    terms).  A worker is declared dead when its PROCESS is gone — the
    definitive signal — or when it still holds in-flight tasks but has
    been heartbeat-silent past the timeout (hung, e.g. stuck in native
    code).  The engine then restarts it and replays its in-flight batches
    within the retry budget; ``HealthMonitor.reset_device`` clears the
    stale heartbeat so the replacement starts a fresh liveness record."""

    def __init__(self, pool: WorkerPool, heartbeat_timeout: float = 5.0):
        from repro_torch.core.runtime import HealthMonitor
        self.pool = pool
        self.monitor = HealthMonitor(pool.devices(),
                                     heartbeat_timeout=heartbeat_timeout)
        self.restarts = 0

    def track(self, device: int, now: float) -> None:
        """Start (or restart) the liveness record for a worker."""
        self.monitor.reset_device(device)
        self.monitor.observe(now, {device: now})

    def beat(self, device: int, now: float) -> None:
        self.monitor.observe(now, {device: now})

    def dead_workers(self, now: float) -> List[int]:
        out = []
        for d in self.pool.devices():
            if not self.pool.alive(d):
                out.append(d)
            elif self.pool.pending(d) and \
                    d in self.monitor.dead_devices(now):
                out.append(d)
        return out

    def restart(self, device: int, now: float) -> Set[int]:
        """Replace ``device``'s worker; returns its in-flight fids.  The
        driver reads no heartbeat while the replacement warms up (seconds
        for full-width models), so every worker's liveness record starts
        again when the replacement is ready — not at ``now``, which would
        make the replacement (and any worker holding tasks) look silent
        past the timeout and restart it again."""
        t0 = time.perf_counter()
        inflight = self.pool.restart(device)
        self.restarts += 1
        ready = now + time.perf_counter() - t0
        for d in self.pool.devices():
            self.track(d, ready)
        return inflight


def stage_blob(tenant_stages: Sequence[Sequence]) -> bytes:
    """Pickle the per-tenant stage servers for worker spawning, with an
    actionable error naming the offending stage when one can't cross the
    process boundary."""
    try:
        return pickle.dumps([list(s) for s in tenant_stages],
                            protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as e:
        for ti, stages in enumerate(tenant_stages):
            for si, st in enumerate(stages):
                try:
                    pickle.dumps(st, protocol=pickle.HIGHEST_PROTOCOL)
                except Exception:
                    raise TypeError(
                        f"stage {si} of tenant {ti} "
                        f"({type(st).__name__}) is not picklable; the "
                        f"processes backend ships stage servers to worker "
                        f"processes by pickle — implement __reduce__ (see "
                        f"ModelStageServer) or use a picklable stage"
                    ) from e
        raise
