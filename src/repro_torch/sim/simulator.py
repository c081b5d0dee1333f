"""Discrete-event datacenter simulator for GPU-microservice service graphs.

The simulator is the *physics*: ground-truth durations from
MicroserviceProfile curves, runtime global-memory-bandwidth contention on
each device (the effect Camelot's Constraint-3 manages), PCIe stream
contention on each host link (paper Fig. 9), and the chosen inter-stage
communication mechanism.  Policies under test only choose the allocation +
placement + mechanism; the simulator charges them the consequences.

Since the unified-execution refactor, every *scheduling* decision —
entry-node dynamic batching, per-node ready queues, free-instance dispatch
against the ``Placement``, per-edge mechanism selection via
``CommModel.crossover_bytes()``, and the DAG fan-in/exit join barriers —
lives in ``repro_torch.core.exec.ExecCore``, the same code path the live serving
engine runs.  This file only advances virtual time and charges
durations/transfer costs.

The measurement plane is the serving system's hot loop — ``find_peak_load``
probes the simulator ~10× per verdict — so it carries the same
fast/legacy contract as the solver:

  * ``SimConfig.fast`` (default on) tabulates every node's
    duration/bandwidth curves over the (batch × placed-quota) pairs the
    run can actually hit (exact on-table, curve-call fallback off-table —
    the ``TabulatedStagePredictor`` contract), caches per-edge routing and
    mechanism-time lookups (pure functions of a fixed placement), and
    switches ``ExecCore`` to its O(1) free-list dispatch.  ``fast=False``
    restores the legacy every-event curve evaluation and linear
    free-instance scan; both paths are bit-identical and pinned in
    tests/test_measurement.py.
  * ``SimConfig.abort_over_target`` stops an *infeasibility probe* early:
    every arrival inside [warmup, duration) is eventually recorded (the
    event queue drains), so the run's final sample count is known up
    front, and once the count of over-target latencies reaches
    ``repro_torch.core.qos.abort_threshold`` the final p99 provably exceeds the
    target whatever the remaining samples are.  An exact bound, not an
    estimate: feasible runs never abort, so verdicts are unchanged.

Topology is a ``ServiceGraph`` (the paper's linear ``Pipeline`` is the
chain special case and simulates bit-for-bit as before).  Event flow per
batch: [arrive & batch at the entry queues] -> per node: wait for a free
instance -> compute (duration × contention factor) -> transfer to each
successor (mechanism-dependent, one event per out-edge) -> fan-in join at
nodes with several predecessors -> ... -> complete once every exit node
has produced the batch.
"""
from __future__ import annotations

import heapq
import itertools
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.comm import HOST_STAGED, CommModel, mechanism_time
from repro_torch.core.exec import BatchingPolicy, ExecCore
from repro_torch.core.faults import FaultSpec
from repro_torch.core.predictor import tabulate_physics
from repro_torch.core.qos import QoSTracker, abort_threshold
from repro_torch.core.types import (Allocation, DeviceSpec, ServiceGraph,
                                    Tenant, TenantSet)

#: minimum recorded latencies for a probe to count as a real measurement —
#: the single feasibility predicate shared by ``SimResult.meets_qos``,
#: ``MultiSimResult.meets_qos`` and both peak searchers
MIN_COMPLETED = 5

# event kinds (ints: cheaper records than strings; ordering is by (t, seq)
# so the code never compares kinds)
_ARRIVE, _TIMEOUT, _COMPUTE, _TRANSFER, _FAULT = 0, 1, 2, 3, 4


@dataclass
class SimConfig:
    duration: float = 20.0             # simulated seconds
    warmup: float = 2.0                # ignore latencies before this
    batch_timeout_frac: float = 0.25   # dispatch partial batch after
                                       # frac×QoS waiting
    seed: int = 0
    max_queries: int = 60_000
    contention_noise: float = 0.02
    # incremental per-device bandwidth accounting (O(1) per dispatch);
    # False restores the legacy every-instance scan — kept so the perf
    # benchmark can charge both and tests can pin their equivalence
    incremental_bw: bool = True
    # tabulated physics + cached routing + O(1) free-list dispatch; False
    # restores the legacy per-event curve evaluation and linear scan.
    # Bit-identical either way (pinned in tests/test_measurement.py).
    fast: bool = True
    # stop an infeasibility probe once the over-target latency count
    # provably pushes the final p99 over target (exact bound — see
    # repro_torch.core.qos.abort_threshold).  Off by default: an aborted run's
    # p99/completed describe a truncated timeline, so only searchers that
    # merely need the boolean verdict should enable it.
    abort_over_target: bool = False


@dataclass
class SimResult:
    p99: float
    mean_latency: float
    completed: int
    offered_qps: float
    achieved_qps: float
    qos: QoSTracker
    device_busy: Dict[int, float] = field(default_factory=dict)
    events: int = 0                    # discrete events processed (the
                                       # benchmark's sim-steps/sec basis)
    aborted: bool = False              # stopped early by abort_over_target
    failed: int = 0                    # queries lost to injected faults
    retries: int = 0                   # fault-path re-dispatches

    @property
    def normalized_p99(self) -> float:
        return self.p99 / self.qos.target if self.qos.target else 0.0

    def meets_qos(self, target: Optional[float] = None,
                  min_completed: int = MIN_COMPLETED) -> bool:
        """The feasibility predicate: p99 on target AND enough recorded
        latencies to call it a measurement (a starved run — zero samples,
        so ``p99 == 0.0`` — must read as failing, not passing).  An
        aborted run always fails: the abort bound certifies its partial
        p99 already exceeds the target."""
        t = target if target is not None else self.qos.target
        return self.qos.count() >= min_completed and self.p99 <= t


class PipelineSimulator:
    """One service on the cluster: the single-tenant special case of
    ``MultiTenantSimulator`` (which owns the event loop and the physics).
    With one tenant the multi-tenant loop's event flow and RNG draw order
    are exactly the historical single-service ones, so this delegation is
    bit-for-bit — chain simulations are pinned against a snapshot in
    the reference's tests/test_graph.py.

    The inner simulator is built once and reused across ``run`` calls, so
    its fast-path tables amortize over a peak search's ~10 probes."""

    def __init__(self, pipeline: ServiceGraph, allocation: Allocation,
                 device: DeviceSpec, comm: CommModel,
                 sim: Optional[SimConfig] = None):
        assert allocation.placement is not None, "allocation must be placed"
        self.pipeline = pipeline
        self.alloc = allocation
        self.device = device
        self.comm = comm
        self.cfg = sim if sim is not None else SimConfig()
        self._multi: Optional[MultiTenantSimulator] = None

    # ------------------------------------------------------------------

    def run(self, offered_qps: float, cfg: Optional[SimConfig] = None,
            faults: Optional[FaultSpec] = None) -> SimResult:
        if self._multi is None:
            self._multi = MultiTenantSimulator(
                TenantSet([Tenant(self.pipeline.name, self.pipeline)]),
                [self.alloc], self.device, self.comm, sim=self.cfg)
        return self._multi.run([offered_qps], cfg=cfg,
                               faults=faults).per_tenant[0]


@dataclass
class MultiSimResult:
    """Per-tenant ``SimResult``s of one shared-cluster run, plus the
    cluster-wide aggregates.  Each per-tenant result owns its OWN
    ``device_busy``/``events`` (only that tenant's compute seconds and
    events); the cluster-wide totals — which span every tenant, since
    contention is shared — live here."""
    per_tenant: List[SimResult]
    device_busy: Dict[int, float] = field(default_factory=dict)
    events: int = 0
    aborted: bool = False
    # device -> virtual time of the last successful completion on it: the
    # health monitor's heartbeat feed (a dead device's heartbeat freezes)
    heartbeats: Dict[int, float] = field(default_factory=dict)

    def meets_qos(self, targets: List[float],
                  min_completed: int = MIN_COMPLETED) -> bool:
        """True when every tenant's p99 meets its target AND actually
        completed work — a starved tenant (zero recorded latencies, so
        ``tail_latency() == 0.0``) must read as failing, not passing."""
        return all(r.meets_qos(t, min_completed=min_completed)
                   for r, t in zip(self.per_tenant, targets))


class MultiTenantSimulator:
    """N service graphs sharing ONE device pool in one virtual timeline.

    Each tenant runs its own ``ExecCore`` (its own admission, batching,
    ready queues and placement slice), but every *physical* effect is
    shared: the per-device global-memory-bandwidth aggregate that
    stretches memory-bound durations (the contention Camelot's
    Constraint-3 manages) and the per-device PCIe stream counters span all
    tenants, so co-located instances from different services slow each
    other down exactly as same-service ones do.  This is the single-
    service incremental accounting extended with a tenant axis: dispatch/release
    update the same per-device aggregate, whichever tenant's core drove
    them.

    With a single tenant the event flow, the RNG draw order and therefore
    every latency are bit-identical to ``PipelineSimulator`` (pinned in
    tests/test_multitenant.py).

    ``run`` is re-entrant: all mutable run state is local, and the
    fast-path caches (physics tables, edge routes, mechanism times) hold
    pure functions of the fixed (tenants, allocations, device, comm)
    tuple, so concurrent ``run`` calls — the parallel peak search — are
    safe and deterministic per offered load.
    """

    def __init__(self, tenants, allocations: List[Allocation],
                 device: DeviceSpec, comm: CommModel,
                 sim: Optional[SimConfig] = None):
        if not isinstance(tenants, TenantSet):
            tenants = TenantSet(tenants)
        assert len(allocations) == len(tenants.tenants)
        for a in allocations:
            assert a.placement is not None, "allocations must be placed"
        self.tenants = tenants
        self.allocs = list(allocations)
        self.device = device
        self.comm = comm
        self.cfg = sim if sim is not None else SimConfig()
        # fast-path caches — pure functions of the fixed construction
        # arguments, so they persist across runs (and benign under
        # concurrent lazy construction: values are deterministic)
        self._phys: Optional[list] = None
        self._routes: Dict[tuple, tuple] = {}
        self._mech_times: Dict[tuple, float] = {}

    # ---- fast-path physics tables ------------------------------------

    def _physics(self) -> list:
        """``_phys[ti][stage]`` maps a placed quota to ``(dur, bw)`` lists
        indexed by batch size (1..entry batch — fan-in preserves item
        counts, so no in-flight batch exceeds the admission batch size).
        Values are the ground-truth curves' own outputs at exactly the
        points the hot loop would evaluate, so lookups are bit-identical;
        anything off-table falls back to the curves."""
        if self._phys is None:
            tenants = self.tenants.tenants
            phys = []
            for ti, (t, a) in enumerate(zip(tenants, self.allocs)):
                max_b = a.stages[0].batch
                per_stage = []
                for si, placed in enumerate(a.placement.per_stage):
                    quotas = sorted({q for _, q in placed})
                    per_stage.append(tabulate_physics(
                        t.graph.nodes[si], self.device, max_b, quotas))
                phys.append(per_stage)
            self._phys = phys
        return self._phys

    def run(self, offered_qps, cfg: Optional[SimConfig] = None,
            faults: Optional[FaultSpec] = None) -> MultiSimResult:
        """Simulate one run.  ``cfg`` overrides the construction-time
        ``SimConfig`` for this call only (the peak searchers use it to
        flip ``abort_over_target`` per probe without mutating the shared
        simulator).

        ``faults`` injects a seeded :class:`FaultSpec` fault script —
        device death, straggle windows, transient stage errors — as
        first-class events.  Fault randomness draws from its OWN
        generator (``faults.seed``), never the workload RNG, so a run
        with ``faults=None`` or an empty spec is bit-identical to the
        fault-free simulator on both the fast and legacy paths."""
        cfg = cfg if cfg is not None else self.cfg
        active = faults is not None and faults.active()
        tenants = self.tenants.tenants
        nt = len(tenants)
        if np.isscalar(offered_qps):
            offered_qps = [float(offered_qps)] * nt
        assert len(offered_qps) == nt, "need one offered load per tenant"
        rng = np.random.default_rng(cfg.seed)
        fast = cfg.fast

        graphs = [t.graph for t in tenants]
        qos = [QoSTracker(g.qos_target) for g in graphs]
        batch_sizes = [a.stages[0].batch for a in self.allocs]
        cores = [ExecCore(g, a.placement,
                          BatchingPolicy(b, cfg.batch_timeout_frac
                                         * g.qos_target),
                          comm=self.comm, fast=fast)
                 for g, a, b in zip(graphs, self.allocs, batch_sizes)]
        phys = self._physics() if fast else None
        routes = self._routes
        mech_times = self._mech_times
        if fast:
            # bind each instance's (dur, bw, len) table once — the hot loop
            # then pays one attribute load instead of two dict lookups
            for ti, core in enumerate(cores):
                pt = phys[ti]
                for si, insts in enumerate(core.stage_instances):
                    tab = pt[si]
                    for inst in insts:
                        t2 = tab.get(inst.quota)
                        inst.tbl = None if t2 is None else \
                            (t2[0], t2[1], len(t2[0]))

        # ---- SHARED contention bookkeeping (the tenant axis rides on the
        # payloads; the per-device aggregates do not care which service an
        # instance belongs to) --------------------------------------------
        device_busy: Dict[int, float] = {}
        busy_t = [dict() for _ in range(nt)]    # per-tenant compute seconds
        host_streams: Dict[int, int] = {}
        dev_bw: Dict[int, float] = {}
        mem_bandwidth = self.device.mem_bandwidth

        def device_bw_load(dev: int) -> float:
            if cfg.incremental_bw:
                return dev_bw.get(dev, 0.0)
            return sum(i.bandwidth for c in cores for i in c.instances
                       if i.busy and i.device == dev)

        evq: List[Tuple] = []
        nxt = itertools.count().__next__
        heappush, heappop = heapq.heappush, heapq.heappop

        def push(t, kind, payload):
            heappush(evq, (t, nxt(), kind, payload))

        # arrivals (Poisson, one stream per tenant drawn in tenant order —
        # with one tenant this is exactly PipelineSimulator's draw order).
        # Every arrival in [warmup, duration) is eventually recorded (the
        # event queue drains, nothing is dropped), so each tenant's final
        # sample count is known now — the abort bound needs it up front.
        n_final = [0] * nt
        n_arr = [0] * nt
        for ti, qps in enumerate(offered_qps):
            n_arrivals = min(int(qps * cfg.duration) + 1, cfg.max_queries)
            gaps = rng.exponential(1.0 / max(qps, 1e-9), n_arrivals)
            at = np.cumsum(gaps)
            arr = at[at < cfg.duration]
            n_arr[ti] = int(arr.size)
            n_final[ti] = int(np.count_nonzero(arr >= cfg.warmup))
            for t in arr:
                evq.append((t, nxt(), _ARRIVE, ti))
        # ---- fault script (seeded separately — workload RNG untouched).
        # Fault events are appended AFTER the arrivals so an inactive spec
        # leaves the arrival sequence numbers, and thus pop order,
        # unchanged.
        straggle: Dict[int, float] = {}
        dead_devices: set = set()
        frng = trans = None
        if active:
            for f in faults.device_failures:
                evq.append((f.time, nxt(), _FAULT, ("die", f.device, 0.0)))
            for s in faults.straggles:
                evq.append((s.time, nxt(), _FAULT,
                            ("slow", s.device, s.factor)))
                if not math.isinf(s.until):
                    evq.append((s.until, nxt(), _FAULT,
                                ("recover", s.device, 0.0)))
            trans = faults.transient
            if trans is not None and trans.rate <= 0.0:
                trans = None
            frng = np.random.default_rng(faults.seed)
        # bulk-seeding the queue then heapifying is O(n); pop order is
        # identical to n pushes (same tuples, total order unique by seq)
        heapq.heapify(evq)
        abort_at: Optional[List[Optional[int]]] = None
        # the abort bound assumes every arrival is eventually recorded,
        # which faults break (failed queries never complete) — keep the
        # exact-counting contract by disabling it under an active script
        if cfg.abort_over_target and not active:
            abort_at = [abort_threshold(n_final[ti], qos[ti].percentile)
                        if qos[ti].window is None
                        or n_final[ti] <= qos[ti].window else None
                        for ti in range(nt)]

        # ---- physics: shared-bandwidth contention factor ----------------
        # The fast path pre-draws contention noise in chunks: a NumPy
        # Generator produces the identical stream whether drawn as scalars
        # or arrays, so chunking is bit-transparent; extra tail draws are
        # harmless (nothing reads the rng after this loop).
        inc_bw = cfg.incremental_bw
        sigma = cfg.contention_noise
        if fast:
            def _noise_stream():
                while True:
                    for x in rng.normal(0.0, sigma, 2048):
                        yield x
            noise_next = _noise_stream().__next__

        def start_compute(ti, inst, rb, now):
            b = len(rb.items)
            if fast:
                tbl = inst.tbl
                if tbl is not None and b < tbl[2]:
                    base = tbl[0][b]
                    bw = tbl[1][b]
                else:                          # off-table: curve fallback
                    prof = graphs[ti].nodes[inst.stage]
                    base = prof.duration(b, inst.quota, self.device)
                    bw = prof.bandwidth(b, inst.quota, self.device)
                inst.bandwidth = bw
                dev = inst.device
                if inc_bw:
                    total_bw = dev_bw.get(dev, 0.0) + bw
                    dev_bw[dev] = total_bw
                else:
                    total_bw = device_bw_load(dev)
                factor = total_bw / mem_bandwidth
                if factor < 1.0:
                    factor = 1.0
                dur = base * factor * (1 + abs(noise_next()))
                if straggle:
                    sf = straggle.get(dev)
                    if sf is not None:
                        dur *= sf
                device_busy[dev] = device_busy.get(dev, 0.0) + dur
                bt = busy_t[ti]
                bt[dev] = bt.get(dev, 0.0) + dur
                heappush(evq, (now + dur, nxt(), _COMPUTE,
                               (ti, inst, rb)))
                return
            prof = graphs[ti].nodes[inst.stage]
            base = prof.duration(b, inst.quota, self.device)
            inst.bandwidth = prof.bandwidth(b, inst.quota, self.device)
            if cfg.incremental_bw:
                dev_bw[inst.device] = dev_bw.get(inst.device, 0.0) \
                    + inst.bandwidth
            total_bw = device_bw_load(inst.device)
            factor = max(1.0, total_bw / mem_bandwidth)
            dur = base * factor * (1 + abs(rng.normal(
                0, cfg.contention_noise)))
            if straggle:
                sf = straggle.get(inst.device)
                if sf is not None:
                    dur *= sf
            device_busy[inst.device] = device_busy.get(inst.device, 0.0) + dur
            bt = busy_t[ti]
            bt[inst.device] = bt.get(inst.device, 0.0) + dur
            push(now + dur, _COMPUTE, (ti, inst, rb))

        def dispatch(ti, si, now):
            core = cores[ti]
            if core.ready[si]:          # skip the call for empty queues
                for inst, rb in core.dispatch_stage(si, now):
                    start_compute(ti, inst, rb, now)

        def flush(ti, now):
            core = cores[ti]
            core.form_batches(now)
            for node in core.entries:
                dispatch(ti, node, now)

        # ---- main loop ---------------------------------------------------
        completed = [0] * nt
        events = 0
        events_t = [0] * nt
        aborted = False
        warmup = cfg.warmup
        heartbeats: Dict[int, float] = {}
        n_retries = [0] * nt
        retries_left: Dict[Tuple[int, int, int], int] = {}
        while evq:
            now, _, kind, payload = heappop(evq)
            events += 1
            if kind == _ARRIVE:
                ti = payload
                events_t[ti] += 1
                core = cores[ti]
                was_empty = not core.pending
                core.pending.append((now, now))          # inlined admit
                if len(core.pending) >= batch_sizes[ti]:
                    flush(ti, now)
                elif was_empty:
                    heappush(evq, (core.batch_deadline(), nxt(), _TIMEOUT,
                                   (ti, now)))
            elif kind == _TIMEOUT:
                ti, oldest = payload
                events_t[ti] += 1
                if cores[ti].oldest_pending() == oldest:
                    flush(ti, now)
            elif kind == _COMPUTE:
                ti, inst, rb = payload
                events_t[ti] += 1
                core = cores[ti]
                if inc_bw:
                    dev_bw[inst.device] = \
                        dev_bw.get(inst.device, 0.0) - inst.bandwidth
                core.release(inst)
                u = rb.stage
                if active:
                    if rb.bid in core._abandoned:
                        dispatch(ti, u, now)     # batch already given up on
                        continue
                    if inst.dead or (trans is not None
                                     and trans.start <= now < trans.until
                                     and frng.random() < trans.rate):
                        # this execution failed: retry on a surviving
                        # instance (bounded per (batch, stage)) or abandon
                        key = (ti, rb.bid, u)
                        left = retries_left.get(key, faults.max_retries)
                        if left > 0 and core.alive_instances(u) > 0:
                            retries_left[key] = left - 1
                            n_retries[ti] += 1
                            core.ready[u].append(rb)
                        else:
                            core.abandon(rb.bid)
                        dispatch(ti, u, now)
                        continue
                heartbeats[inst.device] = now
                succs = core.succs[u]
                if succs:
                    count = len(rb.items)
                    for v in succs:
                        if fast:
                            key = (ti, u, v, count, inst.device)
                            hit = routes.get(key)
                            if hit is None:
                                route = core.route(u, count, inst.device,
                                                   dst=v)
                                hit = (route.mechanism, route.nbytes,
                                       route.mechanism == HOST_STAGED)
                                routes[key] = hit
                            mech, nbytes, used_host = hit
                        else:
                            route = core.route(u, count, inst.device,
                                               dst=v)
                            mech, nbytes = route.mechanism, route.nbytes
                            used_host = mech == HOST_STAGED
                        if used_host:
                            host_streams[inst.device] = \
                                host_streams.get(inst.device, 0) + 1
                        conc = max(host_streams.get(inst.device, 0), 1)
                        if fast:
                            mkey = (mech, nbytes, conc)
                            t = mech_times.get(mkey)
                            if t is None:
                                t = mechanism_time(self.comm, mech, nbytes,
                                                   concurrent=conc)
                                mech_times[mkey] = t
                        else:
                            t = mechanism_time(self.comm, mech, nbytes,
                                               concurrent=conc)
                        heappush(evq, (now + t, nxt(), _TRANSFER,
                                       (ti, u, v, rb.bid, rb.items,
                                        used_host, inst.device)))
                elif core.complete_exit(rb.bid, u):
                    tracker = qos[ti]
                    for at in rb.items:
                        if at >= warmup:
                            tracker.record(now - at)
                        completed[ti] += 1
                    if abort_at is not None and abort_at[ti] is not None \
                            and tracker.over_target >= abort_at[ti]:
                        aborted = True
                        break
                dispatch(ti, u, now)
            elif kind == _TRANSFER:
                ti, src, dst, bid, items, used_host, from_dev = payload
                events_t[ti] += 1
                if used_host:
                    host_streams[from_dev] = max(
                        0, host_streams.get(from_dev, 0) - 1)
                if cores[ti].deliver(src, dst, bid, items, now) is not None:
                    dispatch(ti, dst, now)
            elif kind == _FAULT:
                action, dev, factor = payload
                if action == "die":
                    dead_devices.add(dev)
                    straggle.pop(dev, None)
                    for core in cores:
                        core.kill_device(dev)
                elif action == "slow":
                    if dev not in dead_devices:
                        straggle[dev] = factor
                else:                              # "recover" from straggle
                    straggle.pop(dev, None)

        horizon = max(cfg.duration - cfg.warmup, 1e-9)
        # under a fault script, whatever arrived but never completed was
        # lost to the faults (abandoned batches, starved queues)
        failed = [n_arr[ti] - completed[ti] if active else 0
                  for ti in range(nt)]
        per_tenant = [SimResult(
            p99=qos[ti].tail_latency(),
            mean_latency=qos[ti].mean(),
            completed=completed[ti],
            offered_qps=float(offered_qps[ti]),
            achieved_qps=qos[ti].count() / horizon,
            qos=qos[ti],
            device_busy=busy_t[ti],
            events=events_t[ti],
            aborted=aborted,
            failed=failed[ti],
            retries=n_retries[ti]) for ti in range(nt)]
        return MultiSimResult(per_tenant=per_tenant, device_busy=device_busy,
                              events=events, aborted=aborted,
                              heartbeats=heartbeats)


# --------------------------------------------------------------------------
# Peak search: one shared bracketed geometric bisection
# --------------------------------------------------------------------------

def bracketed_peak_search(probe, meets, lo: float = 1.0, hi: float = 4096.0,
                          tol: float = 0.03, max_iter: int = 14,
                          seed_load: Optional[float] = None,
                          parallel: int = 1):
    """Find the highest load whose probe passes ``meets`` by geometric
    bisection of the (lo, hi) bracket — the shared engine under
    ``find_peak_load`` and ``find_joint_peak``.

    ``probe(load)`` runs one measurement and must be deterministic per
    load (each simulator run seeds its own RNG from ``SimConfig.seed``, so
    it is).  ``meets(result)`` is the feasibility verdict.

    Probes land on a FIXED geometric lattice ``L(k) = lo·(1+tol)^k``, and
    the search bisects lattice *indices* until it holds an adjacent
    (feasible, infeasible) pair.  Because the lattice is anchored at
    ``lo`` — not at whatever bracket the search currently holds — the
    returned peak is the boundary lattice point of the *system*, not of
    the search path: a blind search over the whole (lo, hi) range and a
    seeded search that starts next to the answer return the identical
    load (given per-load-deterministic probes and monotone feasibility
    across the probed points).

    ``seed_load`` — typically the allocator's own predicted peak
    (``SolveResult.load``) — is snapped to its lattice index and probed
    first, then its open-side neighbor.  An accurate prediction finishes
    in two consumed probes (the boundary pair); a wrong one costs those
    probes and index bisection proceeds on the tightened range.

    ``parallel > 1`` runs probes on a thread pool, *speculating* the
    lattice points the search might need next (both bisection children of
    the pending midpoint, the seed's neighbors) while the current point
    is consumed.  Decisions are made only from consumed probe results and
    every probe is deterministic per load, so the returned peak and
    result are identical to the sequential search — speculation only
    overlaps wall time.  ``max_iter`` counts consumed refinement probes
    (checked BEFORE probing, so the budget is exact), not speculative
    ones.

    Returns ``(peak, result-at-peak)``; ``(0.0, result)`` when even ``lo``
    fails."""
    g = 1.0 + tol
    K = max(1, math.ceil(math.log(max(hi, lo * g) / lo) / math.log(g)))
    results: Dict[int, object] = {}
    pool = ThreadPoolExecutor(max_workers=parallel) if parallel > 1 else None
    futures: Dict[int, object] = {}

    def load_at(k: int) -> float:
        return lo * g ** k

    def speculate(k: int) -> None:
        if pool is not None and 0 <= k < K \
                and k not in results and k not in futures:
            futures[k] = pool.submit(probe, load_at(k))

    def run(k: int):
        r = results.get(k)
        if r is not None:
            return r
        fut = futures.pop(k, None)
        r = fut.result() if fut is not None else probe(load_at(k))
        results[k] = r
        return r

    try:
        ks = None
        if seed_load is not None and lo < seed_load < hi:
            ks = min(max(round(math.log(seed_load / lo) / math.log(g)), 1),
                     K - 1)
            speculate(ks)
            speculate(ks + 1)
        r = run(0)
        if not meets(r):
            return 0.0, r
        klo, khi = 0, K          # L(khi) is the assumed-infeasible ceiling
        left = max_iter
        if ks is not None and left > 0:     # bracket from the prediction
            left -= 1
            if meets(run(ks)):
                klo = ks
                n = ks + 1
            else:
                khi = ks
                n = ks - 1
            speculate(n)
            if klo < n < khi and left > 0:
                left -= 1
                if meets(run(n)):
                    klo = n
                else:
                    khi = n
            # Prediction too high: walk DOWN from the seed with doubling
            # offsets (ks-2, ks-4, ks-8, ...) instead of bisecting — these
            # probes sit above the true peak, where an abort-enabled probe
            # is cheapest, the dense early offsets catch the common
            # slightly-optimistic prediction with a single full-length
            # probe, and the lattice makes the final answer independent of
            # the descent path.
            step = 2
            while khi <= ks and khi - klo > 1 and ks - step > klo \
                    and left > 0:
                n = ks - step
                left -= 1
                if meets(run(n)):
                    klo = n
                    break
                khi = n
                step *= 2
        while khi - klo > 1 and left > 0:
            kmid = (klo + khi) // 2
            c_lo, c_hi = (klo + kmid) // 2, (kmid + khi) // 2
            if kmid < c_hi < khi:
                speculate(c_hi)             # child if kmid passes — above
                                            # the peak, cheap if wasted
            if parallel > 2 and klo < c_lo < kmid:
                speculate(c_lo)             # child if kmid fails
            left -= 1
            if meets(run(kmid)):
                klo = kmid
            else:
                khi = kmid
        return load_at(klo), results[klo]
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def find_joint_peak(make_sim, targets: List[float],
                    weights: Optional[List[float]] = None, lo: float = 1.0,
                    hi: float = 4096.0, tol: float = 0.03,
                    max_iter: int = 14, seed_load: Optional[float] = None,
                    parallel: int = 1, abort: bool = False,
                    ) -> Tuple[float, MultiSimResult]:
    """Search the highest normalized load λ at which EVERY tenant meets
    its own p99 target when tenant t is offered ``λ·weights[t]`` qps
    (weights default to 1 — the joint max-peak objective's measurement
    counterpart).  ``make_sim()`` may return a shared simulator — ``run``
    is re-entrant.  ``abort=True`` flips ``SimConfig.abort_over_target``
    on per probe: infeasible probes stop at the exact counting bound, and
    since feasible probes never abort the returned peak and result are
    unchanged."""
    n = len(targets)
    weights = list(weights) if weights is not None else [1.0] * n

    def probe(lam: float) -> MultiSimResult:
        sim = make_sim()
        cfg = None
        if abort and not sim.cfg.abort_over_target:
            cfg = replace(sim.cfg, abort_over_target=True)
        return sim.run([lam * w for w in weights], cfg=cfg)

    def ok(r: MultiSimResult) -> bool:
        return r.meets_qos(targets)

    return bracketed_peak_search(probe, ok, lo=lo, hi=hi, tol=tol,
                                 max_iter=max_iter, seed_load=seed_load,
                                 parallel=parallel)


def find_peak_load(make_sim, qos_target: float, lo: float = 1.0,
                   hi: float = 4096.0, tol: float = 0.03,
                   max_iter: int = 14, seed_load: Optional[float] = None,
                   parallel: int = 1, abort: bool = False,
                   ) -> Tuple[float, SimResult]:
    """Search the highest offered QPS whose p99 meets the target (paper
    §IV-A: 'gradually increase the load until the 99%-ile latency achieves
    the QoS target').  Every query completes (the event queue drains), so
    a saturated system shows up directly as an exploding p99."""

    def probe(qps: float) -> SimResult:
        sim = make_sim()
        cfg = None
        if abort and not sim.cfg.abort_over_target:
            cfg = replace(sim.cfg, abort_over_target=True)
        return sim.run(qps, cfg=cfg)

    def ok(r: SimResult) -> bool:
        return r.meets_qos(qos_target)

    return bracketed_peak_search(probe, ok, lo=lo, hi=hi, tol=tol,
                                 max_iter=max_iter, seed_load=seed_load,
                                 parallel=parallel)
