"""Camelot online runtime: load monitoring + periodic re-allocation.

The paper motivates Camelot with the diurnal load pattern of user-facing
services (§I, §VIII-C evaluates four static load levels).  This module closes
the loop: an EWMA load monitor drives the min-resource policy on a sliding
window, switching to the max-load allocation when the estimate approaches the
cluster's peak capability — the "runtime system that manages GPU resources
online" of the title.

Used by repro_torch.camelot.session and tests/test_torch_runtime.py.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core.allocator import (CamelotAllocator, MultiTenantAllocator,
                                        SAConfig, SolveResult)
from repro_torch.core.comm import CommModel
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.types import (Allocation, DeviceSpec, ServiceGraph,
                                    TenantSet)


@dataclass
class RuntimeConfig:
    reallocate_every: float = 60.0     # seconds between allocator runs
    ewma_alpha: float = 0.3            # load-estimate smoothing
    headroom: float = 1.25             # provision for estimate × headroom
    peak_switch_frac: float = 0.8      # above this fraction of peak, use
                                       # the max-load allocation outright
    warm_start: bool = True            # seed re-solves from the previous
                                       # allocation (vectorized walkers)
    history_limit: int = 4096          # ReallocationEvent ring size — a
                                       # long-lived runtime must not grow
                                       # its event log without bound


@dataclass
class ReallocationEvent:
    time: float
    load_estimate: float
    provisioned_for: float
    total_quota: float
    feasible: bool
    objective: float = 0.0             # the solve's objective at this event
    warm_started: bool = False         # previous allocation seeded the solve
    # why this re-solve happened: "load" (periodic estimate tracking),
    # "device_failure" (health monitor masked out a dead device),
    # "degraded" (surviving pool could not hold every QoS target — load
    # was shed in priority-weight order; ``shed`` names the victims), or
    # "preempted" (a load spike forced low-priority tenants down to the
    # floor so higher tiers keep their targets; ``shed`` names them)
    reason: str = "load"
    shed: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {"time": self.time, "load_estimate": self.load_estimate,
                "provisioned_for": self.provisioned_for,
                "total_quota": self.total_quota, "feasible": self.feasible,
                "objective": self.objective,
                "warm_started": self.warm_started,
                "reason": self.reason, "shed": list(self.shed)}

    @classmethod
    def from_dict(cls, d: dict) -> "ReallocationEvent":
        return cls(time=float(d["time"]),
                   load_estimate=float(d["load_estimate"]),
                   provisioned_for=float(d["provisioned_for"]),
                   total_quota=float(d["total_quota"]),
                   feasible=bool(d["feasible"]),
                   objective=float(d.get("objective", 0.0)),
                   warm_started=bool(d.get("warm_started", False)),
                   reason=str(d.get("reason", "load")),
                   shed=tuple(d.get("shed", ())))


class HealthMonitor:
    """Per-device liveness + straggle detection from completion feeds.

    The serving planes already surface the needed signal for free: the
    simulator's ``MultiSimResult.heartbeats`` (and a live engine's
    completion callbacks) record the last time each device finished work.
    ``observe`` folds those in; ``dead_devices`` flags devices whose
    heartbeat has been silent for ``heartbeat_timeout`` seconds — one
    control interval, so detection is within the interval that follows
    the failure.  A straggle score per device (EWMA of the device's
    heartbeat gap over the fleet median) flags devices slower than
    ``straggle_factor``× their peers without declaring them dead."""

    def __init__(self, devices, heartbeat_timeout: float = 1.0,
                 ewma_alpha: float = 0.3, straggle_factor: float = 3.0):
        self.devices = sorted(int(d) for d in devices)
        self.heartbeat_timeout = heartbeat_timeout
        self.ewma_alpha = ewma_alpha
        self.straggle_factor = straggle_factor
        self._last: dict = {}          # device -> last heartbeat time
        self._gap: dict = {}           # device -> EWMA heartbeat gap
        self._dead: set = set()

    def observe(self, now: float, heartbeats: dict) -> None:
        """Fold one round of completion heartbeats (device -> last
        completion time) observed at wall/virtual time ``now``."""
        a = self.ewma_alpha
        for dev, t in heartbeats.items():
            dev = int(dev)
            prev = self._last.get(dev)
            if prev is not None and t > prev:
                gap = t - prev
                old = self._gap.get(dev)
                self._gap[dev] = gap if old is None else \
                    (1 - a) * old + a * gap
            if prev is None or t > prev:
                self._last[dev] = t

    def mark_dead(self, device: int) -> None:
        self._dead.add(int(device))

    def reset_device(self, device: int) -> None:
        """Forget a device's liveness record — a restarted worker/device
        must not inherit its predecessor's silence (the process serving
        plane re-tracks a replacement worker from its spawn time)."""
        device = int(device)
        self._dead.discard(device)
        self._last.pop(device, None)
        self._gap.pop(device, None)

    def dead_devices(self, now: float) -> List[int]:
        """Devices declared dead: marked explicitly, or seen alive once
        and then silent past the heartbeat timeout.  A device that never
        produced a heartbeat is unproven, not dead."""
        out = set(self._dead)
        for dev, t in self._last.items():
            if now - t > self.heartbeat_timeout:
                out.add(dev)
        return sorted(out)

    def straggle_scores(self) -> dict:
        """Per-device EWMA heartbeat gap over the fleet median (1.0 ==
        keeping pace; > straggle_factor == straggling)."""
        if not self._gap:
            return {}
        med = float(np.median(list(self._gap.values())))
        if med <= 0.0:
            return {d: 1.0 for d in self._gap}
        return {d: g / med for d, g in self._gap.items()}

    def stragglers(self) -> List[int]:
        return sorted(d for d, s in self.straggle_scores().items()
                      if s >= self.straggle_factor)


class CamelotRuntime:
    """Online wrapper around the two allocation policies.

    ``attach_engine`` connects a live ``PipelineEngine``: every
    ``reallocate`` then pushes the fresh allocation into the running engine
    (applied between batches via ``PipelineEngine.apply_allocation``), so
    the same runtime object manages both the simulated and the live world.

    The ``repro_torch.camelot`` facade exposes this loop as
    ``CamelotSession.runtime()/observe()/reallocate()`` — prefer that entry
    point in new code; this constructor keeps its historical signature.
    """

    def __init__(self, pipeline: ServiceGraph, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int, batch: int,
                 rt: Optional[RuntimeConfig] = None,
                 sa: Optional[SAConfig] = None,
                 comm: Optional[CommModel] = None,
                 initial: Optional[SolveResult] = None):
        self.pipeline = pipeline
        self.predictor = predictor
        self.device = device
        self.n_devices = n_devices
        self.batch = batch
        # configs default per-instance: a shared mutable default would leak
        # state between runtimes
        self.rt = rt if rt is not None else RuntimeConfig()
        # comm pricing must match whatever the offline solves used — the
        # facade passes its ClusterSpec.comm_model() here
        self.comm = comm if comm is not None \
            else CommModel(device, global_memory_enabled=True)
        self.allocator = CamelotAllocator(pipeline, predictor, device,
                                          n_devices, comm=self.comm, sa=sa)
        # crash-restart: a persisted SolveResult resumes the runtime with
        # NO cold solve — the incumbent allocation is live immediately
        peak = initial if initial is not None and initial.feasible \
            else self.allocator.solve_max_load(batch)
        self.peak_result = peak
        self.peak_qps = peak.objective if peak.feasible else 0.0
        self._load_est = 0.0
        self.current: Allocation = peak.allocation
        self.last_result: SolveResult = peak
        self.history: Deque[ReallocationEvent] = \
            deque(maxlen=self.rt.history_limit)
        self._engine = None

    # ------------------------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Connect a live PipelineEngine; subsequent reallocations are
        applied to it between batches."""
        self._engine = engine

    def observe(self, qps_sample: float) -> None:
        a = self.rt.ewma_alpha
        self._load_est = (1 - a) * self._load_est + a * qps_sample

    @property
    def load_estimate(self) -> float:
        return self._load_est

    def reallocate(self, now: float) -> Allocation:
        """Re-solve for the current load estimate; returns the allocation.
        Min-resource re-solves are warm-started from the incumbent
        allocation (``rt.warm_start``): the diurnal loop revisits
        near-identical problems, so the previous solution seeds an extra
        annealing walker and the result is pinned >= the cold solve."""
        target = self._load_est * self.rt.headroom
        if self.peak_qps and \
                target >= self.rt.peak_switch_frac * self.peak_qps:
            res = self.peak_result
            alloc, provisioned, feasible = (res.allocation, self.peak_qps,
                                            res.feasible)
        else:
            res = self.allocator.solve_min_resource(
                self.batch, load=max(target, 1.0),
                warm_start=self.current if self.rt.warm_start else None)
            if res.feasible:
                alloc, provisioned, feasible = (res.allocation, target, True)
            else:                       # fall back to the peak allocation
                alloc, provisioned, feasible = (self.peak_result.allocation,
                                                self.peak_qps, False)
        self.last_result = res
        self.current = alloc
        if self._engine is not None and alloc.placement is not None:
            self._engine.apply_allocation(alloc)
        self.history.append(ReallocationEvent(
            time=now, load_estimate=self._load_est,
            provisioned_for=provisioned,
            total_quota=alloc.total_quota(), feasible=feasible,
            objective=res.objective, warm_started=res.warm_started))
        return alloc

    def on_device_failure(self, now: float, dead) -> Allocation:
        """Out-of-band recovery re-solve with the dead device(s) masked
        out, warm-started from the incumbent allocation (device ids in a
        warm ``Allocation`` are never read — only ``.stages`` — so the
        incumbent seeds the masked solve unchanged).  Falls back to the
        surviving pool's peak allocation ("degraded") when the current
        load target no longer fits."""
        if np.isscalar(dead):
            dead = [dead]
        dd = set(getattr(self, "_dead_devices", set()))
        dd.update(int(d) for d in dead)
        self._dead_devices = dd
        avail = [d for d in range(self.n_devices) if d not in dd]
        assert avail, "no surviving devices"
        warm = self.current if self.rt.warm_start else None
        peak = self.allocator.solve_max_load(self.batch, warm_start=warm,
                                             device_mask=avail)
        self.peak_result = peak
        self.peak_qps = peak.objective if peak.feasible else 0.0
        target = max(self._load_est * self.rt.headroom, 1.0)
        res = self.allocator.solve_min_resource(self.batch, load=target,
                                                warm_start=warm,
                                                device_mask=avail)
        reason = "device_failure"
        if res.feasible:
            alloc, provisioned, feasible = res.allocation, target, True
        elif peak.feasible:
            # the surviving pool cannot hold the estimate: serve what the
            # pool CAN peak at — graceful degradation, not an outage
            reason = "degraded"
            res = peak
            alloc, provisioned, feasible = (peak.allocation, self.peak_qps,
                                            False)
        else:
            alloc, provisioned, feasible = self.current, 0.0, False
        self.last_result = res
        self.current = alloc
        if self._engine is not None and alloc.placement is not None:
            self._engine.apply_allocation(alloc)
        self.history.append(ReallocationEvent(
            time=now, load_estimate=self._load_est,
            provisioned_for=provisioned, total_quota=alloc.total_quota(),
            feasible=feasible, objective=res.objective,
            warm_started=res.warm_started, reason=reason))
        return alloc

    # ------------------------------------------------------------------

    def run_trace(self, load_fn: Callable[[float], float], duration: float,
                  sample_every: float = 10.0) -> List[ReallocationEvent]:
        """Drive the runtime over a load trace load_fn(t) -> qps.

        Samples the load every ``sample_every`` s, reallocates every
        ``rt.reallocate_every`` s.  Returns the reallocation history."""
        t = 0.0
        next_realloc = 0.0
        while t < duration:
            self.observe(load_fn(t))
            if t >= next_realloc:
                self.reallocate(t)
                next_realloc = t + self.rt.reallocate_every
            t += sample_every
        return list(self.history)


class MultiTenantRuntime:
    """Online joint reallocation for N services sharing one device pool.

    The single-service loop of ``CamelotRuntime``, lifted to a
    ``TenantSet``: per-tenant EWMA load estimates drive ONE joint
    min-resource solve (every tenant's demand in the same annealing state,
    contention shared across services), warm-started from the incumbent
    joint allocation; when any tenant's normalized estimate approaches the
    joint peak capability, the max-peak allocation is used outright.
    ``attach_engine`` connects a live ``MultiTenantEngine`` — every
    reallocation pushes the service-scoped slices of the fresh joint
    allocation into it between batches.
    """

    def __init__(self, tenants, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int, batch: int,
                 rt: Optional[RuntimeConfig] = None,
                 sa: Optional[SAConfig] = None,
                 comm: Optional[CommModel] = None,
                 initial: Optional[SolveResult] = None):
        if not isinstance(tenants, TenantSet):
            tenants = TenantSet(tenants)
        self.tenants = tenants
        self.predictor = predictor
        self.device = device
        self.n_devices = n_devices
        self.batch = batch
        self.rt = rt if rt is not None else RuntimeConfig()
        self.comm = comm if comm is not None \
            else CommModel(device, global_memory_enabled=True)
        self.allocator = MultiTenantAllocator(tenants, predictor, device,
                                              n_devices, comm=self.comm,
                                              sa=sa)
        # crash-restart: a persisted SolveResult resumes the runtime with
        # NO cold solve — the incumbent joint allocation is live at once
        peak = initial if initial is not None and initial.feasible \
            else self.allocator.solve_max_load(batch)
        self.peak_result = peak
        # λ: the normalized load every tenant sustains simultaneously
        self.peak_lambda = peak.objective if peak.feasible else 0.0
        self._load_est = [0.0] * len(tenants.tenants)
        self.current: Allocation = peak.allocation
        self.last_result: SolveResult = peak
        self.history: Deque[ReallocationEvent] = \
            deque(maxlen=self.rt.history_limit)
        self._engine = None

    # ------------------------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Connect a live ``MultiTenantEngine``; subsequent joint
        reallocations are split per tenant and applied to it."""
        self._engine = engine

    def observe(self, qps_samples) -> None:
        """EWMA-update every tenant's load estimate (one sample per
        tenant, in TenantSet order)."""
        assert len(qps_samples) == len(self._load_est)
        a = self.rt.ewma_alpha
        self._load_est = [(1 - a) * est + a * s
                          for est, s in zip(self._load_est, qps_samples)]

    @property
    def load_estimates(self) -> List[float]:
        return list(self._load_est)

    def _normalized_estimate(self) -> float:
        """The binding tenant's weight-normalized load estimate (the λ the
        cluster must currently sustain)."""
        return max(est / max(t.weight, 1e-9)
                   for est, t in zip(self._load_est, self.tenants.tenants))

    def reallocate(self, now: float) -> Allocation:
        """One joint re-solve for the current per-tenant load estimates;
        returns (and pushes to an attached engine) the joint allocation."""
        targets = [est * self.rt.headroom for est in self._load_est]
        norm_target = self._normalized_estimate() * self.rt.headroom
        if self.peak_lambda and \
                norm_target >= self.rt.peak_switch_frac * self.peak_lambda:
            res = self.peak_result
            alloc, provisioned, feasible = (res.allocation, self.peak_lambda,
                                            res.feasible)
        else:
            res = self.allocator.solve_min_resource(
                self.batch, [max(t, 1.0) for t in targets],
                warm_start=self.current if self.rt.warm_start else None)
            if res.feasible:
                alloc, provisioned, feasible = (res.allocation, norm_target,
                                                True)
            else:                       # fall back to the peak allocation
                alloc, provisioned, feasible = (self.peak_result.allocation,
                                                self.peak_lambda, False)
        self.last_result = res
        self.current = alloc
        if self._engine is not None and alloc.placement is not None:
            self._engine.apply_allocations(
                self.tenants.split_allocation(alloc))
        self.history.append(ReallocationEvent(
            time=now, load_estimate=self._normalized_estimate(),
            provisioned_for=provisioned,
            total_quota=alloc.total_quota(), feasible=feasible,
            objective=res.objective, warm_started=res.warm_started))
        return alloc

    def _shed_order(self) -> List[int]:
        """Tenant indices in shed order: ascending priority tier first,
        ascending weight within a tier (stable — ties keep TenantSet
        order).  Priority 0 is the lowest tier and sheds first."""
        ts = self.tenants.tenants
        return sorted(range(len(ts)),
                      key=lambda ti: (getattr(ts[ti], "priority", 0),
                                      ts[ti].weight))

    def on_device_failure(self, now: float, dead) -> Allocation:
        """Out-of-band joint recovery: mask the dead device(s) out of the
        pool, refresh the peak capability for the survivors, and re-solve
        min-resource for the current estimates — all warm-started from
        the incumbent (a warm ``Allocation``'s device ids are never read,
        only its stage vector, so it seeds the masked solve unchanged).

        When the surviving pool cannot hold every tenant's target,
        degrade gracefully IN PRIORITY-WEIGHT ORDER: the lowest-weight
        tenant's target is shed (dropped to the 1 qps floor) first, then
        the next, until the solve goes feasible — the event records
        ``reason="degraded"`` and the shed tenant names.  Final fallback
        is the surviving pool's own peak allocation."""
        if np.isscalar(dead):
            dead = [dead]
        dd = set(getattr(self, "_dead_devices", set()))
        dd.update(int(d) for d in dead)
        self._dead_devices = dd
        avail = [d for d in range(self.n_devices) if d not in dd]
        assert avail, "no surviving devices"
        warm = self.current if self.rt.warm_start else None
        peak = self.allocator.solve_max_load(self.batch, warm_start=warm,
                                             device_mask=avail)
        self.peak_result = peak
        self.peak_lambda = peak.objective if peak.feasible else 0.0
        targets = [max(est * self.rt.headroom, 1.0)
                   for est in self._load_est]
        norm_target = self._normalized_estimate() * self.rt.headroom
        res = self.allocator.solve_min_resource(self.batch, targets,
                                                warm_start=warm,
                                                device_mask=avail)
        reason: str = "device_failure"
        shed: Tuple[str, ...] = ()
        if not res.feasible:
            order = self._shed_order()
            degraded = list(targets)
            names: List[str] = []
            for ti in order:
                if degraded[ti] <= 1.0:
                    continue             # already at the floor: no shed
                degraded[ti] = 1.0
                names.append(self.tenants.tenants[ti].name)
                res = self.allocator.solve_min_resource(
                    self.batch, degraded, warm_start=warm,
                    device_mask=avail)
                if res.feasible:
                    break
            if res.feasible:
                reason, shed = "degraded", tuple(names)
        if res.feasible:
            alloc, provisioned, feasible = res.allocation, norm_target, True
        elif peak.feasible:
            reason = "degraded"
            shed = tuple(t.name for t in self.tenants.tenants)
            res = peak
            alloc, provisioned, feasible = (peak.allocation,
                                            self.peak_lambda, False)
        else:
            alloc, provisioned, feasible = self.current, 0.0, False
        self.last_result = res
        self.current = alloc
        if self._engine is not None and alloc.placement is not None:
            self._engine.apply_allocations(
                self.tenants.split_allocation(alloc))
        self.history.append(ReallocationEvent(
            time=now, load_estimate=self._normalized_estimate(),
            provisioned_for=provisioned, total_quota=alloc.total_quota(),
            feasible=feasible, objective=res.objective,
            warm_started=res.warm_started, reason=reason, shed=shed))
        return alloc

    def preempt(self, now: float, targets: Optional[List[float]] = None
                ) -> Allocation:
        """Load-spike response: keep high-priority tenants at their
        targets by preempting low tiers.

        Tries the full target vector first; while infeasible, sheds one
        tenant at a time in strict ascending ``(priority, weight)`` order
        (dropping its target to the 1 qps floor) and re-solves, warm-
        started from the incumbent.  ``targets`` defaults to the current
        per-tenant EWMA estimates × headroom.  Feasible shed solves are
        recorded with ``reason="preempted"``; if even the all-shed vector
        cannot be served the pool's peak allocation is kept (recorded
        infeasible) so serving never stops."""
        if targets is None:
            targets = [max(est * self.rt.headroom, 1.0)
                       for est in self._load_est]
        targets = [max(float(t), 1.0) for t in targets]
        assert len(targets) == len(self.tenants.tenants)
        norm_target = max(
            t / max(ten.weight, 1e-9)
            for t, ten in zip(targets, self.tenants.tenants))
        warm = self.current if self.rt.warm_start else None
        res = self.allocator.solve_min_resource(self.batch, targets,
                                                warm_start=warm)
        reason: str = "load"
        shed: Tuple[str, ...] = ()
        if not res.feasible:
            degraded = list(targets)
            names: List[str] = []
            for ti in self._shed_order():
                if degraded[ti] <= 1.0:
                    continue             # already at the floor: no shed
                degraded[ti] = 1.0
                names.append(self.tenants.tenants[ti].name)
                res = self.allocator.solve_min_resource(
                    self.batch, degraded, warm_start=warm)
                if res.feasible:
                    break
            if res.feasible:
                reason, shed = "preempted", tuple(names)
        if res.feasible:
            alloc, provisioned, feasible = res.allocation, norm_target, True
        elif self.peak_result.feasible:
            reason = "preempted"
            shed = tuple(t.name for t in self.tenants.tenants)
            res = self.peak_result
            alloc, provisioned, feasible = (res.allocation,
                                            self.peak_lambda, False)
        else:
            alloc, provisioned, feasible = self.current, 0.0, False
        self.last_result = res
        self.current = alloc
        if self._engine is not None and alloc.placement is not None:
            self._engine.apply_allocations(
                self.tenants.split_allocation(alloc))
        self.history.append(ReallocationEvent(
            time=now, load_estimate=norm_target,
            provisioned_for=provisioned, total_quota=alloc.total_quota(),
            feasible=feasible, objective=res.objective,
            warm_started=res.warm_started, reason=reason, shed=shed))
        return alloc

    # ------------------------------------------------------------------

    def run_trace(self, load_fns, duration: float,
                  sample_every: float = 10.0) -> List[ReallocationEvent]:
        """Drive the joint loop over one load trace per tenant
        (``load_fns[t](time) -> qps``)."""
        assert len(load_fns) == len(self._load_est)
        t = 0.0
        next_realloc = 0.0
        while t < duration:
            self.observe([fn(t) for fn in load_fns])
            if t >= next_realloc:
                self.reallocate(t)
                next_realloc = t + self.rt.reallocate_every
            t += sample_every
        return list(self.history)


def diurnal_load(peak_qps: float, period: float = 86_400.0,
                 low_frac: float = 0.25) -> Callable[[float], float]:
    """Sinusoidal diurnal pattern between low_frac·peak and peak (paper §I:
    'the load of a user-facing service varies (diurnal load pattern)')."""
    amp = (1 - low_frac) / 2.0

    def fn(t: float) -> float:
        phase = np.sin(2 * np.pi * t / period - np.pi / 2)  # trough at t=0
        return peak_qps * (low_frac + amp * (1 + phase))
    return fn
