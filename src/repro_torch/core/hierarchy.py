"""Hierarchical pod decomposition for datacenter-scale joint solves.

A flat ``MultiTenantAllocator`` anneals one decision vector over the
whole cluster — O(tenants × grid) state per candidate and a constraint
pass spanning every tenant.  At datacenter scale (hundreds of tenants,
~1k devices) the joint walk still converges, but each step pays for the
entire union graph even though Camelot's constraints are nearly
separable: tenants only interact through the shared device budget.

``HierarchicalSolver`` exploits that structure (the MISO/ParvaGPU-style
cluster decomposition over the paper's §VII solver):

  1. **Partition** — tenants are greedy-packed into pods by *weighted
     demand* (quota-per-qps from the predictors' ``quota_row`` tables:
     ``Σ_s min_p p / f_s(p)`` scaled by the tenant's weight or required
     load), balancing demand density across pods;
  2. **Coarse joint solve** — the device pool is apportioned to pods
     proportionally to packed demand (largest-remainder rounding, every
     pod keeps ≥ 1 device): the pod boundary is exactly the aggregate
     resource split a flat solve would have to discover by random walk;
  3. **Refine** — each pod runs the existing annealer
     (``SAConfig.mode`` applies: vectorized / incremental) over its
     own tenant subset and device slice, in parallel (thread pool; the
     numpy kernels release the GIL for most of their runtime);
  4. **Boundary repair** — pods only err where the partition guessed
     wrong, so a few rounds of moving one tenant from the bottleneck pod
     to the pod with the most headroom (re-solving just those two pods,
     keeping the move only if the global objective improves) recover
     most of the flat solve's coupling.

With exactly one pod the solver delegates to the flat
``MultiTenantAllocator`` verbatim — same SA stream, same result,
bit for bit — so hierarchy is strictly an opt-in scaling lever.

The joined ``SolveResult`` carries global device ids (pod-local
placements shifted by the pod's device offset), ``mode="hierarchical"``
and per-pod metadata in ``.pods`` for persistence and diagnostics.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.allocator import (MultiTenantAllocator, SAConfig,
                                        SolveResult, _remap_placement)
from repro_torch.core.comm import CommModel
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.types import (QUOTA_GRID, Allocation, DeviceSpec,
                                    Placement, PodAssignment, PodConfig,
                                    TenantSet)


def _shift_devices(alloc: Allocation, delta: int) -> Allocation:
    """Pod-local placement device ids -> global cluster ids, in place."""
    if alloc.placement is not None and delta:
        alloc.placement = Placement(per_stage=[
            [(d + delta, q) for d, q in st]
            for st in alloc.placement.per_stage])
    return alloc


class HierarchicalSolver:
    """Pod-decomposed counterpart of ``MultiTenantAllocator`` — same
    constructor shape plus a ``PodConfig``, same ``solve_max_load`` /
    ``solve_min_resource`` surface, same ``SolveResult`` contract."""

    def __init__(self, tenants, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int,
                 comm: Optional[CommModel] = None,
                 sa: Optional[SAConfig] = None,
                 pods: Optional[PodConfig] = None):
        if not isinstance(tenants, TenantSet):
            tenants = TenantSet(tenants)
        self.tenants = tenants
        self.predictor = predictor
        self.device = device
        self.n_devices = int(n_devices)
        self.comm = comm
        self.sa = sa if sa is not None else SAConfig()
        self.pods = pods if pods is not None else PodConfig(
            pod_size=max(1, self.n_devices))

    # ------------------------------------------------------------------
    # Partition: weighted demand -> tenant groups -> device apportioning
    # ------------------------------------------------------------------

    def _demands(self, batch: int,
                 loads: Optional[Sequence[float]] = None) -> np.ndarray:
        """Per-tenant quota demand: qps-normalised quota need
        ``Σ_s min_p p / f_s(p)`` over the tenant's stages, scaled by its
        weight (max-load solves) or required load (min-resource)."""
        grid = np.asarray(QUOTA_GRID)
        out = np.empty(len(self.tenants))
        stages = self.predictor.stages
        for ti, (t, off) in enumerate(zip(self.tenants.tenants,
                                          self.tenants.offsets)):
            eff = 0.0
            for i in range(t.graph.n_nodes):
                f = np.maximum(
                    np.asarray(stages[off + i].quota_row(
                        "throughput", batch, grid)), 1e-12)
                eff += float((grid / f).min())
            scale = float(loads[ti]) if loads is not None else t.weight
            out[ti] = eff * max(scale, 1e-9)
        return out

    def partition(self, batch: int,
                  loads: Optional[Sequence[float]] = None,
                  ) -> List[PodAssignment]:
        """Greedy demand packing + proportional device apportioning."""
        nt = len(self.tenants)
        n_pods = min(max(1, -(-self.n_devices // self.pods.pod_size)), nt)
        demand = self._demands(batch, loads)
        groups: List[List[int]] = [[] for _ in range(n_pods)]
        packed = np.zeros(n_pods)
        # heaviest tenants first, each onto the least-packed pod
        for ti in np.argsort(-demand, kind="stable"):
            p = int(np.argmin(packed))
            groups[p].append(int(ti))
            packed[p] += demand[ti]
        # coarse joint solve: devices ∝ pod demand, ≥1 each,
        # largest-remainder rounding to hit the budget exactly
        spare = self.n_devices - n_pods
        share = packed / max(packed.sum(), 1e-12) * spare
        base = np.floor(share).astype(int)
        rem = share - base
        for p in np.argsort(-rem, kind="stable")[:spare - int(base.sum())]:
            base[p] += 1
        counts = base + 1
        # isolation floors (lifecycle): a pod must hold at least the sum
        # of its tenants' quota floors in whole devices, or every per-pod
        # solve under it is infeasible by construction — top up deficit
        # pods from the pods with the largest surplus over their own need
        need = np.array([max(1, int(math.ceil(sum(
            self.tenants.tenants[ti].quota_floor for ti in groups[p])
            - 1e-9))) for p in range(n_pods)])
        if (counts < need).any() and need.sum() <= self.n_devices:
            for p in np.flatnonzero(counts < need):
                while counts[p] < need[p]:
                    donor = int(np.argmax(counts - need))
                    if counts[donor] - need[donor] <= 0:
                        break
                    counts[donor] -= 1
                    counts[p] += 1
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        return [PodAssignment(pod_id=p, device_start=int(starts[p]),
                              device_stop=int(starts[p] + counts[p]),
                              tenant_indices=sorted(groups[p]))
                for p in range(n_pods)]

    # ------------------------------------------------------------------

    def _pod_allocator(self, assign: PodAssignment) -> MultiTenantAllocator:
        sub = self.tenants.subset(assign.tenant_indices)
        stages = []
        for ti in assign.tenant_indices:
            off = self.tenants.offsets[ti]
            n_t = self.tenants.tenants[ti].graph.n_nodes
            stages.extend(self.predictor.stages[off:off + n_t])
        # the flat budget is `iterations` proposed mutations spread over
        # the whole union graph; a pod holding a fraction of the nodes
        # keeps the same per-node mutation density at a fraction of the
        # cost (floored so tiny pods still anneal meaningfully)
        iters = max(200, int(round(
            self.sa.iterations * len(stages) / self.tenants.n_nodes)))
        sa = replace(self.sa, iterations=iters)
        return MultiTenantAllocator(sub, PipelinePredictor(stages),
                                    self.device, assign.n_devices,
                                    comm=self.comm, sa=sa)

    def _solve_pod(self, assign: PodAssignment, batch: int, objective: str,
                   loads: Optional[Sequence[float]]) -> SolveResult:
        alloc = self._pod_allocator(assign)
        if objective == "max_load":
            return alloc.solve_max_load(batch)
        return alloc.solve_min_resource(
            batch, [loads[ti] for ti in assign.tenant_indices])

    def _solve_pods(self, assigns: List[PodAssignment], batch: int,
                    objective: str, loads) -> List[SolveResult]:
        if self.pods.parallel and len(assigns) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(assigns))) as ex:
                return list(ex.map(
                    lambda a: self._solve_pod(a, batch, objective, loads),
                    assigns))
        return [self._solve_pod(a, batch, objective, loads)
                for a in assigns]

    # ------------------------------------------------------------------

    @staticmethod
    def _global_score(results: List[SolveResult], objective: str) -> float:
        """min-over-pods for max-load (the joint objective is a min over
        tenants), -Σ quota for min-resource; -inf if any pod failed."""
        if not all(r.feasible for r in results):
            return -math.inf
        if objective == "max_load":
            return min(r.objective for r in results)
        return -sum(r.allocation.total_quota() for r in results)

    def _repair(self, assigns: List[PodAssignment],
                results: List[SolveResult], batch: int, objective: str,
                loads) -> None:
        """Boundary repair: move one tenant from the bottleneck pod to the
        pod with the most headroom and re-solve just those two pods,
        keeping the move only if the global objective improves."""
        demand = self._demands(batch, loads)
        for _ in range(max(0, self.pods.repair_rounds)):
            score = self._global_score(results, objective)
            order = sorted(
                range(len(results)),
                key=lambda p: (results[p].feasible, results[p].objective))
            b = order[0]                      # bottleneck (infeasible first)
            h = order[-1]                     # most headroom
            if b == h or len(assigns[b].tenant_indices) < 2:
                return
            # cheapest tenant to re-home relieves the bottleneck with the
            # least risk of sinking the target pod
            mv = min(assigns[b].tenant_indices, key=lambda ti: demand[ti])
            trial_b = PodAssignment(
                assigns[b].pod_id, assigns[b].device_start,
                assigns[b].device_stop,
                [ti for ti in assigns[b].tenant_indices if ti != mv])
            trial_h = PodAssignment(
                assigns[h].pod_id, assigns[h].device_start,
                assigns[h].device_stop,
                sorted(assigns[h].tenant_indices + [mv]))
            res_b, res_h = self._solve_pods([trial_b, trial_h], batch,
                                            objective, loads)
            trial = list(results)
            trial[b], trial[h] = res_b, res_h
            if self._global_score(trial, objective) > score + 1e-12:
                assigns[b], assigns[h] = trial_b, trial_h
                results[b], results[h] = res_b, res_h
            else:
                return                        # local optimum for this move

    # ------------------------------------------------------------------

    def _join(self, assigns: List[PodAssignment],
              results: List[SolveResult], batch: int, objective: str,
              t_start: float) -> SolveResult:
        feasible = all(r.feasible for r in results)
        parts: List[Optional[Allocation]] = [None] * len(self.tenants)
        for assign, res in zip(assigns, results):
            sub = self.tenants.subset(assign.tenant_indices)
            for ti, part in zip(assign.tenant_indices,
                                sub.split_allocation(res.allocation)):
                parts[ti] = _shift_devices(part, assign.device_start)
        joined = self.tenants.join_allocations(parts)
        joined.predicted_min_throughput = min(
            (r.allocation.predicted_min_throughput for r in results),
            default=0.0) if feasible else 0.0
        joined.predicted_latency = max(
            (r.allocation.predicted_latency for r in results),
            default=0.0) if feasible else float("inf")
        score = self._global_score(results, objective)
        pods_meta = [{
            "pod": assign.pod_id,
            "devices": [assign.device_start, assign.device_stop],
            "tenants": [self.tenants.tenants[ti].name
                        for ti in assign.tenant_indices],
            "objective": res.objective
            if math.isfinite(res.objective) else None,
            "feasible": res.feasible,
            "solve_time": res.solve_time,
            "mode": res.mode,
        } for assign, res in zip(assigns, results)]
        return SolveResult(
            allocation=joined, objective=score, feasible=feasible,
            solve_time=time.perf_counter() - t_start,
            iterations=self.sa.iterations,
            predictor_time=sum(r.predictor_time for r in results),
            mode="hierarchical", pods=pods_meta)

    def _solve(self, batch: int, objective: str, loads) -> SolveResult:
        t_start = time.perf_counter()
        assigns = self.partition(batch, loads)
        if len(assigns) == 1:
            # single pod: the flat joint solve verbatim (bit-for-bit),
            # annotated with the trivial decomposition
            flat = MultiTenantAllocator(self.tenants, self.predictor,
                                        self.device, self.n_devices,
                                        comm=self.comm, sa=self.sa)
            res = flat.solve_max_load(batch) if objective == "max_load" \
                else flat.solve_min_resource(batch, list(loads))
            res.pods = [{
                "pod": 0, "devices": [0, self.n_devices],
                "tenants": [t.name for t in self.tenants.tenants],
                "objective": res.objective
                if math.isfinite(res.objective) else None,
                "feasible": res.feasible, "solve_time": res.solve_time,
                "mode": res.mode,
            }]
            return res
        results = self._solve_pods(assigns, batch, objective, loads)
        self._repair(assigns, results, batch, objective, loads)
        return self._join(assigns, results, batch, objective, t_start)

    def _masked(self, device_mask, thunk) -> Optional[SolveResult]:
        """Shrink the pool to the surviving ids, run ``thunk``, remap the
        joined placement onto them (same count-shrink contract as
        ``CamelotAllocator._mask_avail`` — devices are fungible).  Pod
        metadata stays in masked index space.  None when no-op."""
        if device_mask is None:
            return None
        avail = sorted({int(d) for d in device_mask})
        assert avail, "device_mask must leave at least one device"
        assert 0 <= avail[0] and avail[-1] < self.n_devices
        if len(avail) == self.n_devices:
            return None
        saved, saved_pods = self.n_devices, self.pods
        self.n_devices = len(avail)
        self.pods = replace(saved_pods,
                            pod_size=min(saved_pods.pod_size, len(avail)))
        try:
            res = thunk()
        finally:
            self.n_devices, self.pods = saved, saved_pods
        if res.allocation is not None:
            _remap_placement(res.allocation, avail)
        return res

    def solve_max_load(self, batch: int, device_mask=None) -> SolveResult:
        """Joint Case 1 over pods: maximise ``min_t load_t / weight_t``
        (the pod-wise minimum of the per-pod objectives)."""
        masked = self._masked(device_mask,
                              lambda: self.solve_max_load(batch))
        if masked is not None:
            return masked
        res = self._solve(batch, "max_load", None)
        if res.feasible and self.tenants.utility_codes() is None:
            # predicted λ: the bracket seed (utility-shaped objectives are
            # in utility units, not qps — leave the seed unset then)
            res.load = res.objective
        return res

    def solve_min_resource(self, batch: int, loads,
                           device_mask=None) -> SolveResult:
        """Joint Case 2 over pods: minimise total quota with tenant t
        holding ``loads[t]`` qps (scalar applies to every tenant)."""
        masked = self._masked(device_mask,
                              lambda: self.solve_min_resource(batch, loads))
        if masked is not None:
            return masked
        if np.isscalar(loads):
            loads = [float(loads)] * len(self.tenants)
        assert len(loads) == len(self.tenants), \
            "need one required load per tenant"
        res = self._solve(batch, "min_resource", list(loads))
        if res.feasible:
            # sure-side weighted-λ seed (see MultiTenantAllocator)
            res.load = min(float(l) / max(w, 1e-9) for l, w in
                           zip(loads, self.tenants.weights))
        return res
