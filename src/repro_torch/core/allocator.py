"""Contention-aware resource allocation (paper §VII-B/C).

Two policies, both solved by simulated annealing over the paper's decision
vector V = [N_1..N_n, p_1..p_n]:

  * ``solve_max_load``     — maximise min_i N_i·f(p_i) (Eq. 1): the peak load
    of the pipeline is its slowest stage's aggregate throughput.
  * ``solve_min_resource`` — Eq. 2 sizes the device count
    y = max(ΣC/G, ΣM/F); Eq. 3 then minimises Σ N_i·p_i at the given load.

Constraints (Table II): total compute C·R, instance count C·I (MPS limit),
aggregate global-memory bandwidth C·BW, global-memory capacity C·F
(weights shared between same-stage co-located instances are handled by the
deployment packer), and end-to-end QoS including inter-stage communication
time under the chosen communication mechanism.

Both policies are stated over a ``ServiceGraph`` (chains included as the
degenerate DAG): Eq. 1's objective is the min aggregate throughput over
all *nodes*, and Constraint-5's end-to-end latency is the **critical
path** — the longest entry→exit path of node durations plus per-edge
transfer times (for a chain this reduces to the paper's plain sum).

``MultiTenantAllocator`` lifts both policies to N services sharing ONE
device pool (the datacenter case): the decision vector concatenates every
tenant's stages, Constraints 1–4 span the shared pool, and Constraint-5
holds per tenant against its own QoS target.

The policy hot path (``SAConfig.mode``)
---------------------------------------
Camelot is a *runtime* system: the allocator re-solves as load shifts, so
solve_time is itself a serving-path cost.  The default ``"vectorized"``
mode is population-based annealing: per temperature step it proposes a
population of K candidate moves and evaluates ALL of them against
Constraints 1–4 as batched array ops over per-solve lookup tables
(duration/bandwidth/throughput over the ``QUOTA_STEP`` quota grid — exact
on-grid, see the tabulation contract in ``predictor.py``), Constraint-5 as
one batched numpy longest-path pass over the graph's ``CompiledTopology``,
and per-device packability through a memoized quota-multiset FFD fast
path; an exhaustive 6n-neighbourhood greedy polish then runs the incumbent
to a local optimum.  ``"scalar"`` keeps the paper-faithful one-candidate-
per-iteration loop (and is the benchmark baseline in
``benchmarks/bench_alloc.py``); both modes search the identical constraint
landscape, and the regression suite pins vectorized objectives at >= the
scalar snapshots on every chain/DAG workload.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.comm import CommModel
from repro_torch.core.deployment import pack_instances
from repro_torch.core.incremental import IncrementalEvaluator
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.types import (QUOTA_GRID, QUOTA_STEP, Allocation,
                                    DeviceSpec, Placement, ServiceEdge,
                                    ServiceGraph, StageAlloc, TenantSet,
                                    apply_utility)

QUOTA_MIN = QUOTA_STEP

ANNEAL_NOT_PORTED = (
    "SAConfig.mode='jax' (the reference's jitted annealing kernel) is not "
    "ported: its torch twin is ROADMAP.md Queue A item 5, 'The torch "
    "anneal'; use mode='vectorized' or 'incremental'")


def _remap_placement(alloc: Allocation, avail: List[int]) -> Allocation:
    """Rewrite a placement solved over a dense 0..len(avail)-1 pool onto
    the surviving physical device ids (``avail`` is sorted).  In place —
    the allocation object is the solve's own output."""
    if alloc.placement is not None:
        alloc.placement = Placement(per_stage=[
            [(avail[d], q) for d, q in placed]
            for placed in alloc.placement.per_stage])
    return alloc

# per-move instance/quota-index deltas for the vectorized move kernel
# (moves 4/5 rescale the quota separately, see _apply_moves)
_MOVE_DN = np.array([1, -1, 0, 0, 1, -1], np.int64)
_MOVE_DQ = np.array([0, 0, 1, -1, 0, 0], np.int64)


@dataclass
class SAConfig:
    iterations: int = 2000
    t0: float = 1.0
    t_end: float = 1e-3
    seed: int = 0
    # disable the bandwidth constraint => Camelot-NC ablation (§VIII-D)
    bandwidth_constraint: bool = True
    # fraction of the QoS budget reserved for batching wait (the runtime
    # dispatches partial batches after ~0.25×QoS) and queueing margin; the
    # paper's Constraint-5 only sums stage durations — without this slack the
    # solver picks zero-headroom points that violate p99 under load
    qos_slack: float = 0.45
    # "vectorized": population-based annealing over batched table lookups
    # (the runtime hot path); "scalar": the paper-faithful per-candidate
    # loop, kept as compatibility mode and benchmark baseline;
    # "incremental": the vectorized walk with amortized delta evaluation
    # (core.incremental) — identical RNG stream and constraint landscape,
    # candidates are re-scored only at the mutated stages, falls back to
    # dense evaluation on graphs whose path count exceeds the cap;
    # "jax": the reference's jitted annealing kernel; not ported (its
    # torch twin is ROADMAP.md Queue A 5), so it raises
    # NotImplementedError.
    mode: str = "vectorized"
    # candidates evaluated per vectorized step (one batched _eval_many)
    population: int = 128
    # independent annealing walkers sharing that candidate budget: each
    # walker argmax-selects among population/walkers proposals and does its
    # own Metropolis accept, so the population keeps exploring distinct
    # basins instead of collapsing onto one incumbent
    walkers: int = 16
    # each candidate applies 1..max_mutations random moves (compound jumps:
    # a population step can cross several single-move hops at once, so far
    # fewer Python-level steps reach the same states as the scalar walk);
    # steps = ceil(iterations * max_mutations / population) keeps the
    # proposed-mutation budget aligned with the scalar iteration count
    max_mutations: int = 4
    # cap on greedy 6n-neighbourhood polish rounds after annealing
    polish_rounds: int = 64


def _ffd_fits(quotas: Sequence[float], n_devices: int) -> bool:
    """First-fit-decreasing feasibility: can these per-instance quotas be
    packed into ``n_devices`` bins of capacity 1.0?  (Aggregate Σ N·p ≤ C·R
    is necessary but not sufficient — paper's deployment step, §VII-D.)"""
    bins = [1.0 + 1e-9] * n_devices
    for q in sorted(quotas, reverse=True):
        for i, free in enumerate(bins):
            if free >= q:
                bins[i] = free - q
                break
        else:
            return False
    return True


def _ffd_fits_units(counts: Sequence[int], n_devices: int) -> bool:
    """``_ffd_fits`` on the integer quota lattice: ``counts[s]`` instances
    of size ``(s+1)·QUOTA_STEP`` into bins of capacity ``len(counts)``
    units.  Equal-size items placed item-by-item by FFD fill bin after bin
    greedily, so batching whole size classes per bin gives the identical
    verdict at a fraction of the per-instance loop (and exactly — no float
    tolerance needed on the lattice).  Plain-int hot loop: callers pass a
    Python list."""
    units = len(counts)
    bins = [units] * n_devices
    for s in range(units - 1, -1, -1):
        c = counts[s]
        if not c:
            continue
        size = s + 1
        for i in range(n_devices):
            free = bins[i]
            if free >= size:
                take = free // size
                if take > c:
                    take = c
                bins[i] = free - take * size
                c -= take
                if not c:
                    break
        if c:
            return False
    return True


@dataclass
class _PolicyTables:
    """Per-solve lookup tables for the vectorized hot path: every metric
    tabulated over the QUOTA_STEP quota grid per node, plus per-edge
    transfer-time constants (they depend only on the batch)."""
    grid: np.ndarray                    # (G,) quota grid
    dur: np.ndarray                     # (n, G) durations
    bw: np.ndarray                      # (n, G) bandwidth usage
    thpt: np.ndarray                    # (n, G) per-instance throughput
    foots: np.ndarray                   # (n,) memory footprints
    edge_src: np.ndarray                # (E,) edge source nodes
    edge_dst: np.ndarray                # (E,) edge destination nodes
    edge_t_colo: np.ndarray             # (E,) transfer time if co-locatable
    edge_t_host: np.ndarray             # (E,) transfer time via host


@dataclass
class SolveResult:
    allocation: Allocation
    objective: float
    feasible: bool
    solve_time: float
    iterations: int
    history: List[float] = field(default_factory=list)
    # seconds of predictor model inference charged by this solve (the
    # stages' accumulated ``predict_time`` delta) and the mode that ran
    predictor_time: float = 0.0
    mode: str = "scalar"
    # True when a previous Allocation seeded an extra annealing walker
    # (CamelotRuntime re-solves pass their incumbent as warm_start)
    warm_started: bool = False
    # set by the repro_torch.camelot facade policies: the CommModel the
    # allocation was priced against and the registry name that produced it
    comm: Optional[CommModel] = None
    policy: str = ""
    # hierarchical solves (core.hierarchy): one entry per pod with its
    # device range, tenant names and per-pod solve metrics — None for flat
    # solves.  Serialised so a saved session round-trips the decomposition.
    pods: Optional[List[dict]] = None
    # the allocator's own prediction of the load this allocation sustains
    # (max-load solves: the objective; min-resource solves: the required
    # load; joint solves: the normalized λ).  The measurement plane seeds
    # its peak-search bracket from it (``find_peak_load(seed_load=...)``)
    # instead of searching blind from (1, 4096).  None when unknown.
    load: Optional[float] = None

    # ---- dict round-trip (allocation persistence) ---------------------
    # ``comm`` and ``history`` are deliberately not serialised: the comm
    # model is cluster configuration (rebuilt from the ClusterSpec on
    # load) and the history is solve-time diagnostics.

    def to_dict(self) -> dict:
        return {
            "allocation": self.allocation.to_dict(),
            # -inf for infeasible solves; JSON has no Infinity => null
            "objective": self.objective
            if math.isfinite(self.objective) else None,
            "feasible": self.feasible,
            "solve_time": self.solve_time,
            "iterations": self.iterations,
            "predictor_time": self.predictor_time,
            "mode": self.mode,
            "warm_started": self.warm_started,
            "policy": self.policy,
            "pods": self.pods,
            "load": self.load
            if self.load is None or math.isfinite(self.load) else None,
        }

    @classmethod
    def from_dict(cls, d, comm: Optional[CommModel] = None) -> "SolveResult":
        obj = d["objective"]
        pods = d.get("pods")
        return cls(
            allocation=Allocation.from_dict(d["allocation"]),
            objective=-math.inf if obj is None else float(obj),
            feasible=bool(d["feasible"]),
            solve_time=float(d.get("solve_time", 0.0)),
            iterations=int(d.get("iterations", 0)),
            predictor_time=float(d.get("predictor_time", 0.0)),
            mode=str(d.get("mode", "scalar")),
            warm_started=bool(d.get("warm_started", False)),
            comm=comm,
            policy=str(d.get("policy", "")),
            pods=[dict(p) for p in pods] if pods is not None else None,
            load=float(d["load"]) if d.get("load") is not None else None)


class CamelotAllocator:
    def __init__(self, pipeline: ServiceGraph, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int,
                 comm: Optional[CommModel] = None,
                 sa: Optional[SAConfig] = None):
        self.pipeline = pipeline
        self.predictor = predictor
        self.device = device
        self.n_devices = n_devices
        self.comm = comm or CommModel(device)
        # per-instance default: a shared mutable SAConfig default would let
        # one allocator's tweaks (e.g. bandwidth_constraint) leak into all
        self.sa = sa if sa is not None else SAConfig()
        # vectorized-mode caches: per-batch lookup tables and the FFD
        # quota-multiset memo (packability depends only on the multiset of
        # instance quotas and the device count, so SA revisits hit).  Both
        # live for the allocator's lifetime — periodic re-solves
        # (CamelotRuntime) reuse them for free — and both are bounded
        # (LRU / FIFO eviction) so a runtime re-solving for months holds a
        # fixed worst-case footprint; ``invalidate_caches`` drops
        # everything after a predictor re-fit.
        self._tables_cache: OrderedDict = OrderedDict()
        self._ffd_memo: OrderedDict = OrderedDict()
        # multi-tenant hooks (None => the single-service behaviour, bit
        # for bit).  ``_node_norm`` divides each node's aggregate
        # throughput before the min (the weighted max-min objective over
        # tenants); ``_qos_exit_groups`` is a list of (exit-node-ids,
        # latency-target) pairs evaluating Constraint-5 per tenant over the
        # union graph instead of once over all exits.
        self._node_norm: Optional[np.ndarray] = None
        self._qos_exit_groups: Optional[list] = None
        # lifecycle hooks (both None => pre-lifecycle behaviour, bit for
        # bit).  ``_iso_bounds`` = (segment starts, floors, caps) bounds
        # each tenant's total quota as a first-class constraint;
        # ``_util_codes`` applies per-node monotone utility curves to the
        # normalized throughputs before the max-min objective.
        self._iso_bounds = None
        self._util_codes: Optional[np.ndarray] = None

    #: entries kept in the FFD memo (a long-running runtime re-solving for
    #: months must not grow without bound; one entry is ~100 B, so the cap
    #: is ~50 MB worst case).  Eviction is FIFO — oldest entries leave one
    #: at a time instead of a full clear, so a steady-state solve keeps
    #: its working set hot.
    FFD_MEMO_MAX = 500_000
    #: distinct batch sizes whose per-solve lookup tables stay cached (LRU;
    #: a table set is O(nodes × grid) floats, and runtimes only ever cycle
    #: through a handful of batch sizes)
    TABLES_CACHE_MAX = 16

    def invalidate_caches(self) -> None:
        """Drop the per-batch tables and the FFD memo.  Call after the
        predictor is re-fit (fresh profiling data): the tables hold the old
        models' outputs and have no other invalidation path."""
        self._tables_cache.clear()
        self._ffd_memo.clear()

    # ------------------------------------------------------------------
    # Constraint / objective evaluation for a candidate V
    # ------------------------------------------------------------------

    def _eval(self, ns: np.ndarray, ps: np.ndarray, batch: int,
              n_devices: int):
        """Returns (min_throughput, total_quota, latency, feasible)."""
        dev = self.device
        n = len(ns)
        stages = self.predictor.stages
        durations = np.array([stages[i].duration(batch, ps[i])
                              for i in range(n)])
        thpts = np.array([ns[i] * stages[i].throughput(batch, ps[i])
                          for i in range(n)])
        bws = np.array([ns[i] * stages[i].bandwidth(batch, ps[i])
                        for i in range(n)])
        foots = np.array([stages[i].footprint(batch) for i in range(n)])

        # Constraint-1: Σ N_i p_i <= C·R, refined to per-device packability
        if float(ns @ ps) > n_devices * 1.0 + 1e-9:
            return None
        # isolation (lifecycle): per-tenant total quota within [floor, cap]
        if self._iso_bounds is not None:
            starts, floors, caps = self._iso_bounds
            tq = np.add.reduceat(ns * ps, starts)
            if (tq < floors - 1e-9).any() or (tq > caps + 1e-9).any():
                return None
        quotas = [ps[i] for i in range(n) for _ in range(int(ns[i]))]
        if not _ffd_fits(quotas, n_devices):
            return None
        # Constraint-2: Σ N_i <= C·I
        if int(ns.sum()) > n_devices * dev.max_instances:
            return None
        # Constraint-3: Σ N_i b(p_i) <= C·BW  (Camelot-NC disables this)
        if self.sa.bandwidth_constraint and \
                float(bws.sum()) > n_devices * dev.mem_bandwidth:
            return None
        # Constraint-4: Σ N_i M(i, s) <= C·F — refined by the packer, which
        # shares same-stage weights; use the aggregate bound here.
        total_mem = float(sum(ns[i] * foots[i] for i in range(n)))
        if total_mem > n_devices * dev.mem_capacity:
            return None
        # Constraint-5 (QoS): critical path of the DAG — the longest
        # entry→exit path of node durations plus edge transfer times — must
        # fit the QoS target.  Communication on an edge uses the
        # global-memory mechanism when its endpoints can co-locate (quota
        # headroom on one device), else host.  For a chain this is exactly
        # the paper's Σ duration_i + Σ comm_i.  With per-tenant exit groups
        # (joint multi-tenant solves over a union graph) the constraint is
        # evaluated once per tenant against the tenant's own target.
        if self._qos_exit_groups is None:
            latency = self.pipeline.critical_path(
                node_cost=lambda i: float(durations[i]),
                edge_cost=lambda e: self._edge_comm_time(e, ps, batch))
            if latency > self.pipeline.qos_target * (1 - self.sa.qos_slack):
                return None
        else:
            ecosts = np.array([self._edge_comm_time(e, ps, batch)
                               for e in self.pipeline.edges])
            best = self.pipeline.critical_path_nodes(durations, ecosts)
            latency = 0.0
            for exits, target in self._qos_exit_groups:
                lt = float(best[exits].max())
                if lt > target * (1 - self.sa.qos_slack):
                    return None
                latency = max(latency, lt)
        if self._node_norm is not None:
            vals = thpts / self._node_norm
            if self._util_codes is not None:
                vals = apply_utility(vals, self._util_codes)
            return float(vals.min()), float(ns @ ps), latency
        return float(thpts.min()), float(ns @ ps), latency

    def _edge_comm_time(self, e: ServiceEdge, ps: np.ndarray,
                        batch: int) -> float:
        colocatable = (ps[e.src] + ps[e.dst]) <= 1.0 + 1e-9
        return self.comm.transfer_time(
            self.pipeline.edge_nbytes(e.src, e.dst, batch),
            same_device=colocatable and self.comm.global_memory_enabled)

    def _iso_project(self, ns: np.ndarray, ps: np.ndarray,
                     max_inst: int) -> Tuple[np.ndarray, np.ndarray]:
        """Greedily project a state into the per-tenant isolation boxes.

        Single-step SA moves cannot cross a wide infeasible band: a seed
        whose tenant total sits several lattice steps outside its
        [floor, cap] makes every one-step neighbour infeasible too, and
        the walk never leaves the seed.  Stepping quotas (then instance
        counts) toward the nearest box wall before annealing keeps the
        walk inside — or one step from — the feasible region.  No-op
        when no isolation constraint is active."""
        if self._iso_bounds is None:
            return ns, ps
        starts, floors, caps = self._iso_bounds
        ns, ps = ns.copy(), ps.copy()
        ends = list(starts[1:]) + [len(ps)]
        for a, b, floor, cap in zip(starts, ends, floors, caps):
            a, b = int(a), int(b)
            total = float(np.sum(ns[a:b] * ps[a:b]))
            while np.isfinite(cap) and total > cap + 1e-9:
                i = a + int(np.argmax(ps[a:b]))
                if ps[i] > QUOTA_MIN + 1e-12:
                    ps[i] = round(ps[i] - QUOTA_STEP, 4)
                    total -= ns[i] * QUOTA_STEP
                elif int(np.max(ns[a:b])) > 1:
                    i = a + int(np.argmax(ns[a:b]))
                    ns[i] -= 1
                    total -= ps[i]
                else:
                    break            # all at (1, QUOTA_MIN): cap infeasible
            while total < floor - 1e-9:
                below = np.flatnonzero(ps[a:b] < 1.0 - 1e-12)
                if below.size:
                    i = a + int(below[np.argmin(ps[a:b][below])])
                    step = min(QUOTA_STEP, round(1.0 - ps[i], 4))
                    ps[i] = round(ps[i] + step, 4)
                    total += ns[i] * step
                else:
                    i = a + int(np.argmin(ns[a:b]))
                    if ns[i] >= max_inst:
                        break        # box exceeds pool: floor infeasible
                    ns[i] += 1
                    total += ps[i]
        return ns, ps

    # ------------------------------------------------------------------
    # Simulated annealing core (paper §VII-C description)
    # ------------------------------------------------------------------

    #: SAConfig.mode values this allocator can run (``res.mode`` records
    #: the mode that actually executed after any fallback)
    MODES = ("scalar", "vectorized", "incremental", "jax")

    def _anneal(self, batch: int, n_devices: int, objective: str,
                required_load: Optional[float] = None,
                warm: Optional[Allocation] = None) -> SolveResult:
        mode = self.sa.mode
        assert mode in self.MODES, mode
        pt0 = self.predictor.total_predict_time() \
            if hasattr(self.predictor, "total_predict_time") else 0.0
        if mode == "jax":
            raise NotImplementedError(ANNEAL_NOT_PORTED)
        if mode != "scalar":
            res = self._anneal_vec(batch, n_devices, objective,
                                   required_load, warm=warm,
                                   incremental=(mode == "incremental"))
        else:
            # warm starts are a vectorized-population feature (an extra
            # walker); the paper-faithful scalar walk stays untouched
            res = self._anneal_scalar(batch, n_devices, objective,
                                      required_load)
            res.mode = "scalar"
        if hasattr(self.predictor, "total_predict_time"):
            res.predictor_time = self.predictor.total_predict_time() - pt0
        return res

    def _anneal_scalar(self, batch: int, n_devices: int, objective: str,
                       required_load: Optional[float] = None) -> SolveResult:
        t_start = time.perf_counter()
        rng = np.random.default_rng(self.sa.seed)
        n = self.pipeline.n_stages
        sa = self.sa

        # initial state: even allocation, one instance per stage, projected
        # into any active isolation boxes (else the walk may start stranded
        # in an infeasible band wider than one lattice step)
        ns = np.ones(n, dtype=np.int64)
        ps = np.full(n, min(1.0, n_devices / n), dtype=np.float64)
        ps = np.clip(np.round(ps / QUOTA_STEP) * QUOTA_STEP, QUOTA_MIN, 1.0)
        ns, ps = self._iso_project(ns, ps,
                                   n_devices * self.device.max_instances)

        def score(ev):
            if ev is None:
                return None
            thpt, quota, lat = ev
            if objective == "max_load":
                return thpt
            # min_resource: must still meet the required load
            if required_load is not None and thpt < required_load:
                return None
            return -quota

        best_v = (ns.copy(), ps.copy())
        cur_ev = self._eval(ns, ps, batch, n_devices)
        cur_score = score(cur_ev)
        best_score = cur_score if cur_score is not None else -math.inf
        history = []

        max_inst = n_devices * self.device.max_instances
        for it in range(sa.iterations):
            temp = sa.t0 * (sa.t_end / sa.t0) ** (it / max(sa.iterations - 1, 1))
            cand_ns, cand_ps = ns.copy(), ps.copy()
            i = int(rng.integers(n))
            # random move in one direction (paper §VII-C), plus two compound
            # scale-out/in moves that keep the total quota roughly constant
            # (otherwise quota-saturated states can only escape downhill)
            move = rng.integers(6)
            if move == 0:
                cand_ns[i] = min(cand_ns[i] + 1, max_inst)
            elif move == 1:
                cand_ns[i] = max(cand_ns[i] - 1, 1)
            elif move == 2:
                cand_ps[i] = min(round(cand_ps[i] + QUOTA_STEP, 4), 1.0)
            elif move == 3:
                cand_ps[i] = max(round(cand_ps[i] - QUOTA_STEP, 4), QUOTA_MIN)
            elif move == 4:
                # scale out: one more, proportionally smaller instances
                cand_ns[i] = min(cand_ns[i] + 1, max_inst)
                new_p = ps[i] * ns[i] / cand_ns[i]
                cand_ps[i] = max(round(new_p / QUOTA_STEP) * QUOTA_STEP,
                                 QUOTA_MIN)
            else:
                # scale in: one fewer, proportionally larger instances
                cand_ns[i] = max(cand_ns[i] - 1, 1)
                new_p = ps[i] * ns[i] / cand_ns[i]
                cand_ps[i] = min(round(new_p / QUOTA_STEP) * QUOTA_STEP, 1.0)
            ev = self._eval(cand_ns, cand_ps, batch, n_devices)
            s = score(ev)
            if s is None:
                continue
            accept = (cur_score is None or s >= cur_score
                      or rng.random() < math.exp(
                          min((s - cur_score) / max(temp * abs(cur_score)
                                                    + 1e-12, 1e-12), 0.0)))
            if accept:
                ns, ps, cur_score, cur_ev = cand_ns, cand_ps, s, ev
            if cur_score is not None and cur_score > best_score:
                best_score, best_v = cur_score, (ns.copy(), ps.copy())
            history.append(best_score)

        ns, ps = best_v
        ev = self._eval(ns, ps, batch, n_devices)
        # the incumbent must also have scored (a min-resource walk that
        # never met the required load keeps best_score=-inf: its final
        # state may satisfy Constraints 1-5 yet still miss the load)
        feasible = ev is not None and best_score > -math.inf
        alloc = Allocation(
            stages=[StageAlloc(int(ns[i]), float(ps[i]), batch)
                    for i in range(n)],
            predicted_min_throughput=ev[0] if feasible else 0.0,
            predicted_latency=ev[2] if feasible else float("inf"))
        if feasible:
            alloc.placement = pack_instances(
                alloc, self.pipeline, self.predictor, self.device, n_devices)
            feasible = alloc.placement is not None
        return SolveResult(allocation=alloc,
                           objective=best_score if feasible else -math.inf,
                           feasible=feasible,
                           solve_time=time.perf_counter() - t_start,
                           iterations=sa.iterations, history=history)

    # ------------------------------------------------------------------
    # Vectorized hot path: per-solve tables + batched candidate evaluation
    # ------------------------------------------------------------------

    def _policy_tables(self, batch: int) -> "_PolicyTables":
        """Per-(batch) lookup tables: every metric over the QUOTA_STEP grid
        for every node (one batched predictor call each — exact on-grid for
        tabulated predictors), plus per-edge transfer-time constants.
        Cached: re-solves at the same batch (diurnal tracking, Eq. 3's
        device sweep) pay zero model inference."""
        tab = self._tables_cache.get(batch)
        if tab is not None:
            self._tables_cache.move_to_end(batch)
            return tab
        grid = QUOTA_GRID
        n, g = self.pipeline.n_stages, len(grid)
        stages = self.predictor.stages
        dur = np.empty((n, g))
        bw = np.empty((n, g))
        thpt = np.empty((n, g))
        for i, st in enumerate(stages):
            dur[i] = st.quota_row("duration", batch, grid)
            bw[i] = st.quota_row("bandwidth", batch, grid)
            thpt[i] = st.quota_row("throughput", batch, grid)
        foots = np.array([st.footprint(batch) for st in stages])
        edges = self.pipeline.edges
        e_src = np.array([e.src for e in edges], np.int64)
        e_dst = np.array([e.dst for e in edges], np.int64)
        t_host = np.empty(len(edges))
        t_colo = np.empty(len(edges))
        for k, e in enumerate(edges):
            nb = self.pipeline.edge_nbytes(e.src, e.dst, batch)
            t_host[k] = self.comm.transfer_time(nb, same_device=False)
            t_colo[k] = self.comm.transfer_time(nb, same_device=True) \
                if self.comm.global_memory_enabled else t_host[k]
        tab = _PolicyTables(grid=grid, dur=dur, bw=bw, thpt=thpt,
                            foots=foots, edge_src=e_src, edge_dst=e_dst,
                            edge_t_colo=t_colo, edge_t_host=t_host)
        while len(self._tables_cache) >= self.TABLES_CACHE_MAX:
            self._tables_cache.popitem(last=False)
        self._tables_cache[batch] = tab
        return tab

    def _ffd_cached(self, counts: List[int], n_devices: int) -> bool:
        """Memoized per-device packability.  ``counts`` is the per-quota-
        level instance histogram — both the canonical multiset key
        (permuted stage assignments collapse onto one entry) and the
        integer-FFD input."""
        key = (n_devices, tuple(counts))
        hit = self._ffd_memo.get(key)
        if hit is None:
            hit = _ffd_fits_units(counts, n_devices)
            while len(self._ffd_memo) >= self.FFD_MEMO_MAX:
                self._ffd_memo.popitem(last=False)
            self._ffd_memo[key] = hit
        return hit

    def _eval_many(self, NS: np.ndarray, QI: np.ndarray,
                   tab: "_PolicyTables", n_devices: int):
        """Constraints 1–5 for K candidates at once.  Returns
        (min_throughput (K,), total_quota (K,), latency (K,),
        feasible (K,) bool) — the batched counterpart of ``_eval``."""
        dev = self.device
        k, n = NS.shape
        ar = np.arange(n)
        PS = tab.grid[QI]
        dur = tab.dur[ar, QI]                               # (K, n)
        thpt_all = NS * tab.thpt[ar, QI]
        if self._node_norm is not None:
            vals = thpt_all / self._node_norm
            if self._util_codes is not None:
                vals = apply_utility(vals, self._util_codes)
            thpt_min = vals.min(axis=1)
        else:
            thpt_min = thpt_all.min(axis=1)
        quota = (NS * PS).sum(axis=1)
        # Constraint-1 (aggregate), Constraint-2, Constraint-3, Constraint-4
        feas = quota <= n_devices * 1.0 + 1e-9
        # isolation (lifecycle): per-tenant total quota within [floor, cap]
        if self._iso_bounds is not None:
            starts, floors, caps = self._iso_bounds
            tq = np.add.reduceat(NS * PS, starts, axis=1)
            feas &= (tq >= floors - 1e-9).all(axis=1)
            feas &= (tq <= caps + 1e-9).all(axis=1)
        feas &= NS.sum(axis=1) <= n_devices * dev.max_instances
        if self.sa.bandwidth_constraint:
            feas &= (NS * tab.bw[ar, QI]).sum(axis=1) \
                <= n_devices * dev.mem_bandwidth
        feas &= (NS * tab.foots).sum(axis=1) <= n_devices * dev.mem_capacity
        # Constraint-5: one batched longest-path pass over the compiled DAG
        # (per tenant-exit-group against its own target in joint solves)
        if len(tab.edge_src):
            colo = PS[:, tab.edge_src] + PS[:, tab.edge_dst] <= 1.0 + 1e-9
            ecost = np.where(colo, tab.edge_t_colo, tab.edge_t_host)
        else:
            ecost = None
        if self._qos_exit_groups is None:
            lat = self.pipeline.critical_path_arrays(dur, ecost)
            feas &= lat <= self.pipeline.qos_target * (1 - self.sa.qos_slack)
        else:
            best = self.pipeline.critical_path_nodes(dur, ecost)
            lat = np.zeros(k)
            for exits, target in self._qos_exit_groups:
                lt = best[..., exits].max(axis=-1)
                feas &= lt <= target * (1 - self.sa.qos_slack)
                lat = np.maximum(lat, lt)
        # Constraint-1 refined (per-device packability).  Sufficient
        # condition first: FFD fills every opened bin past (1 - q_max), so
        # sum <= (1 - q_max)·D always packs — those rows skip the real FFD.
        # Survivors build their per-quota-level instance histograms in ONE
        # scatter-add, then hit the memoized integer-FFD check.
        q_max = PS.max(axis=1)
        rows = np.flatnonzero(feas & (quota > (1.0 - q_max) * n_devices))
        if rows.size:
            hist = np.zeros((len(rows), len(tab.grid)), np.int64)
            np.add.at(hist, (np.arange(len(rows))[:, None], QI[rows]),
                      NS[rows])
            for j, counts in zip(rows, hist.tolist()):
                feas[j] = self._ffd_cached(counts, n_devices)
        return thpt_min, quota, lat, feas

    @staticmethod
    def _apply_moves(NS: np.ndarray, QI: np.ndarray, rows: np.ndarray,
                     i: np.ndarray, mv: np.ndarray, max_inst: int,
                     g: int) -> None:
        """Apply move ``mv[r]`` to stage ``i[r]`` of candidate row
        ``rows[r]``, in place.  Moves mirror the scalar neighbourhood: ±1
        instance, ±1 quota step, and the two quota-preserving scale-out/in
        compounds."""
        cn, cq = NS[rows, i], QI[rows, i]
        # instance delta per move type (0: +1, 1: -1, 4: scale-out, 5: in)
        tn = np.clip(cn + _MOVE_DN[mv], 1, max_inst)
        tq = cq + _MOVE_DQ[mv]
        scaled = mv >= 4             # rescale quota to keep N·p ~constant
        if scaled.any():
            tq[scaled] = np.rint(
                (cq[scaled] + 1) * cn[scaled] / tn[scaled]).astype(
                    np.int64) - 1
        NS[rows, i] = tn
        QI[rows, i] = np.clip(tq, 0, g - 1)

    def _neighbourhood(self, ns: np.ndarray, qi: np.ndarray, max_inst: int,
                       g: int):
        """Every single-stage move from one state: the full 6n candidate
        fan used by the greedy polish."""
        n = len(ns)
        NS = np.repeat(ns[None], 6 * n, axis=0)
        QI = np.repeat(qi[None], 6 * n, axis=0)
        r = np.arange(6 * n)
        self._apply_moves(NS, QI, r, r % n, r // n, max_inst, g)
        return NS, QI

    def _polish(self, ns: np.ndarray, qi: np.ndarray, score: float,
                scores, tab: "_PolicyTables", n_devices: int, max_inst: int,
                g: int, history: List[float], engine=None):
        """Greedy polish of one incumbent: exhaust its 6n single-move
        neighbourhood until locally optimal (cheap — one batched eval per
        round).  Ties on the objective break towards LOWER total quota:
        plateau moves (e.g. scale-out at unchanged min-throughput) free
        quota that later rounds spend on the bottleneck stage, and
        strictly decreasing quota on plateaus rules out cycles.
        Deterministic (no RNG); returns (ns, qi, score).  With an
        ``engine`` (IncrementalEvaluator) each neighbour is scored by
        single-stage delta against the incumbent instead of a full dense
        pass — the 6n fan shares everything but one stage with it."""
        if not np.isfinite(score):
            return ns, qi, score
        best_quota = float((ns * tab.grid[qi]).sum())
        nb_base = None
        for _ in range(max(0, self.sa.polish_rounds)):
            NS, QI = self._neighbourhood(ns, qi, max_inst, g)
            if engine is not None:
                if nb_base is None:
                    nb_base = np.zeros(len(NS), np.int64)
                engine.rebase(ns[None], qi[None])
                ev = engine.eval(NS, QI, nb_base)
            else:
                ev = self._eval_many(NS, QI, tab, n_devices)
            s = scores(ev)
            j = int(np.argmax(s))
            if np.isfinite(s[j]) and s[j] > score + 1e-12:
                pass                                 # strict improvement
            else:
                ties = np.flatnonzero(
                    np.isfinite(s) & (s >= score - 1e-12))
                if not ties.size:
                    break
                j = int(ties[np.argmin(ev[1][ties])])
                if ev[1][j] >= best_quota - 1e-12:
                    break                            # local optimum
            score = float(s[j])
            best_quota = float(ev[1][j])
            ns, qi = NS[j].copy(), QI[j].copy()
            history.append(score)
        return ns, qi, score

    def _seed_walkers(self, tab: "_PolicyTables", n_devices: int, w: int,
                      g: int, max_inst: int):
        """Initial population shared by the vectorized and jitted kernels:
        walker 0 is the scalar path's even init, a few walkers are
        closed-form throughput-balanced seeds (argmax f/p grid level,
        N_i ∝ 1/f_i), and the rest spread across the quota grid at the
        device-saturating instance count (see the _anneal_vec comment)."""
        n = self.pipeline.n_stages
        p0 = min(1.0, n_devices / n)
        qi0 = int(np.clip(round(p0 / QUOTA_STEP), 1, g)) - 1
        levels = np.round(np.linspace(0, qi0, w)).astype(np.int64)
        levels[0] = qi0                      # walker 0 = scalar init
        QI_cur = np.repeat(levels[:, None], n, axis=1)
        NS_cur = np.clip(n_devices // (n * tab.grid[QI_cur]), 1,
                         max_inst).astype(np.int64)
        NS_cur[0] = 1
        eff_qi = np.argmax(tab.thpt / tab.grid, axis=1)
        for wi, off in zip(range(1, w), range(0, 4)):
            qi_b = np.clip(eff_qi + off, 0, g - 1)
            f = tab.thpt[np.arange(n), qi_b]
            t_bal = n_devices / (tab.grid[qi_b] / f).sum()
            QI_cur[wi] = qi_b
            NS_cur[wi] = np.clip(np.rint(t_bal / f).astype(np.int64), 1,
                                 max_inst)
        return NS_cur, QI_cur

    def _anneal_vec(self, batch: int, n_devices: int, objective: str,
                    required_load: Optional[float] = None,
                    warm: Optional[Allocation] = None,
                    incremental: bool = False) -> SolveResult:
        t_start = time.perf_counter()
        sa = self.sa
        rng = np.random.default_rng(sa.seed)
        n = self.pipeline.n_stages
        tab = self._policy_tables(batch)
        g = len(tab.grid)
        max_inst = n_devices * self.device.max_instances
        # amortized delta evaluation (mode "incremental"): same RNG stream
        # and constraint landscape as the dense walk; graphs past the path
        # cap fall back to dense evaluation transparently
        engine = None
        if incremental:
            engine = IncrementalEvaluator(self, tab, n_devices)
            if not engine.usable:
                engine = None

        def scores(ev):
            thpt, quota, lat, feas = ev
            if objective == "max_load":
                return np.where(feas, thpt, -np.inf)
            s = np.where(feas, -quota, -np.inf)
            if required_load is not None:
                s = np.where(thpt >= required_load, s, -np.inf)
            return s

        # population: W independent walkers with diversified seeds.
        # Walker 0 starts from the scalar path's initial state (even
        # allocation, one instance per stage); a few walkers start from
        # closed-form throughput-BALANCED seeds — per stage the most
        # quota-efficient grid level (argmax f/p, shifted for variety) with
        # instance counts sized so every stage's aggregate throughput is
        # equal and the quota budget is spent (N_i ∝ 1/f_i) — and the rest
        # are spread across the quota grid at the device-saturating
        # instance count.  The many-instances-at-small-quota optima are a
        # long random walk from the even init but one hop from these seeds;
        # a seed that violates a constraint still works (its walker simply
        # accepts the first feasible mutation it proposes).
        k = max(1, int(sa.population))
        w = int(np.clip(sa.walkers, 1, k))
        c = max(1, k // w)                   # proposals per walker per step
        n_mut = max(1, int(sa.max_mutations))
        NS_cur, QI_cur = self._seed_walkers(tab, n_devices, w, g, max_inst)
        # warm start (diurnal re-solves): ONE extra walker seeded from the
        # previous allocation, drawing from its OWN RNG stream.  The base
        # walkers consume exactly the draws of a cold solve, so their
        # trajectories — and hence the cold incumbent — stay bit-identical
        # with or without the warm walker; the warm walker only ever ADDS
        # explored states, and both incumbents get the deterministic greedy
        # polish at the end, so a warm-started re-solve can never return a
        # worse objective than the cold solve it replaces.
        n_warm = 0
        if warm is not None and len(warm.stages) == n:
            wns = np.clip(np.array([s.n_instances for s in warm.stages],
                                   np.int64), 1, max_inst)
            wqi = np.clip(np.rint(np.array(
                [s.quota for s in warm.stages]) / QUOTA_STEP).astype(
                    np.int64) - 1, 0, g - 1)
            NS_cur = np.vstack([NS_cur, wns[None]])
            QI_cur = np.vstack([QI_cur, wqi[None]])
            n_warm = 1
        rng_w = np.random.default_rng(sa.seed + 0x7A31)
        w_all = w + n_warm
        base_rows = w * c                    # candidate rows of base walkers

        # fallback incumbent for infeasible min-resource solves: the
        # highest-throughput state that meets Constraints 1–5 regardless of
        # the required load.  An infeasible Eq. 2 ladder rung returns it as
        # its allocation, so the next rung warm-starts from the closest
        # miss instead of re-annealing cold.
        track_fb = objective != "max_load"
        fb_score = -math.inf
        fb_ns = fb_qi = None

        def _track_fb(ev, NS_, QI_):
            nonlocal fb_score, fb_ns, fb_qi
            cand = np.where(ev[3], ev[0], -np.inf)
            j = int(np.argmax(cand))
            if cand[j] > fb_score:
                fb_score = float(cand[j])
                fb_ns, fb_qi = NS_[j].copy(), QI_[j].copy()

        ev0 = self._eval_many(NS_cur, QI_cur, tab, n_devices)
        if track_fb:
            _track_fb(ev0, NS_cur, QI_cur)
        if engine is not None:
            engine.rebase(NS_cur, QI_cur)
        cur = scores(ev0)
        j0 = int(np.argmax(cur))
        best_ns, best_qi = NS_cur[j0].copy(), QI_cur[j0].copy()
        best_score = float(cur[j0])
        # the cold incumbent: best over base walkers only (== the whole
        # population when no warm seed was injected)
        jb0 = int(np.argmax(cur[:w]))
        base_ns, base_qi = NS_cur[jb0].copy(), QI_cur[jb0].copy()
        base_score = float(cur[jb0])
        history: List[float] = []
        wr = np.arange(w_all)
        cand_base = np.repeat(wr, c)         # candidate row -> base walker

        # align the proposed-mutation budget with the scalar iteration count
        steps = max(1, -(-sa.iterations * n_mut // (w * c)))  # ceil division
        for it in range(steps):
            temp = sa.t0 * (sa.t_end / sa.t0) ** (it / max(steps - 1, 1))
            NS = np.repeat(NS_cur, c, axis=0)        # (W·C, n), walker-major
            QI = np.repeat(QI_cur, c, axis=0)
            # compound candidates: each row stacks 1..max_mutations random
            # single moves, so one population step can jump several hops of
            # the scalar walk at once.  Base walkers draw from ``rng``
            # (cold-solve stream), the warm walker from ``rng_w``.
            muts = np.empty(w_all * c, np.int64)
            muts[:base_rows] = rng.integers(1, n_mut + 1, size=base_rows)
            if n_warm:
                muts[base_rows:] = rng_w.integers(1, n_mut + 1,
                                                  size=n_warm * c)
            for t in range(n_mut):
                rows = np.flatnonzero(muts > t)
                if not len(rows):
                    break
                base = rows[rows < base_rows]
                if len(base):
                    self._apply_moves(NS, QI, base,
                                      rng.integers(n, size=len(base)),
                                      rng.integers(6, size=len(base)),
                                      max_inst, g)
                wrows = rows[rows >= base_rows]
                if len(wrows):
                    self._apply_moves(NS, QI, wrows,
                                      rng_w.integers(n, size=len(wrows)),
                                      rng_w.integers(6, size=len(wrows)),
                                      max_inst, g)
            if engine is not None:
                ev = engine.eval(NS, QI, cand_base)
            else:
                ev = self._eval_many(NS, QI, tab, n_devices)
            if track_fb:
                _track_fb(ev, NS, QI)
            s_flat = scores(ev)
            s = s_flat.reshape(w_all, c)
            # candidate selection anneals from explorative to greedy: while
            # hot, a walker Metropolis-tests a RANDOM feasible proposal
            # (the scalar walk's behaviour — argmax here would commit every
            # walker to the nearest basin); when cold it takes its best
            jc = np.argmax(s, axis=1)                # per-walker best
            explore = np.empty(w_all, bool)
            explore[:w] = rng.random(w) < min(temp, 1.0)
            if n_warm:
                explore[w:] = rng_w.random(n_warm) < min(temp, 1.0)
            jr = jc.copy()
            if explore[:w].any():
                jr[:w] = rng.integers(c, size=w)
            if n_warm:
                jr[w:] = rng_w.integers(c, size=n_warm)
            # fall back to argmax when the random pick is infeasible
            jc = np.where(explore & np.isfinite(s[wr, jr]), jr, jc)
            sj = s[wr, jc]
            picked = wr * c + jc
            # vectorized Metropolis per walker (a walker whose current
            # state is infeasible accepts any feasible candidate)
            finite = np.isfinite(sj)
            cur_ok = np.isfinite(cur)
            cur_safe = np.where(cur_ok, cur, 0.0)
            gap = np.where(cur_ok, sj - cur_safe, np.inf)
            with np.errstate(invalid="ignore"):
                prob = np.exp(np.minimum(
                    gap / np.maximum(temp * np.abs(cur_safe) + 1e-12,
                                     1e-12), 0.0))
            u = np.empty(w_all)
            u[:w] = rng.random(w)
            if n_warm:
                u[w:] = rng_w.random(n_warm)
            accept = finite & ((gap >= 0) | (u < prob))
            rows = picked[accept]
            NS_cur[accept] = NS[rows]
            QI_cur[accept] = QI[rows]
            cur[accept] = sj[accept]
            if engine is not None and rows.size:
                engine.commit(np.flatnonzero(accept), rows)
            # best-so-far tracks the whole evaluated population, not just
            # the walker-picked rows — exploration picks discard strong
            # candidates for the WALKER state, never for the incumbent
            jb = int(np.argmax(s_flat))
            if np.isfinite(s_flat[jb]) and (s_flat[jb] > best_score
                                            or not np.isfinite(best_score)):
                best_score = float(s_flat[jb])
                best_ns, best_qi = NS[jb].copy(), QI[jb].copy()
            jbb = int(np.argmax(s_flat[:base_rows]))
            if np.isfinite(s_flat[jbb]) and (s_flat[jbb] > base_score
                                             or not np.isfinite(base_score)):
                base_score = float(s_flat[jbb])
                base_ns, base_qi = NS[jbb].copy(), QI[jbb].copy()
            history.append(best_score)

        # greedy polish of the incumbent(s).  A warm-started solve polishes
        # BOTH the overall incumbent and the cold (base-walker) incumbent
        # and keeps the winner: polish is deterministic, so the runner-up
        # branch reproduces the cold solve's final state exactly and the
        # warm result is >= it by construction.
        best_ns, best_qi, best_score = self._polish(
            best_ns, best_qi, best_score, scores, tab, n_devices, max_inst,
            g, history, engine=engine)
        if n_warm:
            base_ns, base_qi, base_score = self._polish(
                base_ns, base_qi, base_score, scores, tab, n_devices,
                max_inst, g, history, engine=engine)
            better = base_score > best_score + 1e-12
            if not better and np.isfinite(base_score) and \
                    abs(base_score - best_score) <= 1e-12:
                # tie-break as the polish does: lower total quota wins
                better = float((base_ns * tab.grid[base_qi]).sum()) < \
                    float((best_ns * tab.grid[best_qi]).sum()) - 1e-12
            if better:
                best_ns, best_qi, best_score = base_ns, base_qi, base_score

        # a solve whose incumbent never scored (min-resource rung that
        # cannot meet the load) is infeasible even when the state it is
        # left holding satisfies Constraints 1–5; it hands back the
        # fallback incumbent so ladder callers can warm-seed the next rung
        scored = np.isfinite(best_score)
        if not scored and fb_ns is not None:
            best_ns, best_qi = fb_ns, fb_qi
        ns, ps = best_ns, tab.grid[best_qi]
        thpt, quota, lat, feas = self._eval_many(
            best_ns[None], best_qi[None], tab, n_devices)
        feasible = bool(feas[0]) and scored
        alloc = Allocation(
            stages=[StageAlloc(int(ns[i]), float(ps[i]), batch)
                    for i in range(n)],
            predicted_min_throughput=float(thpt[0]) if feasible else 0.0,
            predicted_latency=float(lat[0]) if feasible else float("inf"))
        if feasible:
            alloc.placement = pack_instances(
                alloc, self.pipeline, self.predictor, self.device, n_devices)
            feasible = alloc.placement is not None
        return SolveResult(allocation=alloc,
                           objective=best_score if feasible else -math.inf,
                           feasible=feasible,
                           solve_time=time.perf_counter() - t_start,
                           iterations=sa.iterations, history=history,
                           mode="incremental" if engine is not None
                           else "vectorized",
                           warm_started=bool(n_warm))

    # ------------------------------------------------------------------
    # Device masking (fault recovery: solve over the surviving pool)
    # ------------------------------------------------------------------

    def _mask_avail(self, device_mask) -> Optional[List[int]]:
        """Normalise a ``device_mask`` (iterable of AVAILABLE device ids)
        to a sorted list, or None when it is a no-op (no mask, or the full
        pool).  Devices are fungible in Constraints 1–5, so masking is a
        count shrink plus a placement-id remap — every solver mode
        (scalar, vectorized, incremental, jax, hierarchical) inherits it
        through ``n_devices``."""
        if device_mask is None:
            return None
        avail = sorted({int(d) for d in device_mask})
        assert avail, "device_mask must leave at least one device"
        assert 0 <= avail[0] and avail[-1] < self.n_devices, \
            f"device_mask {avail} outside pool of {self.n_devices}"
        if len(avail) == self.n_devices:
            return None
        return avail

    def _solve_masked(self, avail: List[int], thunk) -> SolveResult:
        """Run ``thunk`` (a zero-arg solve) with the pool shrunk to
        ``len(avail)`` devices, then remap the dense placement ids
        0..len(avail)-1 back onto the surviving physical ids."""
        saved = self.n_devices
        self.n_devices = len(avail)
        try:
            res = thunk()
        finally:
            self.n_devices = saved
        if res.allocation is not None:
            _remap_placement(res.allocation, avail)
        return res

    # ------------------------------------------------------------------
    # Public policies
    # ------------------------------------------------------------------

    def solve_max_load(self, batch: int,
                       warm_start: Optional[Allocation] = None,
                       device_mask=None) -> SolveResult:
        """Case 1 (Eq. 1): maximise the peak supported load.
        ``warm_start`` seeds the vectorized search from a previous
        allocation (periodic re-solves).  ``device_mask`` restricts the
        solve to the given available device ids (fault recovery)."""
        avail = self._mask_avail(device_mask)
        if avail is not None:
            return self._solve_masked(
                avail, lambda: CamelotAllocator.solve_max_load(
                    self, batch, warm_start=warm_start))
        res = self._anneal(batch, self.n_devices, "max_load",
                           warm=warm_start)
        if res.feasible and self._util_codes is None:
            # predicted peak: the bracket seed.  With non-linear utility
            # curves the objective is in utility units, not qps — leave
            # ``load`` unset rather than seed the bracket off-scale.
            res.load = res.objective
        return res

    def min_devices(self, batch: int, load: float) -> int:
        """Eq. 2: y = max(ΣC(i,s)/G, ΣM(i,s)/F) scaled to the target load.
        With a per-node normalisation vector (joint multi-tenant solves)
        node i's demand is sized for its own tenant's load."""
        dev = self.device
        n = self.pipeline.n_stages
        norm = self._node_norm if self._node_norm is not None else np.ones(n)
        # FLOP/s demand at `load` qps across stages
        flops_demand = sum(self.predictor.stages[i].flops(batch) / batch
                           * load * norm[i] for i in range(n))
        mem_demand = sum(self.predictor.stages[i].footprint(batch)
                         for i in range(n))
        y = max(flops_demand / dev.peak_flops,
                mem_demand / dev.mem_capacity)
        return max(1, int(math.ceil(y - 1e-9)))

    def _min_rung_bound(self, batch: int, load: float) -> int:
        """Certified lower bound on the feasible Eq. 2 ladder rung, from
        one vectorized pass over the per-solve tables (vectorized mode's
        batched rung eliminator).

        Any allocation supporting ``load`` must give every node i an
        aggregate throughput N_i·f_i(p_i) ≥ load_i with p_i on the quota
        grid, so per node: quota N_i·p_i ≥ load_i·min_p(p/f_i(p)),
        instances N_i ≥ load_i/max_p f_i(p) (and ≥ 1), bandwidth
        N_i·b_i(p_i) ≥ load_i·min_p(b_i(p)/f_i(p)), memory N_i·M_i.
        Summing and dividing by the per-device capacities bounds the
        smallest rung any candidate — not just the walker seeds — could be
        feasible at; rungs below it are eliminated without annealing.
        The bound is exact w.r.t. the same tables ``_eval_many`` checks."""
        dev = self.device
        tab = self._policy_tables(batch)
        n = self.pipeline.n_stages
        norm = self._node_norm if self._node_norm is not None else np.ones(n)
        loads = load * norm                                   # (n,)
        f = np.maximum(tab.thpt, 1e-12)                       # (n, G)
        n_lb = np.maximum(1.0, loads / f.max(axis=1))         # instances
        quota_lb = np.maximum(loads * (tab.grid / f).min(axis=1),
                              QUOTA_MIN).sum()
        inst_lb = n_lb.sum()
        mem_lb = (n_lb * tab.foots).sum()
        y = max(quota_lb,
                inst_lb / dev.max_instances,
                mem_lb / dev.mem_capacity)
        if self.sa.bandwidth_constraint:
            bw_lb = (loads * (tab.bw / f).min(axis=1)).sum()
            y = max(y, bw_lb / dev.mem_bandwidth)
        return max(1, int(math.ceil(y - 1e-9)))

    def solve_min_resource(self, batch: int, load: float,
                           warm_start: Optional[Allocation] = None,
                           device_mask=None,
                           min_rung: Optional[int] = None) -> SolveResult:
        """Case 2 (Eq. 2 + Eq. 3): minimise resource usage at ``load`` qps.

        Vectorized mode sweeps the Eq. 2 device ladder in two moves: a
        batched table pass (``_min_rung_bound``) eliminates provably
        infeasible rungs wholesale, and each remaining infeasible rung
        hands its best incumbent (the highest-throughput state meeting
        Constraints 1–5) forward as the next rung's warm seed instead of
        re-annealing cold.  ``warm_start`` seeds the first rung with a
        previous allocation (diurnal re-solves revisit near-identical
        problems, so the incumbent is usually one polish away); scalar
        mode keeps the paper-faithful sequential ``y += 1`` climb.
        ``min_rung`` floors the ladder start — the feasible region at
        rung y is a subset of rung y+1's, so skipping rungs never costs
        feasibility (the lifecycle admission path uses it to skip rungs
        below the incumbents' committed footprint)."""
        avail = self._mask_avail(device_mask)
        if avail is not None:
            return self._solve_masked(
                avail, lambda: CamelotAllocator.solve_min_resource(
                    self, batch, load, warm_start=warm_start,
                    min_rung=min_rung))
        y = self.min_devices(batch, load)
        if self._iso_bounds is not None:
            # every tenant's quota floor must fit inside the rung's quota
            # budget (Σ floors <= Σ quota <= y) — a certified bound
            floors = self._iso_bounds[1]
            y = max(y, int(math.ceil(float(floors.sum()) - 1e-9)))
        if min_rung is not None:
            y = max(y, min(int(min_rung), self.n_devices))
        vec = self.sa.mode != "scalar"
        if vec:
            y = max(y, self._min_rung_bound(batch, load))
        warm = warm_start
        res = None
        while y <= self.n_devices:
            res = self._anneal(batch, y, "min_resource", required_load=load,
                               warm=warm)
            if res.feasible:
                res.load = load          # supported by construction: the
                return res               # peak-search bracket seed
            # carry the rung's fallback incumbent forward (vectorized
            # mode): it already chases the load under Constraints 1–5, so
            # the next (looser) rung polishes it instead of rediscovering
            # the basin.  The scalar walk stays paper-faithful and cold.
            if vec and res.allocation.stages:
                warm = res.allocation
            y += 1   # infeasible at y: grow (Eq. 2 is a lower bound)
        if res is not None:
            return res
        # the ladder never ran: the Eq. 2 bound already exceeds the
        # cluster — report the (infeasible) best effort at full size
        return self._anneal(batch, self.n_devices, "min_resource",
                            required_load=load, warm=warm)


class MultiTenantAllocator(CamelotAllocator):
    """Joint contention-aware allocation for a ``TenantSet`` sharing ONE
    device pool (the datacenter case the paper targets: many microservice
    pipelines co-located on spatially-shared accelerators).

    The decision vector concatenates every tenant's stage vector — the
    union-graph node namespace of ``TenantSet`` — so one annealing state
    covers all services.  Constraints 1–4 are evaluated over the shared
    pool: co-located instances from *different* services contend for
    compute quota, MPS instance slots, global-memory bandwidth and
    capacity exactly like same-service ones, and the FFD packer sees the
    combined quota multiset.  Constraint-5 is evaluated per tenant (each
    service's own critical path against its own QoS target).

      * ``solve_max_load``     — joint Case 1: maximise
        ``min_t load_t / weight_t``, the best normalized load every tenant
        can sustain simultaneously (objective value = that λ; tenant t
        then supports ``λ·weight_t`` qps).
      * ``solve_min_resource`` — joint Case 2: minimise total quota while
        tenant t supports ``loads[t]`` qps, over the shared Eq. 2 ladder.
    """

    def __init__(self, tenants, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int,
                 comm: Optional[CommModel] = None,
                 sa: Optional[SAConfig] = None):
        if not isinstance(tenants, TenantSet):
            tenants = TenantSet(tenants)
        super().__init__(tenants.union_graph, predictor, device, n_devices,
                         comm=comm, sa=sa)
        self.tenants = tenants
        self._weight_nodes = tenants.node_values(tenants.weights)
        self._node_norm = self._weight_nodes
        self._qos_exit_groups = [
            (exits, t.qos_target)
            for exits, t in zip(tenants.exit_groups, tenants.tenants)]
        # lifecycle constraints lowered from the tenant set (both None
        # for plain tenants — the pre-lifecycle bit-parity gate)
        self._iso_bounds = tenants.iso_bounds()
        self._util_codes = tenants.utility_codes()

    def solve_min_resource(self, batch: int, loads,
                           warm_start: Optional[Allocation] = None,
                           device_mask=None,
                           min_rung: Optional[int] = None) -> SolveResult:
        """Joint Eq. 2 + Eq. 3: ``loads`` is one required qps per tenant
        (a scalar applies to every tenant).  The solve normalises each
        node's throughput by its tenant's load, so the shared ladder and
        annealer run with required_load=1.0.  ``device_mask`` restricts
        the solve to the surviving pool (fault recovery); ``min_rung``
        floors the Eq. 2 ladder start (lifecycle admission).  Utility
        curves only shape the max-peak objective — feasibility at fixed
        loads is load-threshold semantics, so they are suspended here."""
        avail = self._mask_avail(device_mask)
        if avail is not None:
            return self._solve_masked(
                avail, lambda: self.solve_min_resource(
                    batch, loads, warm_start=warm_start, min_rung=min_rung))
        if np.isscalar(loads):
            loads = [float(loads)] * len(self.tenants)
        assert len(loads) == len(self.tenants), \
            "need one required load per tenant"
        self._node_norm = self.tenants.node_values(
            [max(float(l), 1e-9) for l in loads])
        util_saved, self._util_codes = self._util_codes, None
        try:
            res = super().solve_min_resource(batch, 1.0,
                                             warm_start=warm_start,
                                             min_rung=min_rung)
        finally:
            self._node_norm = self._weight_nodes
            self._util_codes = util_saved
        if res.feasible:
            # the λ at which every tenant is offered at most its required
            # load (tenant t gets λ·weight_t ≤ loads[t]) — the sure-side
            # seed for find_joint_peak's weighted bracket
            res.load = min(float(l) / max(w, 1e-9) for l, w in
                           zip(loads, self.tenants.weights))
        return res

    def per_tenant_allocations(self, alloc: Allocation,
                               batch: int) -> List[Allocation]:
        """Service-scoped slices of a joint allocation, each annotated with
        its own tenant's predicted supported load (min aggregate node
        throughput) and critical-path latency.  Placement device ids stay
        global — the tenants keep sharing the one pool."""
        tab = self._policy_tables(batch)
        parts = self.tenants.split_allocation(alloc)
        ns = np.array([s.n_instances for s in alloc.stages], np.int64)
        qi = np.clip(np.rint(np.array(
            [s.quota for s in alloc.stages]) / QUOTA_STEP).astype(
                np.int64) - 1, 0, len(tab.grid) - 1)
        ar = np.arange(len(ns))
        PS = tab.grid[qi]
        thpt = ns * tab.thpt[ar, qi]
        if len(tab.edge_src):
            colo = PS[tab.edge_src] + PS[tab.edge_dst] <= 1.0 + 1e-9
            ecost = np.where(colo, tab.edge_t_colo, tab.edge_t_host)
        else:
            ecost = None
        best = self.pipeline.critical_path_nodes(tab.dur[ar, qi], ecost)
        for part, t, off, exits in zip(parts, self.tenants.tenants,
                                       self.tenants.offsets,
                                       self.tenants.exit_groups):
            n_t = t.graph.n_nodes
            part.predicted_min_throughput = float(
                thpt[off:off + n_t].min())
            part.predicted_latency = float(best[exits].max())
        return parts
