"""Online tenant lifecycle control plane: admission, preemption, mutation.

The solver and runtime layers answer "given THIS tenant set, how should the
pool be divided?".  Datacenter operation needs the layer above: tenants
arrive, leave, scale and change their QoS contracts while incumbents keep
serving.  ``LifecycleManager`` wraps ``MultiTenantRuntime`` with that
control plane:

- ``admit``   — candidate-union solve (incumbents + newcomer) decides
  whether the newcomer fits WITHOUT breaking any incumbent's QoS target;
  the solve is warm-started from the incumbent joint allocation and its
  Eq. 2 ladder starts at the incumbents' committed device footprint
  (``min_rung`` — admission never re-packs incumbents below the devices
  they already hold).  Denials carry certified quotes: a reduced load,
  relaxed latency target, or device count at which admission WOULD
  succeed, each backed by the feasible re-solve that found it.
- ``preempt`` — load-spike response delegated to the runtime's shed
  ladder: low tiers drop to the floor in strict ascending
  ``(priority, weight)`` order until the solve goes feasible.
- ``remove`` / ``scale_tenant`` / ``retarget_qos`` — spec mutations that
  re-solve warm from the incumbent allocation and swap the fresh joint
  allocation into the live runtime (``apply_allocations`` through any
  attached engine).

Every operation appends a bounded ``LifecycleEvent`` log that the
``repro_torch.camelot`` facade persists alongside the session.

Used by repro_torch.camelot.session (MultiServiceSession.admit/evict/...)
and tests/test_torch_runtime.py.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import (MultiTenantAllocator, SAConfig,
                                        SolveResult)
from repro_torch.core.comm import CommModel
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.runtime import MultiTenantRuntime, RuntimeConfig
from repro_torch.core.types import (QUOTA_STEP, Allocation, DeviceSpec,
                                    ServiceGraph, StageAlloc, Tenant,
                                    TenantSet)


@dataclass
class AdmissionQuote:
    """One certified counter-offer attached to a denial.

    ``kind`` says which knob was relaxed: ``"reduce_load"`` (the newcomer
    would fit at ``load`` qps), ``"relax_qos"`` (at latency target
    ``qos_target`` seconds), or ``"add_devices"`` (with ``extra_devices``
    more devices in the pool).  ``certified`` is True because the quote IS
    the feasible re-solve that produced it — ``objective`` is that solve's
    objective, so the offer is not an extrapolation."""
    kind: str
    load: Optional[float] = None
    qos_target: Optional[float] = None
    extra_devices: int = 0
    objective: float = 0.0
    certified: bool = False

    def to_dict(self) -> dict:
        return {"kind": self.kind, "load": self.load,
                "qos_target": self.qos_target,
                "extra_devices": self.extra_devices,
                "objective": self.objective
                if math.isfinite(self.objective) else None,
                "certified": self.certified}

    @classmethod
    def from_dict(cls, d: dict) -> "AdmissionQuote":
        obj = d.get("objective")
        return cls(kind=str(d["kind"]),
                   load=float(d["load"]) if d.get("load") is not None
                   else None,
                   qos_target=float(d["qos_target"])
                   if d.get("qos_target") is not None else None,
                   extra_devices=int(d.get("extra_devices", 0)),
                   objective=-math.inf if obj is None else float(obj),
                   certified=bool(d.get("certified", False)))


@dataclass
class AdmissionDecision:
    """The outcome of one ``LifecycleManager.admit`` call."""
    admitted: bool
    tenant: str
    result: Optional[SolveResult] = None   # the candidate-union solve
    quotes: List[AdmissionQuote] = field(default_factory=list)
    solve_time: float = 0.0
    warm_started: bool = False
    reason: str = ""


@dataclass
class LifecycleEvent:
    """One control-plane operation, as recorded in the bounded log."""
    time: float
    op: str                               # admit|deny|remove|scale|
                                          # retarget|preempt
    tenant: str
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"time": self.time, "op": self.op, "tenant": self.tenant,
                "detail": dict(self.detail)}

    @classmethod
    def from_dict(cls, d: dict) -> "LifecycleEvent":
        return cls(time=float(d["time"]), op=str(d["op"]),
                   tenant=str(d["tenant"]),
                   detail=dict(d.get("detail", {})))


class LifecycleManager:
    """Tenant lifecycle control plane over one shared device pool.

    Construction mirrors ``MultiTenantRuntime`` (and builds one): the
    manager owns the runtime and replaces it wholesale on membership
    changes, carrying per-tenant load estimates across by name.  The
    runtime's peak capability is intentionally reset on every rebuild
    (``peak_lambda = 0.0``): rebuilds seed the runtime from a
    MIN-RESOURCE result whose objective is a negative total quota, and
    letting that masquerade as the peak λ would corrupt the peak-switch
    branch.  The first periodic ``reallocate`` re-solves normally.
    """

    def __init__(self, tenants, predictor: PipelinePredictor,
                 device: DeviceSpec, n_devices: int, batch: int,
                 rt: Optional[RuntimeConfig] = None,
                 sa: Optional[SAConfig] = None,
                 comm: Optional[CommModel] = None,
                 initial: Optional[SolveResult] = None,
                 event_limit: int = 4096, profile_seed: int = 0,
                 profile_kwargs: Optional[dict] = None):
        if not isinstance(tenants, TenantSet):
            tenants = TenantSet(tenants)
        # the predictor is OWNED by the manager: admission appends the
        # newcomer's stage predictors to the union namespace, removal
        # slices the evictee's out — ``predictor.stages[off_t + i]`` stays
        # node i of tenant t throughout the lifecycle
        self.predictor = predictor
        self.profile_seed = profile_seed
        self.profile_kwargs = dict(profile_kwargs or {})
        self.device = device
        self.n_devices = n_devices
        self.batch = batch
        self.rt_cfg = rt if rt is not None else RuntimeConfig()
        self.sa = sa
        self.comm = comm if comm is not None \
            else CommModel(device, global_memory_enabled=True)
        self.runtime = MultiTenantRuntime(
            tenants, predictor, device, n_devices, batch, rt=self.rt_cfg,
            sa=sa, comm=self.comm, initial=initial)
        self.events: Deque[LifecycleEvent] = deque(maxlen=event_limit)

    # ---- introspection ------------------------------------------------

    @property
    def tenants(self) -> TenantSet:
        return self.runtime.tenants

    @property
    def tenant_names(self) -> List[str]:
        return [t.name for t in self.tenants.tenants]

    @property
    def current(self) -> Allocation:
        return self.runtime.current

    def _index_of(self, name: str) -> int:
        for ti, t in enumerate(self.tenants.tenants):
            if t.name == name:
                return ti
        raise KeyError(f"no tenant named {name!r}; have "
                       f"{self.tenant_names}")

    def qos_verdicts(self, result: Optional[SolveResult] = None,
                     allocator: Optional[MultiTenantAllocator] = None
                     ) -> Dict[str, bool]:
        """Per-tenant QoS verdict (predicted critical-path latency within
        the tenant's own target) for ``result`` — default: the runtime's
        last result — evaluated per tenant via
        ``per_tenant_allocations``."""
        alloc_obj = allocator if allocator is not None \
            else self.runtime.allocator
        res = result if result is not None else self.runtime.last_result
        parts = alloc_obj.per_tenant_allocations(res.allocation, self.batch)
        return {t.name: part.predicted_latency <= t.qos_target + 1e-9
                for t, part in zip(alloc_obj.tenants.tenants, parts)}

    # ---- load/demand policy -------------------------------------------

    def _required_loads(self, tenants: Sequence[Tenant]) -> List[float]:
        """One required qps per tenant: its declared ``required_load`` if
        set, else its live EWMA estimate × headroom (floored at 1 qps) —
        incumbents are held to what they currently serve, not to a stale
        spec."""
        est = {t.name: e for t, e in zip(self.tenants.tenants,
                                         self.runtime.load_estimates)}
        out = []
        for t in tenants:
            if t.required_load is not None:
                out.append(float(t.required_load))
            else:
                out.append(max(est.get(t.name, 0.0) * self.rt_cfg.headroom,
                               1.0))
        return out

    def _committed_rung(self) -> Optional[int]:
        """The incumbents' committed device footprint — the admission
        ladder's starting rung.  Policy, not optimisation: admission
        never re-packs incumbents below the devices they already hold,
        so an admitted newcomer never forces disruptive migration.
        (Sound to use as a ladder floor: the feasible region at rung y
        is a subset of rung y+1, so skipping lower rungs never costs
        feasibility — only, possibly, quota optimality.)"""
        pl = self.runtime.current.placement
        if pl is None:
            return None
        used = len(pl.devices_used())
        return used if used > 0 else None

    @staticmethod
    def _naive_alloc(graph: ServiceGraph, batch: int) -> Allocation:
        """Smallest-footprint seed for a newcomer: one instance per stage
        at one lattice step of quota.  Placement stays None — a warm
        ``Allocation``'s device ids are never read, only its stages."""
        return Allocation(stages=[StageAlloc(1, QUOTA_STEP, batch)
                                  for _ in range(graph.n_nodes)])

    def _candidate_allocator(self, cand: TenantSet,
                             n_devices: Optional[int] = None,
                             predictor: Optional[PipelinePredictor] = None
                             ) -> MultiTenantAllocator:
        """A fresh joint allocator over ``cand``.  The per-stage
        predictors are already fitted, so the candidate allocator pays
        tabulation, not training."""
        return MultiTenantAllocator(
            cand, predictor if predictor is not None else self.predictor,
            self.device,
            self.n_devices if n_devices is None else n_devices,
            comm=self.comm, sa=self.sa)

    def _warm_seed(self, cand: TenantSet, newcomer_graph: ServiceGraph
                   ) -> Allocation:
        """Incumbent slices + a naive newcomer slice, joined into the
        candidate union namespace."""
        parts = self.tenants.split_allocation(self.runtime.current)
        parts.append(self._naive_alloc(newcomer_graph, self.batch))
        return cand.join_allocations(parts)

    # ---- rebuild (membership / spec changes) --------------------------

    def _rebuild(self, tenants: List[Tenant],
                 result: Optional[SolveResult]) -> None:
        """Swap in a new runtime over ``tenants``, seeded by ``result``
        (no cold solve), carrying load estimates across by name."""
        est = {t.name: e for t, e in zip(self.tenants.tenants,
                                         self.runtime.load_estimates)}
        engine = self.runtime._engine
        new_rt = MultiTenantRuntime(
            TenantSet(tenants), self.predictor, self.device,
            self.n_devices, self.batch, rt=self.rt_cfg, sa=self.sa,
            comm=self.comm, initial=result)
        if result is not None:
            # the seed is a min-resource result: its objective is a
            # negative total quota, NOT a peak λ — force the first
            # periodic reallocate to re-derive capability instead
            new_rt.peak_lambda = 0.0
        new_rt._load_est = [est.get(t.name, 0.0) for t in tenants]
        self.runtime = new_rt
        if engine is not None:
            self.runtime.attach_engine(engine)
            alloc = self.runtime.current
            if alloc.placement is not None:
                engine.apply_allocations(
                    self.runtime.tenants.split_allocation(alloc))

    # ---- admission -----------------------------------------------------

    def admit(self, now: float, tenant: Tenant, warm: bool = True,
              quote: bool = True,
              quote_kinds: Sequence[str] = ("reduce_load", "relax_qos",
                                            "add_devices"),
              stage_predictor: Optional[PipelinePredictor] = None
              ) -> AdmissionDecision:
        """Admit ``tenant`` iff the candidate union (incumbents at their
        current demands + the newcomer at its required load) has a
        feasible joint allocation — feasibility of that solve IS the
        certificate that every incumbent keeps its QoS target.  On
        admission the runtime is rebuilt around the candidate result and
        the fresh joint allocation goes live immediately.  On denial,
        ``quotes`` carries one certified counter-offer per relaxation
        family that reached feasibility (see ``AdmissionQuote``).

        ``warm=False`` runs the cold baseline (no incumbent seed, full
        Eq. 2 ladder) — the admission benchmark's control arm.

        ``stage_predictor`` supplies the newcomer's fitted per-node
        predictors; when omitted they are profiled here with the
        manager's ``profile_seed + <union offset>`` (the same convention
        the facade's ``profile()`` uses, so admitting tenants one by one
        reproduces a freshly-built session bit for bit)."""
        if tenant.name in self.tenant_names:
            raise ValueError(f"tenant {tenant.name!r} already admitted")
        extra = stage_predictor if stage_predictor is not None else \
            PipelinePredictor.from_graph(
                tenant.graph, self.device,
                seed=self.profile_seed + self.tenants.n_nodes,
                **self.profile_kwargs)
        assert len(extra.stages) == tenant.graph.n_nodes, \
            (len(extra.stages), tenant.graph.n_nodes)
        cand_pred = PipelinePredictor(list(self.predictor.stages)
                                      + list(extra.stages))
        cand_tenants = list(self.tenants.tenants) + [tenant]
        cand = TenantSet(cand_tenants)
        alloc_obj = self._candidate_allocator(cand, predictor=cand_pred)
        loads = self._required_loads(cand_tenants)
        seed = self._warm_seed(cand, tenant.graph) if warm else None
        rung = self._committed_rung() if warm else None
        t0 = time.perf_counter()
        res = alloc_obj.solve_min_resource(self.batch, loads,
                                           warm_start=seed, min_rung=rung)
        dt = time.perf_counter() - t0
        if res.feasible:
            self.predictor = cand_pred
            self._rebuild(cand_tenants, res)
            self.events.append(LifecycleEvent(
                time=now, op="admit", tenant=tenant.name,
                detail={"loads": loads, "objective": res.objective,
                        "solve_time": dt,
                        "warm_started": res.warm_started}))
            return AdmissionDecision(
                admitted=True, tenant=tenant.name, result=res,
                solve_time=dt, warm_started=res.warm_started,
                reason="feasible joint allocation")
        quotes: List[AdmissionQuote] = []
        if quote:
            quotes = self._quotes(cand_tenants, loads, seed, rung,
                                  quote_kinds, cand_pred)
        self.events.append(LifecycleEvent(
            time=now, op="deny", tenant=tenant.name,
            detail={"loads": loads, "solve_time": dt,
                    "quotes": [q.to_dict() for q in quotes]}))
        return AdmissionDecision(
            admitted=False, tenant=tenant.name, result=res, quotes=quotes,
            solve_time=dt, warm_started=res.warm_started,
            reason="no feasible joint allocation at requested load/QoS/"
                   "pool size")

    # quote search: every step is a full certifying solve, so searches
    # are short and coarse — a quote is an offer, not an optimum.  The
    # load quote bisects (log-space) for the LARGEST admissible newcomer
    # load between 1 qps and the requested load; QoS/device quotes walk
    # short relaxation ladders.
    _LOAD_BISECT_STEPS = 4
    _QOS_FACTORS = (1.5, 2.0, 4.0)
    _EXTRA_DEVICES = (1, 2, 4)

    def _quotes(self, cand_tenants: List[Tenant], loads: List[float],
                seed: Optional[Allocation], rung: Optional[int],
                kinds: Sequence[str],
                predictor: PipelinePredictor) -> List[AdmissionQuote]:
        newcomer = cand_tenants[-1]
        cand = TenantSet(cand_tenants)
        out: List[AdmissionQuote] = []
        if "reduce_load" in kinds and loads[-1] > 1.0:
            alloc_obj = self._candidate_allocator(cand,
                                                  predictor=predictor)
            trial = list(loads)

            def _at(load: float) -> SolveResult:
                trial[-1] = load
                return alloc_obj.solve_min_resource(
                    self.batch, trial, warm_start=seed, min_rung=rung)

            # floor probe: can the pool take the newcomer at all?
            res = _at(1.0)
            if res.feasible:
                lo, best_obj = 1.0, res.objective
                hi = loads[-1]          # the (infeasible) requested load
                for _ in range(self._LOAD_BISECT_STEPS):
                    mid = math.sqrt(lo * hi)
                    r = _at(mid)
                    if r.feasible:
                        lo, best_obj = mid, r.objective
                    else:
                        hi = mid
                out.append(AdmissionQuote(
                    kind="reduce_load", load=lo,
                    objective=best_obj, certified=True))
        if "relax_qos" in kinds:
            g = newcomer.graph
            for f in self._QOS_FACTORS:
                relaxed = ServiceGraph(g.name, g.nodes, g.edges,
                                       qos_target=g.qos_target * f)
                trial_t = dataclasses.replace(newcomer, graph=relaxed)
                trial_set = TenantSet(cand_tenants[:-1] + [trial_t])
                res = self._candidate_allocator(
                    trial_set, predictor=predictor).solve_min_resource(
                        self.batch, loads, warm_start=seed, min_rung=rung)
                if res.feasible:
                    out.append(AdmissionQuote(
                        kind="relax_qos", qos_target=relaxed.qos_target,
                        objective=res.objective, certified=True))
                    break
        if "add_devices" in kinds:
            for k in self._EXTRA_DEVICES:
                res = self._candidate_allocator(
                    cand, n_devices=self.n_devices + k,
                    predictor=predictor).solve_min_resource(
                        self.batch, loads, warm_start=seed, min_rung=rung)
                if res.feasible:
                    out.append(AdmissionQuote(
                        kind="add_devices", extra_devices=k,
                        objective=res.objective, certified=True))
                    break
        return out

    # ---- removal / mutation -------------------------------------------

    def remove(self, now: float, name: str) -> SolveResult:
        """Evict ``name`` and re-solve the survivors warm from their own
        slices of the incumbent joint allocation."""
        ti = self._index_of(name)
        survivors = [t for i, t in enumerate(self.tenants.tenants)
                     if i != ti]
        if not survivors:
            raise ValueError(
                "cannot remove the last tenant — a TenantSet needs at "
                "least one")
        keep = TenantSet(survivors)
        off = self.tenants.offsets[ti]
        n = self.tenants.tenants[ti].graph.n_nodes
        keep_pred = PipelinePredictor(self.predictor.stages[:off]
                                      + self.predictor.stages[off + n:])
        parts = self.tenants.split_allocation(self.runtime.current)
        seed = keep.join_allocations(
            [p for i, p in enumerate(parts) if i != ti])
        alloc_obj = self._candidate_allocator(keep, predictor=keep_pred)
        loads = self._required_loads(survivors)
        t0 = time.perf_counter()
        res = alloc_obj.solve_min_resource(self.batch, loads,
                                           warm_start=seed)
        dt = time.perf_counter() - t0
        # eviction always commits: the survivors' own slices are feasible
        # for them by construction, so even an infeasible re-solve only
        # means "keep serving on the old slices until the next reallocate"
        self.predictor = keep_pred
        self._rebuild(survivors, res if res.feasible else None)
        self.events.append(LifecycleEvent(
            time=now, op="remove", tenant=name,
            detail={"objective": res.objective, "feasible": res.feasible,
                    "solve_time": dt}))
        return res

    def _mutate(self, now: float, op: str, name: str,
                new_tenant: Tenant) -> SolveResult:
        """Shared spec-mutation path: swap one tenant's spec, re-solve
        warm from the incumbent joint allocation (the union namespace is
        unchanged — same graphs, same node count), and commit only if
        the re-solve is feasible."""
        ti = self._index_of(name)
        cand_tenants = list(self.tenants.tenants)
        cand_tenants[ti] = new_tenant
        cand = TenantSet(cand_tenants)
        alloc_obj = self._candidate_allocator(cand)
        loads = self._required_loads(cand_tenants)
        warm = self.runtime.current if self.rt_cfg.warm_start else None
        t0 = time.perf_counter()
        res = alloc_obj.solve_min_resource(self.batch, loads,
                                           warm_start=warm)
        dt = time.perf_counter() - t0
        if res.feasible:
            self._rebuild(cand_tenants, res)
        self.events.append(LifecycleEvent(
            time=now, op=op, tenant=name,
            detail={"feasible": res.feasible, "objective": res.objective,
                    "solve_time": dt}))
        return res

    def scale_tenant(self, now: float, name: str,
                     required_load: Optional[float] = None,
                     weight: Optional[float] = None) -> SolveResult:
        """Change a tenant's demand (``required_load``) and/or its joint
        objective ``weight``; commits only on a feasible warm re-solve."""
        if required_load is None and weight is None:
            raise ValueError("scale_tenant needs required_load and/or "
                             "weight")
        t = self.tenants.tenants[self._index_of(name)]
        kw: dict = {}
        if required_load is not None:
            kw["required_load"] = float(required_load)
        if weight is not None:
            kw["weight"] = float(weight)
        return self._mutate(now, "scale", name,
                            dataclasses.replace(t, **kw))

    def retarget_qos(self, now: float, name: str,
                     qos_target: float) -> SolveResult:
        """Change a tenant's latency target (rebuilds its graph with the
        new target — topology and profiles are shared, so this is
        cheap); commits only on a feasible warm re-solve."""
        if not (qos_target > 0.0):
            raise ValueError(f"qos_target must be > 0, got {qos_target}")
        t = self.tenants.tenants[self._index_of(name)]
        g = t.graph
        new_graph = ServiceGraph(g.name, g.nodes, g.edges,
                                 qos_target=float(qos_target))
        return self._mutate(now, "retarget", name,
                            dataclasses.replace(t, graph=new_graph))

    # ---- preemption ----------------------------------------------------

    def preempt(self, now: float,
                targets: Optional[List[float]] = None) -> Allocation:
        """Load-spike response: delegate to the runtime's shed ladder
        (strict ascending ``(priority, weight)`` order, events recorded
        with ``reason="preempted"``) and mirror the outcome into the
        lifecycle log."""
        alloc = self.runtime.preempt(now, targets=targets)
        ev = self.runtime.history[-1]
        self.events.append(LifecycleEvent(
            time=now, op="preempt", tenant=",".join(ev.shed) or "-",
            detail={"shed": list(ev.shed), "feasible": ev.feasible,
                    "reason": ev.reason}))
        return alloc

    # ---- persistence ---------------------------------------------------

    def events_to_dict(self) -> List[dict]:
        return [e.to_dict() for e in self.events]

    def restore_events(self, rows: Sequence[dict]) -> None:
        self.events.clear()
        for r in rows:
            self.events.append(LifecycleEvent.from_dict(r))
