"""``CamelotSession``: the whole Camelot lifecycle behind one object.

The paper's value proposition is a single runtime owning the loop —
profile, predict, contention-aware allocate, place, and serve under a
99%-ile QoS target.  The session is that loop as an API: construct it from
declarative specs, then

    sess = CamelotSession(service_spec, ClusterSpec(devices=2))
    sess.profile()                         # fit the per-node predictors
    res = sess.solve(policy="max-peak")    # any registered policy
    sim = sess.simulate(load=res.objective * 0.5)   # datacenter simulator
    eng = sess.serve()                     # LIVE engine, same allocation
    sess.reallocate(now)                   # online loop via CamelotRuntime

Every step delegates to the existing layers (``PipelinePredictor``,
``CamelotAllocator`` through the policy registry, ``PipelineSimulator``,
``PipelineEngine``, ``CamelotRuntime``); the session only owns the wiring,
so hand-wired callers and the facade produce identical results.
"""
from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import List, Mapping, Optional, Sequence, Tuple

from repro_torch.camelot.policies import get_policy
from repro_torch.camelot.specs import (ClusterSpec, LoadSpec, MultiServiceSpec,
                                       QoSSpec, ServeSpec, ServiceSpec,
                                       SolverSpec, TenantSpec)
from repro_torch.core.allocator import (CamelotAllocator, MultiTenantAllocator,
                                        SAConfig, SolveResult)
from repro_torch.core.faults import FaultSpec
from repro_torch.core.lifecycle import AdmissionDecision, LifecycleManager
from repro_torch.core.predictor import (DEFAULT_BATCHES, PipelinePredictor,
                                        ProfileSample, StagePredictor,
                                        TabulatedStagePredictor)
from repro_torch.core.runtime import (CamelotRuntime, MultiTenantRuntime,
                                      RuntimeConfig)
from repro_torch.core.types import (QUOTA_STEP, Allocation, ServiceGraph,
                                    Tenant, TenantSet)
from repro_torch.sim.simulator import (MultiSimResult, MultiTenantSimulator,
                                       PipelineSimulator, SimConfig, SimResult,
                                       find_joint_peak, find_peak_load)


class CamelotSession:
    """One service on one cluster under one QoS objective.

    ``service`` may be a ``ServiceSpec``, a plain dict (lowered through
    ``ServiceSpec.from_dict``), or an already-built ``ServiceGraph``
    (lifted through ``ServiceSpec.from_graph`` — the migration path for
    chain-era callers)."""

    def __init__(self, service, cluster: Optional[ClusterSpec] = None,
                 qos: Optional[QoSSpec] = None, batch: int = 8,
                 seed: int = 0):
        if isinstance(service, ServiceGraph):
            service = ServiceSpec.from_graph(service)
        elif isinstance(service, Mapping):
            service = ServiceSpec.from_dict(service)
        assert isinstance(service, ServiceSpec), service
        self.service = service
        self.cluster = cluster if cluster is not None else ClusterSpec()
        self.qos = qos if qos is not None else QoSSpec()
        self.batch = batch
        self.seed = seed
        self.graph: ServiceGraph = service.build(self.qos)
        self.predictor: Optional[PipelinePredictor] = None
        self.last_result: Optional[SolveResult] = None
        self.results: List[SolveResult] = []
        self._runtime: Optional[CamelotRuntime] = None
        self._stages = None               # live stage servers, set by serve()

    @property
    def qos_target(self) -> float:
        return self.qos.resolve_target(self.service)

    # ---- 1. profile / predict ------------------------------------------

    def profile(self, model_kind: str = "dt", noise: float = 0.03,
                seed: Optional[int] = None,
                batches: Sequence[int] = DEFAULT_BATCHES,
                tabulate: bool = True) -> PipelinePredictor:
        """Solo-run profile every node and fit its performance models
        (paper §VII-A).  Identical to hand-wiring
        ``PipelinePredictor.from_graph`` — same seeds, same samples."""
        self.predictor = PipelinePredictor.from_graph(
            self.graph, self.cluster.device_spec, model_kind=model_kind,
            noise=noise, seed=self.seed if seed is None else seed,
            batches=batches, tabulate=tabulate)
        return self.predictor

    def fit_from_samples(self, samples_per_node:
                         Sequence[Sequence[ProfileSample]],
                         model_kind: str = "dt",
                         tabulate: bool = True) -> PipelinePredictor:
        """Fit the predictors from pre-collected ``ProfileSample``s (real
        profiler output) instead of the analytic ground-truth curves —
        ``samples_per_node[i]`` trains node i's predictor."""
        assert len(samples_per_node) == self.service.n_nodes, \
            "need one sample list per service node"
        mk = TabulatedStagePredictor if tabulate else StagePredictor
        preds = []
        for i, samples in enumerate(samples_per_node):
            node = self.graph.nodes[i]
            preds.append(mk(node.name, model_kind, seed=self.seed + i)
                         .fit(samples, profile=node))
        self.predictor = PipelinePredictor(preds)
        return self.predictor

    def _require_predictor(self) -> PipelinePredictor:
        if self.predictor is None:
            self.profile()
        return self.predictor

    # ---- 2. solve ------------------------------------------------------

    def solve(self, policy="max-peak", batch: Optional[int] = None,
              **kwargs) -> SolveResult:
        """Run a registered policy (or a Policy instance) against the
        session's specs.  Extra keyword arguments go to the policy
        (e.g. ``load=`` for min-resource, ``sa=`` for an SA override)."""
        pol = get_policy(policy)
        res = pol.solve(self.service, self._require_predictor(),
                        self.cluster, self.qos,
                        batch=self.batch if batch is None else batch,
                        **kwargs)
        self.last_result = res
        self.results.append(res)
        return res

    def _resolve_result(self, result: Optional[SolveResult]) -> SolveResult:
        res = result if result is not None else self.last_result
        if res is None:
            res = self.solve()
        return res

    # ---- 3. simulate ---------------------------------------------------

    def _make_sim(self, res: SolveResult,
                  sim: Optional[SimConfig]) -> PipelineSimulator:
        assert res.feasible and res.allocation.placement is not None, \
            f"result of policy {res.policy or '?'} is not placeable"
        return PipelineSimulator(
            self.graph, res.allocation, self.cluster.device_spec,
            res.comm if res.comm is not None else self.cluster.comm_model(),
            sim=sim)

    def simulate(self, load: Optional[float] = None,
                 sim: Optional[SimConfig] = None,
                 result: Optional[SolveResult] = None,
                 faults: Optional[FaultSpec] = None) -> SimResult:
        """Charge the (last) solved allocation in the discrete-event
        simulator at ``load`` qps (default: ``QoSSpec.load``'s level).
        ``faults`` injects a seeded fault script (device death, straggle,
        transient errors) into the run."""
        res = self._resolve_result(result)
        if load is None:
            if self.qos.load is None:
                raise ValueError("simulate needs a load: pass load=... or "
                                 "set QoSSpec.load")
            load = self.qos.load.qps
        return self._make_sim(res, sim).run(float(load), faults=faults)

    def find_peak(self, sim: Optional[SimConfig] = None,
                  result: Optional[SolveResult] = None, lo: float = 1.0,
                  hi: float = 4096.0, tol: float = 0.03, max_iter: int = 14,
                  seed_load: Optional[float] = None, parallel: int = 1,
                  abort: bool = True) -> Tuple[float, SimResult]:
        """Search the highest load whose simulated p99 meets the QoS
        target (paper §IV-A methodology).  One simulator is built and
        shared across probes (its physics tables amortize), the bracket
        seeds from the solver's own predicted load (``SolveResult.load``;
        pass ``seed_load`` to override, ``seed_load=0`` to disable), and
        infeasible probes stop at the exact early-abort bound — abort
        never changes a verdict, so the peak matches ``abort=False``.
        ``parallel > 1`` speculates probe loads on a thread pool with
        results identical to the sequential search."""
        res = self._resolve_result(result)
        simulator = self._make_sim(res, sim)
        if seed_load is None:
            seed_load = res.load
        return find_peak_load(lambda: simulator, self.qos_target, lo=lo,
                              hi=hi, tol=tol, max_iter=max_iter,
                              seed_load=seed_load or None,
                              parallel=parallel, abort=abort)

    # ---- 4. serve (live) -----------------------------------------------

    def serve(self, stages=None, result: Optional[SolveResult] = None,
              comm_mechanism: str = "auto", batch_timeout: float = 0.05,
              seq_len: int = 16, backend: str = "threads",
              spec: Optional[ServeSpec] = None, *, reduced: bool = False,
              device=None):
        """A live ``PipelineEngine`` running the solved allocation on real
        models.  ``stages`` maps node i to its stage server; omitted,
        servers are built from each node's model-zoo ``arch`` with the
        servers' own ``reduced``/``device`` (full width on the card by
        default).  ``backend`` picks threads (default) or worker
        processes (each stage server rebuilt in every worker from its
        pickle; payloads hand off through the workers' arenas, by CUDA
        IPC on the card); a full ``ServeSpec`` overrides all backend/fault
        knobs at once.  Close the engine to stop a process pool."""
        from repro_torch.serving import ModelStageServer, PipelineEngine
        res = self._resolve_result(result)
        assert res.feasible and res.allocation.placement is not None, \
            "cannot serve an infeasible allocation"
        if spec is None:
            spec = ServeSpec(backend=backend, comm_mechanism=comm_mechanism,
                             batch_timeout=batch_timeout)
        if stages is None:
            missing = [n.name for n in self.graph.nodes if n.arch is None]
            if missing:
                raise ValueError(
                    f"nodes {missing} carry no model-zoo arch; pass "
                    "stage servers explicitly")
            stages = [ModelStageServer(n.name, n.arch, seq_len=seq_len,
                                       reduced=reduced, device=device)
                      for n in self.graph.nodes]
        self._stages = list(stages)
        return PipelineEngine(
            self._stages, qos_target=self.qos_target,
            allocation=res.allocation,
            comm_model=res.comm if res.comm is not None
            else self.cluster.comm_model(),
            graph=self.graph, **spec.engine_kwargs())

    def make_trace(self, n: int, qps: float, seed: int = 0):
        """A query trace shaped for the served entry node (vocab/seq_len
        from its stage server) — call after ``serve()``."""
        from repro_torch.serving import make_trace
        assert self._stages is not None, "serve() first — the trace needs " \
            "the entry stage's vocabulary"
        entry = self._stages[self.graph.entries[0]]
        return make_trace(n, qps=qps, seq_len=entry.seq_len,
                          vocab=entry.cfg.vocab_size, seed=seed)

    # ---- 5. online runtime ---------------------------------------------

    def runtime(self, rt: Optional[RuntimeConfig] = None,
                sa=None, resume: bool = False) -> CamelotRuntime:
        """The online reallocation loop (lazily built; solves the peak
        allocation once on first use).  ``resume=True`` seeds the runtime
        from the session's persisted ``last_result`` (crash-restart: a
        loaded session re-attaches with NO cold solve)."""
        if self._runtime is None:
            initial = self.last_result if resume and \
                self.last_result is not None and \
                self.last_result.feasible else None
            self._runtime = CamelotRuntime(
                self.graph, self._require_predictor(),
                self.cluster.device_spec, self.cluster.devices, self.batch,
                rt=rt, sa=sa, comm=self.cluster.comm_model(),
                initial=initial)
        return self._runtime

    def observe(self, qps: float) -> None:
        self.runtime().observe(qps)

    def reallocate(self, now: float = 0.0) -> Allocation:
        """Delegate to ``CamelotRuntime.reallocate``: re-solve for the
        current load estimate (warm-started from the previous allocation)
        and push the result into an attached live engine."""
        return self.runtime().reallocate(now)

    def attach_engine(self, engine) -> None:
        self.runtime().attach_engine(engine)

    # ---- 6. persistence -------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the session's specs AND its last solved allocation as
        one JSON document, so a restart skips the solve entirely:
        ``CamelotSession.load(path)`` can ``simulate``/``serve`` the saved
        allocation immediately."""
        doc = {
            "kind": "camelot-session",
            "service": self.service.to_dict(),
            "cluster": self.cluster.to_dict(),
            "qos": self.qos.to_dict(),
            "batch": self.batch,
            "seed": self.seed,
            "result": self.last_result.to_dict()
            if self.last_result is not None else None,
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CamelotSession":
        """Rebuild a session (specs + last solved allocation) from
        ``save`` output.  The restored ``SolveResult`` is re-priced with
        the cluster's comm model (comm config is cluster data, not solver
        state) and becomes ``last_result``, so simulate/serve/find_peak
        run without re-solving."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("kind") != "camelot-session":
            raise ValueError(f"{path} is not a saved CamelotSession "
                             f"(kind={doc.get('kind')!r})")
        sess = cls(ServiceSpec.from_dict(doc["service"]),
                   ClusterSpec.from_dict(doc["cluster"]),
                   QoSSpec.from_dict(doc["qos"]),
                   batch=int(doc.get("batch", 8)),
                   seed=int(doc.get("seed", 0)))
        if doc.get("result") is not None:
            res = SolveResult.from_dict(doc["result"],
                                        comm=sess.cluster.comm_model())
            sess.last_result = res
            sess.results.append(res)
        return sess


# --------------------------------------------------------------------------
# Multi-service sessions: N tenants sharing ONE cluster
# --------------------------------------------------------------------------

class MultiServiceSession:
    """N services on ONE shared cluster under per-tenant QoS objectives —
    the datacenter consolidation entry point.

        sess = MultiServiceSession([
            (img_spec, QoSSpec()),                 # tenant 0
            TenantSpec(dag_spec, QoSSpec(), 2.0),  # tenant 1, 2x demand
        ], ClusterSpec(devices=3))
        sess.profile()
        res = sess.solve(policy="max-peak")        # ONE joint solve
        lam, sim = sess.find_peak()                # all tenants together
        static = sess.solve_partitioned([1, 2])    # the baseline it beats

    The joint solve concatenates every tenant's stage vector into one
    annealing state (``MultiTenantAllocator``): Constraints 1–4 are shared
    over the one device pool — instances from different services contend —
    while Constraint-5 holds per tenant.  With exactly ONE tenant every
    step is bit-for-bit identical to ``CamelotSession`` (pinned in
    tests/test_multitenant.py).

    ``services`` accepts a ``MultiServiceSpec``, or a sequence whose items
    are ``TenantSpec``s, ``ServiceSpec``s, ``(service, qos)`` pairs,
    ``ServiceGraph``s or plain spec dicts.
    """

    JOINT_POLICIES = ("max-peak", "min-resource", "camelot-nc")

    def __init__(self, services, cluster: Optional[ClusterSpec] = None,
                 batch: int = 8, seed: int = 0, name: str = "multi",
                 solver: Optional[SolverSpec] = None):
        self.spec = self._lift(services, name)
        self.cluster = cluster if cluster is not None else ClusterSpec()
        self.batch = batch
        self.seed = seed
        # default solver configuration (mode / budget / pod decomposition)
        # for joint solves; solve(solver=...) overrides per call
        self.solver = solver
        self.tenant_set = TenantSet([t.build() for t in self.spec.tenants])
        self.predictor: Optional[PipelinePredictor] = None
        self.last_result: Optional[SolveResult] = None
        self.results: List[SolveResult] = []
        self._allocator: Optional[MultiTenantAllocator] = None
        self._runtime: Optional[MultiTenantRuntime] = None
        self._stages = None             # per-tenant live servers (serve())
        self._lifecycle: Optional[LifecycleManager] = None
        self._lifecycle_events: List[dict] = []   # restored by load()

    @staticmethod
    def _lift(services, name: str) -> MultiServiceSpec:
        if isinstance(services, MultiServiceSpec):
            return services
        if isinstance(services, Mapping):
            return MultiServiceSpec.from_dict(services)
        tenants = []
        for item in services:
            if isinstance(item, TenantSpec):
                tenants.append(item)
                continue
            if isinstance(item, Tenant):
                # core Tenant (e.g. straight from multitenant_suite):
                # weight, required_load and the lifecycle knobs must
                # survive the lift
                tenants.append(TenantSpec(
                    ServiceSpec.from_graph(item.graph),
                    QoSSpec(load=LoadSpec(qps=item.required_load)
                            if item.required_load is not None else None),
                    weight=item.weight,
                    priority=item.priority,
                    quota_floor=item.quota_floor,
                    quota_cap=item.quota_cap,
                    utility=item.utility))
                continue
            if isinstance(item, tuple):
                svc, qos = item
            else:
                svc, qos = item, QoSSpec()
            if isinstance(svc, ServiceGraph):
                svc = ServiceSpec.from_graph(svc)
            elif isinstance(svc, Mapping):
                svc = ServiceSpec.from_dict(svc)
            tenants.append(TenantSpec(svc, qos))
        return MultiServiceSpec(name, tuple(tenants))

    # ---- derived -------------------------------------------------------

    @property
    def tenants(self) -> List[TenantSpec]:
        return list(self.spec.tenants)

    @property
    def n_tenants(self) -> int:
        return self.spec.n_tenants

    @property
    def graphs(self) -> List[ServiceGraph]:
        return [t.graph for t in self.tenant_set.tenants]

    @property
    def qos_targets(self) -> List[float]:
        return [t.qos_target for t in self.tenant_set.tenants]

    @property
    def weights(self) -> List[float]:
        return self.tenant_set.weights

    def _required_loads(self, loads=None) -> List[float]:
        if loads is not None:
            if isinstance(loads, (int, float)):
                return [float(loads)] * self.n_tenants
            if len(loads) != self.n_tenants:
                raise ValueError(
                    f"need one load per tenant ({self.n_tenants}), got "
                    f"{len(loads)}")
            return [float(l) for l in loads]
        out = []
        for t in self.tenant_set.tenants:
            if t.required_load is None:
                raise ValueError(
                    f"tenant {t.name!r} has no load target: pass loads=[...]"
                    " or set QoSSpec.load per tenant")
            out.append(float(t.required_load))
        return out

    # ---- 1. profile ----------------------------------------------------

    def profile(self, model_kind: str = "dt", noise: float = 0.03,
                seed: Optional[int] = None,
                batches: Sequence[int] = DEFAULT_BATCHES,
                tabulate: bool = True) -> PipelinePredictor:
        """Solo-run profile every tenant's nodes (profiling is per node —
        tenancy does not change it) and concatenate the per-node
        predictors into the union namespace.  Tenant t's nodes use seed
        ``seed + offset_t``, so tenant 0 is seeded exactly like a solo
        ``CamelotSession`` (the bit-parity contract)."""
        base = self.seed if seed is None else seed
        stages = []
        for graph, off in zip(self.graphs, self.tenant_set.offsets):
            stages.extend(PipelinePredictor.from_graph(
                graph, self.cluster.device_spec, model_kind=model_kind,
                noise=noise, seed=base + off, batches=batches,
                tabulate=tabulate).stages)
        self.predictor = PipelinePredictor(stages)
        self._allocator = None          # tables hold the old models' output
        return self.predictor

    def _require_predictor(self) -> PipelinePredictor:
        if self.predictor is None:
            self.profile()
        return self.predictor

    # ---- 2. joint solve ------------------------------------------------

    def allocator(self, sa: Optional[SAConfig] = None,
                  bandwidth_constraint: bool = True) -> MultiTenantAllocator:
        """The joint allocator over the union namespace (rebuilt when an
        SA override is passed; cached otherwise so re-solves share the
        per-batch tables and FFD memo)."""
        if sa is not None or self._allocator is None or \
                self._allocator.sa.bandwidth_constraint \
                != bandwidth_constraint:
            eff = replace(sa if sa is not None else SAConfig(),
                          bandwidth_constraint=bandwidth_constraint)
            self._allocator = MultiTenantAllocator(
                self.tenant_set, self._require_predictor(),
                self.cluster.device_spec, self.cluster.devices,
                comm=self.cluster.comm_model(), sa=eff)
        return self._allocator

    def solve(self, policy: str = "max-peak", batch: Optional[int] = None,
              sa: Optional[SAConfig] = None, loads=None,
              warm_start: Optional[Allocation] = None,
              solver: Optional[SolverSpec] = None) -> SolveResult:
        """One JOINT solve across every tenant.  ``max-peak`` maximises
        the worst weight-normalized supported load (the objective value is
        that λ — tenant t sustains ``λ·weight_t`` qps); ``min-resource``
        minimises total quota while tenant t supports ``loads[t]`` (or its
        ``QoSSpec.load``); ``camelot-nc`` is max-peak without the
        bandwidth constraint.

        ``solver`` (or the session-level default) picks the evaluation
        mode and, with ``pod_size`` set, routes the solve through the
        hierarchical pod decomposition (``core.hierarchy``); an explicit
        ``sa=`` still wins over the spec's SA-level knobs."""
        if policy not in self.JOINT_POLICIES:
            raise ValueError(
                f"unknown joint policy {policy!r}; available: "
                f"{', '.join(self.JOINT_POLICIES)} (single-service "
                "policies live on CamelotSession)")
        # same lattice contract as the single-service solver policies
        if abs(self.cluster.quota_step - QUOTA_STEP) > 1e-12:
            raise ValueError(
                f"the allocator solves on the fixed QUOTA_STEP={QUOTA_STEP} "
                f"lattice; ClusterSpec.quota_step={self.cluster.quota_step} "
                "is only supported by quantize()-built demo allocations")
        b = self.batch if batch is None else batch
        spec = solver if solver is not None else self.solver
        if sa is None and spec is not None:
            sa = spec.sa_config()
        if spec is not None and spec.hierarchical:
            res = self._solve_hierarchical(policy, b, sa, loads, spec)
        else:
            alloc = self.allocator(
                sa=sa, bandwidth_constraint=policy != "camelot-nc")
            if policy == "min-resource":
                res = alloc.solve_min_resource(
                    b, self._required_loads(loads), warm_start=warm_start)
            else:
                res = alloc.solve_max_load(b, warm_start=warm_start)
            res.comm, res.policy = alloc.comm, policy
        self.last_result = res
        self.results.append(res)
        return res

    def _solve_hierarchical(self, policy: str, batch: int,
                            sa: Optional[SAConfig], loads,
                            spec: SolverSpec) -> SolveResult:
        from repro_torch.core.hierarchy import HierarchicalSolver
        eff = replace(sa if sa is not None else SAConfig(),
                      bandwidth_constraint=policy != "camelot-nc")
        comm = self.cluster.comm_model()
        solver = HierarchicalSolver(
            self.tenant_set, self._require_predictor(),
            self.cluster.device_spec, self.cluster.devices, comm=comm,
            sa=eff, pods=spec.pod_config())
        if policy == "min-resource":
            res = solver.solve_min_resource(batch,
                                            self._required_loads(loads))
        else:
            res = solver.solve_max_load(batch)
        res.comm, res.policy = comm, policy
        return res

    def _resolve_result(self, result: Optional[SolveResult]) -> SolveResult:
        res = result if result is not None else self.last_result
        if res is None:
            res = self.solve()
        return res

    def _current_allocator(self) -> MultiTenantAllocator:
        """The cached allocator whatever its bandwidth flag — annotation
        and simulation only need the predictor tables, which do not depend
        on it, and reusing the instance keeps its per-batch tables and FFD
        memo warm across solve/measure alternations."""
        return self._allocator if self._allocator is not None \
            else self.allocator()

    def split(self, result: Optional[SolveResult] = None,
              batch: Optional[int] = None) -> List[Allocation]:
        """Service-scoped slices of the (last) joint allocation, annotated
        with per-tenant predicted load and critical-path latency."""
        res = self._resolve_result(result)
        return self._current_allocator().per_tenant_allocations(
            res.allocation, batch if batch is not None else self.batch)

    # ---- static-partition baseline -------------------------------------

    def solve_partitioned(self, partition: Sequence[int],
                          policy: str = "max-peak",
                          sa: Optional[SAConfig] = None,
                          loads=None) -> Tuple[float, List[SolveResult]]:
        """The consolidation baseline: statically split the cluster into
        per-tenant partitions (``partition[t]`` whole devices for tenant
        t) and solve each tenant ALONE on its share.  Returns a static
        objective (higher is better, so partitions compare uniformly) and
        the per-tenant results, with placements shifted onto each
        partition's global device ids so the whole static deployment can
        be simulated on the shared timeline.

        For ``max-peak``/``camelot-nc`` the objective is the static λ —
        min over tenants of objective/weight (0.0 when any tenant is
        infeasible).  For ``min-resource`` it is the NEGATED total quota
        across tenants at their required ``loads`` (-inf when any tenant
        cannot meet its load), mirroring the joint solve's
        quota-minimising objective."""
        assert len(partition) == self.n_tenants
        assert all(p >= 1 for p in partition), partition
        assert sum(partition) <= self.cluster.devices, \
            (partition, self.cluster.devices)
        pred = self._require_predictor()
        min_resource = policy == "min-resource"
        req = self._required_loads(loads) if min_resource \
            else [None] * self.n_tenants
        results: List[SolveResult] = []
        lam = float("inf")
        quota_total = 0.0
        all_feasible = True
        start = 0
        for t, graph, off, n_dev, load in zip(
                self.tenant_set.tenants, self.graphs,
                self.tenant_set.offsets, partition, req):
            sub = PipelinePredictor(
                pred.stages[off:off + graph.n_nodes])
            eff = replace(sa if sa is not None else SAConfig(),
                          bandwidth_constraint=policy != "camelot-nc")
            solo = CamelotAllocator(graph, sub, self.cluster.device_spec,
                                    int(n_dev),
                                    comm=self.cluster.comm_model(), sa=eff)
            if min_resource:
                res = solo.solve_min_resource(self.batch, float(load))
            else:
                res = solo.solve_max_load(self.batch)
            res.comm, res.policy = solo.comm, f"static/{policy}"
            if res.feasible and res.allocation.placement is not None:
                for st in res.allocation.placement.per_stage:
                    st[:] = [(d + start, q) for d, q in st]
                lam = min(lam, res.objective / max(t.weight, 1e-9))
                quota_total += res.allocation.total_quota()
            else:
                all_feasible = False
            results.append(res)
            start += int(n_dev)
        if not all_feasible:
            return (-float("inf") if min_resource else 0.0), results
        return (-quota_total if min_resource else lam), results

    def best_static_partition(self, policy: str = "max-peak",
                              sa: Optional[SAConfig] = None, loads=None,
                              ) -> Tuple[float, List[int],
                                         List[SolveResult]]:
        """Exhaust every whole-device split of the cluster (each tenant
        gets ≥ 1 device) and keep the best static objective — the
        strongest partitioned competitor the joint solve is charged
        against in ``benchmarks/bench_multitenant.py``."""
        if self.cluster.devices < self.n_tenants:
            raise ValueError(
                f"no static partition exists: {self.n_tenants} tenants "
                f"need at least one whole device each, cluster has "
                f"{self.cluster.devices} (the joint solve can still share "
                "fractional devices)")
        best = (0.0, None, None)
        for part in _compositions(self.cluster.devices, self.n_tenants):
            lam, results = self.solve_partitioned(part, policy=policy,
                                                  sa=sa, loads=loads)
            if best[1] is None or lam > best[0]:
                best = (lam, list(part), results)
        return best

    # ---- 3. simulate ---------------------------------------------------

    def _make_sim(self, res: SolveResult,
                  sim: Optional[SimConfig]) -> MultiTenantSimulator:
        assert res.feasible and res.allocation.placement is not None, \
            "joint result is not placeable"
        return MultiTenantSimulator(
            self.tenant_set, self.split(result=res),
            self.cluster.device_spec,
            res.comm if res.comm is not None else self.cluster.comm_model(),
            sim=sim)

    def simulate(self, loads=None, sim: Optional[SimConfig] = None,
                 result: Optional[SolveResult] = None,
                 faults: Optional[FaultSpec] = None) -> MultiSimResult:
        """Charge the joint allocation on the shared cluster: every tenant
        offered its own load (default: per-tenant ``QoSSpec.load``), one
        virtual timeline, shared per-device contention.  ``faults``
        injects a seeded fault script into the run."""
        res = self._resolve_result(result)
        return self._make_sim(res, sim).run(self._required_loads(loads),
                                            faults=faults)

    def find_peak(self, sim: Optional[SimConfig] = None,
                  result: Optional[SolveResult] = None, lo: float = 1.0,
                  hi: float = 4096.0, tol: float = 0.03, max_iter: int = 14,
                  seed_load: Optional[float] = None, parallel: int = 1,
                  abort: bool = True) -> Tuple[float, MultiSimResult]:
        """Search the highest normalized load λ at which EVERY tenant's
        simulated p99 meets its own target when tenant t is offered
        λ·weight_t qps — the measurement counterpart of the joint
        max-peak objective.  Shares one simulator across probes, seeds
        the bracket from the joint solve's predicted λ
        (``SolveResult.load``) and early-aborts infeasible probes; see
        ``CamelotSession.find_peak`` for the knobs."""
        res = self._resolve_result(result)
        simulator = self._make_sim(res, sim)
        if seed_load is None:
            seed_load = res.load
        return find_joint_peak(lambda: simulator, self.qos_targets,
                               weights=self.weights, lo=lo, hi=hi, tol=tol,
                               max_iter=max_iter, seed_load=seed_load or None,
                               parallel=parallel, abort=abort)

    def simulate_static(self, results: List[SolveResult], loads,
                        sim: Optional[SimConfig] = None) -> MultiSimResult:
        """Simulate a static partition (``solve_partitioned`` output) on
        the same shared timeline, so joint and static deployments are
        charged by identical physics."""
        allocs = [r.allocation for r in results]
        assert all(a.placement is not None for a in allocs)
        return MultiTenantSimulator(
            self.tenant_set, allocs, self.cluster.device_spec,
            self.cluster.comm_model(), sim=sim).run(loads)

    # ---- 4. serve (live) -----------------------------------------------

    def serve(self, tenant_stages=None,
              result: Optional[SolveResult] = None,
              comm_mechanism: str = "auto", batch_timeout: float = 0.05,
              seq_len: int = 16, backend: str = "threads",
              spec: Optional[ServeSpec] = None, *, reduced: bool = False,
              device=None):
        """A live ``MultiTenantEngine`` running the joint allocation's
        per-tenant slices against one shared worker pool.  Omitted
        ``tenant_stages`` are built as in ``CamelotSession.serve`` (full
        width on the card unless ``reduced``/``device`` say otherwise).
        ``backend`` picks threads (default) or worker processes, as in
        ``CamelotSession.serve``; a full ``ServeSpec`` overrides all
        backend/fault knobs at once."""
        from repro_torch.serving import ModelStageServer, MultiTenantEngine
        res = self._resolve_result(result)
        assert res.feasible and res.allocation.placement is not None, \
            "cannot serve an infeasible joint allocation"
        if spec is None:
            spec = ServeSpec(backend=backend, comm_mechanism=comm_mechanism,
                             batch_timeout=batch_timeout)
        if tenant_stages is None:
            tenant_stages = []
            for graph in self.graphs:
                missing = [n.name for n in graph.nodes if n.arch is None]
                if missing:
                    raise ValueError(
                        f"nodes {missing} carry no model-zoo arch; pass "
                        "tenant_stages explicitly")
                tenant_stages.append(
                    [ModelStageServer(n.name, n.arch, seq_len=seq_len,
                                      reduced=reduced, device=device)
                     for n in graph.nodes])
        self._stages = [list(s) for s in tenant_stages]
        return MultiTenantEngine(
            self._stages, self.graphs, self.split(result=res),
            comm_model=res.comm if res.comm is not None
            else self.cluster.comm_model(), **spec.engine_kwargs())

    def make_traces(self, n: int, qps_per_tenant, seed: int = 0):
        """One query trace per tenant, each shaped for that tenant's entry
        stage — call after ``serve()``."""
        from repro_torch.serving import make_trace
        assert self._stages is not None, "serve() first"
        out = []
        for ti, (graph, stages) in enumerate(zip(self.graphs, self._stages)):
            entry = stages[graph.entries[0]]
            out.append(make_trace(n, qps=float(qps_per_tenant[ti]),
                                  seq_len=entry.seq_len,
                                  vocab=entry.cfg.vocab_size,
                                  seed=seed + ti))
        return out

    # ---- 5. online runtime ---------------------------------------------

    def runtime(self, rt: Optional[RuntimeConfig] = None,
                sa=None, resume: bool = False) -> MultiTenantRuntime:
        """The joint online loop.  ``resume=True`` seeds it from the
        session's persisted ``last_result`` (crash-restart: a loaded
        session re-attaches its incumbent joint allocation with NO cold
        solve)."""
        if self._runtime is None:
            initial = self.last_result if resume and \
                self.last_result is not None and \
                self.last_result.feasible else None
            self._runtime = MultiTenantRuntime(
                self.tenant_set, self._require_predictor(),
                self.cluster.device_spec, self.cluster.devices, self.batch,
                rt=rt, sa=sa, comm=self.cluster.comm_model(),
                initial=initial)
        return self._runtime

    def observe(self, qps_samples) -> None:
        self.runtime().observe(qps_samples)

    def reallocate(self, now: float = 0.0) -> Allocation:
        """Joint re-solve for the current per-tenant load estimates,
        warm-started from the incumbent joint allocation."""
        return self.runtime().reallocate(now)

    def attach_engine(self, engine) -> None:
        self.runtime().attach_engine(engine)

    # ---- 5b. tenant lifecycle control plane ----------------------------

    def lifecycle(self, rt: Optional[RuntimeConfig] = None, sa=None,
                  resume: bool = False) -> LifecycleManager:
        """The tenant lifecycle control plane (``core.lifecycle``):
        admission with certified denial quotes, priority preemption and
        spec mutation over this session's tenants.  Built once; the
        ``admit``/``evict``/``scale_tenant``/``retarget_qos`` wrappers
        below keep the session's specs, tenant set, predictor and
        runtime in lock-step with it."""
        if self._lifecycle is None:
            initial = self.last_result if resume and \
                self.last_result is not None and \
                self.last_result.feasible else None
            if sa is None and self.solver is not None:
                sa = self.solver.sa_config()
            self._lifecycle = LifecycleManager(
                self.tenant_set, self._require_predictor(),
                self.cluster.device_spec, self.cluster.devices, self.batch,
                rt=rt, sa=sa, comm=self.cluster.comm_model(),
                initial=initial, profile_seed=self.seed)
            if self._lifecycle_events:
                self._lifecycle.restore_events(self._lifecycle_events)
            self._runtime = self._lifecycle.runtime
        return self._lifecycle

    def _sync_from_lifecycle(self) -> None:
        """Pull the manager's post-operation state into the session: the
        tenant set and predictor (the union namespace may have changed),
        the live runtime, and the allocator cache (now stale)."""
        mgr = self._lifecycle
        self.tenant_set = mgr.tenants
        self.predictor = mgr.predictor
        self._allocator = None
        self._runtime = mgr.runtime

    def _record_joint(self, res: Optional[SolveResult]) -> None:
        if res is not None and res.feasible:
            res.comm = self.cluster.comm_model()
            self.last_result = res
            self.results.append(res)

    def admit(self, service, now: float = 0.0, **kw) -> AdmissionDecision:
        """Admission-controlled tenant arrival.  ``service`` takes any
        form ``MultiServiceSession(services=[...])`` accepts (TenantSpec,
        core Tenant, (service, qos) pair, ServiceGraph, spec dict).
        Extra keywords reach ``LifecycleManager.admit`` (``warm``,
        ``quote``, ``quote_kinds``, ``stage_predictor``).  On admission
        the session's spec/tenant set/runtime all advance; on denial the
        returned decision carries the certified quotes."""
        spec_t = service if isinstance(service, TenantSpec) else \
            self._lift([service], self.spec.name).tenants[0]
        decision = self.lifecycle().admit(now, spec_t.build(), **kw)
        if decision.admitted:
            self.spec = MultiServiceSpec(self.spec.name,
                                         self.spec.tenants + (spec_t,))
            self._sync_from_lifecycle()
            self._record_joint(decision.result)
        return decision

    def evict(self, name: str, now: float = 0.0) -> SolveResult:
        """Remove tenant ``name`` and re-solve the survivors (warm from
        their own slices of the incumbent joint allocation)."""
        res = self.lifecycle().remove(now, name)
        self.spec = MultiServiceSpec(
            self.spec.name,
            tuple(t for t in self.spec.tenants if t.name != name))
        self._sync_from_lifecycle()
        self._record_joint(res)
        return res

    def scale_tenant(self, name: str,
                     required_load: Optional[float] = None,
                     weight: Optional[float] = None,
                     now: float = 0.0) -> SolveResult:
        """Change a tenant's demand and/or weight; the spec mutation
        commits only when the warm re-solve is feasible."""
        res = self.lifecycle().scale_tenant(now, name,
                                            required_load=required_load,
                                            weight=weight)
        if res.feasible:
            new = []
            for t in self.spec.tenants:
                if t.name == name:
                    qos = t.qos
                    if required_load is not None:
                        load = LoadSpec(qps=float(required_load)) \
                            if qos.load is None \
                            else replace(qos.load, qps=float(required_load))
                        qos = replace(qos, load=load)
                    t = replace(t, qos=qos,
                                weight=float(weight)
                                if weight is not None else t.weight)
                new.append(t)
            self.spec = MultiServiceSpec(self.spec.name, tuple(new))
            self._sync_from_lifecycle()
            self._record_joint(res)
        return res

    def retarget_qos(self, name: str, qos_target: float,
                     now: float = 0.0) -> SolveResult:
        """Change a tenant's end-to-end latency target; commits only on a
        feasible warm re-solve."""
        res = self.lifecycle().retarget_qos(now, name, qos_target)
        if res.feasible:
            self.spec = MultiServiceSpec(self.spec.name, tuple(
                replace(t, qos=replace(t.qos,
                                       latency_target=float(qos_target)))
                if t.name == name else t for t in self.spec.tenants))
            self._sync_from_lifecycle()
            self._record_joint(res)
        return res

    def preempt(self, now: float = 0.0, targets=None) -> Allocation:
        """Load-spike preemption: shed low tiers in strict ascending
        ``(priority, weight)`` order until the pool holds the rest."""
        return self.lifecycle().preempt(now, targets=targets)

    # ---- 6. persistence -------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the multi-service specs and the last joint solve, so a
        restart simulates/serves the saved joint allocation instantly."""
        doc = {
            "kind": "camelot-multi-session",
            "services": self.spec.to_dict(),
            "cluster": self.cluster.to_dict(),
            "batch": self.batch,
            "seed": self.seed,
            "solver": self.solver.to_dict()
            if self.solver is not None else None,
            "result": self.last_result.to_dict()
            if self.last_result is not None else None,
            "lifecycle": self._lifecycle.events_to_dict()
            if self._lifecycle is not None else
            (self._lifecycle_events or None),
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "MultiServiceSession":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("kind") != "camelot-multi-session":
            raise ValueError(f"{path} is not a saved MultiServiceSession "
                             f"(kind={doc.get('kind')!r})")
        sess = cls(MultiServiceSpec.from_dict(doc["services"]),
                   ClusterSpec.from_dict(doc["cluster"]),
                   batch=int(doc.get("batch", 8)),
                   seed=int(doc.get("seed", 0)),
                   solver=SolverSpec.from_dict(doc["solver"])
                   if doc.get("solver") is not None else None)
        if doc.get("result") is not None:
            res = SolveResult.from_dict(doc["result"],
                                        comm=sess.cluster.comm_model())
            sess.last_result = res
            sess.results.append(res)
        if doc.get("lifecycle"):
            sess._lifecycle_events = [dict(e) for e in doc["lifecycle"]]
        return sess


def _compositions(total: int, parts: int):
    """All ways to hand ``total`` whole devices to ``parts`` tenants with
    every tenant getting at least one."""
    if parts == 1:
        if total >= 1:
            yield (total,)
        return
    for first in range(1, total - parts + 2):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest
