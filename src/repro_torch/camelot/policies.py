"""Pluggable allocation policies: one interface over every solver.

A *policy* turns ``(ServiceSpec, PipelinePredictor, ClusterSpec, QoSSpec)``
into a ``SolveResult`` — the paper's two Camelot cases (max-peak Eq. 1,
min-resource Eq. 2+3) and the comparison strategies of
``repro_torch.sim.baselines`` (even allocation, standalone, Laius) all
implement the same ``Policy`` protocol and live in one registry, so callers
select by name (``session.solve(policy="max-peak")``) and new policies plug
in via ``register_policy`` without touching the session or the benchmarks.

The returned ``SolveResult`` additionally carries the ``CommModel`` the
allocation was priced against (baselines are host-staged,
contention-unaware; Camelot routes per-edge) so downstream simulation and
serving charge communication exactly as the policy assumed it.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.camelot.specs import ClusterSpec, QoSSpec, ServiceSpec
from repro_torch.core.allocator import CamelotAllocator, SAConfig, SolveResult
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.types import QUOTA_STEP, Allocation
from repro_torch.sim import baselines


@runtime_checkable
class Policy(Protocol):
    """The pluggable-policy contract: a ``name`` for the registry and a
    ``solve`` producing a placed allocation for the given specs."""
    name: str

    def solve(self, spec: ServiceSpec, predictor: PipelinePredictor,
              cluster: ClusterSpec, qos: QoSSpec,
              batch: int = 8) -> SolveResult:
        ...


class UnknownPolicyError(KeyError):
    """Raised when a policy name is not in the registry."""

    def __init__(self, name: str, available: Tuple[str, ...]):
        super().__init__(name)
        self.name = name
        self.available = available

    def __str__(self) -> str:
        return (f"unknown policy {self.name!r}; registered: "
                f"{', '.join(self.available)}")


_REGISTRY: Dict[str, Policy] = {}


def register_policy(policy: Policy, *, overwrite: bool = False) -> Policy:
    """Add a policy to the registry under ``policy.name``.  Re-registering
    an existing name needs ``overwrite=True`` (guards against two plugins
    silently shadowing each other).  Returns the policy, so it can be used
    as a decorator on a no-arg policy class."""
    if isinstance(policy, type):
        policy = policy()
    name = getattr(policy, "name", None)
    if not name or not callable(getattr(policy, "solve", None)):
        raise TypeError(f"{policy!r} does not implement the Policy protocol "
                        "(needs .name and .solve)")
    if not overwrite and name in _REGISTRY and _REGISTRY[name] is not policy:
        raise ValueError(f"policy {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[name] = policy
    return policy


def get_policy(policy) -> Policy:
    """Resolve a registry name or pass a Policy instance through."""
    if isinstance(policy, str):
        try:
            return _REGISTRY[policy]
        except KeyError:
            raise UnknownPolicyError(policy, available_policies()) from None
    if isinstance(policy, Policy):
        return policy
    raise TypeError(f"expected a policy name or Policy instance, got "
                    f"{policy!r}")


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Built-in policies
# --------------------------------------------------------------------------

def _allocator(spec: ServiceSpec, predictor: PipelinePredictor,
               cluster: ClusterSpec, qos: QoSSpec,
               sa: Optional[SAConfig], bandwidth_constraint: bool):
    # the SA solver's decision lattice (and the predictors' tabulation
    # axis) is the module-wide QUOTA_STEP grid; a cluster declaring a
    # different lattice must fail loudly, not be silently ignored
    if abs(cluster.quota_step - QUOTA_STEP) > 1e-12:
        raise ValueError(
            f"the allocator solves on the fixed QUOTA_STEP={QUOTA_STEP} "
            f"lattice; ClusterSpec.quota_step={cluster.quota_step} is only "
            "supported by quantize()-built demo allocations")
    graph = spec.build(qos)
    comm = cluster.comm_model()
    sa = replace(sa if sa is not None else SAConfig(),
                 bandwidth_constraint=bandwidth_constraint)
    return CamelotAllocator(graph, predictor, cluster.device_spec,
                            cluster.devices, comm=comm, sa=sa), comm


class MaxPeakPolicy:
    """Camelot Case 1 (Eq. 1): maximise the pipeline's peak supported load
    — the min aggregate node throughput — under Constraints 1-5.
    ``camelot-nc`` is the same solver with the bandwidth constraint off
    (the §VIII-D ablation)."""

    def __init__(self, sa: Optional[SAConfig] = None,
                 bandwidth_constraint: bool = True, name: str = "max-peak"):
        self.name = name
        self.sa = sa
        self.bandwidth_constraint = bandwidth_constraint

    def solve(self, spec, predictor, cluster, qos, batch: int = 8, *,
              sa: Optional[SAConfig] = None, solver=None,
              warm_start: Optional[Allocation] = None) -> SolveResult:
        if sa is None and solver is not None:
            sa = solver.sa_config()          # SolverSpec mode/budget knob
        alloc, comm = _allocator(spec, predictor, cluster, qos,
                                 sa if sa is not None else self.sa,
                                 self.bandwidth_constraint)
        res = alloc.solve_max_load(batch, warm_start=warm_start)
        res.comm, res.policy = comm, self.name
        return res


class MinResourcePolicy:
    """Camelot Case 2 (Eq. 2 + Eq. 3): minimise total quota while
    supporting a required load.  The load target comes from (in order)
    the ``solve(load=...)`` call, the policy instance, or
    ``QoSSpec.load.qps``."""

    def __init__(self, load: Optional[float] = None,
                 sa: Optional[SAConfig] = None,
                 bandwidth_constraint: bool = True,
                 name: str = "min-resource"):
        self.name = name
        self.load = load
        self.sa = sa
        self.bandwidth_constraint = bandwidth_constraint

    def solve(self, spec, predictor, cluster, qos, batch: int = 8, *,
              load: Optional[float] = None, sa: Optional[SAConfig] = None,
              solver=None,
              warm_start: Optional[Allocation] = None) -> SolveResult:
        if sa is None and solver is not None:
            sa = solver.sa_config()          # SolverSpec mode/budget knob
        target = load if load is not None else self.load
        if target is None and qos.load is not None:
            target = qos.load.qps
        if target is None:
            raise ValueError("min-resource needs a load target: pass "
                             "solve(load=...), configure the policy, or set "
                             "QoSSpec.load")
        alloc, comm = _allocator(spec, predictor, cluster, qos,
                                 sa if sa is not None else self.sa,
                                 self.bandwidth_constraint)
        res = alloc.solve_min_resource(batch, float(target),
                                       warm_start=warm_start)
        res.comm, res.policy = comm, self.name
        return res


def _predicted_min_throughput(alloc: Allocation,
                              predictor: Optional[PipelinePredictor],
                              batch: int) -> float:
    """Eq. 1 charged on a baseline's allocation (its reported objective)."""
    if predictor is None:
        return 0.0
    return min(s.n_instances * predictor.stages[i].throughput(batch, s.quota)
               for i, s in enumerate(alloc.stages))


class BaselinePolicy:
    """A ``repro_torch.sim.baselines`` strategy behind the Policy interface.
    These are closed-form (no search): ``iterations=0``,
    ``mode="closed-form"``, and the objective is the predicted min node
    throughput of whatever allocation the strategy picked."""

    def __init__(self, name: str, fn, uses_predictor: bool):
        self.name = name
        self._fn = fn
        self._uses_predictor = uses_predictor

    def solve(self, spec, predictor, cluster, qos,
              batch: int = 8) -> SolveResult:
        graph = spec.build(qos)
        t0 = time.perf_counter()
        if self._uses_predictor:
            alloc, comm = self._fn(graph, predictor, cluster.device_spec,
                                   cluster.devices, batch)
        else:
            alloc, comm = self._fn(graph, cluster.device_spec,
                                   cluster.devices, batch)
        res = SolveResult(
            allocation=alloc,
            objective=_predicted_min_throughput(alloc, predictor, batch),
            feasible=alloc.placement is not None,
            solve_time=time.perf_counter() - t0,
            iterations=0, mode="closed-form")
        res.comm, res.policy = comm, self.name
        if res.feasible and res.objective > 0:
            res.load = res.objective     # predicted min node throughput
        return res


register_policy(MaxPeakPolicy())
register_policy(MinResourcePolicy())
register_policy(MaxPeakPolicy(bandwidth_constraint=False, name="camelot-nc"))
register_policy(BaselinePolicy("even", baselines.even_allocation,
                               uses_predictor=False))
register_policy(BaselinePolicy("standalone", baselines.standalone,
                               uses_predictor=False))
register_policy(BaselinePolicy("laius", baselines.laius,
                               uses_predictor=True))
