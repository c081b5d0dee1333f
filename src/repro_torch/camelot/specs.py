"""Declarative control-plane specs: the data half of the
``repro_torch.camelot`` facade.

Three frozen dataclasses describe a deployment completely:

  * ``ServiceSpec`` — WHAT runs: the microservice DAG (nodes + explicit
    edges with per-edge payload sizing; a chain shorthand covers the
    paper's linear pipelines).
  * ``ClusterSpec`` — WHERE it runs: device model and count, the compute
    quota lattice, PCIe/interconnect bandwidths, and whether the
    global-memory hand-off mechanism (paper §VI-B) is available.
  * ``QoSSpec``    — HOW WELL it must run: tail percentile, end-to-end
    latency target, and the offered-load model (``LoadSpec``).

Every spec round-trips through plain dicts (``to_dict``/``from_dict`` with
``spec == Spec.from_dict(spec.to_dict())``), so workloads and benchmark
configurations are data — JSON/YAML-serialisable, diffable, and buildable
without touching the internal layers.  ``ServiceSpec.build`` lowers the
declarative form onto the executable ``ServiceGraph`` the allocator,
simulator and live engine consume.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.comm import CommModel
from repro_torch.core.qos import QoSTracker
from repro_torch.core.types import (H100, QUOTA_STEP, RTX_2080TI, UTILITY_FNS,
                                    V100, DeviceSpec, MicroserviceProfile,
                                    Pipeline, ServiceEdge, ServiceGraph,
                                    Tenant)

#: devices addressable by name in ``ClusterSpec.from_dict``: the paper's
#: two GPUs and the port's card (a cluster of TPUs is no deployment of
#: the port, so "tpu-v5e" is refused as unknown)
KNOWN_DEVICES: Dict[str, DeviceSpec] = {
    d.name: d for d in (RTX_2080TI, V100, H100)}


def _chain_edges(n_nodes: int) -> Tuple[ServiceEdge, ...]:
    return tuple(ServiceEdge(i, i + 1) for i in range(n_nodes - 1))


@dataclass(frozen=True)
class ServiceSpec:
    """A user-facing service as pure data: nodes, edges, QoS target.

    ``nodes`` are ``MicroserviceProfile``s (already frozen dataclasses);
    ``edges`` are ``ServiceEdge``s whose optional
    ``payload_bytes_per_query`` overrides the default payload sizing.
    ``from_dict`` accepts ``"edges": "chain"`` (or simply omits the key)
    as the linear-pipeline shorthand.
    """
    name: str
    nodes: Tuple[MicroserviceProfile, ...]
    edges: Tuple[ServiceEdge, ...]
    qos_target: float = 0.25           # end-to-end 99%-ile target (seconds)

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "edges", tuple(self.edges))

    # ---- constructors --------------------------------------------------

    @classmethod
    def chain(cls, name: str, nodes: Sequence[MicroserviceProfile],
              qos_target: float = 0.25) -> "ServiceSpec":
        """The paper's shape: node i feeds node i+1."""
        return cls(name, tuple(nodes), _chain_edges(len(nodes)), qos_target)

    @classmethod
    def from_graph(cls, graph: ServiceGraph) -> "ServiceSpec":
        """Lift an executable ``ServiceGraph``/``Pipeline`` back to data."""
        return cls(graph.name, tuple(graph.nodes), tuple(graph.edges),
                   graph.qos_target)

    # ---- derived -------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def is_chain(self) -> bool:
        return self.edges == _chain_edges(len(self.nodes))

    def build(self, qos: Optional["QoSSpec"] = None) -> ServiceGraph:
        """Lower to the executable graph (``Pipeline`` for pure chains so
        chain-era ``isinstance`` checks keep working).  ``qos`` overrides
        the spec's latency target when it carries one."""
        target = self.qos_target
        if qos is not None and qos.latency_target is not None:
            target = qos.latency_target
        if self.is_chain:
            return Pipeline(self.name, list(self.nodes), qos_target=target)
        return ServiceGraph(self.name, list(self.nodes), list(self.edges),
                            qos_target=target)

    # ---- dict round-trip ----------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "qos_target": self.qos_target,
            "nodes": [asdict(n) for n in self.nodes],
            "edges": [asdict(e) for e in self.edges],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServiceSpec":
        nodes = tuple(n if isinstance(n, MicroserviceProfile)
                      else MicroserviceProfile(**n) for n in d["nodes"])
        edges = d.get("edges", "chain")
        if isinstance(edges, str):
            if edges != "chain":
                raise ValueError(f"unknown edges shorthand {edges!r}")
            edges = _chain_edges(len(nodes))
        else:
            edges = tuple(e if isinstance(e, ServiceEdge)
                          else ServiceEdge(**e) for e in edges)
        return cls(d["name"], nodes, edges,
                   qos_target=float(d.get("qos_target", 0.25)))


@dataclass(frozen=True)
class ClusterSpec:
    """The accelerator fleet as data.

    ``device`` carries the per-device model (compute, memory, MPS instance
    limit, PCIe host link); ``pcie_total``/``pcie_stream`` override its
    host-link bandwidths without redefining the whole device;
    ``ici_bandwidth``/``ici_latency`` price the device-to-device
    interconnect (NVLink/ICI); ``quota_step`` is the compute-quota lattice
    every allocation snaps to (``quantize``).  NOTE: the SA solver's
    decision lattice is the module-wide ``QUOTA_STEP`` grid — the solver
    policies reject a cluster declaring any other ``quota_step`` (it is
    honoured by ``quantize``-built demo allocations only).
    """
    devices: int = 2
    device: DeviceSpec = RTX_2080TI
    quota_step: float = QUOTA_STEP
    pcie_total: Optional[float] = None     # override device.host_link_total
    pcie_stream: Optional[float] = None    # override device.host_link_stream
    ici_bandwidth: float = 50e9            # NVLink/ICI B/s
    ici_latency: float = 2e-6
    global_memory: bool = True             # §VI-B hand-off available
    # measured Fig. 11 crossover (bytes); None keeps the modelled
    # constant
    crossover_bytes: Optional[float] = None

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if not 0.0 < self.quota_step <= 1.0:
            raise ValueError(f"quota_step must be in (0, 1], got "
                             f"{self.quota_step}")

    # ---- derived -------------------------------------------------------

    @property
    def device_spec(self) -> DeviceSpec:
        """The device with any cluster-level PCIe overrides applied."""
        if self.pcie_total is None and self.pcie_stream is None:
            return self.device
        return replace(
            self.device,
            host_link_total=self.pcie_total
            if self.pcie_total is not None else self.device.host_link_total,
            host_link_stream=self.pcie_stream
            if self.pcie_stream is not None else self.device.host_link_stream)

    def quantize(self, quota: float) -> float:
        """Snap a raw quota onto the lattice: the largest multiple of
        ``quota_step`` that does not exceed ``quota`` (so per-device sums
        stay packable), floored at one step and capped at a full device."""
        units = math.floor(quota / self.quota_step + 1e-9)
        q = max(1, min(units, round(1.0 / self.quota_step))) * self.quota_step
        return round(q, 6)

    def comm_model(self) -> CommModel:
        return CommModel(self.device_spec,
                         global_memory_enabled=self.global_memory,
                         ici_bandwidth=self.ici_bandwidth,
                         ici_latency=self.ici_latency,
                         crossover_override=self.crossover_bytes)

    # ---- dict round-trip ----------------------------------------------

    def to_dict(self) -> dict:
        dev = self.device
        known = KNOWN_DEVICES.get(dev.name)
        return {
            "devices": self.devices,
            "device": dev.name if known == dev else asdict(dev),
            "quota_step": self.quota_step,
            "pcie_total": self.pcie_total,
            "pcie_stream": self.pcie_stream,
            "ici_bandwidth": self.ici_bandwidth,
            "ici_latency": self.ici_latency,
            "global_memory": self.global_memory,
            "crossover_bytes": self.crossover_bytes,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ClusterSpec":
        d = dict(d)
        dev = d.get("device", RTX_2080TI)
        if isinstance(dev, str):
            if dev not in KNOWN_DEVICES:
                raise ValueError(f"unknown device {dev!r}; known: "
                                 f"{sorted(KNOWN_DEVICES)}")
            dev = KNOWN_DEVICES[dev]
        elif isinstance(dev, Mapping):
            dev = DeviceSpec(**dev)
        d["device"] = dev
        return cls(**d)


@dataclass(frozen=True)
class ServeSpec:
    """Execution-backend knobs for the live serving plane as data.

    ``session.serve(spec=ServeSpec(...))`` threads these into
    ``PipelineEngine``/``MultiTenantEngine``: ``backend`` picks the
    thread pool (default) or the worker-process pool;
    ``comm_mechanism`` pins the per-edge hand-off for A/B runs ("auto"
    routes by the comm crossover); ``start_method``/``shm_*``/
    ``supervise_timeout`` are the worker-process pool's; the fault knobs
    (``max_retries``, ``retry_backoff``, ``deadline``) are the engine's.
    """
    backend: str = "threads"               # "threads" | "processes"
    comm_mechanism: str = "auto"           # "auto" | "device" | "host"
    batch_timeout: float = 0.05
    start_method: str = "spawn"            # worker-process start method
    shm_slots: int = 32                    # per-worker arena ring slots
    shm_slot_bytes: int = 1 << 20          # per-slot payload capacity
    supervise_timeout: float = 5.0         # hung-worker heartbeat silence
    max_retries: int = 0
    retry_backoff: float = 0.0
    deadline: Optional[float] = None

    def __post_init__(self):
        if self.backend not in ("threads", "processes"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.comm_mechanism not in ("auto", "device", "host"):
            raise ValueError(
                f"unknown comm_mechanism {self.comm_mechanism!r}")

    def engine_kwargs(self) -> dict:
        """The knobs in engine-constructor keyword form."""
        return {
            "backend": self.backend,
            "comm_mechanism": self.comm_mechanism,
            "batch_timeout": self.batch_timeout,
            "start_method": self.start_method,
            "shm_slots": self.shm_slots,
            "shm_slot_bytes": self.shm_slot_bytes,
            "supervise_timeout": self.supervise_timeout,
            "max_retries": self.max_retries,
            "retry_backoff": self.retry_backoff,
            "deadline": self.deadline,
        }

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServeSpec":
        return cls(**d)


@dataclass(frozen=True)
class LoadSpec:
    """Offered-load model: a constant level or the diurnal pattern the
    paper motivates Camelot with (§I)."""
    kind: str = "constant"              # "constant" | "diurnal"
    qps: float = 100.0                  # constant level / diurnal peak
    period: float = 86_400.0            # diurnal period (seconds)
    low_frac: float = 0.25              # diurnal trough as fraction of peak

    def __post_init__(self):
        if self.kind not in ("constant", "diurnal"):
            raise ValueError(f"unknown load kind {self.kind!r}")

    def fn(self) -> Callable[[float], float]:
        """The load trace load(t) -> qps this spec describes."""
        if self.kind == "constant":
            qps = self.qps
            return lambda t: qps
        from repro_torch.core.runtime import diurnal_load
        return diurnal_load(self.qps, period=self.period,
                            low_frac=self.low_frac)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "LoadSpec":
        return cls(**d)


@dataclass(frozen=True)
class QoSSpec:
    """The service-level objective as data.

    ``latency_target=None`` inherits the ``ServiceSpec``'s own target, so
    one QoSSpec can drive a whole suite of services with per-service
    targets; setting it overrides the service."""
    latency_target: Optional[float] = None   # end-to-end target (seconds)
    percentile: float = 99.0
    load: Optional[LoadSpec] = None

    def resolve_target(self, service: ServiceSpec) -> float:
        return self.latency_target if self.latency_target is not None \
            else service.qos_target

    def tracker(self, service: ServiceSpec) -> QoSTracker:
        return QoSTracker(target=self.resolve_target(service),
                          percentile=self.percentile)

    def to_dict(self) -> dict:
        return {
            "latency_target": self.latency_target,
            "percentile": self.percentile,
            "load": self.load.to_dict() if self.load is not None else None,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "QoSSpec":
        load = d.get("load")
        if isinstance(load, Mapping):
            load = LoadSpec.from_dict(load)
        return cls(latency_target=d.get("latency_target"),
                   percentile=float(d.get("percentile", 99.0)),
                   load=load)


@dataclass(frozen=True)
class SolverSpec:
    """HOW the solver runs, as data: evaluation mode, annealing budget and
    the optional hierarchical pod decomposition — the scaling knobs of the
    datacenter-scale solver, serialisable like every other spec.

    ``mode`` selects the annealing kernel ("scalar" | "vectorized" |
    "incremental"; "jax", the reference's jitted kernel, is accepted as
    data but raises ``NotImplementedError`` when it solves);
    ``pod_size`` switches joint multi-tenant solves to the hierarchical
    pod decomposition (``core.hierarchy``) with that many devices per pod
    — ``None`` keeps the flat joint solve.  ``iterations``/``seed`` feed
    the underlying ``SAConfig`` (other SA knobs keep their defaults; pass
    a full ``SAConfig`` to the session for fine control).
    """
    mode: str = "vectorized"
    iterations: int = 2000
    seed: int = 0
    pod_size: Optional[int] = None        # None => flat joint solve
    repair_rounds: int = 2
    parallel_pods: bool = True

    def __post_init__(self):
        from repro_torch.core.allocator import CamelotAllocator
        if self.mode not in CamelotAllocator.MODES:
            raise ValueError(f"unknown solver mode {self.mode!r}; "
                             f"available: {CamelotAllocator.MODES}")
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got "
                             f"{self.iterations}")
        if self.pod_size is not None and self.pod_size < 1:
            raise ValueError(f"pod_size must be >= 1, got {self.pod_size}")

    @property
    def hierarchical(self) -> bool:
        return self.pod_size is not None

    def sa_config(self, base=None):
        """Lower onto a ``SAConfig`` (optionally overriding ``base``)."""
        from repro_torch.core.allocator import SAConfig
        base = base if base is not None else SAConfig()
        return replace(base, mode=self.mode, iterations=self.iterations,
                       seed=self.seed)

    def pod_config(self):
        """The ``PodConfig`` for hierarchical solves (None when flat)."""
        if self.pod_size is None:
            return None
        from repro_torch.core.types import PodConfig
        return PodConfig(pod_size=self.pod_size,
                         repair_rounds=self.repair_rounds,
                         parallel=self.parallel_pods)

    # ---- dict round-trip ----------------------------------------------

    def to_dict(self) -> dict:
        return {"mode": self.mode, "iterations": self.iterations,
                "seed": self.seed, "pod_size": self.pod_size,
                "repair_rounds": self.repair_rounds,
                "parallel_pods": self.parallel_pods}

    @classmethod
    def from_dict(cls, d: Mapping) -> "SolverSpec":
        return cls(mode=str(d.get("mode", "vectorized")),
                   iterations=int(d.get("iterations", 2000)),
                   seed=int(d.get("seed", 0)),
                   pod_size=None if d.get("pod_size") is None
                   else int(d["pod_size"]),
                   repair_rounds=int(d.get("repair_rounds", 2)),
                   parallel_pods=bool(d.get("parallel_pods", True)))


# --------------------------------------------------------------------------
# Multi-service deployments: N (service, QoS) tenants on ONE cluster
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantSpec:
    """One tenant of a multi-service deployment, as data.

    ``weight`` normalises the joint max-peak objective (the solver
    maximises the worst ``supported_load / weight`` across tenants —
    weights express that one tenant needs proportionally more capacity);
    the tenant's required load for joint min-resource solves comes from
    ``qos.load``.

    Lifecycle / isolation knobs (data mirrors of the executable
    ``Tenant`` fields; all default to the pre-lifecycle behaviour):
    ``priority`` is the preemption tier (lower sheds first),
    ``quota_floor``/``quota_cap`` bound the tenant's total compute quota
    as hard solver constraints, and ``utility`` picks the joint max-peak
    objective curve (``linear`` | ``log`` | ``sqrt``)."""
    service: ServiceSpec
    qos: QoSSpec = QoSSpec()
    weight: float = 1.0
    priority: int = 0
    quota_floor: float = 0.0
    quota_cap: Optional[float] = None
    utility: str = "linear"

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.quota_floor < 0:
            raise ValueError(f"quota_floor must be >= 0, got "
                             f"{self.quota_floor}")
        if self.quota_cap is not None and \
                self.quota_cap < max(self.quota_floor, QUOTA_STEP):
            raise ValueError(
                f"quota_cap={self.quota_cap} is below max(quota_floor="
                f"{self.quota_floor}, one lattice step {QUOTA_STEP})")
        if self.utility not in UTILITY_FNS:
            raise ValueError(f"unknown utility {self.utility!r}; "
                             f"available: {', '.join(UTILITY_FNS)}")

    @property
    def name(self) -> str:
        return self.service.name

    def build(self) -> Tenant:
        """Lower to the executable ``repro_torch.core.types.Tenant`` (the QoS
        spec's latency target overrides the service's own, exactly as in
        the single-service session)."""
        return Tenant(
            name=self.service.name,
            graph=self.service.build(self.qos),
            weight=self.weight,
            required_load=self.qos.load.qps
            if self.qos.load is not None else None,
            priority=self.priority,
            quota_floor=self.quota_floor,
            quota_cap=self.quota_cap,
            utility=self.utility)

    def to_dict(self) -> dict:
        return {"service": self.service.to_dict(),
                "qos": self.qos.to_dict(),
                "weight": self.weight,
                "priority": self.priority,
                "quota_floor": self.quota_floor,
                "quota_cap": self.quota_cap,
                "utility": self.utility}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TenantSpec":
        qos = d.get("qos")
        return cls(
            service=ServiceSpec.from_dict(d["service"]),
            qos=QoSSpec.from_dict(qos) if isinstance(qos, Mapping)
            else (qos if qos is not None else QoSSpec()),
            weight=float(d.get("weight", 1.0)),
            priority=int(d.get("priority", 0)),
            quota_floor=float(d.get("quota_floor", 0.0)),
            quota_cap=None if d.get("quota_cap") is None
            else float(d["quota_cap"]),
            utility=str(d.get("utility", "linear")))


@dataclass(frozen=True)
class MultiServiceSpec:
    """A whole multi-tenant deployment as data: N tenants intended for ONE
    shared cluster.  Round-trips through plain dicts like every other
    spec, so a co-location scenario is serialisable/diffable config."""
    name: str
    tenants: Tuple[TenantSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "tenants", tuple(self.tenants))
        if not self.tenants:
            raise ValueError("a MultiServiceSpec needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant service names must be unique: {names}")

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    def to_dict(self) -> dict:
        return {"name": self.name,
                "tenants": [t.to_dict() for t in self.tenants]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "MultiServiceSpec":
        return cls(name=d["name"],
                   tenants=tuple(TenantSpec.from_dict(t)
                                 for t in d["tenants"]))
