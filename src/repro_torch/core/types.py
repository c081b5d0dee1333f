"""Camelot datatypes the serving engine needs (a copy of the reference's
``repro/core/types.py`` subset: device model, profiles as edge sizing
needs them, the service graph, and allocations).

Units are SI throughout: seconds, bytes, FLOPs, bytes/s, queries/s.
  - ``DeviceSpec``  — one accelerator: compute, memory, host link (PCIe),
                      global-memory IPC costs.
  - ``MicroserviceProfile`` — performance curves of one stage.
  - ``ServiceGraph``  — a DAG of stages; the paper's chain is
                      ``ServiceGraph.chain``.
  - ``StageAlloc``/``Placement``/``Allocation`` — (N_i, p_i, s) per stage
                      and the instance -> device packing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# the compute-quota lattice step of the allocator
QUOTA_STEP = 0.05


@dataclass(frozen=True)
class DeviceSpec:
    name: str = "rtx2080ti"
    peak_flops: float = 13.45e12        # fp32 FLOP/s (2080Ti)
    mem_capacity: float = 11e9          # bytes
    mem_bandwidth: float = 616e9        # B/s (2080Ti); V100: 897e9
    max_instances: int = 48             # Volta MPS client limit I
    # host link (16x PCIe 3.0, paper §VI-A)
    host_link_total: float = 12_160e6   # effective B/s
    host_link_stream: float = 3_150e6   # single-stream B/s
    host_link_latency: float = 10e-6    # per-transfer setup
    ipc_latency: float = 33e-6          # global-memory handle overhead
    ipc_setup: float = 1e-3             # one-time channel setup (§VIII-G)


RTX_2080TI = DeviceSpec()


@dataclass(frozen=True)
class MicroserviceProfile:
    """Performance curves for one microservice.  The port keeps the fields
    (the simulator's physics over them is not ported yet); the engine
    reads only ``host_bytes_per_query``, through ``edge_bytes``."""
    name: str
    flops_per_query: float
    mem_bytes_per_query: float
    host_bytes_per_query: float         # PCIe in+out per query
    weights_bytes: float
    act_bytes_per_query: float
    overhead: float = 1e-3
    serial_frac: float = 0.08
    flops_base: float = 0.0
    arch: Optional[str] = None


def edge_bytes(profile: MicroserviceProfile, count: int) -> float:
    """Default payload sizing for an edge leaving ``profile``'s node: half
    the node's PCIe in+out traffic per query, with a 1 MB/query floor for
    profiles that do not model host traffic."""
    per_query = profile.host_bytes_per_query * 0.5
    if per_query <= 0.0:
        per_query = 1e6
    return per_query * count


@dataclass(frozen=True)
class ServiceEdge:
    """One directed call edge ``src -> dst``; ``payload_bytes_per_query``
    overrides the default sizing."""
    src: int
    dst: int
    payload_bytes_per_query: Optional[float] = None


class ServiceGraph:
    """An end-to-end service: a DAG of microservice nodes.

    Entry nodes (no predecessors) admit queries; exit nodes (no
    successors) complete them.  Nodes may be ``None`` placeholders (the
    live engine's view, where the models live in the stage servers).
    """

    def __init__(self, name: str, nodes: Sequence[Optional[MicroserviceProfile]],
                 edges: Sequence[ServiceEdge], qos_target: float = 0.25):
        self.name = name
        self.nodes = list(nodes)
        self.edges: List[ServiceEdge] = list(edges)
        self.qos_target = qos_target
        n = len(self.nodes)
        if n == 0:
            raise ValueError("a ServiceGraph needs at least one node")
        self.preds: List[List[int]] = [[] for _ in range(n)]
        self.succs: List[List[int]] = [[] for _ in range(n)]
        self._edge_map: Dict[Tuple[int, int], ServiceEdge] = {}
        for e in self.edges:
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(f"dangling edge {e}")
            if (e.src, e.dst) in self._edge_map:
                raise ValueError(f"duplicate edge {e}")
            self._edge_map[(e.src, e.dst)] = e
            self.succs[e.src].append(e.dst)
            self.preds[e.dst].append(e.src)
        self.entries: List[int] = [i for i in range(n) if not self.preds[i]]
        self.exits: List[int] = [i for i in range(n) if not self.succs[i]]
        self.topo_order: List[int] = self._toposort()

    def _toposort(self) -> List[int]:
        indeg = [len(p) for p in self.preds]
        order = [i for i in range(len(self.nodes)) if indeg[i] == 0]
        for u in order:                  # Kahn's algorithm; order grows
            for v in self.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(order) != len(self.nodes):
            raise ValueError(f"{self.name}: cycle detected")
        return order

    @classmethod
    def chain(cls, name: str, stages: Sequence[Optional[MicroserviceProfile]],
              qos_target: float = 0.25) -> "ServiceGraph":
        """The paper's shape: stage i feeds stage i+1."""
        return cls(name, stages,
                   [ServiceEdge(i, i + 1) for i in range(len(stages) - 1)],
                   qos_target=qos_target)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def edge(self, src: int, dst: int) -> ServiceEdge:
        return self._edge_map[(src, dst)]

    def edge_nbytes(self, src: int, dst: int, count: int) -> float:
        """Bytes crossing ``src -> dst`` for ``count`` queries: the edge's
        explicit sizing, else the source node's default (1 MB/query for a
        placeholder node)."""
        e = self._edge_map[(src, dst)]
        if e.payload_bytes_per_query is not None:
            return e.payload_bytes_per_query * count
        if self.nodes[e.src] is None:
            return 1e6 * count
        return edge_bytes(self.nodes[e.src], count)

    def __repr__(self) -> str:
        return (f"ServiceGraph({self.name!r}, nodes={len(self.nodes)}, "
                f"edges={[(e.src, e.dst) for e in self.edges]})")


@dataclass
class StageAlloc:
    n_instances: int
    quota: float                        # fraction of one device per instance
    batch: int


@dataclass
class Placement:
    """instance placements: stage -> list of (device_id, quota)."""
    per_stage: List[List[Tuple[int, float]]] = field(default_factory=list)


@dataclass
class Allocation:
    stages: List[StageAlloc]
    placement: Optional[Placement] = None
    predicted_min_throughput: float = 0.0
    predicted_latency: float = 0.0

