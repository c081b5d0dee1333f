"""Shared Camelot datatypes.

Units are SI throughout: seconds, bytes, FLOPs, bytes/s, queries/s.

Terminology mapping to the paper (§VII, Table II):
  - ``DeviceSpec``      — one accelerator ("GPU"): R (compute, normalised to
                          1.0), F (global-memory capacity), BW (global-memory
                          bandwidth), I (max co-resident instances — Volta MPS
                          client limit), G (peak FLOP/s), host link (PCIe).
  - ``MicroserviceProfile`` — ground-truth performance curves of one
                          microservice stage (the simulator's physics; the
                          predictor only sees sampled observations of it).
  - ``StageAlloc``      — (N_i, p_i, s): instances, per-instance quota,
                          batch size for stage i.
  - ``Placement``       — instance -> device packing (deployment scheme §VII-D).

The service topology model
--------------------------
The paper states its model over a *linear* stage chain (stage i feeds
stage i+1), but real GPU microservice applications are call **graphs** with
fan-out and fan-in (ensemble branches, shared feature extractors).  The
repo's core abstraction is therefore ``ServiceGraph``: a DAG whose nodes
are ``MicroserviceProfile``s and whose explicit edge list carries per-edge
payload sizing.  Every layer — execution core, allocator, packer,
simulator, live engine — dispatches against this topology:

  - Eq. 1's min-throughput objective becomes the min *aggregate node*
    throughput over all nodes of the graph;
  - Constraint-5's end-to-end latency becomes the **critical path** (the
    longest entry→exit path of node durations plus edge transfer times);
  - a batch advances over an edge only once all predecessor outputs for
    its queries have arrived (fan-in join barrier).

``Pipeline`` survives as a thin ``ServiceGraph.chain(...)`` constructor —
the paper's linear chain is exactly the special case with edges
``i -> i+1`` — so all chain-shaped workloads, tests and benchmarks are
unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# The canonical compute-quota lattice shared by the allocator's decision
# space and the predictor's tabulation: multiples of QUOTA_STEP up to a
# full device.  Single definition — the tabulated fast path relies on the
# allocator's grid and the predictor's table axis being bit-identical.
QUOTA_STEP = 0.05
QUOTA_GRID = np.round(
    np.arange(1, int(round(1.0 / QUOTA_STEP)) + 1) * QUOTA_STEP, 2)


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
V100 = DeviceSpec(name="v100", peak_flops=15.7e12, mem_capacity=32e9,
                  mem_bandwidth=897e9)
# The port's card, NVIDIA H100 SXM5, from NVIDIA's data sheet: the dense
# bf16 tensor-core rate (the port serves bf16), 80 GB of HBM3 at 3.35 TB/s,
# and one direction of its PCIe Gen5 x16 link (128 GB/s both ways).  The
# other fields keep the paper's figures and are not measured on the card:
# max_instances is the Volta MPS client limit, host_link_stream the
# single-stream PCIe 3.0 rate, ipc_latency/ipc_setup the global-memory
# hand-off costs of §VIII-G (ROADMAP.md Queue D 17 measures them).
H100 = DeviceSpec(name="h100", peak_flops=989e12, mem_capacity=80e9,
                  mem_bandwidth=3.35e12, host_link_total=64e9)


@dataclass(frozen=True)
class MicroserviceProfile:
    """Ground-truth curves for one microservice (the simulator's physics).

    duration(batch, quota) = overhead
        + serial_frac-limited speedup of the compute term (Amdahl — models
          the saturating SM scalability in paper Fig. 3)
        + memory term (global-memory bandwidth is NOT partitioned by quota)
    """
    name: str
    flops_per_query: float              # C(i, s) slope (LR-modelled, §VII-A)
    mem_bytes_per_query: float          # global-memory traffic per query
    host_bytes_per_query: float         # PCIe in+out per query
    weights_bytes: float                # model weights (shared by co-located
                                        # same-stage instances, §VII-D)
    act_bytes_per_query: float          # activations / working set per query
    overhead: float = 1e-3              # fixed launch/dispatch time
    serial_frac: float = 0.08           # Amdahl serial fraction
    flops_base: float = 0.0             # per-batch constant FLOPs
    arch: Optional[str] = None          # model-zoo arch id, if any

    # ---- ground truth -------------------------------------------------
    def flops(self, batch: int) -> float:
        return self.flops_base + self.flops_per_query * batch

    def mem_bytes(self, batch: int) -> float:
        return self.weights_bytes + self.mem_bytes_per_query * batch

    def footprint(self, batch: int) -> float:
        """M(i, s): global-memory footprint at batch size s."""
        return self.weights_bytes + self.act_bytes_per_query * batch

    def duration(self, batch: int, quota: float,
                 device: DeviceSpec) -> float:
        """Solo-run duration at ``quota`` (fraction of one device).

        The achievable memory bandwidth of one instance saturates with
        occupancy (~25% of SMs already stream a large fraction of DRAM bw),
        so a small-quota instance cannot monopolise the device's bandwidth.
        """
        quota = float(np.clip(quota, 1e-3, 1.0))
        speedup = 1.0 / (self.serial_frac + (1 - self.serial_frac) / quota)
        compute_t = self.flops(batch) / (device.peak_flops * speedup)
        bw_frac = min(1.0, 0.25 + quota)
        memory_t = self.mem_bytes(batch) / (device.mem_bandwidth * bw_frac)
        return self.overhead + max(compute_t, memory_t)

    def bandwidth(self, batch: int, quota: float,
                  device: DeviceSpec) -> float:
        """Global-memory bandwidth usage b(p) while running."""
        d = self.duration(batch, quota, device)
        return self.mem_bytes(batch) / max(d, 1e-9)

    def throughput(self, batch: int, quota: float,
                   device: DeviceSpec) -> float:
        """Queries/s of one instance."""
        return batch / self.duration(batch, quota, device)


def edge_bytes(profile: MicroserviceProfile, count: int) -> float:
    """Default payload sizing for an edge leaving ``profile``'s node: half
    the node's PCIe in+out traffic per query.  Profiles that do not model
    host traffic get an explicit 1 MB/query floor (a zero-byte edge would
    make every transfer free and hide the mechanism choice entirely)."""
    per_query = profile.host_bytes_per_query * 0.5
    if per_query <= 0.0:
        per_query = 1e6
    return per_query * count


@dataclass(frozen=True)
class CompiledTopology:
    """A ServiceGraph's structure lowered to numpy index arrays, in
    topological order — the form the allocator's vectorized longest-path
    pass consumes (``ServiceGraph.compiled`` builds and caches it)."""
    topo: np.ndarray                    # (n,) node ids, topologically sorted
    exits: np.ndarray                   # (n_exits,) exit node ids
    pred_nodes: List[np.ndarray]        # per node: predecessor node ids
    pred_edges: List[np.ndarray]        # per node: edge ids (into .edges),
                                        # aligned with pred_nodes


@dataclass(frozen=True)
class ServiceEdge:
    """One directed call edge ``src -> dst`` of a ServiceGraph.

    ``payload_bytes_per_query`` overrides the default sizing (half the
    source node's PCIe traffic, see ``edge_bytes``) — fan-out edges often
    carry different payloads (e.g. a feature vector to one branch, a
    thumbnail to another)."""
    src: int
    dst: int
    payload_bytes_per_query: Optional[float] = None


class ServiceGraph:
    """An end-to-end user-facing service: a DAG of microservice nodes.

    Nodes are ``MicroserviceProfile``s indexed 0..n-1; ``edges`` is an
    explicit directed edge list.  Entry nodes (no predecessors) admit
    queries; exit nodes (no successors) complete them — a query finishes
    only when *every* exit has produced its output.  The linear chain of
    the paper is the special case built by ``ServiceGraph.chain`` (and the
    back-compat ``Pipeline`` constructor).

    Derived topology (predecessors, successors, topological order,
    entries/exits) is computed once at construction; the graph is
    validated to be acyclic with no dangling node indices.
    """

    def __init__(self, name: str, nodes: Sequence[MicroserviceProfile],
                 edges: Sequence[ServiceEdge], qos_target: float = 0.25):
        self.name = name
        self.nodes: List[MicroserviceProfile] = list(nodes)
        self.edges: List[ServiceEdge] = list(edges)
        self.qos_target = qos_target    # end-to-end 99%-ile target (seconds)
        n = len(self.nodes)
        assert n > 0, "a ServiceGraph needs at least one node"
        self.preds: List[List[int]] = [[] for _ in range(n)]
        self.succs: List[List[int]] = [[] for _ in range(n)]
        self._edge_map: Dict[Tuple[int, int], ServiceEdge] = {}
        self._edge_index: Dict[Tuple[int, int], int] = {}
        for k, e in enumerate(self.edges):
            assert 0 <= e.src < n and 0 <= e.dst < n, f"dangling edge {e}"
            assert (e.src, e.dst) not in self._edge_map, f"duplicate edge {e}"
            self._edge_map[(e.src, e.dst)] = e
            self._edge_index[(e.src, e.dst)] = k
            self.succs[e.src].append(e.dst)
            self.preds[e.dst].append(e.src)
        self.entries: List[int] = [i for i in range(n) if not self.preds[i]]
        self.exits: List[int] = [i for i in range(n) if not self.succs[i]]
        assert self.entries, f"{name}: graph has a cycle (no entry node)"
        self.topo_order: List[int] = self._toposort()
        self._compiled: Optional["CompiledTopology"] = None

    def _toposort(self) -> List[int]:
        indeg = [len(p) for p in self.preds]
        order = [i for i in range(len(self.nodes)) if indeg[i] == 0]
        for u in order:                  # Kahn's algorithm; order grows
            for v in self.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        assert len(order) == len(self.nodes), f"{self.name}: cycle detected"
        return order

    # ---- chain special case -------------------------------------------

    @classmethod
    def chain(cls, name: str, stages: Sequence[MicroserviceProfile],
              qos_target: float = 0.25) -> "ServiceGraph":
        """The paper's shape: stage i feeds stage i+1."""
        return cls(name, stages,
                   [ServiceEdge(i, i + 1) for i in range(len(stages) - 1)],
                   qos_target=qos_target)

    @property
    def is_chain(self) -> bool:
        return all(len(p) <= 1 for p in self.preds) and \
            all(len(s) <= 1 for s in self.succs) and \
            len(self.entries) == 1 and len(self.edges) == len(self.nodes) - 1

    # ---- back-compat stage view ---------------------------------------

    @property
    def stages(self) -> List[MicroserviceProfile]:
        """Node list under its historical name (chain-era callers)."""
        return self.nodes

    @property
    def n_stages(self) -> int:
        return len(self.nodes)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    # ---- per-edge payloads and path metrics ---------------------------

    def edge(self, src: int, dst: int) -> ServiceEdge:
        return self._edge_map[(src, dst)]

    def edge_nbytes(self, src: int, dst: int, count: int) -> float:
        """Bytes crossing ``src -> dst`` for ``count`` queries: the edge's
        explicit payload sizing, else the source node's default.  Graphs
        built with placeholder (None) nodes — the live engine's topology
        view, where profiles live in the stage servers — price edges at
        the 1 MB/query default."""
        e = self._edge_map[(src, dst)]
        if e.payload_bytes_per_query is not None:
            return e.payload_bytes_per_query * count
        if self.nodes[e.src] is None:
            return 1e6 * count
        return edge_bytes(self.nodes[e.src], count)

    @property
    def compiled(self) -> "CompiledTopology":
        """Topology lowered to index arrays (built once, cached): per-node
        predecessor/edge id arrays in topological order, plus the exit set.
        This is what lets Constraint-5 evaluate as a batched numpy
        longest-path pass instead of per-candidate Python lambdas."""
        if self._compiled is None:
            self._compiled = CompiledTopology(
                topo=np.asarray(self.topo_order, np.int64),
                exits=np.asarray(self.exits, np.int64),
                pred_nodes=[np.asarray(self.preds[u], np.int64)
                            for u in range(len(self.nodes))],
                pred_edges=[np.asarray(
                    [self._edge_index[(p, u)] for p in self.preds[u]],
                    np.int64) for u in range(len(self.nodes))])
        return self._compiled

    def critical_path(self, node_cost: Callable[[int], float],
                      edge_cost: Callable[[ServiceEdge], float] = None,
                      ) -> float:
        """Longest entry→exit path: sum of node costs plus edge costs along
        it (Constraint-5's end-to-end latency over a DAG; for a chain this
        reduces to the paper's plain sum)."""
        ec = edge_cost or (lambda e: 0.0)
        best = [0.0] * len(self.nodes)
        for u in self.topo_order:
            incoming = [best[p] + ec(self._edge_map[(p, u)])
                        for p in self.preds[u]]
            best[u] = node_cost(u) + (max(incoming) if incoming else 0.0)
        return max(best[x] for x in self.exits)

    def critical_path_nodes(self, node_costs: np.ndarray,
                            edge_costs: Optional[np.ndarray] = None,
                            ) -> np.ndarray:
        """The batched longest-path pass WITHOUT the final exit reduction:
        returns the full ``(..., n_nodes)`` best-path-ending-at-node array.
        Callers that need per-exit-group maxima (e.g. per-tenant QoS over a
        disjoint union graph) reduce it themselves."""
        nc = np.asarray(node_costs, np.float64)
        ct = self.compiled
        best = np.zeros_like(nc)
        for u in ct.topo:
            pn = ct.pred_nodes[u]
            if len(pn):
                inc = best[..., pn]
                if edge_costs is not None:
                    inc = inc + edge_costs[..., ct.pred_edges[u]]
                best[..., u] = nc[..., u] + inc.max(axis=-1)
            else:
                best[..., u] = nc[..., u]
        return best

    def critical_path_arrays(self, node_costs: np.ndarray,
                             edge_costs: Optional[np.ndarray] = None,
                             ) -> np.ndarray:
        """Batched ``critical_path``: ``node_costs`` is ``(..., n_nodes)``
        and ``edge_costs`` ``(..., n_edges)`` (edge order = ``self.edges``);
        returns the ``(...)`` longest entry→exit path per leading row.  One
        numpy pass over the compiled topo arrays evaluates every candidate
        allocation at once."""
        best = self.critical_path_nodes(node_costs, edge_costs)
        return best[..., self.compiled.exits].max(axis=-1)

    # ---- explicit path enumeration (sparse/incremental hot paths) -----

    def count_paths(self) -> int:
        """Number of distinct entry→exit paths (DP over the topo order —
        no enumeration, so safe on graphs with exponentially many)."""
        counts = [0] * len(self.nodes)
        for u in self.topo_order:
            counts[u] = sum(counts[p] for p in self.preds[u]) \
                if self.preds[u] else 1
        return sum(counts[x] for x in self.exits)

    def enumerate_paths(self, cap: int = 4096,
                        ) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
        """Every entry→exit path as a ``(node_ids, edge_ids)`` pair (edge
        ids index ``self.edges``), or ``None`` when the graph has more than
        ``cap`` paths.  The critical path is then ``max`` over this list of
        per-path node+edge cost sums — the form the incremental evaluator
        and the jitted annealing kernel consume: a single-node mutation
        perturbs only the paths through that node, and each path is a flat
        gather instead of a topo-order recurrence.  Iterative DFS (a
        900-node union-graph chain must not hit the recursion limit)."""
        if self.count_paths() > cap:
            return None
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for entry in self.entries:
            # stack of (node, successor cursor); path holds the DFS spine
            path = [entry]
            edges: List[int] = []
            cursor = [0]
            while path:
                u = path[-1]
                succ = self.succs[u]
                if not succ:                      # exit node: emit path
                    out.append((np.asarray(path, np.int64),
                                np.asarray(edges, np.int64)))
                if cursor[-1] < len(succ):
                    v = succ[cursor[-1]]
                    cursor[-1] += 1
                    path.append(v)
                    edges.append(self._edge_index[(u, v)])
                    cursor.append(0)
                else:
                    path.pop()
                    cursor.pop()
                    if edges:
                        edges.pop()
        return out

    def __repr__(self) -> str:
        return (f"ServiceGraph({self.name!r}, nodes={len(self.nodes)}, "
                f"edges={[(e.src, e.dst) for e in self.edges]})")


class Pipeline(ServiceGraph):
    """An ordered chain of stages — thin ``ServiceGraph.chain`` constructor
    kept so every chain-era workload/test/benchmark builds unchanged."""

    def __init__(self, name: str, stages: Sequence[MicroserviceProfile],
                 qos_target: float = 0.25):
        super().__init__(
            name, stages,
            [ServiceEdge(i, i + 1) for i in range(len(stages) - 1)],
            qos_target=qos_target)


@dataclass
class StageAlloc:
    n_instances: int
    quota: float                        # fraction of one device per instance
    batch: int


@dataclass
class Placement:
    """instance placements: stage -> list of (device_id, quota)."""
    per_stage: List[List[Tuple[int, float]]] = field(default_factory=list)

    def devices_used(self) -> set:
        return {d for st in self.per_stage for d, _ in st}

    # ---- dict round-trip (allocation persistence) ---------------------

    def to_dict(self) -> dict:
        return {"per_stage": [[[d, q] for d, q in st]
                              for st in self.per_stage]}

    @classmethod
    def from_dict(cls, d) -> "Placement":
        return cls(per_stage=[[(int(dev), float(q)) for dev, q in st]
                              for st in d["per_stage"]])


@dataclass
class Allocation:
    stages: List[StageAlloc]
    placement: Optional[Placement] = None
    predicted_min_throughput: float = 0.0
    predicted_latency: float = 0.0

    def total_quota(self) -> float:
        return sum(s.n_instances * s.quota for s in self.stages)

    def total_instances(self) -> int:
        return sum(s.n_instances for s in self.stages)

    # ---- dict round-trip (allocation persistence) ---------------------

    def to_dict(self) -> dict:
        # predicted_latency is +inf for infeasible allocations; JSON has no
        # Infinity, so non-finite floats serialise as null
        lat = self.predicted_latency
        return {
            "stages": [{"n_instances": s.n_instances, "quota": s.quota,
                        "batch": s.batch} for s in self.stages],
            "placement": self.placement.to_dict()
            if self.placement is not None else None,
            "predicted_min_throughput": self.predicted_min_throughput,
            "predicted_latency": lat if math.isfinite(lat) else None,
        }

    @classmethod
    def from_dict(cls, d) -> "Allocation":
        pl = d.get("placement")
        lat = d.get("predicted_latency", 0.0)
        return cls(
            stages=[StageAlloc(int(s["n_instances"]), float(s["quota"]),
                               int(s["batch"])) for s in d["stages"]],
            placement=Placement.from_dict(pl) if pl is not None else None,
            predicted_min_throughput=float(
                d.get("predicted_min_throughput", 0.0)),
            predicted_latency=float("inf") if lat is None else float(lat))


# --------------------------------------------------------------------------
# Multi-tenant layer: N services sharing ONE device pool
# --------------------------------------------------------------------------

#: Per-tenant utility curves for the joint max-peak objective.  Each maps
#: a normalized load x >= 0 to a utility; all are monotone increasing, so
#: the within-tenant min over nodes commutes with the transform and the
#: joint objective becomes ``min_t u_t(load_t / weight_t)``.
UTILITY_FNS = ("linear", "log", "sqrt")


def apply_utility(values: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Apply per-node utility transforms to ``values`` (last axis = union
    node axis; ``codes[i]`` indexes ``UTILITY_FNS``).  Every curve is
    monotone increasing on x >= 0, so min-reductions over transformed
    values select the same argmin within a tenant."""
    out = np.array(values, np.float64, copy=True)
    log_m = codes == 1
    if log_m.any():
        out[..., log_m] = np.log1p(np.maximum(out[..., log_m], 0.0))
    sqrt_m = codes == 2
    if sqrt_m.any():
        out[..., sqrt_m] = np.sqrt(np.maximum(out[..., sqrt_m], 0.0))
    return out


@dataclass(frozen=True)
class Tenant:
    """One service sharing the cluster with others.

    ``graph`` carries the service topology and its OWN QoS target
    (Constraint-5 is evaluated per tenant); ``weight`` normalises the joint
    max-peak objective (the solver maximises ``min_t load_t / weight_t`` —
    with the default 1.0 every tenant's absolute supported load counts
    equally, weights express that one tenant needs proportionally more);
    ``required_load`` is the tenant's demand for joint min-resource solves.

    Lifecycle / isolation knobs (all default to the pre-lifecycle
    behaviour):

    - ``priority``: tier for preemption — under overload or device loss,
      load is shed in ASCENDING ``(priority, weight)`` order, so priority 0
      tenants are sacrificed before priority 1, and so on.
    - ``quota_floor``: dedicated-capacity floor in device-fraction units —
      the solver only accepts states where this tenant's total quota
      (sum over its stages of instances x quota) is at least the floor.
    - ``quota_cap``: hard cap on the same total quota (``None`` = no cap),
      bounding how much of the shared pool one tenant may occupy.
    - ``utility``: objective curve for joint max-peak solves — ``linear``
      (the default weight normalisation), ``log`` (diminishing returns:
      ``log1p``) or ``sqrt``; see ``UTILITY_FNS``.
    """
    name: str
    graph: ServiceGraph
    weight: float = 1.0
    required_load: Optional[float] = None
    priority: int = 0
    quota_floor: float = 0.0
    quota_cap: Optional[float] = None
    utility: str = "linear"

    def __post_init__(self):
        if not (self.weight > 0.0):
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0 (the joint "
                f"objective divides by it), got {self.weight}")
        if not (self.graph.qos_target > 0.0):
            raise ValueError(
                f"tenant {self.name!r}: QoS latency target must be > 0, "
                f"got {self.graph.qos_target}")
        if self.required_load is not None and not (self.required_load > 0.0):
            raise ValueError(
                f"tenant {self.name!r}: required_load must be > 0 when "
                f"set, got {self.required_load}")
        if self.quota_floor < 0.0:
            raise ValueError(
                f"tenant {self.name!r}: quota_floor must be >= 0, got "
                f"{self.quota_floor}")
        if self.quota_cap is not None and \
                self.quota_cap < max(self.quota_floor, QUOTA_STEP):
            raise ValueError(
                f"tenant {self.name!r}: quota_cap={self.quota_cap} is below "
                f"max(quota_floor={self.quota_floor}, one lattice step "
                f"{QUOTA_STEP}) — no allocation can satisfy it")
        if self.utility not in UTILITY_FNS:
            raise ValueError(
                f"tenant {self.name!r}: unknown utility {self.utility!r}; "
                f"available: {', '.join(UTILITY_FNS)}")

    @property
    def qos_target(self) -> float:
        return self.graph.qos_target

    @property
    def isolated(self) -> bool:
        """True when this tenant carries an isolation constraint the
        solver must enforce (a floor above 0 or any cap)."""
        return self.quota_floor > 0.0 or self.quota_cap is not None


class TenantSet:
    """A set of tenants with a stable node namespace over one device pool.

    Tenant t's local node ``i`` is global node ``offsets[t] + i`` — the
    joint allocator's decision vector, the packer's instance list and the
    per-device accounting all index this namespace, so co-located instances
    of *different* services contend exactly like same-service ones.

    ``union_graph`` is the disjoint union of the tenants' graphs (edges
    shifted into the namespace): one ``CompiledTopology`` evaluates every
    tenant's critical path in a single batched pass, with per-tenant QoS
    read off the tenant's own exit group (``exit_groups``).
    """

    def __init__(self, tenants: Sequence[Tenant]):
        assert tenants, "a TenantSet needs at least one tenant"
        self.tenants: List[Tenant] = list(tenants)
        names = [t.name for t in self.tenants]
        assert len(set(names)) == len(names), \
            f"tenant names must be unique, got {names}"
        self.offsets: List[int] = []
        off = 0
        for t in self.tenants:
            self.offsets.append(off)
            off += t.graph.n_nodes
        self.n_nodes = off
        # global node id -> tenant index
        self.node_tenant = np.concatenate([
            np.full(t.graph.n_nodes, ti, np.int64)
            for ti, t in enumerate(self.tenants)])
        self._union: Optional[ServiceGraph] = None

    def __len__(self) -> int:
        return len(self.tenants)

    def __iter__(self):
        return iter(self.tenants)

    @property
    def union_graph(self) -> ServiceGraph:
        """The disjoint union as one ServiceGraph (built once, cached).
        Its ``qos_target`` is the tightest tenant target — callers that
        need per-tenant Constraint-5 use ``exit_groups`` instead."""
        if self._union is None:
            nodes: List[MicroserviceProfile] = []
            edges: List[ServiceEdge] = []
            for t, off in zip(self.tenants, self.offsets):
                nodes.extend(t.graph.nodes)
                edges.extend(ServiceEdge(e.src + off, e.dst + off,
                                         e.payload_bytes_per_query)
                             for e in t.graph.edges)
            self._union = ServiceGraph(
                "+".join(t.name for t in self.tenants), nodes, edges,
                qos_target=min(t.qos_target for t in self.tenants))
        return self._union

    @property
    def exit_groups(self) -> List[np.ndarray]:
        """Per tenant: its exit nodes in the global namespace (the reduction
        sets for per-tenant critical-path QoS)."""
        return [np.asarray(t.graph.exits, np.int64) + off
                for t, off in zip(self.tenants, self.offsets)]

    def node_values(self, per_tenant: Sequence[float]) -> np.ndarray:
        """Expand one value per tenant to one value per global node."""
        assert len(per_tenant) == len(self.tenants)
        return np.asarray(per_tenant, np.float64)[self.node_tenant]

    @property
    def weights(self) -> List[float]:
        return [t.weight for t in self.tenants]

    def iso_bounds(self):
        """Isolation constraints lowered to the solver's array form:
        ``(starts, floors, caps)`` where ``starts`` are the tenant node
        offsets (the ``np.add.reduceat`` segment starts over the union
        node axis), ``floors[t]``/``caps[t]`` bound tenant t's total quota.
        Returns ``None`` when no tenant is isolated — the gate that keeps
        the non-isolated solve bit-identical to the pre-lifecycle path."""
        if not any(t.isolated for t in self.tenants):
            return None
        starts = np.asarray(self.offsets, np.int64)
        floors = np.asarray([t.quota_floor for t in self.tenants],
                            np.float64)
        caps = np.asarray([t.quota_cap if t.quota_cap is not None
                           else np.inf for t in self.tenants], np.float64)
        return starts, floors, caps

    def utility_codes(self) -> Optional[np.ndarray]:
        """Per-node utility codes (indices into ``UTILITY_FNS``), or
        ``None`` when every tenant is linear (the bit-parity gate)."""
        if all(t.utility == "linear" for t in self.tenants):
            return None
        per_tenant = [UTILITY_FNS.index(t.utility) for t in self.tenants]
        return np.asarray(per_tenant, np.int64)[self.node_tenant]

    # ---- allocation namespacing ---------------------------------------

    def split_allocation(self, alloc: Allocation) -> List[Allocation]:
        """Slice a joint (union-namespace) Allocation into service-scoped
        per-tenant Allocations.  Placement device ids stay GLOBAL — the
        tenants share the one device pool, so per-tenant views must keep
        pointing at the shared devices.

        The slices' predicted metrics are left zeroed: the joint
        allocation's objective/latency are cross-tenant aggregates, not
        any one tenant's — ``MultiTenantAllocator.per_tenant_allocations``
        annotates each slice with its own tenant's values."""
        assert len(alloc.stages) == self.n_nodes, \
            (len(alloc.stages), self.n_nodes)
        out = []
        for t, off in zip(self.tenants, self.offsets):
            n = t.graph.n_nodes
            pl = None
            if alloc.placement is not None:
                pl = Placement(per_stage=[
                    list(st) for st in alloc.placement.per_stage[off:off + n]])
            out.append(Allocation(
                stages=[StageAlloc(s.n_instances, s.quota, s.batch)
                        for s in alloc.stages[off:off + n]],
                placement=pl))
        return out

    def subset(self, indices: Sequence[int]) -> "TenantSet":
        """A new TenantSet over ``[self.tenants[i] for i in indices]`` (the
        hierarchical solver's per-pod view; order follows ``indices``)."""
        return TenantSet([self.tenants[i] for i in indices])

    def join_allocations(self, allocs: Sequence[Allocation]) -> Allocation:
        """Concatenate per-tenant Allocations into the union namespace (the
        warm-start path: per-tenant incumbents seed a joint re-solve)."""
        assert len(allocs) == len(self.tenants)
        stages: List[StageAlloc] = []
        per_stage: List[List[Tuple[int, float]]] = []
        placeable = all(a.placement is not None for a in allocs)
        for t, a in zip(self.tenants, allocs):
            assert len(a.stages) == t.graph.n_nodes
            stages.extend(StageAlloc(s.n_instances, s.quota, s.batch)
                          for s in a.stages)
            if placeable:
                per_stage.extend(list(st) for st in a.placement.per_stage)
        return Allocation(
            stages=stages,
            placement=Placement(per_stage=per_stage) if placeable else None)


# --------------------------------------------------------------------------
# Hierarchical (pod-decomposed) solves over large device pools
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PodConfig:
    """Knobs for the hierarchical pod decomposition (``core.hierarchy``).

    ``pod_size`` devices per pod (the last pod takes the remainder);
    ``repair_rounds`` boundary-repair attempts moving one tenant from the
    bottleneck pod to the pod with the most headroom; ``parallel`` refines
    pods concurrently (thread pool — the per-pod annealers are numpy-bound
    and release the GIL for most of their time)."""
    pod_size: int
    repair_rounds: int = 2
    parallel: bool = True

    def to_dict(self) -> dict:
        return {"pod_size": self.pod_size,
                "repair_rounds": self.repair_rounds,
                "parallel": self.parallel}

    @classmethod
    def from_dict(cls, d) -> "PodConfig":
        return cls(pod_size=int(d["pod_size"]),
                   repair_rounds=int(d.get("repair_rounds", 2)),
                   parallel=bool(d.get("parallel", True)))


@dataclass
class PodAssignment:
    """One pod of a hierarchical solve: a contiguous device range plus the
    tenant-group assigned to it (indices into the global TenantSet)."""
    pod_id: int
    device_start: int
    device_stop: int                     # exclusive
    tenant_indices: List[int]

    @property
    def n_devices(self) -> int:
        return self.device_stop - self.device_start
