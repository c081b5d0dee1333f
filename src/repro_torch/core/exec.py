"""Unified pipeline-execution core (paper §VI–§VII), generalised to DAGs.

The port's copy of the reference's ``repro/core/exec.py``, apart from its
imports: its instances keep no dispatch count or busy time, which nothing
read (the engine's tracer times the calls), and a ``ReadyBatch`` carries
the host stamp at which the live engine queued it, when it traces.  One
scheduling state machine for two execution worlds:

  * the **live serving engine** (``repro_torch.serving.engine``) drives it
    with the wall clock and a thread pool of real model calls on the card,
    and
  * the **discrete-event simulator** (``repro_torch.sim.simulator``)
    drives it with virtual time and charges durations from
    MicroserviceProfile physics.

The core owns every *policy* decision so both worlds are charged
identically:

  - entry-node admission and QoS-aware dynamic batching (dispatch a batch
    when it is full OR the oldest query has waited past the timeout),
  - per-node FIFO ready queues for in-flight batches,
  - multi-instance dispatch against an ``Allocation``'s ``Placement``
    (first free instance, FIFO batches — N_i concurrent instances per
    node),
  - per-edge communication-mechanism selection via
    ``CommModel.crossover_bytes()`` (Fig. 11): host-staging below the
    crossover, global-memory hand-off above it, host forced when producer
    and consumers share no device.

The DAG model (``repro_torch.core.types.ServiceGraph``)
-------------------------------------------------------
The topology is a service DAG, with the paper's linear chain as the
special case (an ``int`` node count still builds a chain, so chain-era
callers are unchanged).  Three graph-only behaviours:

  - **batch identity**: every batch formed at admission gets a ``bid``; all
    downstream copies of it (one per branch) carry that id and the same
    ordered ``items`` list, so fan-in can re-associate branches.
  - **fan-in join barrier** (``deliver``): a batch becomes ready at a node
    only once the outputs of *all* predecessor nodes for its queries have
    arrived, regardless of branch completion order.  The joined batch keeps
    the entry-time item order (per-query ordering is preserved) and exposes
    each branch's payload in ``ReadyBatch.inputs``.
  - **exit join** (``complete_exit``): with several exit nodes a query is
    complete only when every exit has produced it; the core tracks this so
    both worlds record end-to-end latency at the same instant.

The core is deliberately time-agnostic: callers pass ``now`` in, so the
same code runs under a real clock and a simulated one.  It holds no locks —
the live engine serialises all core calls on its driver thread; workers
only report completions through a queue.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from heapq import heapify, heappop, heappush
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

from repro_torch.core.comm import CommModel, select_mechanism
from repro_torch.core.types import (Allocation, Placement, ServiceEdge,
                                    ServiceGraph, edge_bytes)

__all__ = ["edge_bytes", "BatchingPolicy", "StageInstance", "ReadyBatch",
           "EdgeRoute", "ExecCore", "default_allocation"]


@dataclass
class BatchingPolicy:
    """QoS-aware dynamic batching: dispatch on size or oldest-wait timeout.

    The simulator derives ``timeout`` from the QoS budget
    (``batch_timeout_frac × qos_target``); the live engine passes it
    directly.  Either way the decision logic is this one."""
    batch_size: int
    timeout: float

    def should_dispatch(self, n_pending: int, oldest_arrival: float,
                        now: float) -> bool:
        if n_pending <= 0:
            return False
        if n_pending >= self.batch_size:
            return True
        return (now - oldest_arrival) >= self.timeout - 1e-12

    def deadline(self, oldest_arrival: float) -> float:
        return oldest_arrival + self.timeout


@dataclass(slots=True)
class StageInstance:
    """One schedulable instance of a node: a (device, quota) slot from the
    Placement.  ``bandwidth`` is simulator-side contention bookkeeping."""
    stage: int
    index: int
    device: int
    quota: float
    busy: bool = False
    bandwidth: float = 0.0
    gen: int = 0      # placement generation — stale releases are no-ops
    tbl: Optional[tuple] = None   # fast-path (dur, bw, len) physics table
    dead: bool = False            # device failed — never dispatch again


@dataclass(slots=True)
class ReadyBatch:
    """A formed batch travelling through the service graph.  ``items`` is
    opaque to the core (Query objects in the live engine, arrival
    timestamps in the simulator); ``data`` is the node input (live: a
    jax.Array).  ``bid`` identifies the admission-time batch across
    branches; ``inputs`` maps predecessor node -> branch payload for
    batches produced by a fan-in join.  ``ready_ns``: the tracer's stamp
    of its entering this ready queue (set by a tracing live engine)."""
    stage: int
    items: List[Any]
    ready_time: float
    data: Any = None
    bid: int = -1
    inputs: Optional[Dict[int, Any]] = None
    ready_ns: int = 0


@dataclass
class EdgeRoute:
    """Resolved routing decision for one batch over one graph edge."""
    mechanism: str
    same_device: bool
    nbytes: float
    src: int = -1
    dst: int = -1


class ExecCore:
    """The shared scheduling state machine.

    Construction takes the service topology — a ``ServiceGraph``, or an
    ``int`` node count meaning the linear chain of that length — and a
    ``Placement`` (one ``StageInstance`` per placed (device, quota) entry):
    this is how the allocator's output drives execution in both worlds.

    ``edge_nbytes`` overrides payload sizing; it is called as
    ``edge_nbytes(edge, count)`` with the ``ServiceEdge`` being crossed.
    Without it, a ``ServiceGraph`` topology prices edges itself
    (``ServiceGraph.edge_nbytes``) and an int chain uses a 1 MB/query
    default."""

    def __init__(self, topology: Union[int, ServiceGraph],
                 placement: Placement,
                 batching: BatchingPolicy, comm: Optional[CommModel] = None,
                 edge_nbytes: Optional[Callable[[ServiceEdge, int],
                                               float]] = None,
                 fast: bool = False):
        if isinstance(topology, int):
            self.graph: Optional[ServiceGraph] = None
            n = topology
            self.preds = [[] if i == 0 else [i - 1] for i in range(n)]
            self.succs = [[i + 1] if i + 1 < n else [] for i in range(n)]
            self.entries = [0] if n else []
            self.exits = [n - 1] if n else []
            self.topo_order = list(range(n))
            self._edges = {(i, i + 1): ServiceEdge(i, i + 1)
                           for i in range(n - 1)}
        else:
            self.graph = topology
            n = topology.n_nodes
            self.preds = topology.preds
            self.succs = topology.succs
            self.entries = topology.entries
            self.exits = topology.exits
            self.topo_order = topology.topo_order
            self._edges = {(e.src, e.dst): e for e in topology.edges}
        assert len(placement.per_stage) == n, \
            "placement must cover every node"
        self.n_stages = n
        self.batching = batching
        self.comm = comm
        self._edge_nbytes = edge_nbytes
        self.fast = fast
        self._gen = 0
        self._free: List[List[int]] = []
        self.stage_instances: List[List[StageInstance]] = []
        self._build_instances(placement)
        # entry admission: (arrival, item)
        self.pending: List[Tuple[float, Any]] = []
        self.ready: List[deque] = [deque() for _ in range(n)]
        self.batches_formed = 0
        # fan-in joins: (dst, bid) -> {src: payload}; items kept per join
        self._joins: Dict[Tuple[int, int], Dict[int, Any]] = {}
        self._join_items: Dict[Tuple[int, int], List[Any]] = {}
        # exit joins: bid -> set of exits still owed
        self._exit_open: Dict[int, Set[int]] = {}
        # fault path: batches given up on (device death / retry exhaustion)
        self._abandoned: Set[int] = set()

    # ---- instances ----------------------------------------------------

    def _build_instances(self, placement: Placement) -> None:
        self.placement = placement
        self.stage_instances = []
        self._gen += 1
        for si, placed in enumerate(placement.per_stage):
            assert placed, f"node {si} has no placed instance"
            self.stage_instances.append([
                StageInstance(si, k, dev, quota, gen=self._gen)
                for k, (dev, quota) in enumerate(placed)])
        # fast-path free-lists: min-heap of free instance indices per stage.
        # A range is already heap-ordered; popping the min index reproduces
        # the legacy first-free linear scan exactly.
        self._free = [list(range(len(st))) for st in self.stage_instances]

    def reset_instances(self, placement: Placement) -> None:
        """Swap to a new Placement between batches (live re-allocation).

        Queues and pending arrivals survive; in-flight batches complete on
        the old StageInstance objects, whose release is then a no-op for
        dispatch because they are no longer in the pool."""
        self._build_instances(placement)

    @property
    def instances(self) -> List[StageInstance]:
        return [i for st in self.stage_instances for i in st]

    # ---- entry admission & dynamic batching ---------------------------

    def admit(self, item: Any, arrival: float) -> None:
        self.pending.append((arrival, item))

    def oldest_pending(self) -> Optional[float]:
        return self.pending[0][0] if self.pending else None

    def batch_deadline(self) -> Optional[float]:
        """Virtual time at which the current oldest pending query forces a
        partial dispatch (None when nothing is pending)."""
        if not self.pending:
            return None
        return self.batching.deadline(self.pending[0][0])

    def form_batches(self, now: float) -> List[ReadyBatch]:
        """Move pending queries into entry-node ready batches per the
        size/timeout policy.  Each admission-time batch gets a ``bid`` and
        is seeded at EVERY entry node (one ReadyBatch per entry, sharing
        bid and items).  Returns the newly formed batches so the live
        engine can attach input data before dispatch."""
        out: List[ReadyBatch] = []
        while self.pending and self.batching.should_dispatch(
                len(self.pending), self.pending[0][0], now):
            take = self.pending[:self.batching.batch_size]
            del self.pending[:len(take)]
            items = [it for _, it in take]
            bid = self.batches_formed
            self._exit_open[bid] = set(self.exits)
            for node in self.entries:
                rb = ReadyBatch(stage=node, items=items, ready_time=now,
                                bid=bid)
                self.ready[node].append(rb)
                out.append(rb)
            self.batches_formed += 1
        return out

    def push_ready(self, stage: int, items: List[Any], now: float,
                   data: Any = None, bid: int = -1) -> ReadyBatch:
        """Queue a batch directly at a node, bypassing the fan-in barrier
        (chain-era callers; single-predecessor nodes)."""
        rb = ReadyBatch(stage=stage, items=items, ready_time=now, data=data,
                        bid=bid)
        self.ready[stage].append(rb)
        return rb

    # ---- fan-in join barrier ------------------------------------------

    def deliver(self, src: int, dst: int, bid: int, items: List[Any],
                now: float, data: Any = None) -> Optional[ReadyBatch]:
        """One branch's output for batch ``bid`` arrives over ``src -> dst``.

        Returns the joined ReadyBatch once ALL predecessors of ``dst`` have
        delivered for this bid (out-of-order branch completion is fine —
        the join holds early arrivals), else None.  The joined batch keeps
        the first-arrival ``items`` order, so per-query ordering survives
        the join."""
        if bid in self._abandoned:      # a sibling branch already failed
            return None
        key = (dst, bid)
        joins = self._joins
        pending = joins.get(key)
        if pending is None:
            pending = joins[key] = {}
            self._join_items[key] = items
        assert src not in pending, \
            f"duplicate delivery over edge {src}->{dst} for batch {bid}"
        pending[src] = data
        # each predecessor delivers exactly once (asserted above), so a
        # length check is the full set comparison
        if len(pending) != len(self.preds[dst]):
            return None
        inputs = self._joins.pop(key)
        joined_items = self._join_items.pop(key)
        rb = ReadyBatch(stage=dst, items=joined_items, ready_time=now,
                        bid=bid, inputs=inputs,
                        data=inputs[src] if len(inputs) == 1 else None)
        self.ready[dst].append(rb)
        return rb

    # ---- exit join -----------------------------------------------------

    def complete_exit(self, bid: int, node: int) -> bool:
        """Record that exit ``node`` finished batch ``bid``; True when every
        exit of the graph has — i.e. the batch's queries are end-to-end
        complete (for a chain: immediately true at the last stage)."""
        if bid in self._abandoned:      # failed batch: never completes
            return False
        open_exits = self._exit_open.get(bid)
        if open_exits is None:          # untracked bid (direct push_ready)
            return True
        open_exits.discard(node)
        if open_exits:
            return False
        del self._exit_open[bid]
        return True

    # ---- faults --------------------------------------------------------

    def kill_device(self, device: int) -> int:
        """Mark every instance on ``device`` dead; they are pulled from the
        dispatch pools immediately (in-flight batches on them are the
        caller's problem — fail/retry them on release).  Returns how many
        instances died."""
        n_dead = 0
        for si, insts in enumerate(self.stage_instances):
            stage_hit = False
            for inst in insts:
                if inst.device == device and not inst.dead:
                    inst.dead = True
                    n_dead += 1
                    stage_hit = True
            if stage_hit and self.fast:
                # filtering a heap of ints keeps ascending pop order, but
                # re-heapify to restore the invariant explicitly
                alive = [k for k in self._free[si] if not insts[k].dead]
                heapify(alive)
                self._free[si] = alive
        return n_dead

    def alive_instances(self, stage: int) -> int:
        return sum(1 for i in self.stage_instances[stage] if not i.dead)

    def abandon(self, bid: int) -> None:
        """Give up on batch ``bid`` everywhere: forget its exit tracking,
        drop held join branches, and purge queued copies, so sibling
        branches can neither complete nor deadlock the join barrier.
        Idempotent; safe for untracked bids."""
        if bid in self._abandoned:
            return
        self._abandoned.add(bid)
        self._exit_open.pop(bid, None)
        for key in [k for k in self._joins if k[1] == bid]:
            del self._joins[key]
            self._join_items.pop(key, None)
        for q in self.ready:
            if any(rb.bid == bid for rb in q):
                keep = [rb for rb in q if rb.bid != bid]
                q.clear()
                q.extend(keep)

    # ---- dispatch -----------------------------------------------------

    def _free_instance(self, stage: int) -> Optional[StageInstance]:
        for inst in self.stage_instances[stage]:
            if not inst.busy and not inst.dead:
                return inst
        return None

    def dispatch_stage(self, stage: int, now: float,
                       ) -> List[Tuple[StageInstance, ReadyBatch]]:
        """Assign queued batches of one node to free instances (FIFO
        batches, first free instance)."""
        out = []
        q = self.ready[stage]
        if self.fast:
            free = self._free[stage]
            insts = self.stage_instances[stage]
            while q and free:
                inst = insts[heappop(free)]
                rb = q.popleft()
                inst.busy = True
                out.append((inst, rb))
            return out
        while q:
            inst = self._free_instance(stage)
            if inst is None:
                break
            rb = q.popleft()
            inst.busy = True
            out.append((inst, rb))
        return out

    def dispatch(self, now: float) -> List[Tuple[StageInstance, ReadyBatch]]:
        """Dispatch every node; deeper nodes first (reverse topological
        order) so a freed instance can be reused for work already further
        through the graph."""
        out = []
        for si in reversed(self.topo_order):
            out.extend(self.dispatch_stage(si, now))
        return out

    def release(self, inst: StageInstance) -> None:
        inst.busy = False
        inst.bandwidth = 0.0
        # Return to the free-list only for live, current-generation
        # instances: after ``reset_instances`` an in-flight release refers
        # to the old pool, and the legacy scan never sees it either; a dead
        # instance must never re-enter the dispatch pool.
        if self.fast and inst.gen == self._gen and not inst.dead:
            heappush(self._free[inst.stage], inst.index)

    # ---- per-edge communication routing -------------------------------

    def consumer_devices(self, stage: int) -> set:
        return {d for d, _ in self.placement.per_stage[stage]}

    def edge_payload(self, src: int, dst: int, count: int) -> float:
        """Bytes crossing ``src -> dst`` for ``count`` queries: the caller
        override, the graph's per-edge sizing, or the 1 MB/query default."""
        edge = self._edges[(src, dst)]
        if self._edge_nbytes is not None:
            return float(self._edge_nbytes(edge, count))
        if self.graph is not None:
            return float(self.graph.edge_nbytes(src, dst, count))
        return 1e6 * count

    def route(self, edge: int, count: int, from_device: int,
              dst: Optional[int] = None) -> EdgeRoute:
        """Mechanism selection for the edge ``edge -> dst`` (``dst``
        defaults to the sole successor — the chain case): global-memory
        only when the producer's device also hosts a consumer instance AND
        the payload is above the Fig. 11 crossover."""
        src = edge
        if dst is None:
            succs = self.succs[src]
            assert len(succs) == 1, \
                f"node {src} has {len(succs)} successors; pass dst explicitly"
            dst = succs[0]
        nbytes = self.edge_payload(src, dst, count)
        same = from_device in self.consumer_devices(dst)
        mech = select_mechanism(self.comm, nbytes, same)
        return EdgeRoute(mechanism=mech, same_device=same, nbytes=nbytes,
                         src=src, dst=dst)

    # ---- progress -----------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.pending) or any(self.ready) or \
            bool(self._joins) or \
            any(i.busy for st in self.stage_instances for i in st)


def default_allocation(topology: Union[int, ServiceGraph], batch: int,
                       instances_per_stage: int = 1) -> Allocation:
    """A trivial placed allocation (everything on device 0, even quotas) for
    running an engine without an allocator in the loop."""
    from repro_torch.core.types import StageAlloc
    n_stages = topology if isinstance(topology, int) else topology.n_nodes
    quota = round(1.0 / max(n_stages * instances_per_stage, 1), 4)
    stages = [StageAlloc(n_instances=instances_per_stage, quota=quota,
                         batch=batch) for _ in range(n_stages)]
    placement = Placement(per_stage=[
        [(0, quota) for _ in range(instances_per_stage)]
        for _ in range(n_stages)])
    return Allocation(stages=stages, placement=placement)
