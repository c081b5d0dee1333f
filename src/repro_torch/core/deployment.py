"""Deployment scheme across multiple devices (paper §VII-D).

Best-fit packing of microservice instances onto devices:
  * devices are sorted by remaining resources, global-memory capacity first
    (the paper identifies it as the dominant bottleneck), then compute quota;
  * fewest-remaining-resources first — avoids fragmenting the pool;
  * instances of the same stage prefer the same device so co-located
    instances share the model weights (one copy of weights, per-instance
    activations).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from repro_torch.core.types import (Allocation, DeviceSpec, Placement,
                                    ServiceGraph)


@dataclass
class DeviceState:
    idx: int
    quota_free: float
    mem_free: float
    instances: int = 0
    stages_hosted: Set[int] = field(default_factory=set)

    def key(self):
        # fewest remaining first; memory is the highest-priority dimension
        return (self.mem_free, self.quota_free)


def pack_instances(alloc: Allocation, pipeline: ServiceGraph,
                   predictor, device: DeviceSpec,
                   n_devices: int) -> Optional[Placement]:
    """Place every instance; returns None if infeasible.  Packing is
    per-node (topology-free), so chains and DAGs share this code; ``si``
    indexes the graph's node list.

    Memory accounting: first instance of stage s on a device pays
    weights + activations; further same-stage instances on that device pay
    activations only (weight sharing, §VII-D)."""
    devs = [DeviceState(i, 1.0, device.mem_capacity)
            for i in range(n_devices)]
    placement = Placement(per_stage=[[] for _ in alloc.stages])

    # place larger-quota stages first (harder to fit)
    order = sorted(range(len(alloc.stages)),
                   key=lambda i: -alloc.stages[i].quota)
    for si in order:
        st = alloc.stages[si]
        prof = pipeline.stages[si]
        weights = prof.weights_bytes
        acts = prof.act_bytes_per_query * st.batch
        for _ in range(st.n_instances):
            # candidate devices: those that fit; prefer (a) already hosting
            # this stage (weight sharing), (b) fewest remaining resources
            best = None
            for d in devs:
                mem_need = acts + (0.0 if si in d.stages_hosted else weights)
                if (d.quota_free + 1e-9 < st.quota
                        or d.mem_free < mem_need
                        or d.instances >= device.max_instances):
                    continue
                key = (0 if si in d.stages_hosted else 1,) + d.key()
                if best is None or key < best[0]:
                    best = (key, d, mem_need)
            if best is None:
                return None
            _, d, mem_need = best
            d.quota_free -= st.quota
            d.mem_free -= mem_need
            d.instances += 1
            d.stages_hosted.add(si)
            placement.per_stage[si].append((d.idx, st.quota))
    return placement


def placement_summary(placement: Placement, n_devices: int) -> dict:
    per_dev_quota = [0.0] * n_devices
    per_dev_instances = [0] * n_devices
    for st in placement.per_stage:
        for d, q in st:
            per_dev_quota[d] += q
            per_dev_instances[d] += 1
    used = [i for i in range(n_devices) if per_dev_instances[i] > 0]
    return {
        "devices_used": len(used),
        "quota_per_device": per_dev_quota,
        "instances_per_device": per_dev_instances,
        "total_quota": sum(per_dev_quota),
    }
