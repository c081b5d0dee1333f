"""Policies under test: Camelot + the paper's comparison points.

Each policy returns (Allocation incl. placement, CommModel) for a service
graph on ``n_devices`` devices.  All of them size and place *per node*, so
chains and DAGs are charged through the identical code: the baselines see
``graph.n_stages`` nodes and the simulator/engine applies the topology
(fan-out transfers, fan-in joins, multi-exit completion) on top of their
allocations.  Camelot itself is graph-aware through ``CamelotAllocator``
(critical-path Constraint-5, per-edge comm).

  * ``even_allocation`` (EA) — splits every device evenly between the stages;
    no pipeline awareness, host-staged communication.
  * ``standalone``      — one stage per device (paper §IV-A), host-staged.
  * ``laius``           — balances stage throughputs *within* each device
    (the paper optimised Laius this way), one instance per stage per device,
    no cross-device scheduling, no instance-count tuning, host-staged comm,
    contention-unaware.
  * ``camelot``         — the full system (SA allocator, global-memory comm).
  * ``camelot_nc``      — Camelot without the bandwidth constraint (§VIII-D).

The reference wraps these functions behind its ``camelot`` facade's
policy registry (``session.solve(policy="even" | "laius" | ...)``); the
port's facade is ROADMAP.md Queue A 1c, so callers use the functions
directly.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.allocator import CamelotAllocator, SAConfig
from repro_torch.core.comm import CommModel
from repro_torch.core.predictor import PipelinePredictor
from repro_torch.core.types import (Allocation, DeviceSpec, Placement,
                                    ServiceGraph, StageAlloc)


def _placed(stages, per_stage) -> Allocation:
    return Allocation(stages=stages, placement=Placement(per_stage=per_stage))


def even_allocation(pipeline: ServiceGraph, device: DeviceSpec,
                    n_devices: int,
                    batch: int) -> Tuple[Allocation, CommModel]:
    n = pipeline.n_stages
    quota = round(1.0 / n, 4)
    stages = [StageAlloc(n_instances=n_devices, quota=quota, batch=batch)
              for _ in range(n)]
    per_stage = [[(d, quota) for d in range(n_devices)] for _ in range(n)]
    return _placed(stages, per_stage), CommModel(device,
                                                 global_memory_enabled=False)


def standalone(pipeline: ServiceGraph, device: DeviceSpec, n_devices: int,
               batch: int) -> Tuple[Allocation, CommModel]:
    n = pipeline.n_stages
    assert n_devices >= n, "standalone needs one device per stage"
    stages = [StageAlloc(1, 1.0, batch) for _ in range(n)]
    per_stage = [[(i, 1.0)] for i in range(n)]
    return _placed(stages, per_stage), CommModel(device,
                                                 global_memory_enabled=False)


def laius(pipeline: ServiceGraph, predictor: PipelinePredictor,
          device: DeviceSpec, n_devices: int, batch: int,
          ) -> Tuple[Allocation, CommModel]:
    """Per-device throughput balancing from offline solo profiles."""
    n = pipeline.n_stages
    # find quotas p_i (sum 1) equalising f_i(p_i) via iterative rebalance
    ps = np.full(n, 1.0 / n)
    for _ in range(60):
        f = np.array([predictor.stages[i].throughput(batch, float(ps[i]))
                      for i in range(n)])
        inv = 1.0 / np.maximum(f / ps, 1e-9)   # cost per unit quota
        target = inv / inv.sum()
        ps = 0.5 * ps + 0.5 * target
        ps = np.clip(ps, 0.05, 1.0)
        ps = ps / ps.sum()
    ps = np.maximum(np.round(ps / 0.05) * 0.05, 0.05)
    while ps.sum() > 1.0 + 1e-9:
        ps[np.argmax(ps)] -= 0.05
    stages = [StageAlloc(n_instances=n_devices, quota=float(ps[i]),
                         batch=batch) for i in range(n)]
    per_stage = [[(d, float(ps[i])) for d in range(n_devices)]
                 for i in range(n)]
    return _placed(stages, per_stage), CommModel(device,
                                                 global_memory_enabled=False)


def camelot(pipeline: ServiceGraph, predictor: PipelinePredictor,
            device: DeviceSpec, n_devices: int, batch: int,
            sa: Optional[SAConfig] = None,
            bandwidth_constraint: bool = True,
            ) -> Tuple[Allocation, CommModel, object]:
    comm = CommModel(device, global_memory_enabled=True)
    sa = sa or SAConfig()
    sa = replace(sa, bandwidth_constraint=bandwidth_constraint)
    alloc = CamelotAllocator(pipeline, predictor, device, n_devices,
                             comm=comm, sa=sa)
    res = alloc.solve_max_load(batch)
    return res.allocation, comm, res


def camelot_nc(pipeline: ServiceGraph, predictor: PipelinePredictor,
               device: DeviceSpec, n_devices: int, batch: int,
               sa: Optional[SAConfig] = None):
    return camelot(pipeline, predictor, device, n_devices, batch, sa=sa,
                   bandwidth_constraint=False)


def camelot_min_resource(pipeline: ServiceGraph, predictor: PipelinePredictor,
                         device: DeviceSpec, n_devices: int, batch: int,
                         load: float, sa: Optional[SAConfig] = None,
                         bandwidth_constraint: bool = True):
    comm = CommModel(device, global_memory_enabled=True)
    sa = sa or SAConfig()
    sa = replace(sa, bandwidth_constraint=bandwidth_constraint)
    alloc = CamelotAllocator(pipeline, predictor, device, n_devices,
                             comm=comm, sa=sa)
    res = alloc.solve_min_resource(batch, load)
    return res.allocation, comm, res
