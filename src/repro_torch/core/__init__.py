# Camelot's control plane in the port, numpy on the host as in the
# reference (the card runs only the stage servers' models):
#   predictor.py  — per-microservice performance models (LR/DT/RF, §VII-A)
#   allocator.py  — SA-based contention-aware allocation (Eq. 1-3, §VII-B/C)
#   hierarchy.py  — pod decomposition of datacenter-scale joint solves
#   deployment.py — multi-device packing, memory-capacity first (§VII-D)
#   comm.py       — global-memory vs host-staged communication (§VI)
#   exec.py       — the pipeline-execution core shared by the live engine
#                   and the simulator
#   faults.py     — fault scripts the simulator injects
#   qos.py        — tail-latency tracking
from repro_torch.core.allocator import (CamelotAllocator,
                                        MultiTenantAllocator, SAConfig,
                                        SolveResult)
from repro_torch.core.comm import (GLOBAL_MEMORY, HOST_STAGED, ICI,
                                   CommModel, DeviceHandoff, EdgeChannel,
                                   HostStagedChannel, mechanism_time,
                                   select_mechanism)
from repro_torch.core.deployment import pack_instances, placement_summary
from repro_torch.core.exec import (BatchingPolicy, EdgeRoute, ExecCore,
                                   ReadyBatch, StageInstance,
                                   default_allocation, edge_bytes)
from repro_torch.core.faults import (DeviceFailure, FaultSpec, Straggle,
                                     TransientErrors)
from repro_torch.core.hierarchy import HierarchicalSolver
from repro_torch.core.mlmodels import (DecisionTreeRegressor,
                                       LinearRegression,
                                       RandomForestRegressor,
                                       mean_absolute_percentage_error)
from repro_torch.core.predictor import (PipelinePredictor, StagePredictor,
                                        TabulatedStagePredictor,
                                        collect_samples, profile_from_engine)
from repro_torch.core.qos import QoSTracker
from repro_torch.core.types import (H100, QUOTA_GRID, QUOTA_STEP,
                                    RTX_2080TI, UTILITY_FNS, V100,
                                    Allocation, CompiledTopology, DeviceSpec,
                                    MicroserviceProfile, Pipeline, Placement,
                                    PodConfig, ServiceEdge, ServiceGraph,
                                    StageAlloc, Tenant, TenantSet)

__all__ = [
    "CamelotAllocator", "MultiTenantAllocator", "SAConfig", "SolveResult",
    "HierarchicalSolver", "PodConfig", "UTILITY_FNS", "CommModel",
    "DeviceHandoff", "EdgeChannel", "HostStagedChannel", "GLOBAL_MEMORY",
    "HOST_STAGED", "ICI", "select_mechanism", "mechanism_time",
    "BatchingPolicy", "EdgeRoute", "ExecCore", "ReadyBatch", "StageInstance",
    "DeviceFailure", "FaultSpec", "Straggle", "TransientErrors",
    "default_allocation", "edge_bytes", "pack_instances",
    "placement_summary", "DecisionTreeRegressor", "LinearRegression",
    "RandomForestRegressor", "mean_absolute_percentage_error",
    "PipelinePredictor", "StagePredictor", "TabulatedStagePredictor",
    "collect_samples", "profile_from_engine", "QoSTracker", "H100",
    "QUOTA_GRID", "QUOTA_STEP", "RTX_2080TI", "V100", "Allocation",
    "CompiledTopology", "DeviceSpec", "MicroserviceProfile", "Pipeline",
    "Placement", "ServiceEdge", "ServiceGraph", "StageAlloc", "Tenant",
    "TenantSet",
]
