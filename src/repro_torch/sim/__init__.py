from repro_torch.core.faults import (DeviceFailure, FaultSpec, Straggle,
                                     TransientErrors)
from repro_torch.sim.baselines import (camelot, camelot_min_resource,
                                       camelot_nc, even_allocation, laius,
                                       standalone)
from repro_torch.sim.simulator import (MIN_COMPLETED, MultiSimResult,
                                       MultiTenantSimulator,
                                       PipelineSimulator, SimConfig,
                                       SimResult, bracketed_peak_search,
                                       find_joint_peak, find_peak_load)
from repro_torch.sim.workloads import (artifact_pipelines, artifact_stage,
                                       camelot_suite, dag_suite,
                                       diamond_service, ensemble_service,
                                       multitenant_suite,
                                       shared_backbone_service,
                                       synthetic_predictor,
                                       synthetic_tenant_set)

__all__ = [
    "DeviceFailure", "FaultSpec", "Straggle", "TransientErrors",
    "camelot", "camelot_min_resource", "camelot_nc", "even_allocation",
    "laius", "standalone", "MIN_COMPLETED", "MultiSimResult",
    "MultiTenantSimulator", "PipelineSimulator", "SimConfig", "SimResult",
    "bracketed_peak_search", "find_joint_peak",
    "find_peak_load", "artifact_pipelines", "artifact_stage", "camelot_suite",
    "dag_suite", "diamond_service", "ensemble_service", "multitenant_suite",
    "shared_backbone_service", "synthetic_predictor", "synthetic_tenant_set",
]
