from repro_torch.core.comm import (GLOBAL_MEMORY, HOST_STAGED, CommModel,
                                   EdgeChannel, select_mechanism)
from repro_torch.core.exec import (BatchingPolicy, ExecCore, ReadyBatch,
                                   StageInstance, default_allocation)
from repro_torch.core.qos import QoSTracker
from repro_torch.core.types import (QUOTA_STEP, RTX_2080TI, Allocation,
                                    DeviceSpec, MicroserviceProfile,
                                    Placement, ServiceEdge, ServiceGraph,
                                    StageAlloc)

__all__ = ["GLOBAL_MEMORY", "HOST_STAGED", "CommModel", "EdgeChannel",
           "select_mechanism", "BatchingPolicy", "ExecCore", "ReadyBatch",
           "StageInstance", "default_allocation", "QoSTracker", "QUOTA_STEP",
           "RTX_2080TI", "Allocation", "DeviceSpec", "MicroserviceProfile",
           "Placement", "ServiceEdge", "ServiceGraph", "StageAlloc"]
