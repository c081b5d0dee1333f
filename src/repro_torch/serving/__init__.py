from repro_torch.serving.engine import (ModelStageServer, MultiTenantEngine,
                                        PipelineEngine, Query, ServeStats,
                                        make_trace)
from repro_torch.serving.transport import (ArenaMap, DeviceArena, PayloadRef,
                                           ShmArena,
                                           measure_device_transport,
                                           measure_transport,
                                           measured_crossover,
                                           select_transport)
from repro_torch.serving.workers import (CpuStageServer, WorkerPool,
                                         WorkerSupervisor)

__all__ = ["ModelStageServer", "MultiTenantEngine", "PipelineEngine",
           "Query", "ServeStats", "make_trace",
           "ArenaMap", "DeviceArena", "PayloadRef", "ShmArena",
           "measure_device_transport", "measure_transport",
           "measured_crossover", "select_transport",
           "CpuStageServer", "WorkerPool", "WorkerSupervisor"]
