from repro_torch.serving.engine import (ModelStageServer, MultiTenantEngine,
                                        PipelineEngine, Query, ServeStats,
                                        make_trace)

__all__ = ["ModelStageServer", "MultiTenantEngine", "PipelineEngine",
           "Query", "ServeStats", "make_trace"]
