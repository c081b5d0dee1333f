from repro_torch.configs.base import (
    ARCH_IDS,
    ATTN,
    CROSS,
    MAMBA,
    MLSTM,
    SLSTM,
    ModelConfig,
    MoEConfig,
    active_param_count,
    get_config,
    param_count,
    register,
)

__all__ = ["ARCH_IDS", "ATTN", "CROSS", "MAMBA", "MLSTM", "ModelConfig",
           "MoEConfig", "SLSTM", "active_param_count", "get_config",
           "param_count", "register"]
