from repro_torch.configs.base import (
    ARCH_IDS,
    ATTN,
    CROSS,
    H100,
    INPUT_SHAPES,
    MAMBA,
    MLSTM,
    SLSTM,
    HardwareSpec,
    InputShape,
    ModelConfig,
    MoEConfig,
    active_param_count,
    get_config,
    param_count,
    register,
)

__all__ = ["ARCH_IDS", "ATTN", "CROSS", "H100", "HardwareSpec",
           "INPUT_SHAPES", "InputShape", "MAMBA", "MLSTM", "ModelConfig",
           "MoEConfig", "SLSTM", "active_param_count", "get_config",
           "param_count", "register"]
