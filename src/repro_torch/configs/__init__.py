from repro_torch.configs.base import (
    ARCH_IDS,
    ATTN,
    MAMBA,
    MLSTM,
    SLSTM,
    ModelConfig,
    MoEConfig,
    get_config,
    register,
)

__all__ = ["ARCH_IDS", "ATTN", "MAMBA", "MLSTM", "ModelConfig", "MoEConfig",
           "SLSTM", "get_config", "register"]
