from repro_torch.configs.base import (
    ARCH_IDS,
    ATTN,
    MLSTM,
    SLSTM,
    ModelConfig,
    MoEConfig,
    get_config,
    register,
)

__all__ = ["ARCH_IDS", "ATTN", "MLSTM", "ModelConfig", "MoEConfig", "SLSTM",
           "get_config", "register"]
