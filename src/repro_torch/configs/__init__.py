from repro_torch.configs.base import (
    ARCH_IDS,
    ATTN,
    ModelConfig,
    MoEConfig,
    get_config,
    register,
)

__all__ = ["ARCH_IDS", "ATTN", "ModelConfig", "MoEConfig", "get_config",
           "register"]
