"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Jamba period-8 superblock: attention at layer 4 of each block (1:7 attn:mamba),
MoE replacing the dense MLP every other layer.  32 layers = 4 superblocks.
"""
from repro_torch.configs.base import (ATTN, MAMBA, ModelConfig, MoEConfig,
                                     register)

register(ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887 (Jamba), 52B config",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # layers 0..7 of a superblock; attn at index 4 (1 of 8)
    block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    # MoE every other layer (odd indices)
    mlp_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    rope=False,                 # Jamba uses no positional encoding
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    max_position_embeddings=1 << 20,
))
