"""Qwen3-0.6B — dense, qk-norm, GQA [hf:Qwen/Qwen3-8B family card].

Assigned: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, ATTN, register

register(ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (family model card, 0.6B config)",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    block_pattern=(ATTN,),
    mlp_pattern=("dense",),
    qk_norm=True,
    rope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
