"""Phi-3.5-MoE — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=(ATTN,),
    mlp_pattern=("moe",),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
    rope=True,
    rope_theta=10_000.0,
))
