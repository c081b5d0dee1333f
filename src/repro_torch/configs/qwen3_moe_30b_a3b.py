"""Qwen3-MoE-30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

Assigned: 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8.
d_ff=768 is the per-expert hidden dim; every layer is MoE.  qk-norm per Qwen3.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    block_pattern=(ATTN,),
    mlp_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    qk_norm=True,
    rope=True,
    rope_theta=1_000_000.0,
))
