"""Qwen1.5-0.5B — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B].

Assigned: 24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, ATTN, register

register(ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    block_pattern=(ATTN,),
    mlp_pattern=("dense",),
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
