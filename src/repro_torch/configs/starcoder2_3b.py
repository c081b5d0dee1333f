"""StarCoder2-3B — dense code model, GQA + RoPE + sliding window [arXiv:2402.19173].

Assigned: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
Native sliding-window attention (4096): its decode cache is a ring of the
window's size.
"""
from repro_torch.configs.base import ModelConfig, ATTN, register

register(ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    source="arXiv:2402.19173 (StarCoder2), 3B config",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_pattern=("dense",),
    rope=True,
    rope_theta=100_000.0,
    sliding_window=4096,
    qkv_bias=True,
    max_position_embeddings=524_288,
))
