"""Granite-34B-Code — deep llama-arch code model, MQA [arXiv:2405.04324].

Assigned: 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

register(ModelConfig(
    name="granite-34b",
    arch_type="dense",
    source="arXiv:2405.04324 (Granite Code Models), 34B config",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_pattern=("dense",),
    rope=True,
    rope_theta=10_000.0,
    qkv_bias=True,
    tie_embeddings=True,
))
