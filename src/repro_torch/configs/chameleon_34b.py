"""Chameleon-34B — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

Assigned: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: image patches are VQ-quantized into in-vocabulary tokens, so the
backbone consumes one mixed token stream — the VQ codec is the (stubbed)
modality frontend.  Chameleon uses qk-norm for training stability.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

register(ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818 (Chameleon), 34B config",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    block_pattern=(ATTN,),
    mlp_pattern=("dense",),
    qk_norm=True,
    rope=True,
))
