"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

Assigned: 48L d_model=2048 4H d_ff=0 vocab=50304.
xLSTM[7:1]: superblock of 7 mLSTM + 1 sLSTM, repeated 6 times.
d_ff=0 — mLSTM blocks carry their own up-projection (inner 4096, 4 heads
of 1024); sLSTM blocks (4 heads of 512) have a small GEGLU FFN (2730) per
the paper.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, register

register(ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="arXiv:2405.04517 (xLSTM), 1.3B config",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    mlp_pattern=("none",) * 8,
    rope=False,
    xlstm_num_heads=4,
    xlstm_expand=2,
    max_position_embeddings=1 << 20,   # recurrent: unbounded context
))
