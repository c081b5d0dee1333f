"""Whisper-medium — encoder-decoder ASR backbone [arXiv:2212.04356].

24 decoder + 24 encoder layers, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 51865, no RoPE.  ``learned_pos_emb``: the tokens get the same
sinusoidal table as the encoder's frames, at their absolute positions, as
in the reference (no learned table).  The mel-spectrogram and conv front
end is a stub: a prefill takes the (B, 1500, d_model) frame embeddings.
The second stage of the workloads' text-to-text service.
"""
from repro_torch.configs.base import CROSS, ModelConfig, register

register(ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356 (Whisper), medium config",
    num_layers=24,                  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=(CROSS,),
    mlp_pattern=("dense",),
    rope=False,
    learned_pos_emb=True,
    encoder_decoder=True,
    num_encoder_layers=24,
    encoder_seq_len=1500,           # 30 s audio -> 1500 frames post-conv
    max_position_embeddings=524_288,  # window-decode variant for long_500k
))
