"""PyTorch/CUDA port of the Camelot reproduction, for one NVIDIA H100.

It sits beside the JAX package ``repro`` (the reference it is held
against) and imports nothing of it or of jax.  Its entry points run on
the card unless the caller passes ``device="cpu"``.  Ported so far: the
live serving path — configs of qwen3-0.6b, qwen1.5-0.5b and xlstm-1.3b,
the prefill of their layer kinds (attention with a dense MLP, mLSTM,
sLSTM), the execution core, the threads serving engine — and its two
kernels, prefill attention (``kernels/csrc/flash_attention.cu``) and the
chunkwise mLSTM step (``kernels/csrc/mlstm_chunk.cu``).
"""
