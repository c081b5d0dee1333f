"""PyTorch/CUDA port of the Camelot reproduction, for one NVIDIA H100.

It sits beside the JAX package ``repro`` (the reference it is held
against) and imports nothing of it or of jax.  Its entry points run on
the card unless the caller passes ``device="cpu"``.  Ported so far: the
live serving path — configs of qwen3-0.6b and qwen1.5-0.5b, the dense
transformer prefill, the execution core, the threads serving engine — and
its one kernel, prefill attention (``kernels/csrc/flash_attention.cu``).
"""
