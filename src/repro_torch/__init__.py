"""PyTorch/CUDA port of the Camelot reproduction, for one NVIDIA H100.

It sits beside the JAX package ``repro`` (the reference it is held
against) and imports nothing of it or of jax.  Its entry points run on
the card unless the caller passes ``device="cpu"``.  Ported so far:

- ``configs``: qwen3-0.6b, qwen1.5-0.5b, starcoder2-3b, xlstm-1.3b and
  jamba-v0.1-52b with their models; whisper-medium as a configuration;
- ``models``: prefill and decode of attention (dense MLP), mLSTM, sLSTM
  and Mamba (dense or MoE MLP) layers, on the four hand-written
  ``sm_90a`` kernels of ``kernels/csrc``;
- ``core`` and ``sim``: Camelot's control plane in numpy — the
  predictor, the simulator, the contention-aware allocator (scalar,
  vectorized, incremental and hierarchical solves), placement, the
  execution core and the workloads;
- ``serving``: the threads serving engine; ``launch.serve``: profile the
  stages live, fit, solve, serve.
"""
