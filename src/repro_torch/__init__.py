"""PyTorch/CUDA port of the Camelot reproduction, for one NVIDIA H100.

It sits beside the JAX package ``repro`` (the reference it is held
against) and imports nothing of it or of jax.  Its entry points run on
the card unless the caller passes ``device="cpu"``.  Ported so far:

- ``configs``: qwen3-0.6b, qwen1.5-0.5b, starcoder2-3b, xlstm-1.3b,
  jamba-v0.1-52b and whisper-medium, each with its model;
- ``models``: prefill and decode of attention (dense MLP), mLSTM, sLSTM
  and Mamba (dense or MoE MLP) layers, and of the encoder-decoder
  (whisper-medium's encoder and its decoder's cross-attention blocks), on
  the four hand-written ``sm_90a`` kernels of ``kernels/csrc``;
- ``core`` and ``sim``: Camelot's control plane in numpy — the
  predictor, the simulator, the contention-aware allocator (scalar,
  vectorized, incremental and hierarchical solves), placement, the
  execution core and the workloads;
- ``core`` also holds the online runtime (``runtime.py``) and the tenant
  lifecycle (``lifecycle.py``); ``camelot``: the facade over all of it
  (``CamelotSession``, ``MultiServiceSession``, specs and policies);
- ``serving``: the serving engine (threads, or worker processes that
  hand stage outputs off by CUDA IPC), with live allocation swaps,
  retries and deadlines; ``launch.serve``: profile the stages live, fit,
  solve, serve.
"""
