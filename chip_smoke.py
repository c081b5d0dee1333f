"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one line per case:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels (nvcc, sm_90a) and its seconds;
  3. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at ragged/odd ones (max error per case;
     attention in bf16, the tensor-core kernel, and in fp32, the exact
     kernel, each launching once per call, and on strided (B, S, H, hd)
     views through ``ops.flash_attention``; for the mLSTM chunk kernel
     per output h, c, n, m, with zero and carried state, a three-chunk
     carried sequence, padded-gate tails, and L on both sides of the
     one-pass threshold, through the one pass, the tensor-core passes
     (bf16) and the CUDA-core passes (fp32));
  4. kernel, plain and library times at the paths' shapes, beside the
     bound of the card: attention at the prefill shapes (S 2048 for
     qwen3-0.6b, qwen1.5-0.5b and jamba-v0.1-52b, S 4096 with the window
     for starcoder2-3b) and the serving shape (S 16), CUDA events and the
     profiler's device time of the kernel and of
     ``scaled_dot_product_attention``; the mLSTM chunk at (B*H 16, L 16
     and 256, hd 1024), which no single PyTorch call computes, and the
     device time of its one pass and its two passes at L 8 to 32;
  5. full-width prefill of qwen3-0.6b and qwen1.5-0.5b (B=4, S=2048) and of
     xlstm-1.3b (B=4, S=1024: four mLSTM chunks per layer): finite logits,
     one kernel launch per attention layer and per mLSTM layer and chunk,
     argmax equal to the same model with the plain op (xlstm-1.3b: in
     fp32, and in bf16 every chunk held to the plain op on the path's own
     inputs), and its device time by kernel (torch.profiler; xlstm-1.3b
     profiled at S=256);
  6. the paper's two chains served at full width through
     ``PipelineEngine`` under each communication mechanism on a
     hand-built allocation, after one profiled call of a stage alone
     (wall time, device idle share): qwen3-0.6b -> qwen1.5-0.5b, then
     text-to-img, xlstm-1.3b -> qwen1.5-0.5b (``sim/workloads.py``); and
     after each chain's ``serve`` lines, Camelot's loop on the same stage
     servers (``camelot``): each stage profiled live at batch 1/2/4/8,
     its profile fitted on the H100's spec, the predictor, the
     allocation solved on one card (feasible, on device 0, quotas on the
     grid summing to <= 1), simulated at 40 qps and served on the card
     with the same trace, the simulated and measured p99/mean beside the
     hand-built allocation's; then the facade on both chains' servers:
     ``session`` (``CamelotSession`` over the qwen chain's fitted
     profiles: profile, max-peak solve, simulate at 40 qps, serve the
     trace with the engine attached to the session's runtime, which
     re-solves at the observed 40 qps halfway through and swaps the
     allocation in once), ``session_faults`` (the same chain with
     ``ServeSpec(max_retries=1)`` and a last stage whose first call
     raises: one retry, all served) and ``multi_session``
     (``MultiServiceSession`` over both chains on one card, a joint
     solve, 32 queries at 20 qps for each tenant), each with 32/32
     completed and exact kernel launches; then the process backend:
     ``transport`` (the device arena's hand-off against the host-staged
     round trip on the card, 64 B to 16 MiB, the measured crossover beside
     the ``H100`` spec's modelled one), ``serve_processes`` (the ``serve``
     trace on worker processes, stage 0's two instances on logical devices
     0 and 1 and stage 1 on device 2, three workers on the one card with
     unenforced quotas: the qwen chain under host/device/auto, text-to-img
     under auto, the measured crossover in the comm model, the threads
     backend's p99/mean beside; under "device" every edge pick
     global-memory, by CUDA IPC) and ``session_processes``
     (``CamelotSession.serve(spec=ServeSpec(backend="processes"))`` on the
     qwen chain's fitted profiles, then a worker that kills itself on its
     first call: restarted, its batch replayed); 32/32 each, and each
     kernel's launches summed over the workers' exit reports equal to
     layers x (batches + workers), every worker warming every stage once;
  7. decode: the decode-attention kernel against its plain version
     (``check_decode``: G 1/2/4/12, hd 64/128, Sc 1 to 4096, valid from 0
     to Sc and off the tile, bf16 on the tensor-core kernel and fp32 on
     the exact one, the cache in the model's strided layout), its times
     at the decode path's shapes (``time_decode``: qwen3-0.6b,
     qwen1.5-0.5b and jamba-v0.1-52b at B 4, Sc 2080, starcoder2-3b at B
     4, Sc 4096, against ``scaled_dot_product_attention``, events and
     device time, and the kernel at other split targets), then
     ``Transformer.serve_decode`` at full width and depth in bf16 after
     each model's prefill
     (``decode``: qwen3-0.6b and qwen1.5-0.5b, B 4, prompt 2048, 32 steps;
     starcoder2-3b, B 4, prompt 4096 = its window, 64 steps through the
     full ring; xlstm-1.3b, B 4, prompt 256, 16 steps), every kernel call
     of a first run held against the plain version on its own inputs and
     a second run timed (ms per step, device idle share, launches), and
     in fp32 prefill + teacher-forced decode against the prefill of the
     whole sequence (``decode_consistency``: qwen3-0.6b, and starcoder2-3b
     decoding past its window through the ring);
  8. Mamba and jamba-v0.1-52b: the selective-scan kernel against its plain
     version (``check_ssm``: B 1/4, L 1/7/256, D 8/100/8192, ST 4/16, and
     D*ST odd or misaligned for the scalar path), its times at Jamba's
     shapes (``time_ssm``: B 4 and 1, L 256, D 8192, ST 16), then
     jamba-v0.1-52b at full width and 16 of its 32 layers in bf16
     (``jamba_memory``, ``prefill`` at B 4, S 2048 with every scan call of
     a first run held against the plain version, ``decode`` B 4, prompt
     2048, 32 steps) and in fp32 at one superblock
     (``decode_consistency``, B 1, prompt 512 + 16 steps);
then a ``{"kernels": [...]}`` line (``launches``: each kernel's launches
on its path, counted from 0 just before the path and read just after:
the served traces for the prefill kernels, those of the ``serve`` phases
plus the ``camelot`` phases' profiling and served trace and the facade
phases' traces (each also beside it; ``launches_processes``: the
process phases', counted in the workers), the timed decode steps for
the decode kernel, the timed jamba prefill for the scan kernel; the other
paths' counts beside them), the
``nvidia-smi`` line again, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without that line.  It imports nothing of jax or of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"

# (bf16 dense FLOP/s, memory B/s) from NVIDIA's data sheets, by the part
# that nvidia-smi names
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12),
         "SXM": (989e12, 3.35e12)}
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# a second bound, scaled to each output row: |diff| <= ROW_TOL * max|ref| of
# the row.  Kernel and plain both compute in fp32, so bf16 outputs differ
# by at most one rounding step (<= 2^-7 of the row's largest value): 2^-6
# is two steps.  It catches a dropped or doubled kv tile in late rows,
# whose outputs are small (~0.04) next to the fixed 2e-2.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# full-width prefill, kernel vs plain attention: max |logit diff| over
# max |logit|; measured 0.0162 (qwen3-0.6b) and 0.0169 (qwen1.5-0.5b) on
# an H100; a broken attention layer moves the last token's logits by O(1)
LOGIT_REL_TOL = 3e-2
# full-width xlstm-1.3b in fp32, kernel vs plain mLSTM: max |logit diff|
# over max |logit|.  Kernel and plain differ by fp32 summation order
# (~1e-6 of h), which the 48 layers amplify about a thousandfold (a 1e-6
# nudge moved the logits by 9e-4 on a CPU run of the stack at d 256); a
# broken mLSTM layer moves them by O(1)
XLSTM_LOGIT_REL_TOL = 0.1
# the camelot phase profiles each stage at these batches, each time a
# warm-up call and then the median of CAMELOT_REPEATS timed calls
CAMELOT_BATCHES = (1, 2, 4, 8)
CAMELOT_REPEATS = 3
# prefix of both attention kernels' symbols: flash_attention_bf16_kernel
# (tensor cores) and flash_attention_fp32_kernel (exact, CUDA cores)
ATTN_KERNEL = "flash_attention_"
# mLSTM chunk, kernel vs plain (both fp32 from the same inputs): the repo's
# tolerances for the Pallas kernel against its oracle (tests/test_kernels.py)
# |diff| <= atol + rtol |ref| for h, c, n; m is a sum of log gates
MLSTM_TOL = {"h": (2e-3, 2e-2), "c": (2e-3, 2e-2), "n": (2e-3, 2e-2),
             "m": (1e-4, 1e-4)}
# decode attention, kernel vs plain (both fp32 inside): |diff| <= tol +
# tol |ref|, the reference's decode tolerances (tests/test_kernels.py),
# and ROW_TOL's bound on each head's output row: at Sc in the thousands
# the outputs are ~0.04, where the fixed tol misses a lost or doubled tile
DECODE_TOL = {torch.float32: 3e-3, torch.bfloat16: 2e-2}
# the decode kernel's symbols: the bf16 (tensor-core) and fp32 (exact)
# split passes, and the combine pass both end with
DECODE_BF16 = ("decode_attention_bf16_kernel",
               "decode_attention_combine_kernel")
DECODE_KERNELS = DECODE_BF16 + ("decode_attention_fp32_kernel",)
# fp32 prefill + decode vs the prefill of the whole sequence: max |logit
# diff| over max |logit|.  The two paths sum in other orders (the prefill
# and decode kernels, GEMMs of 1 row against thousands), ~1e-6 of each
# layer's output in fp32; a wrong ring slot, position or mask moves the
# logits by O(1)
DECODE_LOGIT_REL_TOL = 2e-3
# selective scan, kernel vs plain (both fp32 from the same inputs; both
# round each step's product and sum separately, so they agree bit for
# bit): the reference's tolerances for the Pallas scan against its oracle
# (tests/test_kernels.py), |diff| <= atol + rtol |ref|
SSM_TOL = (1e-4, 1e-3)
SSM_KERNEL = "ssm_scan_kernel"    # ssm_scan_kernel<float4> / <float>
# fp32 rates outside the tensor cores (NVIDIA's data sheets), by part
FP32_FLOPS = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}
# torch.profiler loses the first device records of a session, more the more
# the process has traced (none early on; 10 of 10 back-to-back scan
# launches late in this script, on an H100 with torch 2.11): each profile
# first launches PROFILE_LEAD_IN spin kernels, left out of every total,
# and is kept only if some of them were recorded.  A profile that missed
# launches is taken again, up to PROFILE_TRIES times
PROFILE_LEAD_IN = 256
LEAD_IN_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
PROFILE_TRIES = 3
LEAD_IN_LOST: list = []             # lead-in records lost, per profile
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 16
JAMBA_CUT = ("num_layers 32 -> 16 (2 of 4 superblocks): 104 GB of bf16 "
             "weights do not fit one 80 GB card")


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks_for(name: str):
    for part in ("PCIe", "NVL"):
        if part in name:
            return part, PEAKS[part]
    return "SXM", PEAKS["SXM"]


def rand(gen, shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------

# (B, Sq, Skv, H, KVH, hd, causal, window, dtype)
CHECK_CASES = [
    # the serving path's shapes
    (4, 16, 16, 16, 8, 128, True, None, torch.bfloat16),
    (4, 16, 16, 16, 16, 64, True, None, torch.bfloat16),
    (4, 2048, 2048, 16, 8, 128, True, None, torch.bfloat16),
    (4, 2048, 2048, 16, 16, 64, True, None, torch.bfloat16),
    # jamba-v0.1-52b's prefill: 32 query heads over 8 KV heads, no RoPE
    (4, 2048, 2048, 32, 8, 128, True, None, torch.bfloat16),
    # ragged and odd cases
    (2, 1, 1, 4, 2, 32, True, None, torch.float32),
    (2, 1, 77, 4, 2, 16, True, None, torch.float32),
    (3, 77, 77, 8, 2, 16, True, None, torch.float32),
    (2, 77, 130, 4, 1, 32, True, None, torch.float32),
    (2, 130, 77, 4, 4, 8, True, None, torch.float32),
    (2, 100, 100, 4, 2, 16, True, 1, torch.float32),
    (2, 100, 100, 4, 2, 16, True, 7, torch.float32),
    (2, 100, 100, 4, 2, 16, True, 64, torch.float32),
    (2, 77, 90, 4, 2, 8, False, None, torch.float32),
    (2, 77, 77, 4, 2, 32, False, 7, torch.float32),
    # rows past Skv + window - 1 see no key: all average V, as the oracle
    (2, 77, 16, 4, 2, 32, True, 7, torch.float32),
    (3, 80, 80, 8, 4, 8, True, None, torch.bfloat16),
    (1, 65, 200, 2, 1, 128, True, None, torch.float32),
    (1, 130, 130, 2, 2, 64, False, None, torch.float32),
    # their bf16 twins, on the tensor-core kernel, at hd 8 to 128: Sq = 1,
    # Skv not a multiple of the 128-key tile, windows 1 / 7 / 64, a window
    # without causal, rows with no key left
    (2, 1, 1, 4, 2, 32, True, None, torch.bfloat16),
    (2, 1, 77, 4, 2, 16, True, None, torch.bfloat16),
    (2, 1, 300, 4, 2, 128, True, None, torch.bfloat16),
    (3, 77, 77, 8, 2, 16, True, None, torch.bfloat16),
    (2, 77, 130, 4, 1, 32, True, None, torch.bfloat16),
    (2, 130, 77, 4, 4, 8, True, None, torch.bfloat16),
    (2, 100, 100, 4, 2, 16, True, 1, torch.bfloat16),
    (2, 100, 100, 4, 2, 16, True, 7, torch.bfloat16),
    (2, 100, 100, 4, 2, 16, True, 64, torch.bfloat16),
    (2, 300, 300, 4, 2, 128, True, 1, torch.bfloat16),
    (2, 300, 300, 4, 2, 64, True, 7, torch.bfloat16),
    (2, 300, 300, 4, 2, 8, True, 64, torch.bfloat16),
    (2, 77, 90, 4, 2, 8, False, None, torch.bfloat16),
    (2, 77, 77, 4, 2, 32, False, 7, torch.bfloat16),
    (2, 300, 300, 4, 2, 128, False, 64, torch.bfloat16),
    (2, 77, 16, 4, 2, 32, True, 7, torch.bfloat16),
    (2, 300, 100, 4, 2, 128, True, 64, torch.bfloat16),
    (1, 65, 200, 2, 1, 128, True, None, torch.bfloat16),
    (1, 130, 130, 2, 2, 64, False, None, torch.bfloat16),
    # starcoder2-3b's prefill on the decode path: 24/2/128, window 4096
    (1, 4096, 4096, 24, 2, 128, True, 4096, torch.bfloat16),
]


def check_kernels(fa) -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for b, sq, skv, h, kvh, hd, causal, window, dtype in CHECK_CASES:
        q = rand(gen, (b * h, sq, hd), dtype)
        k = rand(gen, (b * kvh, skv, hd), dtype)
        v = rand(gen, (b * kvh, skv, hd), dtype)
        kw = dict(num_heads=h, num_kv_heads=kvh, causal=causal,
                  window=window)
        before = fa.LAUNCHES
        out = fa.flash_attention_bhsd(q, k, v, **kw)
        launched = fa.LAUNCHES - before
        ref = fa.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        case = {"b": b, "sq": sq, "skv": skv, "h": h, "kvh": kvh, "hd": hd,
                "causal": causal, "window": window}
        worst = max(worst, _held_to_plain("check", case, out, ref, launched))
    return worst


def _held_to_plain(phase: str, case: dict, out, ref, launched: int) -> float:
    """Prints the kernel's error against the plain version under TOL and
    ROW_TOL and raises if it is out of bounds or the call did not launch
    the kernel exactly once; returns the max error."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"shape/dtype {out.shape} {out.dtype}")
    dtype = out.dtype
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    tol = TOL[dtype]
    row_max = ref.float().abs().amax(-1, keepdim=True)
    ok_abs = bool((diff <= tol + tol * ref.float().abs()).all())
    ok_row = bool((diff <= ROW_TOL[dtype] * row_max).all())
    ok = ok_abs and ok_row and launched == 1
    emit({"phase": phase, **case, "dtype": str(dtype).split(".")[-1],
          "max_abs_err": err, "mean_abs_err": diff.mean().item(),
          "max_err_over_row_max": (diff / row_max).max().item(),
          "tol": tol, "row_tol": ROW_TOL[dtype], "launches": launched,
          "ok": ok})
    if not ok or not math.isfinite(err):
        raise AssertionError(f"kernel disagrees with plain or launched "
                             f"{launched} times: {phase} case {case}")
    return err


# (B, S, H, KVH, hd, causal, window, dtype): q, k, v as the (B, S, H, hd)
# slices of one fused (B, S, H + 2 KVH, hd) projection, so none is
# contiguous, through ops.flash_attention as the models call it
BSHD_CASES = [
    (2, 300, 16, 8, 128, True, None, torch.bfloat16),
    (2, 300, 16, 16, 64, True, None, torch.bfloat16),
    (2, 130, 4, 2, 8, True, 7, torch.bfloat16),
    (2, 130, 4, 2, 32, False, None, torch.float32),
]


def check_bshd(fa, ops) -> float:
    """The model's layout read in place: the kernel on strided (B, S, H,
    hd) views against the plain version on the same views; the output is
    (B, S, H, hd) and contiguous, so the model's reshape is a view."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for b, s, h, kvh, hd, causal, window, dtype in BSHD_CASES:
        qkv = rand(gen, (b, s, h + 2 * kvh, hd), dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
        before = fa.LAUNCHES
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        launched = fa.LAUNCHES - before
        ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        if not out.is_contiguous():
            raise AssertionError(f"output strides {out.stride()}")
        case = {"b": b, "s": s, "h": h, "kvh": kvh, "hd": hd,
                "causal": causal, "window": window,
                "q_strides": list(q.stride())}
        worst = max(worst, _held_to_plain("check_bshd", case, out, ref,
                                          launched))
    return worst


# --------------------------------------------------------------------------
# phase 4: timing at the path's prefill shapes
# --------------------------------------------------------------------------

# (S, H, KVH, hd, window, the model whose prefill has this shape), B 4
ATTN_TIME_SHAPES = [
    (2048, 16, 8, 128, None, "qwen3-0.6b"),
    (2048, 16, 16, 64, None, "qwen1.5-0.5b"),
    (2048, 32, 8, 128, None, JAMBA),
    (4096, 24, 2, 128, 4096, "starcoder2-3b (decode path's prefill)"),
    (16, 16, 8, 128, None, "qwen3-0.6b (serving)"),
    (16, 16, 16, 64, None, "qwen1.5-0.5b (serving)"),
]


def library_device_ms(fn, calls: int) -> tuple:
    """Device ms per call of a library function (all the kernels it
    launches) over ``calls`` profiled calls, and its kernels' names."""
    def run():
        for _ in range(calls):
            fn()
    device_ms, kernels = device_profile(run)
    return device_ms / calls, [name for name, _, _ in kernels[:3]]


def time_kernels(fa, ops, peaks) -> list:
    """Kernel, plain and library times at the prefill paths' shapes (and
    the serving shape, S = 16): CUDA-event ms of the kernel on the TPU
    op's (B*H, S, hd) layout and on the model's (B, S, H, hd), the
    kernel's device ms from the profiler, and the same two times of one
    ``scaled_dot_product_attention`` call on the same values."""
    import torch.nn.functional as F
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    rows = []
    for s, h, kvh, hd, window, model in ATTN_TIME_SHAPES:
        iters = 20 if s > 16 else 200        # S = 16 launches take ~10 us
        dt = torch.bfloat16
        q = rand(gen, (b * h, s, hd), dt)
        k = rand(gen, (b * kvh, s, hd), dt)
        v = rand(gen, (b * kvh, s, hd), dt)
        kw = dict(num_heads=h, num_kv_heads=kvh, causal=True, window=window)

        def kernel():
            return fa.flash_attention_bhsd(q, k, v, **kw)
        ms = cuda_ms(kernel, iters)
        device_ms = kernel_device_ms(kernel, (ATTN_KERNEL,),
                                     10 if s > 16 else 50)[ATTN_KERNEL]
        # the model's layout: (B, S, H, hd) tensors of the same values
        q4, k4, v4 = (t.view(b, -1, s, hd).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        ms_bshd = cuda_ms(lambda: ops.flash_attention(
            q4, k4, v4, causal=True, window=window), iters)
        del q4, k4, v4
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, **kw),
                           max(iters // 4, 3))
        torch.cuda.empty_cache()
        # the library on (B, H, S, hd) views; every window here spans the
        # whole sequence, so causal is the same function
        if window is not None and window < s:
            raise AssertionError("SDPA's is_causal is not this window")
        ql, kl, vl = (t.view(b, -1, s, hd) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=kvh != h)
        lib_ms = cuda_ms(library, iters)
        lib_device_ms, lib_kernels = library_device_ms(
            library, 10 if s > 16 else 50)
        # work these inputs need: every unmasked (q, k) pair, QK^T and PV
        pairs = sum(min(i + 1, window or s) for i in range(s))
        flops = 4 * hd * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"model": model, "h": h, "kvh": kvh, "hd": hd, "b": b, "s": s,
               "window": window, "ms": ms, "device_ms": device_ms,
               "ms_bshd": ms_bshd, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_device_ms": lib_device_ms,
               "library_kernels": lib_kernels, "flops": flops,
               "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / ms
        row["bound_share_device"] = row["bound_ms"] / device_ms
        emit({"phase": "time", **row})
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# mLSTM chunk cases: (B*H, L, hd, dtype, carried state?, chunks, padded
# tail steps in the last chunk)
MLSTM_CASES = [
    # the serving path's chunk (S = 16) and the prefill's (S >= 256)
    (16, 16, 1024, torch.bfloat16, False, 1, 0),
    (16, 16, 1024, torch.bfloat16, True, 1, 0),
    (16, 256, 1024, torch.bfloat16, False, 1, 0),
    (16, 256, 1024, torch.bfloat16, True, 1, 0),
    # a three-chunk carried sequence at full width
    (16, 256, 1024, torch.bfloat16, False, 3, 0),
    # padded-gate tails (i = -1e30, f = +30), as mlstm_mix pads
    (16, 16, 1024, torch.bfloat16, False, 1, 5),
    (4, 100, 64, torch.float32, True, 2, 37),
    # ragged L and small head dims
    (4, 1, 16, torch.float32, False, 3, 0),
    (4, 7, 8, torch.float32, True, 3, 0),
    (4, 100, 64, torch.float32, False, 3, 0),
    (4, 100, 128, torch.float32, True, 1, 0),
    (2, 64, 1024, torch.float32, True, 2, 0),
    # both sides of the one-pass threshold (MAX_SHORT = 16), bf16 and fp32
    (16, 17, 1024, torch.bfloat16, True, 2, 0),
    (4, 16, 1024, torch.float32, True, 2, 5),
    (4, 17, 1024, torch.float32, True, 2, 5),
    # the one pass at hd 64 / 128 and ragged L
    (4, 7, 64, torch.bfloat16, True, 3, 2),
    (4, 13, 128, torch.float32, True, 2, 0),
    (4, 1, 1024, torch.bfloat16, True, 2, 0),
    # the tensor-core passes at ragged L, padded (and hd 64)
    (8, 100, 1024, torch.bfloat16, True, 2, 37),
    (4, 200, 64, torch.bfloat16, True, 2, 11),
]


def mlstm_inputs(gen, bh, l, hd, dtype, pad=0):
    """q, k (pre-scaled by hd^-0.5, as the model makes it), v in ``dtype``
    and fp32 gates; the last ``pad`` steps carry the model's padding."""
    q, k, v = (rand(gen, (bh, l, hd), torch.float32) for _ in range(3))
    k = k / hd ** 0.5
    i_raw = rand(gen, (bh, l), torch.float32)
    f_raw = rand(gen, (bh, l), torch.float32) + 2.0
    if pad:
        for t in (q, k, v):
            t[:, l - pad:] = 0.0
        i_raw[:, l - pad:] = -1e30
        f_raw[:, l - pad:] = 30.0
    return q.to(dtype), k.to(dtype), v.to(dtype), i_raw, f_raw


def mlstm_carry(ms, gen, bh, l, hd, dtype, carried: bool):
    """The zero state (m = -1e30), or the state one random chunk leaves."""
    zero = (torch.zeros(bh, hd, hd, device="cuda"),
            torch.zeros(bh, hd, device="cuda"),
            torch.full((bh,), -1e30, device="cuda"))
    if not carried:
        return zero
    _, *state = ms.mlstm_chunk_plain(*mlstm_inputs(gen, bh, l, hd, dtype),
                                     *zero)
    return tuple(state)


def check_mlstm(ms) -> float:
    """The mLSTM chunk kernel against ``mlstm_chunk_plain``, the carry
    threaded through each side; returns the largest error over h, c, n."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for bh, l, hd, dtype, carried, chunks, pad in MLSTM_CASES:
        kern = plain = mlstm_carry(ms, gen, bh, l, hd, dtype, carried)
        errs = dict.fromkeys("hcnm", 0.0)
        ok = True
        for ci in range(chunks):
            xs = mlstm_inputs(gen, bh, l, hd, dtype,
                              pad if ci == chunks - 1 else 0)
            h_k, *kern = ms.mlstm_chunk_step(*xs, *kern)
            h_p, *plain = ms.mlstm_chunk_plain(*xs, *plain)
            torch.cuda.synchronize()
            for name, a, b in zip("hcnm", (h_k, *kern), (h_p, *plain)):
                atol, rtol = MLSTM_TOL[name]
                diff = (a - b).abs()
                errs[name] = max(errs[name], diff.max().item())
                ok &= a.shape == b.shape and a.dtype == torch.float32 \
                    and bool((diff <= atol + rtol * b.abs()).all()) \
                    and bool(torch.isfinite(a).all())
        emit({"phase": "check_mlstm", "bh": bh, "l": l, "hd": hd,
              "dtype": str(dtype).split(".")[-1], "carried": carried,
              "chunks": chunks, "pad": pad,
              "kernels": ms.passes(l, hd, dtype),
              **{f"max_abs_err_{n}": e for n, e in errs.items()},
              "tol": MLSTM_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"mLSTM kernel disagrees with plain: case "
                                 f"{(bh, l, hd, dtype, carried, chunks, pad)}")
        worst = max(worst, errs["h"], errs["c"], errs["n"])
    return worst


def kernel_device_ms(fn, names, launches: int) -> dict:
    """Device ms per launch of each kernel named in ``names`` (the passes
    of one entry point) over ``launches`` profiled calls of ``fn``; the
    profile must record all ``launches`` of the first pass."""
    def calls():
        for _ in range(launches):
            fn()
    _, kernels = device_profile(calls, expect={names[0]: launches})
    out = {}
    for n in names:
        rows = [(cnt, t) for key, cnt, t in kernels if n in key]
        recorded = sum(cnt for cnt, _ in rows)
        if not recorded:
            raise AssertionError(f"the profiler recorded no {n} launch of "
                                 f"{launches}: {kernels[:4]}")
        out[n] = sum(t for _, t in rows) / recorded
    return out


def time_mlstm(ms, peaks) -> list:
    """Kernel and plain times of the mLSTM chunk at the path's shapes
    (B*H = 16 heads of 1024, L = 16 at serving and 256 in a long
    prefill) and at L = 17, the shortest chunk of the two passes, bf16
    q/k/v and a carried state, beside the bound."""
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(4)
    bh, hd, dt = 16, 1024, torch.bfloat16
    rows = []
    for l in (16, 17, 256):
        xs = mlstm_inputs(gen, bh, l, hd, dt)
        carry = mlstm_carry(ms, gen, bh, l, hd, dt, True)
        iters = 50 if l < 256 else 20
        t_ms = cuda_ms(lambda: ms.mlstm_chunk_step(*xs, *carry), iters)
        plain_ms = cuda_ms(lambda: ms.mlstm_chunk_plain(*xs, *carry),
                           max(iters // 4, 5))
        by_pass = kernel_device_ms(
            lambda: ms.mlstm_chunk_step(*xs, *carry),
            ms.passes(l, hd, dt), 10)
        dev_ms = sum(by_pass.values())
        # work these inputs need: the causal (t, j) pairs of q k^T and
        # W v, the two (L, hd) x (hd, hd) products with C, the n terms
        pairs = l * (l + 1) // 2
        flops = bh * (4 * hd * pairs + 4 * l * hd * hd + 4 * l * hd)
        # each input read once, each output written once
        nbytes = sum(t.numel() * t.element_size() for t in (*xs, *carry))
        nbytes += 4 * (bh * l * hd + bh * hd * hd + bh * hd + bh)
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"bh": bh, "l": l, "hd": hd, "dtype": "bfloat16", "ms": t_ms,
               "device_ms": dev_ms, "device_ms_by_pass": by_pass,
               "plain_ms": plain_ms,
               "library_ms": None, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / t_ms
        row["bound_share_device"] = row["bound_ms"] / dev_ms
        emit({"phase": "time_mlstm", **row})
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phases 5-6: the port's main path
# --------------------------------------------------------------------------

def prefill_full_width(fa, ops, Transformer, get_config) -> int:
    """Returns the kernel launches of the two timed prefills."""
    total = 0
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, s = 4, 2048
    for seed, arch in enumerate(("qwen3-0.6b", "qwen1.5-0.5b")):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        model = Transformer(cfg, device="cuda", dtype=torch.bfloat16,
                            seed=seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            model.serve_prefill(tokens)              # warm-up
            torch.cuda.synchronize()
            fa.LAUNCHES = 0               # this model's timed prefill only
            t0 = time.perf_counter()
            logits, cache = model.serve_prefill(tokens)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = fa.LAUNCHES
            total += launches
            device_ms, kernels = device_profile(
                lambda: model.serve_prefill(tokens),
                expect={ATTN_KERNEL: cfg.num_layers})
            plain, _ = model.serve_prefill(
                tokens, attention=ops.flash_attention_plain)
            torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        ids, ids_plain = logits.argmax(-1), plain.argmax(-1)
        same = bool((ids == ids_plain).all())
        scale = plain.float().abs().max().item()
        rel = (logits.float() - plain.float()).abs().max().item() / scale
        emit({"phase": "prefill", "arch": arch, "b": b, "s": s,
              "layers": cfg.num_layers, "init_s": init_s,
              "prefill_s": prefill_s, "launches": launches,
              "logits_shape": list(logits.shape), "finite": finite,
              "argmax_equal_plain": same,
              "max_rel_logit_diff_plain": rel,
              "cache_shape": list(cache.layers[0].k.shape),
              "device_ms": device_ms,
              "attention_share": sum(ms for name, _, ms in kernels
                                     if ATTN_KERNEL in name) / device_ms,
              "top_device_kernels": kernels[:6]})
        if logits.shape != (b, cfg.vocab_size) or not finite:
            raise AssertionError(f"{arch}: bad logits")
        if launches != cfg.num_layers:
            raise AssertionError(f"{arch}: {launches} kernel launches for "
                                 f"{cfg.num_layers} layers")
        if not same:
            raise AssertionError(f"{arch}: argmax differs from the plain-"
                                 f"attention run: {ids.tolist()} vs "
                                 f"{ids_plain.tolist()}")
        if not rel <= LOGIT_REL_TOL:
            raise AssertionError(f"{arch}: logits differ from the plain-"
                                 f"attention run by {rel} of max |logit|")
        del model, logits, plain, cache
        torch.cuda.empty_cache()
    return total


def checking_op(ms, ops, errs: dict):
    """An mLSTM op for ``serve_prefill`` that runs the kernel and, on the
    same inputs, the plain version; it keeps in ``errs`` the largest error
    of each output over all calls and its worst ratio to the tolerance
    (MLSTM_TOL), and hands the kernel's result on."""
    def op(*args):
        h_k, carry_k = ops.mlstm_chunk(*args)
        h_p, carry_p = ops.mlstm_chunk_plain(*args)
        for name, a, b in zip("hcnm", (h_k, *carry_k), (h_p, *carry_p)):
            atol, rtol = MLSTM_TOL[name]
            diff = (a - b).abs()
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
            ratio = (diff / (atol + rtol * b.abs())).max().item()
            errs["worst_ratio"] = max(errs.get("worst_ratio", 0.0), ratio)
        return h_k, carry_k
    return op


def prefill_xlstm(ms, ops, Transformer, get_config) -> int:
    """Full-width xlstm-1.3b at B = 4, S = 1024 (four mLSTM chunks per
    layer, so the carry crosses chunks at full width); returns the mLSTM
    kernel launches of the timed bf16 prefill.

    In bf16 this randomly initialised 48-layer stack amplifies any
    rounding difference until the logits decorrelate (a 1e-6 relative
    nudge to the mLSTM outputs moves them by 66 % of max |logit| and
    flips the argmax, in a CPU run of the same stack at d 256), so the
    bf16 run is held to the plain op chunk by chunk, on the path's own
    inputs; the whole-model argmax and logit comparison runs in fp32."""
    cfg = get_config("xlstm-1.3b")
    n_mlstm = cfg.block_pattern.count("mlstm") * cfg.num_superblocks
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, s_prof = 4, 1024, 256
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=3)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    errs: dict = {}
    with torch.inference_mode():
        model.serve_prefill(tokens)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms.LAUNCHES = 0                   # the timed prefill only
        t0 = time.perf_counter()
        logits, cache = model.serve_prefill(tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = ms.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model.serve_prefill(tokens, mlstm=checking_op(ms, ops, errs))
        plain, _ = model.serve_prefill(tokens, mlstm=ops.mlstm_chunk_plain)
        # the sLSTM loop dispatches S x 6 x ~20 small ops from the host:
        # the profile is taken at S = 256 (one chunk per layer)
        device_ms, kernels = device_profile(
            lambda: model.serve_prefill(tokens[:, :s_prof]),
            expect={ms.TWO_PASS_TC[0]: n_mlstm * (s_prof // 256)})
        torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    scale = plain.float().abs().max().item()
    rel_bf16 = (logits.float() - plain.float()).abs().max().item() / scale
    state_c_shape = list(cache.layers[0].c.shape)
    mlstm_ms = sum(t for name, _, t in kernels
                   if any(k in name for k in ms.KERNELS))
    del model, plain, cache
    torch.cuda.empty_cache()

    model = Transformer(cfg, device="cuda", dtype=torch.float32, seed=3)
    with torch.inference_mode():
        logits32, _ = model.serve_prefill(tokens)
        plain32, _ = model.serve_prefill(tokens, mlstm=ops.mlstm_chunk_plain)
        torch.cuda.synchronize()
    ids, ids_plain = logits32.argmax(-1), plain32.argmax(-1)
    same = bool((ids == ids_plain).all())
    rel = (logits32 - plain32).abs().max().item() \
        / plain32.abs().max().item()
    emit({"phase": "prefill", "arch": cfg.name, "b": b, "s": s,
          "layers": cfg.num_layers, "mlstm_layers": n_mlstm,
          "init_s": init_s, "prefill_s": prefill_s, "launches": launches,
          "peak_gb": peak_gb, "logits_shape": list(logits.shape),
          "finite": finite, "chunk_errs_vs_plain": errs,
          "max_rel_logit_diff_plain_bf16": rel_bf16,
          "fp32_argmax_equal_plain": same,
          "fp32_max_rel_logit_diff_plain": rel,
          "state_c_shape": state_c_shape,
          "profiled_s": s_prof, "device_ms": device_ms,
          "mlstm_ms": mlstm_ms, "mlstm_share": mlstm_ms / device_ms,
          "device_launches": sum(n for _, n, _ in kernels),
          "top_device_kernels": kernels[:6]})
    if logits.shape != (b, cfg.vocab_size) or not finite \
            or not bool(torch.isfinite(logits32).all()):
        raise AssertionError("xlstm-1.3b: bad logits")
    if launches != n_mlstm * (s // 256):
        raise AssertionError(f"xlstm-1.3b: {launches} mLSTM launches for "
                             f"{n_mlstm} layers x {s // 256} chunks")
    if not errs["worst_ratio"] <= 1.0:
        raise AssertionError(f"xlstm-1.3b: a chunk of the bf16 path "
                             f"disagrees with the plain op: {errs}")
    if not same:
        raise AssertionError(f"xlstm-1.3b fp32: argmax differs from the "
                             f"plain-mLSTM run: {ids.tolist()} vs "
                             f"{ids_plain.tolist()}")
    if not rel <= XLSTM_LOGIT_REL_TOL:
        raise AssertionError(f"xlstm-1.3b fp32: logits differ from the "
                             f"plain-mLSTM run by {rel} of max |logit|")
    del model, logits, logits32, plain32
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 7: decode
# --------------------------------------------------------------------------

def decode_case(gen, b, sc, h, kvh, hd, dtype, layout: str):
    """q (B, 1, H, hd) and a cache in ``layout``: "model" (B, Sc, KVH, hd)
    as the model keeps it, or "slice" (that layout cut out of a larger
    buffer, strided in every axis but hd)."""
    q = rand(gen, (b, 1, h, hd), dtype)
    k, v = (rand(gen, (b, sc, kvh, hd), dtype) for _ in range(2))
    if layout == "slice":
        def cut(t):
            buf = torch.zeros(b + 1, sc + 3, kvh + 1, hd, dtype=dtype,
                              device="cuda")
            buf[1:, 2:2 + sc, 1:] = t
            return buf[1:, 2:2 + sc, 1:]
        k, v = cut(k), cut(v)
    return q, k, v


def check_decode(dec) -> tuple:
    """The decode kernel against ``decode_attention_plain`` on the card,
    one line per (G, hd, Sc, dtype, layout), with the max error for each
    ``valid`` (0, 1, part of Sc, Sc - 3: off the 32-slot tile, Sc: a full
    ring); returns the largest error and the largest error over its
    row's max |ref|."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, kvh = 2, 2
    worst = (0.0, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for g in (1, 2, 4, 12):
            for hd in (64, 128):
                for sc in (1, 7, 100, 2080, 4096):
                    layouts = ("model", "slice") if sc == 100 \
                        else ("model",)
                    for layout in layouts:
                        err, row = _check_decode_case(
                            dec, gen, b, sc, g * kvh, kvh, hd, dtype,
                            layout)
                        worst = (max(worst[0], err), max(worst[1], row))
    return worst


def decode_row_ratio(out, ref, dtype) -> float:
    """The largest |diff| / (ROW_TOL max|ref| of its row), over the heads'
    output rows; a row whose reference is all zeros (valid 0) must come
    out zeros."""
    diff = (out.float() - ref.float()).abs()
    bound = ROW_TOL[dtype] * ref.float().abs().amax(-1, keepdim=True)
    ratio = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item()


def _check_decode_case(dec, gen, b, sc, h, kvh, hd, dtype, layout) -> tuple:
    q, k, v = decode_case(gen, b, sc, h, kvh, hd, dtype, layout)
    qp = q.reshape(b * kvh, h // kvh, hd)
    tol = DECODE_TOL[dtype]
    errs, row_ratios, ok = {}, {}, True
    for valid in sorted({0, 1, max(1, sc * 5 // 8), max(1, sc - 3), sc}):
        kw = dict(num_heads=h, num_kv_heads=kvh)
        out = dec.decode_attention_packed(qp, k, v, valid, **kw)
        ref = dec.decode_attention_plain(qp, k, v, valid, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        errs[valid] = diff.max().item()
        row_ratios[valid] = decode_row_ratio(out, ref, dtype)
        ok &= out.shape == ref.shape and out.dtype == dtype \
            and bool((diff <= tol + tol * ref.float().abs()).all()) \
            and row_ratios[valid] <= 1.0 \
            and math.isfinite(errs[valid]) \
            and (valid > 0 or not bool(out.any()))
    over_row = {n: r * ROW_TOL[dtype] for n, r in row_ratios.items()}
    emit({"phase": "check_decode", "g": h // kvh, "hd": hd, "sc": sc,
          "b": b, "kvh": kvh, "dtype": str(dtype).split(".")[-1],
          "layout": layout, "max_abs_err_by_valid": errs,
          "max_err_over_row_max_by_valid": over_row,
          "tol": tol, "row_tol": ROW_TOL[dtype], "ok": ok})
    if not ok:
        raise AssertionError(f"decode kernel disagrees with plain: case "
                             f"{(b, sc, h, kvh, hd, dtype, layout)}")
    return max(errs.values()), max(over_row.values())


# the decode path's attention shapes: (model, H, KVH, hd, Sc)
DECODE_SHAPES = [("qwen3-0.6b", 16, 8, 128, 2080),
                 ("qwen1.5-0.5b", 16, 16, 64, 2080),
                 ("starcoder2-3b", 24, 2, 128, 4096),
                 (JAMBA, 32, 8, 128, 2080)]


def time_decode(dec, ops, peaks) -> list:
    """Kernel, plain and library times at the decode path's shapes, B 4,
    bf16, every slot valid (the last step of the path).  The caches
    rotate over enough copies to exceed the 50 MB L2, as the path's layers
    each read their own cache."""
    import torch.nn.functional as F
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, dt = 4, torch.bfloat16
    rows = []
    for arch, h, kvh, hd, sc in DECODE_SHAPES:
        valid = sc
        kv_bytes = 2 * b * sc * kvh * hd * 2
        n_sets = max(2, math.ceil(200e6 / kv_bytes))
        q = rand(gen, (b, 1, h, hd), dt)
        caches = [tuple(rand(gen, (b, sc, kvh, hd), dt) for _ in range(2))
                  for _ in range(n_sets)]
        turn = [0]

        def rotating(fn):
            def call():
                turn[0] = (turn[0] + 1) % n_sets
                return fn(*caches[turn[0]])
            return call
        kernel = rotating(lambda k, v: ops.decode_attention(q, k, v, valid))
        ms = cuda_ms(kernel, 200)
        by_pass = kernel_device_ms(kernel, DECODE_BF16, 50)
        dev_ms = sum(by_pass.values())
        plain_ms = cuda_ms(rotating(
            lambda k, v: ops.decode_attention_plain(q, k, v, valid)), 20)
        # the library's own layout, (B, KVH, Sc, hd), made outside the
        # timing; slots >= valid masked (none at valid = Sc)
        lib_kv = [tuple(t.transpose(1, 2).contiguous() for t in kv)
                  for kv in caches]
        mask = (torch.arange(sc, device="cuda") < valid)[None, None, None]
        qt = q.transpose(1, 2)
        lib_turn = [0]

        def library():
            lib_turn[0] = (lib_turn[0] + 1) % n_sets
            k, v = lib_kv[lib_turn[0]]
            return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  enable_gqa=kvh != h)
        lib_ms = cuda_ms(library, 200)
        lib_device_ms, lib_kernels = library_device_ms(library, 50)
        del lib_kv
        # K and V up to valid read once, q read and out written once
        nbytes = 2 * b * valid * kvh * hd * 2 + 2 * q.numel() * 2
        flops = 4 * b * h * valid * hd
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"arch": arch, "b": b, "h": h, "kvh": kvh, "hd": hd,
               "g": h // kvh, "sc": sc, "valid": valid, "dtype": "bfloat16",
               "cache_copies_rotated": n_sets, "ms": ms, "device_ms": dev_ms,
               "device_ms_by_pass": by_pass,
               "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_device_ms": lib_device_ms,
               "library_kernels": lib_kernels, "flops": flops,
               "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / ms
        row["bound_share_device"] = row["bound_ms"] / dev_ms
        emit({"phase": "time_decode", **row})
        rows.append(row)
        del caches
        torch.cuda.empty_cache()
    return rows


def checking_decode_op(ops, errs: dict):
    """A decode attention op for ``serve_decode`` that runs the kernel and,
    on the same inputs, the plain version; it keeps in ``errs`` the
    largest error over all calls, its worst ratios to the two bounds
    (DECODE_TOL, ROW_TOL) and the number of calls, and hands the kernel's
    result on."""
    def op(q, k, v, valid):
        out = ops.decode_attention(q, k, v, valid)
        ref = ops.decode_attention_plain(q, k, v, valid).float()
        tol = DECODE_TOL[q.dtype]
        diff = (out.float() - ref).abs()
        errs["max_abs_err"] = max(errs.get("max_abs_err", 0.0),
                                  diff.max().item())
        errs["worst_ratio"] = max(errs.get("worst_ratio", 0.0),
                                  (diff / (tol + tol * ref.abs())).max()
                                  .item())
        errs["worst_row_ratio"] = max(errs.get("worst_row_ratio", 0.0),
                                      decode_row_ratio(out, ref, q.dtype))
        errs["calls"] = errs.get("calls", 0) + 1
        return out
    return op


def decode_steps(model, logits, cache, steps: int, **kw):
    """``steps`` greedy decode steps from a prefill's logits and cache;
    returns the last logits, the cache and the tokens fed (B, steps)."""
    fed = []
    for _ in range(steps):
        nxt = logits.argmax(-1)
        fed.append(nxt)
        logits, cache = model.serve_decode(nxt, cache, **kw)
    return logits, cache, torch.stack(fed, dim=1)


def first_attention_layer(model):
    """Index of the model's first attention layer, or None."""
    from repro_torch.configs import ATTN
    return next((i for i, (kind, _) in enumerate(model.kinds)
                 if kind == ATTN), None)


def decode_model(dec, ops, model, prompt: int, steps: int, gen,
                 b: int = 4, **extra) -> int:
    """``serve_decode`` of ``model`` in bf16 after its prefill: a first
    run with every decode kernel call held against the plain version, a
    timed run (the count from 0 just before its steps) and a profiled
    one; returns the decode kernel's launches in the timed steps."""
    from repro_torch.configs import ATTN
    cfg = model.cfg
    n_attn = cfg.block_pattern.count(ATTN) * cfg.num_superblocks
    ai = first_attention_layer(model)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device="cuda", dtype=torch.int32)
    errs: dict = {}
    with torch.inference_mode():
        # run 1: every kernel call held against the plain version
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps)
        _, cache, fed_checked = decode_steps(
            model, logits, cache, steps,
            decode_attention=checking_decode_op(ops, errs))
        del cache
        # run 2, timed: the counts from 0 just before the steps
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps)
        s_cache = cache.layers[ai].k.shape[1] if n_attn else None
        k_ptr = cache.layers[ai].k.data_ptr() if n_attn else None
        torch.cuda.synchronize()
        dec.LAUNCHES = 0
        t0 = time.perf_counter()
        last, cache, fed = decode_steps(model, logits, cache, steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dec.LAUNCHES
        in_place = k_ptr is None or cache.layers[ai].k.data_ptr() == k_ptr
        del cache
        # run 3, profiled: device time of a few steps
        prof_steps = min(8, steps)
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps)
        torch.cuda.synchronize()
        device_ms, kernels = device_profile(
            lambda: decode_steps(model, logits, cache, prof_steps),
            expect={DECODE_BF16[0]: n_attn * prof_steps})
        del cache
    step_ms = wall_s * 1e3 / steps
    dev_step_ms = device_ms / prof_steps
    decode_kernel_ms = sum(t for name, _, t in kernels
                           if any(k in name for k in DECODE_KERNELS))
    finite = bool(torch.isfinite(last).all())
    emit({"phase": "decode", "arch": cfg.name, **extra, "b": b,
          "prompt": prompt, "steps": steps, "layers": cfg.num_layers,
          "attention_layers": n_attn, "s_cache": s_cache,
          "ms_per_step": step_ms, "device_ms_per_step": dev_step_ms,
          "device_idle_share": max(0.0, 1 - dev_step_ms / step_ms),
          "device_launches_per_step":
              sum(n for _, n, _ in kernels) / prof_steps,
          "tokens_per_s": b * steps / wall_s,
          "decode_kernel_launches": launches,
          "decode_kernel_ms_per_step": decode_kernel_ms / prof_steps,
          "decode_kernel_share": decode_kernel_ms / device_ms,
          "kernel_errs_vs_plain": errs, "cache_updated_in_place":
              in_place, "finite": finite,
          "same_tokens_as_checked_run": bool(torch.equal(fed, fed_checked)),
          "logits_shape": list(last.shape),
          "top_device_kernels": kernels[:6]})
    if launches != n_attn * steps:
        raise AssertionError(f"{cfg.name}: {launches} decode kernel "
                             f"launches for {n_attn} attention layers x "
                             f"{steps} steps")
    if n_attn and errs.get("calls") != n_attn * steps:
        raise AssertionError(f"{cfg.name}: {errs.get('calls')} checked calls")
    if n_attn and not (errs["worst_ratio"] <= 1.0
                       and errs["worst_row_ratio"] <= 1.0):
        raise AssertionError(f"{cfg.name}: a decode kernel call disagrees "
                             f"with the plain version: {errs}")
    if last.shape != (b, cfg.vocab_size) or not finite or not in_place:
        raise AssertionError(f"{cfg.name}: bad decode logits or cache")
    return launches


# (model, prompt, decode steps, seed): B = 4 for each
DECODE_RUNS = [("qwen3-0.6b", 2048, 32, 0), ("qwen1.5-0.5b", 2048, 32, 1),
               ("starcoder2-3b", 4096, 64, 4), ("xlstm-1.3b", 256, 16, 3)]


def decode_full_width(dec, ops, Transformer, get_config) -> dict:
    """``serve_decode`` at full width and depth in bf16 after each model's
    prefill; returns the decode kernel's launches in each model's timed
    steps."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    launches = {}
    for arch, prompt, steps, seed in DECODE_RUNS:
        model = Transformer(get_config(arch), device="cuda",
                            dtype=torch.bfloat16, seed=seed)
        launches[arch] = decode_model(dec, ops, model, prompt, steps, gen)
        del model
        torch.cuda.empty_cache()
    return launches


# (model, batch, prompt, teacher-forced decode steps)
CONSISTENCY_RUNS = [("qwen3-0.6b", 2, 512, 16),
                    # 4092 + 12 crosses the 4096 window: the last 8 steps
                    # overwrite the ring's oldest slots
                    ("starcoder2-3b", 1, 4092, 12)]


def decode_consistency(Transformer, runs, seed: int = 11) -> list:
    """In fp32: prefill(S) and N teacher-forced decode steps give the last
    logits of prefill(S + N).  ``runs``: (config, batch, prompt, decode
    steps, note) each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for cfg, b, s, n, note in runs:
        model = Transformer(cfg, device="cuda", dtype=torch.float32, seed=5)
        ai = first_attention_layer(model)
        tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            full, full_cache = model.serve_prefill(tokens)
            s_cache = full_cache.layers[ai].k.shape[1]
            del full_cache
            logits, cache = model.serve_prefill(tokens[:, :s],
                                                cache_len=s + n)
            for i in range(s, s + n):
                logits, cache = model.serve_decode(tokens[:, i], cache)
            torch.cuda.synchronize()
        same = bool(torch.equal(logits.argmax(-1), full.argmax(-1)))
        rel = (logits - full).abs().max().item() / full.abs().max().item()
        row = {"phase": "decode_consistency", "arch": cfg.name,
               "dtype": "float32", "layers": cfg.num_layers, **note,
               "b": b, "prompt": s, "decode_steps": n,
               "window": cfg.sliding_window, "s_cache": s_cache,
               "ring_wrapped": s + n > cache.layers[ai].k.shape[1],
               "argmax_equal": same, "max_rel_logit_diff": rel,
               "tol": DECODE_LOGIT_REL_TOL}
        emit(row)
        rows.append(row)
        if not same or not rel <= DECODE_LOGIT_REL_TOL:
            raise AssertionError(f"{cfg.name}: prefill + decode differs from "
                                 f"the prefill of the whole sequence: {row}")
        del model, full, logits, cache
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phase 8: the selective scan and jamba-v0.1-52b
# --------------------------------------------------------------------------

# (B, L, D, ST, offset): B 1/4 x L 1/7/256 x D 8/100/8192 x ST 4/16, then
# the scalar path: D*ST not a multiple of 4, and buffers 4 bytes off the
# 16-byte alignment of the vector path
SSM_CASES = [(b, l, d, st, 0) for b in (1, 4) for l in (1, 7, 256)
             for d in (8, 100, 8192) for st in (4, 16)] \
    + [(2, 33, 7, 3, 0), (2, 9, 100, 16, 1), (3, 256, 8192, 16, 1)]


def ssm_inputs(gen, b, l, d, st, offset=0):
    """da in (0, 1) and dbx ~ 0.1 N(0, 1), fp32; with ``offset``, each a
    contiguous view ``offset`` floats into a larger buffer."""
    n = b * l * d * st

    def buf(t):
        if not offset:
            return t
        out = torch.empty(n + offset, device="cuda")[offset:]
        return out.view(b, l, d, st).copy_(t)
    da = torch.sigmoid(rand(gen, (b, l, d, st), torch.float32))
    dbx = rand(gen, (b, l, d, st), torch.float32) * 0.1
    return buf(da), buf(dbx)


def check_ssm(sm) -> float:
    """The scan kernel against ``ssm_chunk_scan_plain`` on the card, one
    line per case; returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    atol, rtol = SSM_TOL
    worst = 0.0
    for b, l, d, st, offset in SSM_CASES:
        da, dbx = ssm_inputs(gen, b, l, d, st, offset)
        before = sm.LAUNCHES
        out = sm.ssm_chunk_scan(da, dbx)
        launched = sm.LAUNCHES - before
        ref = sm.ssm_chunk_scan_plain(da, dbx)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = diff.max().item()
        ok = out.shape == ref.shape and out.dtype == torch.float32 \
            and launched == 1 and math.isfinite(err) \
            and bool((diff <= atol + rtol * ref.abs()).all())
        emit({"phase": "check_ssm", "b": b, "l": l, "d": d, "st": st,
              "vector_path": (d * st) % 4 == 0 and offset == 0,
              "max_abs_err": err, "bit_equal": bool(torch.equal(out, ref)),
              "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            raise AssertionError(f"ssm scan kernel disagrees with plain: "
                                 f"case {(b, l, d, st, offset)}")
        worst = max(worst, err)
        del da, dbx, out, ref, diff
    return worst


def time_ssm(sm, part: str, peaks) -> list:
    """Kernel, plain and device times of the scan at Jamba's chunk (L 256,
    D 8192, ST 16) at B 4 and B 1, beside the bound.  No single PyTorch
    call computes this linear recurrence: library none."""
    _, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for b in (4, 1):
        l, d, st = 256, 8192, 16
        da, dbx = ssm_inputs(gen, b, l, d, st)
        t_ms = cuda_ms(lambda: sm.ssm_chunk_scan(da, dbx), 20)
        dev_ms = kernel_device_ms(lambda: sm.ssm_chunk_scan(da, dbx),
                                  (SSM_KERNEL,), 50)[SSM_KERNEL]
        plain_ms = cuda_ms(lambda: sm.ssm_chunk_scan_plain(da, dbx), 3, 1)
        # one multiply and one add per element; da, dbx read once and h
        # written once, fp32
        flops = 2 * da.numel()
        nbytes = 3 * da.numel() * 4
        t_ops, t_bytes = flops / FP32_FLOPS[part], nbytes / mem_rate
        row = {"b": b, "l": l, "d": d, "st": st, "dtype": "float32",
               "ms": t_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": None, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / t_ms
        row["bound_share_device"] = row["bound_ms"] / dev_ms
        emit({"phase": "time_ssm", **row})
        rows.append(row)
        del da, dbx
        torch.cuda.empty_cache()
    return rows


def checking_attention_op(ops, errs: dict):
    """An attention op for ``serve_prefill`` that runs the kernel and, on
    the same inputs, the plain version, held to ``check_kernels``'s two
    bounds (TOL, ROW_TOL); it keeps in ``errs`` the largest error over all
    calls, the worst ratio to each bound and the number of calls, and
    hands the kernel's result on."""
    def op(q, k, v, *, causal=True, window=None):
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                        window=window).float()
        tol, row_tol = TOL[q.dtype], ROW_TOL[q.dtype]
        diff = (out.float() - ref).abs()
        row_max = ref.abs().amax(-1, keepdim=True)
        errs["max_abs_err"] = max(errs.get("max_abs_err", 0.0),
                                  diff.max().item())
        errs["worst_ratio"] = max(errs.get("worst_ratio", 0.0),
                                  (diff / (tol + tol * ref.abs())).max()
                                  .item())
        errs["worst_row_ratio"] = max(errs.get("worst_row_ratio", 0.0),
                                      (diff / (row_tol * row_max)).max()
                                      .item())
        errs["calls"] = errs.get("calls", 0) + 1
        return out
    return op


def checking_ssm_op(ops, errs: dict):
    """A scan op for ``serve_prefill`` that runs the kernel and, on the
    same inputs, the plain version; it keeps in ``errs`` the largest error
    over all calls, its worst ratio to the tolerance (SSM_TOL), the number
    of calls and of bit-equal calls, and hands the kernel's result on."""
    atol, rtol = SSM_TOL

    def op(da, dbx):
        out = ops.ssm_scan(da, dbx)
        ref = ops.ssm_scan_plain(da, dbx)
        diff = (out - ref).abs()
        errs["max_abs_err"] = max(errs.get("max_abs_err", 0.0),
                                  diff.max().item())
        errs["worst_ratio"] = max(errs.get("worst_ratio", 0.0),
                                  (diff / (atol + rtol * ref.abs())).max()
                                  .item())
        errs["calls"] = errs.get("calls", 0) + 1
        errs["bit_equal_calls"] = errs.get("bit_equal_calls", 0) \
            + int(torch.equal(out, ref))
        return out
    return op


def jamba_config(get_config, layers: int = JAMBA_LAYERS):
    """jamba-v0.1-52b at its published width, cut to ``layers`` layers
    (whole superblocks)."""
    return dataclasses.replace(get_config(JAMBA), num_layers=layers)


def prefill_jamba(sm, fa, ops, Transformer, get_config, param_bytes):
    """jamba-v0.1-52b at full width, 16 layers, bf16, B 4, S 2048 (8 scan
    chunks per Mamba layer).  Prints the parameter bytes and the card's
    free memory before anything is allocated.  Returns the model (for
    the decode phase) and the kernels' launches in the timed prefill."""
    from repro_torch.configs import ATTN, MAMBA
    cfg = jamba_config(get_config)
    n_mamba = cfg.block_pattern.count(MAMBA) * cfg.num_superblocks
    n_attn = cfg.block_pattern.count(ATTN) * cfg.num_superblocks
    b, s = 4, 2048
    chunks = s // 256
    gc_collect()
    free, total = torch.cuda.mem_get_info()
    need = param_bytes(cfg, torch.bfloat16)
    emit({"phase": "jamba_memory", "arch": cfg.name, "cut": JAMBA_CUT,
          "layers": cfg.num_layers, "param_bytes": need,
          "param_gb": need / 1e9,
          "full_depth_param_gb": param_bytes(get_config(JAMBA),
                                             torch.bfloat16) / 1e9,
          "free_gb": free / 1e9, "total_gb": total / 1e9})
    if need > free:
        raise AssertionError(f"{cfg.name}: {need / 1e9} GB of parameters, "
                             f"{free / 1e9} GB free")
    gen = torch.Generator(device="cuda").manual_seed(14)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=6)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = torch.cuda.memory_allocated() / 1e9
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    errs: dict = {}
    attn_errs: dict = {}
    with torch.inference_mode():
        # run 1: every scan and attention call held against the plain
        # version
        checked, _ = model.serve_prefill(
            tokens, ssm=checking_ssm_op(ops, errs),
            attention=checking_attention_op(ops, attn_errs))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sm.LAUNCHES = fa.LAUNCHES = 0     # the timed prefill only
        t0 = time.perf_counter()
        logits, cache = model.serve_prefill(tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = {"ssm_chunk_scan": sm.LAUNCHES,
                    "flash_attention_bhsd": fa.LAUNCHES}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state_h_shape = list(cache.layers[0].h.shape)
        del cache
        plain, _ = model.serve_prefill(tokens, ssm=ops.ssm_scan_plain)
        device_ms, kernels = device_profile(
            lambda: model.serve_prefill(tokens),
            expect={SSM_KERNEL: n_mamba * chunks, ATTN_KERNEL: n_attn})
    finite = bool(torch.isfinite(logits).all())
    ids, ids_plain = logits.argmax(-1), plain.argmax(-1)
    same = bool((ids == ids_plain).all())
    rel = (logits.float() - plain.float()).abs().max().item() \
        / plain.float().abs().max().item()
    ssm_ms = sum(t for name, _, t in kernels if SSM_KERNEL in name)
    attn_ms = sum(t for name, _, t in kernels if ATTN_KERNEL in name)
    emit({"phase": "prefill", "arch": cfg.name, "cut": JAMBA_CUT, "b": b,
          "s": s, "dtype": "bfloat16", "layers": cfg.num_layers,
          "mamba_layers": n_mamba, "attention_layers": n_attn,
          "param_gb": param_gb, "peak_gb": peak_gb, "init_s": init_s,
          "prefill_s": prefill_s, "device_ms": device_ms,
          "device_idle_share": max(0.0, 1 - device_ms / (prefill_s * 1e3)),
          "launches": launches,
          "device_launches": sum(n for _, n, _ in kernels),
          "ssm_kernel_ms": ssm_ms, "ssm_kernel_share": ssm_ms / device_ms,
          "attention_kernel_ms": attn_ms,
          "attention_kernel_share": attn_ms / device_ms,
          "logits_shape": list(logits.shape), "finite": finite,
          "ssm_errs_vs_plain": errs, "attention_errs_vs_plain": attn_errs,
          "checked_run_equal": bool(torch.equal(checked, logits)),
          "argmax_equal_plain": same, "max_rel_logit_diff_plain": rel,
          "state_h_shape": state_h_shape,
          "top_device_kernels": kernels[:8]})
    if logits.shape != (b, cfg.vocab_size) or not finite:
        raise AssertionError(f"{cfg.name}: bad logits")
    if launches["ssm_chunk_scan"] != n_mamba * chunks:
        raise AssertionError(f"{cfg.name}: {launches['ssm_chunk_scan']} scan "
                             f"launches for {n_mamba} Mamba layers x "
                             f"{chunks} chunks")
    if launches["flash_attention_bhsd"] != n_attn:
        raise AssertionError(f"{cfg.name}: {launches['flash_attention_bhsd']}"
                             f" attention launches for {n_attn} layers")
    if errs.get("calls") != n_mamba * chunks or not errs["worst_ratio"] <= 1:
        raise AssertionError(f"{cfg.name}: a scan call of the checked run "
                             f"disagrees with the plain version: {errs}")
    if attn_errs.get("calls") != n_attn or not attn_errs["worst_ratio"] <= 1 \
            or not attn_errs["worst_row_ratio"] <= 1:
        raise AssertionError(f"{cfg.name}: an attention call of the checked "
                             f"run disagrees with the plain version: "
                             f"{attn_errs}")
    if not same:
        raise AssertionError(f"{cfg.name}: argmax differs from the plain-"
                             f"scan run: {ids.tolist()} vs "
                             f"{ids_plain.tolist()}")
    del logits, plain, checked
    return model, launches


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def build_allocation(n_stages: int, instances: int, batch: int):
    """Stage 0 gets ``instances`` concurrent instances, the rest one each,
    all on device 0; quotas floored onto the ``QUOTA_STEP`` lattice (as
    ``examples/serve_pipeline.py`` builds its allocation)."""
    from repro_torch.core.types import (QUOTA_STEP, Allocation, Placement,
                                        StageAlloc)
    per_stage, stages = [], []
    for si in range(n_stages):
        n_i = instances if si == 0 else 1
        units = math.floor(1.0 / (n_stages * n_i) / QUOTA_STEP + 1e-9)
        quota = round(max(1, min(units, round(1.0 / QUOTA_STEP)))
                      * QUOTA_STEP, 6)
        stages.append(StageAlloc(n_instances=n_i, quota=quota, batch=batch))
        per_stage.append([(0, quota) for _ in range(n_i)])
    return Allocation(stages=stages, placement=Placement(per_stage=per_stage))


def device_profile(fn, host_ops: bool = False, expect=None):
    """Run ``fn`` once under torch.profiler: the device's busy ms and the
    device kernels (and copies) as [name, launches, ms], longest first
    (with ``host_ops``, also the host's top ops as [name, calls, self ms],
    whose launch calls include the lead-in's).
    Only the device's own events are summed: a host op's row repeats the
    device time of the kernels it launched.

    ``fn``'s work follows PROFILE_LEAD_IN spin kernels on the stream; the
    profile is kept when some of them were recorded (the records lost are
    the session's first) and ``fn``'s count of each kernel in ``expect``
    (a name, matched as a substring, to its launches) is whole.  Else it
    is printed as a ``profile_retake`` line and taken again, up to
    PROFILE_TRIES times, and then fails the run."""
    for attempt in range(1, PROFILE_TRIES + 1):
        lead_in, out = _profile_once(fn, host_ops)
        recorded = {n: sum(cnt for key, cnt, _ in out[1] if n in key)
                    for n in expect or {}}
        LEAD_IN_LOST.append(PROFILE_LEAD_IN - lead_in)
        if lead_in and recorded == dict(expect or {}):
            return out
        emit({"phase": "profile_retake", "attempt": attempt,
              "lead_in_recorded": lead_in, "expected": expect,
              "recorded": recorded})
    raise AssertionError(f"the profiler recorded {lead_in} lead-in and "
                         f"{recorded} launches of {expect} in "
                         f"{PROFILE_TRIES} tries")


def _profile_once(fn, host_ops: bool):
    """One profile of ``fn`` after the lead-in: the lead-in kernels
    recorded, then ``device_profile``'s result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA or not e.is_user_annotation]
    lead_in = sum(e.count for e in rows if e.device_type == DeviceType.CUDA
                  and LEAD_IN_KERNEL in e.key)
    dev = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                  and LEAD_IN_KERNEL not in e.key),
                 key=lambda e: e.self_device_time_total, reverse=True)
    kernels = [[e.key, e.count, e.self_device_time_total / 1e3] for e in dev]
    device_ms = sum(ms for _, _, ms in kernels)
    if not host_ops:
        return lead_in, (device_ms, kernels)
    top = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    return lead_in, (device_ms, kernels,
                     [[e.key, e.count, e.self_cpu_time_total / 1e3]
                      for e in top[:6]])


def stage_breakdown(stage, batch: int) -> dict:
    """One stage call alone: wall time (median of 5, no profiler), and
    from one profiled call the device's busy time, its longest kernels
    and the host's top ops."""
    wall_s = stage.profile_stage_timings(batches=(batch,), repeats=5)[0][1]
    toks = torch.zeros(batch, stage.seq_len, dtype=torch.int32,
                       device="cuda")
    device_ms, kernels, host = device_profile(lambda: stage.process(toks),
                                              host_ops=True)
    return {"phase": "stage", "name": stage.name, "arch": stage.cfg.name,
            "batch": batch, "seq_len": stage.seq_len,
            "wall_ms": wall_s * 1e3, "device_busy_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / (wall_s * 1e3)),
            "device_launches": sum(n for _, n, _ in kernels),
            "top_device_kernels": kernels[:4], "top_host_ops": host}


def serve_chain(chain: str, stages, alloc, kernels,
                mechanisms=("host", "device", "auto"),
                phase: str = "serve") -> tuple:
    """Serve ``stages`` as a chain on ``alloc``: 32 queries at 40 qps
    (Poisson, seed 7), batch timeout 50 ms, under each of ``mechanisms``.
    ``kernels``: [(name, module, launches per batch through the chain)].
    Returns each kernel's launches over the traces, counted from 0 just
    before the first and read just after the last, and each trace's
    ``ServeStats.summary()`` by mechanism."""
    from repro_torch.serving import PipelineEngine, make_trace
    counts = zero_counts(kernels)         # the served traces only
    summaries = {}
    for mech in mechanisms:
        trace = make_trace(32, qps=40.0, seq_len=16,
                           vocab=stages[0].cfg.vocab_size, seed=7)
        before = counts()
        busy = [(st.busy_time, st.calls) for st in stages]
        with PipelineEngine(stages, comm_mechanism=mech, qos_target=1.0,
                            batch_timeout=0.05, allocation=alloc) as eng:
            stats = eng.run_trace(trace)
        launches = {name: n - before[name] for name, n in counts().items()}
        stage_ms = [(st.busy_time - b) / max(st.calls - c, 1) * 1e3
                    for st, (b, c) in zip(stages, busy)]
        s = summaries[mech] = stats.summary()
        emit({"phase": phase, "chain": chain, "mechanism": mech,
              "queries": 32, "qps": 40.0, "batch": eng.batch_size,
              "instances": [a.n_instances for a in alloc.stages],
              "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
              "completed": s["completed"], "failed": s["failed"],
              "batches": stats.batches, "comm_share": s["comm_frac"],
              "stage_ms_in_pipeline": stage_ms,
              "edge0_picks": eng.channels[0].picks, "launches": launches})
        if s["completed"] != 32 or s["failed"] != 0:
            raise AssertionError(f"{chain} {mech}: completed "
                                 f"{s['completed']}, failed {s['failed']}")
        # each batch passes every stage once, plus one warm-up per stage
        for name, _, per_batch in kernels:
            if launches[name] != per_batch * (stats.batches + 1):
                raise AssertionError(
                    f"{chain} {mech}: {launches[name]} {name} launches for "
                    f"{stats.batches} batches")
    return counts(), summaries


def camelot_chain(chain: str, stages, kernels, hand: dict) -> tuple:
    """Camelot's loop over ``stages`` at full width on the card: profile
    each stage live, fit its profile on the H100's spec and the predictor,
    solve the allocation on one card (``solve_max_load(4)``), simulate it
    at 40 qps, and serve it with the ``serve`` phase's trace under "auto".
    ``hand``: the serve phase's "auto" summary on the hand-built
    allocation, printed beside.  Returns each kernel's launches in the
    phase (the profiling's, counted from 0 before it, plus the served
    trace's: ``serve_chain``'s own count) and the fitted profiles."""
    from repro_torch.core import (H100, CamelotAllocator, Pipeline,
                                  PipelinePredictor, SAConfig,
                                  profile_from_engine)
    from repro_torch.models import param_bytes
    from repro_torch.sim import PipelineSimulator
    t_phase = time.perf_counter()
    counts = zero_counts(kernels)
    timings, profiles = [], []
    for st in stages:
        t = st.profile_stage_timings(batches=CAMELOT_BATCHES,
                                     repeats=CAMELOT_REPEATS)
        timings.append(t)
        profiles.append(profile_from_engine(
            st.name, t, weights_bytes=param_bytes(st.cfg),
            act_bytes_per_query=2e7, device=H100, host_bytes_per_query=2e6))
    profiled = counts()
    calls = len(CAMELOT_BATCHES) * (CAMELOT_REPEATS + 1)   # warm-up + timed
    for name, _, per_batch in kernels:
        if profiled[name] != per_batch * calls:
            raise AssertionError(f"{chain}: {profiled[name]} {name} "
                                 f"launches in {calls} profiled calls")
    pipeline = Pipeline(chain, profiles, qos_target=1.0)
    pred = PipelinePredictor.from_profiles(profiles, H100)
    allocator = CamelotAllocator(pipeline, pred, H100, 1,
                                 sa=SAConfig(iterations=1200, seed=0))
    t0 = time.perf_counter()
    res = allocator.solve_max_load(4)
    solve_s = time.perf_counter() - t0
    if not res.feasible:
        raise AssertionError(f"{chain}: the solve found no feasible "
                             f"allocation on one card (fitted profiles "
                             f"{profiles})")
    alloc = res.allocation
    device0 = on_one_card(chain, alloc)
    sim = PipelineSimulator(pipeline, alloc, H100, allocator.comm).run(40.0)
    served, summaries = serve_chain(chain, stages, alloc, kernels,
                                    mechanisms=("auto",),
                                    phase="camelot_serve")
    s = summaries["auto"]
    emit({"phase": "camelot", "chain": chain,
          "profiled": {st.name: t for st, t in zip(stages, timings)},
          "fitted": {p.name: {"overhead_ms": p.overhead * 1e3,
                              "per_query_ms": p.flops_per_query
                              / H100.peak_flops * 1e3,
                              "weights_bytes": p.weights_bytes}
                     for p in profiles},
          "solve": {"feasible": res.feasible, "mode": res.mode,
                    "predicted_peak_qps": res.objective,
                    "predicted_latency_ms":
                        alloc.predicted_latency * 1e3,
                    "wall_s": solve_s,
                    "stages": alloc_row(alloc),
                    "devices": [0], "device0_quota": device0},
          "simulated": {"qps": 40.0, "p99_ms": sim.p99 * 1e3,
                        "mean_ms": sim.mean_latency * 1e3,
                        "completed": sim.completed},
          "measured": {"qps": 40.0, "p99_ms": s["p99"] * 1e3,
                       "mean_ms": s["mean"] * 1e3,
                       "completed": s["completed"], "failed": s["failed"]},
          "hand_built": {"p99_ms": hand["p99"] * 1e3,
                         "mean_ms": hand["mean"] * 1e3},
          "launches_profile": profiled, "launches_serve": served,
          "seconds": time.perf_counter() - t_phase})
    return ({name: profiled[name] + served[name] for name, _, _ in kernels},
            profiles)


def on_one_card(name: str, alloc) -> float:
    """Raise unless ``alloc`` is placed on device 0 alone with every quota
    on the ``QUOTA_GRID`` and device 0's quotas summing to <= 1; returns
    that sum."""
    from repro_torch.core import QUOTA_GRID
    placed = [dq for per in alloc.placement.per_stage for dq in per]
    quotas = [a.quota for a in alloc.stages] + [q for _, q in placed]
    off_grid = [q for q in quotas
                if min(abs(float(g) - q) for g in QUOTA_GRID) > 1e-9]
    device0 = sum(q for _, q in placed)
    if {d for d, _ in placed} != {0} or off_grid or device0 > 1.0 + 1e-9:
        raise AssertionError(
            f"{name}: allocation placed on devices "
            f"{sorted({d for d, _ in placed})}, quotas off the grid "
            f"{off_grid}, device 0's quotas sum to {device0}")
    return device0


def layers_of(stages, kind: str) -> int:
    return sum(st.cfg.block_pattern.count(kind) * st.cfg.num_superblocks
               for st in stages)


# ---------------------------------------------------------------------------
# the facade: CamelotSession / MultiServiceSession on the live stage servers
# ---------------------------------------------------------------------------

FACADE_SA_ITERATIONS = 1200
# each kernel of the served chains and the block kind that launches it
KERNEL_KINDS = (("flash_attention_bhsd", "attn"),
                ("mlstm_chunk_step", "mlstm"))


def served_spec(chain: str, stages, profiles):
    """The chain as a ``ServiceSpec`` of its live-fitted profiles, each
    node naming its stage server's model (``arch``)."""
    from repro_torch.camelot import ServiceSpec
    return ServiceSpec.chain(chain, [dataclasses.replace(p, arch=st.cfg.name)
                                     for st, p in zip(stages, profiles)],
                             qos_target=1.0)


def alloc_row(alloc) -> list:
    return [{"instances": a.n_instances, "quota": a.quota, "batch": a.batch}
            for a in alloc.stages]


def zero_counts(kernels) -> dict:
    """Set every kernel's count to 0; returns a reader of the counts."""
    for _, mod, _ in kernels:
        mod.LAUNCHES = 0
    return lambda: {name: mod.LAUNCHES for name, mod, _ in kernels}


def check_launches(phase: str, launches: dict, expected: dict) -> None:
    if launches != expected:
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{expected}")


def check_served(phase: str, s: dict, n: int, retries: int = 0) -> None:
    if (s["completed"], s["failed"], s["retries"]) != (n, 0, retries):
        raise AssertionError(f"{phase}: completed {s['completed']}, failed "
                             f"{s['failed']}, retries {s['retries']} (want "
                             f"{n}, 0, {retries})")


class FirstCallFails:
    """A stage server whose first ``process`` call raises before any work
    (so it launches nothing); every later call goes to the server."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.seq_len, self.cfg, self.device = \
            inner.name, inner.seq_len, inner.cfg, inner.device
        self.raised = 0

    def warmup(self, batch: int):
        self.inner.warmup(batch)

    def process(self, tokens):
        if not self.raised:
            self.raised += 1
            raise RuntimeError("injected fault: the first call of "
                               f"{self.name}")
        return self.inner.process(tokens)


def session_phase(chain: str, stages, profiles, kernels) -> dict:
    """``CamelotSession`` over the chain's live-fitted profiles on one
    H100: ``profile`` → ``solve("max-peak")`` → ``simulate(40)`` →
    ``serve(stages=...)``, the engine attached to the session's runtime
    (resumed from the solve: no second cold solve).  The ``serve`` phase's
    trace (32 queries, 40 qps, seed 7) is replayed; once half its arrivals
    are in, a second thread observes 40 qps (EWMA alpha 1: the estimate is
    the observation) and reallocates, a min-resource re-solve that the
    engine swaps in between batches.  Returns the trace's launches."""
    from repro_torch.camelot import (CamelotSession, ClusterSpec, QoSSpec,
                                     SAConfig)
    from repro_torch.core import H100, RuntimeConfig
    t_phase = time.perf_counter()
    sa = SAConfig(iterations=FACADE_SA_ITERATIONS, seed=0)
    sess = CamelotSession(served_spec(chain, stages, profiles),
                          ClusterSpec(device=H100, devices=1),
                          QoSSpec(latency_target=1.0), batch=4)
    sess.profile()
    t0 = time.perf_counter()
    res = sess.solve("max-peak", sa=sa)
    solve_s = time.perf_counter() - t0
    if not res.feasible:
        raise AssertionError(f"session: no feasible solve ({profiles})")
    on_one_card("session solve", res.allocation)
    sim = sess.simulate(40.0)
    eng = sess.serve(stages=stages)
    runtime = sess.runtime(rt=RuntimeConfig(ewma_alpha=1.0), sa=sa,
                           resume=True)
    runtime.attach_engine(eng)
    trace = sess.make_trace(32, 40.0, seed=7)
    # the engine's clock starts when its last stage is warm: mark it
    started = threading.Event()
    last = stages[-1]

    def warmup_then_mark(batch: int) -> None:
        type(last).warmup(last, batch)
        started.set()

    swap = {}

    def reallocate() -> None:
        if not started.wait(timeout=120.0):
            return
        time.sleep(trace[15].arrival)
        t0 = time.perf_counter()
        sess.observe(40.0)
        swap["alloc"] = sess.reallocate(now=trace[15].arrival)
        swap["seconds"] = time.perf_counter() - t0

    counts = zero_counts(kernels)
    last.warmup = warmup_then_mark
    th = threading.Thread(target=reallocate)
    th.start()
    try:
        stats = eng.run_trace(trace)
    finally:
        del last.warmup
        started.set()
        th.join(timeout=120.0)
    launches = counts()
    s = stats.summary()
    ev = runtime.history[-1] if runtime.history else None
    emit({"phase": "session", "chain": chain, "queries": 32, "qps": 40.0,
          "solve": {"predicted_peak_qps": res.objective, "wall_s": solve_s,
                    "stages": alloc_row(res.allocation)},
          "resolve": None if ev is None else {
              "provisioned_for_qps": ev.provisioned_for,
              "feasible": ev.feasible, "objective": ev.objective,
              "warm_started": ev.warm_started,
              "reallocate_s": swap.get("seconds"),
              "stages": alloc_row(runtime.current)},
          "swaps": eng.swaps,
          "simulated": {"p99_ms": sim.p99 * 1e3,
                        "mean_ms": sim.mean_latency * 1e3},
          "measured": {"p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
                       "completed": s["completed"], "failed": s["failed"]},
          "batches": stats.batches, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    check_served("session", s, 32)
    if th.is_alive() or "alloc" not in swap or eng.swaps != 1:
        raise AssertionError(f"session: {eng.swaps} swaps, reallocation "
                             f"{'done' if 'alloc' in swap else 'not done'}")
    if not (ev.feasible and eng.alloc is runtime.current is swap["alloc"]):
        raise AssertionError("session: the engine does not serve the "
                             "runtime's feasible re-solve")
    on_one_card("session re-solve", runtime.current)
    # each batch passes every stage once, plus one warm-up per stage
    check_launches("session", launches,
                   {name: per_batch * (stats.batches + 1)
                    for name, _, per_batch in kernels})
    return launches


def session_faults_phase(chain: str, stages, profiles, kernels) -> dict:
    """The chain served through ``CamelotSession.serve`` with
    ``ServeSpec(max_retries=1, retry_backoff=0.01)``, its last stage
    wrapped in ``FirstCallFails``: the failed batch is retried once and
    every query completes; the kernels launch once per layer of every
    call that ran.  Returns the trace's launches."""
    from repro_torch.camelot import (CamelotSession, ClusterSpec, QoSSpec,
                                     SAConfig, ServeSpec)
    from repro_torch.core import H100
    t_phase = time.perf_counter()
    sess = CamelotSession(served_spec(chain, stages, profiles),
                          ClusterSpec(device=H100, devices=1),
                          QoSSpec(latency_target=1.0), batch=4)
    sess.profile()
    res = sess.solve("max-peak", sa=SAConfig(
        iterations=FACADE_SA_ITERATIONS, seed=0))
    flaky = FirstCallFails(stages[-1])
    eng = sess.serve(stages=list(stages[:-1]) + [flaky], result=res,
                     spec=ServeSpec(max_retries=1, retry_backoff=0.01))
    calls = [st.calls for st in stages]
    counts = zero_counts(kernels)
    stats = eng.run_trace(sess.make_trace(32, 40.0, seed=7))
    launches = counts()
    calls = [st.calls - c for st, c in zip(stages, calls)]
    s = stats.summary()
    emit({"phase": "session_faults", "chain": chain, "queries": 32,
          "qps": 40.0, "max_retries": 1, "retry_backoff_s": 0.01,
          "raised": flaky.raised, "retries": s["retries"],
          "completed": s["completed"], "failed": s["failed"],
          "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
          "batches": stats.batches, "stage_calls": calls,
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    check_served("session_faults", s, 32, retries=1)
    if flaky.raised != 1 or calls != [stats.batches] * len(stages):
        raise AssertionError(f"session_faults: raised {flaky.raised}, "
                             f"stage calls {calls} for {stats.batches} "
                             "batches")
    # each stage's launches: its layers x (its calls + its warm-up)
    check_launches("session_faults", launches, {
        name: sum(layers_of([st], kind) * (c + 1)
                  for st, c in zip(stages, calls))
        for name, kind in KERNEL_KINDS
        if name in launches})
    return launches


def multi_session_phase(chains, kernels) -> dict:
    """``MultiServiceSession`` over both chains on one H100, each from its
    live-fitted profiles: one joint ``solve("max-peak")``, ``simulate([20,
    20])``, then ``serve(tenant_stages=...)`` with ``make_traces(32, [20,
    20], seed=7)`` on the shared pool.  Returns the traces' launches."""
    from repro_torch.camelot import (ClusterSpec, MultiServiceSession,
                                     QoSSpec, SAConfig, TenantSpec)
    from repro_torch.core import H100
    t_phase = time.perf_counter()
    sess = MultiServiceSession(
        [TenantSpec(served_spec(chain, stages, profiles),
                    QoSSpec(latency_target=1.0))
         for chain, stages, profiles in chains],
        ClusterSpec(device=H100, devices=1), batch=4, name="paper-chains")
    sess.profile()
    t0 = time.perf_counter()
    res = sess.solve("max-peak", sa=SAConfig(
        iterations=FACADE_SA_ITERATIONS, seed=0))
    solve_s = time.perf_counter() - t0
    if not res.feasible:
        raise AssertionError("multi_session: no feasible joint solve")
    on_one_card("multi_session", res.allocation)
    sim = sess.simulate([20.0, 20.0])
    eng = sess.serve(tenant_stages=[stages for _, stages, _ in chains])
    traces = sess.make_traces(32, [20.0, 20.0], seed=7)
    counts = zero_counts(kernels)
    stats = eng.run_traces(traces)
    launches = counts()
    rows = []
    for (chain, _, _), st, sm, part in zip(chains, stats, sim.per_tenant,
                                           sess.split()):
        s = st.summary()
        rows.append({"chain": chain, "stages": alloc_row(part),
                     "simulated": {"p99_ms": sm.p99 * 1e3,
                                   "mean_ms": sm.mean_latency * 1e3},
                     "measured": {"p99_ms": s["p99"] * 1e3,
                                  "mean_ms": s["mean"] * 1e3,
                                  "completed": s["completed"],
                                  "failed": s["failed"]},
                     "batches": st.batches})
    emit({"phase": "multi_session", "queries": 32, "qps": [20.0, 20.0],
          "solve": {"predicted_lambda": res.objective, "wall_s": solve_s},
          "tenants": rows, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    for (chain, _, _), st in zip(chains, stats):
        check_served(f"multi_session {chain}", st.summary(), 32)
    check_launches("multi_session", launches, {
        name: sum(layers_of(stages, kind) * (st.batches + 1)
                  for (_, stages, _), st in zip(chains, stats))
        for name, kind in KERNEL_KINDS})
    return launches


def facade_phases(chains, kernels) -> dict:
    """The three facade phases; ``chains``: (name, live stage servers,
    fitted profiles) of the qwen chain, then text-to-img."""
    qwen = chains[0]
    return {"session": session_phase(*qwen, kernels),
            "session_faults": session_faults_phase(*qwen, kernels),
            "multi_session": multi_session_phase(chains, kernels)}


# ---------------------------------------------------------------------------
# the process backend: worker processes, CUDA IPC hand-off between them
# ---------------------------------------------------------------------------

QUOTAS_NOTE = ("quotas not enforced: no MPS, the workers' CUDA contexts "
               "time-slice the card")


class DiesOnFirstCall:
    """A picklable stage server (spawned workers import it from this
    file) that kills its own worker process on its first ``process`` call,
    before any work; a sentinel file marks the crash, so the replacement
    worker's replay goes to the server."""

    def __init__(self, inner, sentinel: str):
        self.inner, self.sentinel = inner, sentinel
        self.name, self.seq_len, self.cfg, self.device = \
            inner.name, inner.seq_len, inner.cfg, inner.device

    def warmup(self, batch: int):
        self.inner.warmup(batch)

    def process(self, tokens):
        if not Path(self.sentinel).exists():
            Path(self.sentinel).touch()
            os._exit(17)
        return self.inner.process(tokens)


def transport_phase() -> float:
    """The device arena's hand-off against the host-staged round trip on
    the card, 64 B to 16 MiB (median of 15 each); returns the measured
    crossover, printed beside the ``H100`` spec's modelled one."""
    from repro_torch.core import H100, CommModel
    from repro_torch.serving import measure_device_transport
    t0 = time.perf_counter()
    tr = measure_device_transport(repeats=15)
    emit({"phase": "transport", "sizes_bytes": tr["sizes"],
          "device_arena_ms": [s * 1e3 for s in tr["shm_s"]],
          "host_staged_ms": [s * 1e3 for s in tr["queue_s"]],
          "measured_crossover_bytes": tr["crossover_bytes"],
          "modelled_crossover_bytes": CommModel(H100).crossover_bytes(),
          "modelled_by": "H100 DeviceSpec (ipc_latency, host link)",
          "seconds": time.perf_counter() - t0})
    return tr["crossover_bytes"]


def spread_allocation():
    """Stage 0's two instances on logical devices 0 and 1, stage 1 on
    device 2: three workers, all on the one card."""
    from repro_torch.core.types import Allocation, Placement, StageAlloc
    return Allocation(stages=[StageAlloc(2, 1.0, 4), StageAlloc(1, 1.0, 4)],
                      placement=Placement(per_stage=[[(0, 1.0), (1, 1.0)],
                                                     [(2, 1.0)]]))


def card_memory() -> dict:
    """The driver's reserved device memory and the card's free memory
    (GiB): the workers' models and contexts come out of the latter."""
    free, total = torch.cuda.mem_get_info()
    return {"driver_reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "card_free_gib": free / 2**30, "card_total_gib": total / 2**30}


def worker_launches(eng) -> dict:
    """Each kernel's launches, summed over the engine's closed workers."""
    return {name: sum(r["launches"][name]
                      for r in eng.worker_reports.values())
            for name, _ in KERNEL_KINDS}


def check_worker_launches(phase: str, stages, eng, batches: int) -> dict:
    """Every worker warms every stage once, and each batch passes every
    stage once: layers x (batches + workers) launches of each kernel."""
    launches = worker_launches(eng)
    workers = len(eng.worker_reports)
    check_launches(phase, launches,
                   {name: layers_of(stages, kind) * (batches + workers)
                    for name, kind in KERNEL_KINDS})
    return launches


def serve_processes(chain: str, stages, mechanisms, crossover: float,
                    threads: dict) -> dict:
    """The ``serve`` phase's trace (32 queries, 40 qps, seed 7, batch 4,
    timeout 50 ms) on the processes backend with ``spread_allocation``,
    under each of ``mechanisms``, the comm model fed the measured
    crossover; ``threads``: the ``serve`` phase's summaries by mechanism
    (the threads backend, this run).  Returns the kernels' launches summed
    over every pool's workers."""
    from repro_torch.camelot import ClusterSpec
    from repro_torch.core import GLOBAL_MEMORY, H100, HOST_STAGED
    from repro_torch.serving import PipelineEngine, make_trace
    comm = ClusterSpec(device=H100, devices=3,
                       crossover_bytes=crossover).comm_model()
    alloc = spread_allocation()
    total = {name: 0 for name, _ in KERNEL_KINDS}
    for mech in mechanisms:
        t0 = time.perf_counter()
        gc_collect()                     # the driver's cached blocks
        memory = card_memory()
        trace = make_trace(32, qps=40.0, seq_len=16,
                           vocab=stages[0].cfg.vocab_size, seed=7)
        with PipelineEngine(stages, comm_mechanism=mech, qos_target=1.0,
                            batch_timeout=0.05, allocation=alloc,
                            comm_model=comm, backend="processes") as eng:
            stats = eng.run_trace(trace)
            picks = dict(eng.channels[0].picks)
        s = stats.summary()
        th = threads[mech]
        line = {"phase": "serve_processes", "chain": chain,
                "mechanism": mech, "queries": 32, "qps": 40.0, "batch": 4,
                "placement": alloc.placement.per_stage,
                "workers": len(eng.worker_reports),
                "crossover_bytes": comm.crossover_bytes(),
                "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
                "completed": s["completed"], "failed": s["failed"],
                "batches": stats.batches, "comm_share": s["comm_frac"],
                "edge0_picks": picks,
                "threads_serve": {"p99_ms": th["p99"] * 1e3,
                                  "mean_ms": th["mean"] * 1e3},
                "quotas": QUOTAS_NOTE,
                "worker_calls": {w: r["calls"]
                                 for w, r in eng.worker_reports.items()},
                "launches": worker_launches(eng), "memory": memory,
                "seconds": time.perf_counter() - t0}
        emit(line)
        check_served(f"serve_processes {chain} {mech}", s, 32)
        if line["workers"] != 3:
            raise AssertionError(f"serve_processes: {line['workers']} "
                                 "workers reported, want 3")
        if mech == "device" and (picks[HOST_STAGED] != 0
                                 or picks[GLOBAL_MEMORY] != stats.batches):
            raise AssertionError(f"serve_processes {chain} device: edge "
                                 f"picks {picks} for {stats.batches} "
                                 "batches")
        launched = check_worker_launches(
            f"serve_processes {chain} {mech}", stages, eng, stats.batches)
        for name in total:
            total[name] += launched[name]
    return total


def session_processes_phase(chain: str, stages, profiles,
                            crossover: float) -> dict:
    """``CamelotSession.serve(spec=ServeSpec(backend="processes"))`` on the
    chain's fitted profiles: the max-peak solve, placed on device 0 of one
    card, is served by one worker; then the same with the last stage
    wrapped in ``DiesOnFirstCall`` and ``max_retries=2``: the worker dies,
    is restarted once and its batches replayed, and every query
    completes.  Returns the first trace's launches summed over its
    workers."""
    from repro_torch.camelot import (CamelotSession, ClusterSpec, QoSSpec,
                                     SAConfig, ServeSpec)
    from repro_torch.core import H100
    t0 = time.perf_counter()
    gc_collect()
    sess = CamelotSession(served_spec(chain, stages, profiles),
                          ClusterSpec(device=H100, devices=1,
                                      crossover_bytes=crossover),
                          QoSSpec(latency_target=1.0), batch=4)
    sess.profile()
    res = sess.solve("max-peak", sa=SAConfig(
        iterations=FACADE_SA_ITERATIONS, seed=0))
    if not res.feasible:
        raise AssertionError("session_processes: no feasible solve")
    on_one_card("session_processes", res.allocation)
    with sess.serve(stages=stages, result=res,
                    spec=ServeSpec(backend="processes")) as eng:
        stats = eng.run_trace(sess.make_trace(32, 40.0, seed=7))
    s = stats.summary()
    emit({"phase": "session_processes", "chain": chain, "queries": 32,
          "qps": 40.0, "stages": alloc_row(res.allocation),
          "workers": len(eng.worker_reports),
          "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
          "completed": s["completed"], "failed": s["failed"],
          "batches": stats.batches, "comm_share": s["comm_frac"],
          "edge0_picks": dict(eng.channels[0].picks),
          "quotas": QUOTAS_NOTE, "launches": worker_launches(eng),
          "seconds": time.perf_counter() - t0})
    check_served("session_processes", s, 32)
    launches = check_worker_launches("session_processes", stages, eng,
                                     stats.batches)

    t0 = time.perf_counter()
    sentinel = Path(__file__).resolve().parent / "build" / \
        f"chip_smoke_crash.{time.time_ns()}"
    sentinel.parent.mkdir(parents=True, exist_ok=True)
    dies = DiesOnFirstCall(stages[-1], str(sentinel))
    try:
        with sess.serve(stages=[*stages[:-1], dies], result=res,
                        spec=ServeSpec(backend="processes", max_retries=2,
                                       retry_backoff=0.01)) as eng:
            stats = eng.run_trace(sess.make_trace(32, 40.0, seed=7))
            restarts = eng.worker_restarts
    finally:
        crashed = sentinel.exists()
        sentinel.unlink(missing_ok=True)
    s = stats.summary()
    emit({"phase": "session_processes_crash", "chain": chain,
          "queries": 32, "qps": 40.0, "crashed": crashed,
          "worker_restarts": restarts, "retries": s["retries"],
          "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
          "completed": s["completed"], "failed": s["failed"],
          "batches": stats.batches,
          "launches_replacement": worker_launches(eng),
          "seconds": time.perf_counter() - t0})
    if not crashed or restarts != 1 or s["retries"] < 1 \
            or (s["completed"], s["failed"]) != (32, 0):
        raise AssertionError(f"session_processes_crash: crashed {crashed}, "
                             f"restarts {restarts}, retries "
                             f"{s['retries']}, completed {s['completed']}, "
                             f"failed {s['failed']}")
    return launches


def process_phases(chains, threads: dict) -> dict:
    """``transport``, then ``serve_processes`` (the qwen chain under
    host/device/auto, text-to-img under auto) and ``session_processes``
    on the qwen chain; ``threads``: each chain's ``serve`` summaries.
    Returns the kernels' launches summed over the workers, by phase.  The
    driver's cached device blocks are released before each pool, so the
    workers' models fit beside the driver's."""
    crossover = transport_phase()
    qwen, t2i = chains
    return {"serve_processes_chain": serve_processes(
                qwen[0], qwen[1], ("host", "device", "auto"), crossover,
                threads[qwen[0]]),
            "serve_processes_text_to_img": serve_processes(
                t2i[0], t2i[1], ("auto",), crossover, threads[t2i[0]]),
            "session_processes": session_processes_phase(*qwen, crossover)}


def serve_pipelines(fa, ms) -> tuple:
    """The two chains of the paper's services, one after the other, each
    served on the hand-built allocation (``serve``) and then through
    Camelot's loop on the same stage servers (``camelot``); at seq_len 16
    each mLSTM layer runs one chunk per batch.  Then the facade phases on
    both chains' servers, then the process backend's phases (the workers
    rebuild the servers from their pickles).  Returns each chain's kernel
    launches in the two phases, the facade phases' launches, and the
    process phases' launches (summed over their workers)."""
    from repro_torch.serving import ModelStageServer
    chains = (
        ("qwen3-0.6b->qwen1.5-0.5b", (("stage0", "qwen3-0.6b", 0),
                                      ("stage1", "qwen1.5-0.5b", 1)),
         (0, 1)),
        ("text-to-img", (("semantic-understanding", "xlstm-1.3b", 3),
                         ("image-generation", "qwen1.5-0.5b", 1)), (0,)))
    out, live, threads = [], [], {}
    for chain, specs, breakdown in chains:
        stages = [ModelStageServer(name, arch, seq_len=16, seed=seed)
                  for name, arch, seed in specs]
        kernels = [("flash_attention_bhsd", fa, layers_of(stages, "attn")),
                   ("mlstm_chunk_step", ms, layers_of(stages, "mlstm"))]
        for i in breakdown:
            emit(stage_breakdown(stages[i], batch=4))
        served, summaries = serve_chain(
            chain, stages, build_allocation(len(stages), instances=2,
                                            batch=4), kernels)
        camelot, profiles = camelot_chain(chain, stages, kernels,
                                          summaries["auto"])
        threads[chain] = summaries
        out.append((served, camelot))
        live.append((chain, stages, profiles))
    qwen_stages = live[0][1]
    facade = facade_phases(live, [
        ("flash_attention_bhsd", fa, layers_of(qwen_stages, "attn")),
        ("mlstm_chunk_step", ms, layers_of(qwen_stages, "mlstm"))])
    processes = process_phases(live, threads)
    del live, stages, qwen_stages
    gc_collect()
    return out, facade, processes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.models import Transformer, param_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(card)
    emit(card)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks_part": part, "peak_bf16_flops": peaks[0],
          "peak_bytes_per_s": peaks[1]})

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    # each kernel's name (mangled), then its registers and spills
    ptxas = [ln.split(":", 1)[-1].strip()
             for ln in _build.build_log.splitlines()
             if "Compiling entry function" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "library": lib.name,
          "ptxas": ptxas})

    worst = max(check_kernels(fa), check_bshd(fa, ops))
    worst_mlstm = check_mlstm(ms)
    worst_decode, worst_decode_row = check_decode(dec)
    timing = time_kernels(fa, ops, peaks)
    timing_mlstm = time_mlstm(ms, peaks)
    timing_decode = time_decode(dec, ops, peaks)

    # each path resets the counts just before it runs and reads them just
    # after: the full-width prefills, then the served chains (the main
    # path, whose counts are the kernels line's ``launches``)
    launches_prefill = prefill_full_width(fa, ops, Transformer, get_config)
    launches_prefill_mlstm = prefill_xlstm(ms, ops, Transformer, get_config)
    ((first, camelot_first), (second, camelot_second)), facade, processes = \
        serve_pipelines(fa, ms)
    # the decode path: the decode kernel's count from 0 before each
    # model's timed steps; the prefills before them count the others
    fa.LAUNCHES = ms.LAUNCHES = 0
    launches_decode = decode_full_width(dec, ops, Transformer, get_config)
    launches_decode_prefills = {"flash_attention_bhsd": fa.LAUNCHES,
                                "mlstm_chunk_step": ms.LAUNCHES}
    decode_consistency(Transformer, [(get_config(arch), b, s, n, {})
                                     for arch, b, s, n in CONSISTENCY_RUNS])

    # the selective scan, then jamba-v0.1-52b: its prefill is the scan
    # kernel's path (counts from 0 just before the timed prefill); its
    # decode adds to the decode kernel's
    worst_ssm = check_ssm(sm)
    timing_ssm = time_ssm(sm, part, peaks)
    model, launches_jamba = prefill_jamba(sm, fa, ops, Transformer,
                                          get_config, param_bytes)
    gen = torch.Generator(device="cuda").manual_seed(15)
    launches_decode[JAMBA] = decode_model(dec, ops, model, 2048, 32, gen,
                                          cut=JAMBA_CUT)
    del model
    gc_collect()
    # fp32, one superblock (53 GB).  Capacity factor E / k = 8 makes every
    # expert's capacity the whole batch, so the prefill drops no pair: at
    # the published 1.25 a prefill of T tokens drops the pairs past its
    # experts' capacity, which the dropless decode (as in the reference)
    # keeps, and the two paths would compute different functions
    jamba_sb = jamba_config(get_config, 8)
    moe = dataclasses.replace(jamba_sb.moe, capacity_factor=float(
        jamba_sb.moe.num_experts // jamba_sb.moe.top_k))
    decode_consistency(Transformer, [(
        dataclasses.replace(jamba_sb, moe=moe), 1, 512, 16,
        {"cut": "num_layers 32 -> 8 (1 of 4 superblocks): 53 GB in fp32",
         "capacity_factor": moe.capacity_factor})], seed=16)

    main_row = timing[0]
    attn_serve = first["flash_attention_bhsd"] \
        + second["flash_attention_bhsd"]
    # the facade phases' launches, by phase, for each kernel
    facade_by = {name: {phase: n[name] for phase, n in facade.items()}
                 for name in ("flash_attention_bhsd", "mlstm_chunk_step")}
    # the process phases' launches (counted in the workers), by phase
    processes_by = {name: {phase: n[name] for phase, n in processes.items()}
                    for name in ("flash_attention_bhsd", "mlstm_chunk_step")}
    mlstm_row = timing_mlstm[0]           # the serving shape, L = 16
    decode_row = timing_decode[0]         # qwen3-0.6b's, B 4, Sc 2080
    ssm_row = timing_ssm[0]               # jamba's chunk at B 4
    emit({"phase": "profiler", "profiles": len(LEAD_IN_LOST),
          "lead_in": PROFILE_LEAD_IN, "lead_in_lost": LEAD_IN_LOST})
    emit({"kernels": [{
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": attn_serve + camelot_first["flash_attention_bhsd"]
        + camelot_second["flash_attention_bhsd"]
        + sum(facade_by["flash_attention_bhsd"].values()),
        "launches_serve": attn_serve,
        "launches_facade": facade_by["flash_attention_bhsd"],
        "launches_processes": sum(
            processes_by["flash_attention_bhsd"].values()),
        "launches_processes_by_phase": processes_by["flash_attention_bhsd"],
        "launches_serve_chain": first["flash_attention_bhsd"],
        "launches_serve_text_to_img": second["flash_attention_bhsd"],
        "launches_camelot_chain": camelot_first["flash_attention_bhsd"],
        "launches_camelot_text_to_img":
            camelot_second["flash_attention_bhsd"],
        "launches_prefill": launches_prefill,
        "launches_jamba_prefill": launches_jamba["flash_attention_bhsd"],
        "launches_decode_path_prefills":
            launches_decode_prefills["flash_attention_bhsd"],
        "max_abs_err": worst,
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "per_shape": timing}, {
        "name": "mlstm_chunk_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:78",
        "launches": second["mlstm_chunk_step"]
        + camelot_second["mlstm_chunk_step"]
        + sum(facade_by["mlstm_chunk_step"].values()),
        "launches_serve": second["mlstm_chunk_step"],
        "launches_facade": facade_by["mlstm_chunk_step"],
        "launches_processes": sum(processes_by["mlstm_chunk_step"].values()),
        "launches_processes_by_phase": processes_by["mlstm_chunk_step"],
        "launches_serve_chain": first["mlstm_chunk_step"],
        "launches_camelot_chain": camelot_first["mlstm_chunk_step"],
        "launches_camelot_text_to_img": camelot_second["mlstm_chunk_step"],
        "launches_prefill": launches_prefill_mlstm,
        "launches_decode_path_prefills":
            launches_decode_prefills["mlstm_chunk_step"],
        "max_abs_err": worst_mlstm,
        "ms": mlstm_row["ms"], "device_ms": mlstm_row["device_ms"],
        "plain_ms": mlstm_row["plain_ms"],
        "bound_ms": mlstm_row["bound_ms"],
        "bound_by": mlstm_row["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes a chunkwise "
                        "mLSTM step",
        "per_shape": timing_mlstm}, {
        "name": "decode_attention_packed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:65",
        "launches": sum(launches_decode.values()),
        "launches_decode_by_model": launches_decode,
        "launches_serve": 0, "max_abs_err": worst_decode,
        "max_err_over_row_max": worst_decode_row,
        "ms": decode_row["ms"], "device_ms": decode_row["device_ms"],
        "plain_ms": decode_row["plain_ms"],
        "bound_ms": decode_row["bound_ms"],
        "bound_by": decode_row["bound_by"],
        "library_ms": decode_row["library_ms"],
        "library_device_ms": decode_row["library_device_ms"],
        "per_shape": timing_decode}, {
        "name": "ssm_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:39",
        "launches": launches_jamba["ssm_chunk_scan"],
        "launches_note": "timed jamba-v0.1-52b prefill, B 4, S 2048, "
                         "16 layers",
        "launches_serve": 0, "max_abs_err": worst_ssm,
        "ms": ssm_row["ms"], "device_ms": ssm_row["device_ms"],
        "plain_ms": ssm_row["plain_ms"], "bound_ms": ssm_row["bound_ms"],
        "bound_by": ssm_row["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this linear "
                        "recurrence",
        "per_shape": timing_ssm}]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
