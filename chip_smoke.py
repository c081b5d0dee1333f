"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one line per case:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels (nvcc, sm_90a) and its seconds;
  3. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes, at whisper-medium's unmasked encoder (S 1500)
     and cross-attention (Sq 16 and 1 over 1,500 keys) and at ragged/odd
     ones (max error per case;
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
     for starcoder2-3b, whisper-medium's encoder at S 1500 unmasked), the
     serving shape (S 16) and whisper-medium's serving cross-attention
     (Sq 16 over 1,500 keys), CUDA events and the
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
     profiled at S=256) and of whisper-medium (B=4, S=448 over 1,500 zero
     frames: 72 launches, 24 encoder + 24 self + 24 cross, each held to
     the plain version, argmax equal to the plain-attention run);
  6. the paper's three chains served at full width through
     ``PipelineEngine`` under each communication mechanism on a
     hand-built allocation, after one profiled call of a stage alone
     (wall time, device idle share): qwen3-0.6b -> qwen1.5-0.5b, then
     text-to-img, xlstm-1.3b -> qwen1.5-0.5b, then text-to-text,
     qwen3-0.6b -> whisper-medium, under "auto" only
     (``sim/workloads.py``); and
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
     solve, 32 queries at 20 qps for each tenant) and, beside it, the
     suite's ``two-chains`` scenario (img-to-text and text-to-text, the
     suite's own profiles, the four stage servers built by the session's
     ``serve()``), each with 32/32 completed and exact kernel launches;
     then the process backend:
     ``transport`` (the device arena's hand-off against the host-staged
     round trip on the card, 64 B to 16 MiB, the measured crossover beside
     the ``H100`` spec's modelled one), ``serve_processes`` (the ``serve``
     trace on worker processes, stage 0's two instances on logical devices
     0 and 1 and stage 1 on device 2, three workers on the one card with
     unenforced quotas: the qwen chain under host/device/auto, text-to-img
     and text-to-text under auto, the measured crossover in the comm
     model, the threads
     backend's p99/mean beside; under "device" every edge pick
     global-memory, by CUDA IPC) and ``session_processes``
     (``CamelotSession.serve(spec=ServeSpec(backend="processes"))`` on the
     qwen chain's fitted profiles, then a worker that kills itself on its
     first call: restarted, its batch replayed); 32/32 each, and each
     kernel's launches summed over the workers' exit reports equal to
     per-call launches x (batches + workers), every worker warming every
     stage once (a whisper-medium call launches the attention kernel 72
     times: once per encoder layer, twice per decoder layer);
  7. decode: the decode-attention kernel against its plain version
     (``check_decode``: G 1/2/4/12/24/48 (above 16, blocks of 16 heads
     over the same slots), hd 64/128, Sc 1 to 4096, valid from 0
     to Sc and off the tile, bf16 on the tensor-core kernel and fp32 on
     the exact one, the cache in the model's strided layout), its times
     at the decode path's shapes (``time_decode``: qwen3-0.6b,
     qwen1.5-0.5b, jamba-v0.1-52b (and phi3.5-moe-42b-a6.6b),
     chameleon-34b, qwen3-moe-30b-a3b and granite-34b (G 48) at B 4, Sc
     2080, starcoder2-3b at B 4, Sc 4096, whisper-medium's
     cross-attention at B 4 over the
     encoder's 1,500 slots, against ``scaled_dot_product_attention``,
     events and
     device time, and the kernel at other split targets), then
     ``Transformer.serve_decode`` at full width and depth in bf16 after
     each model's prefill
     (``decode``: qwen3-0.6b and qwen1.5-0.5b, B 4, prompt 2048, 32 steps;
     starcoder2-3b, B 4, prompt 4096 = its window, 64 steps through the
     full ring; xlstm-1.3b, B 4, prompt 256, 16 steps; whisper-medium, B
     4, prompt 256, 32 steps, 48 launches a step), every kernel call
     of a first run held against the plain version on its own inputs and
     a second run timed (ms per step, device idle share, launches), and
     in fp32 prefill + teacher-forced decode against the prefill of the
     whole sequence (``decode_consistency``: qwen3-0.6b, starcoder2-3b
     decoding past its window through the ring, and whisper-medium over
     random frames, its steps reading the prefill's cross cache);
  8. Mamba and jamba-v0.1-52b: the selective-scan kernel against its plain
     version (``check_ssm``: B 1/4, L 1/7/256, D 8/100/8192, ST 4/16, and
     D*ST odd or misaligned for the scalar path), its times at Jamba's
     shapes (``time_ssm``: B 4 and 1, L 256, D 8192, ST 16), then
     jamba-v0.1-52b at full width and 16 of its 32 layers in bf16
     (``jamba_memory``, ``prefill`` at B 4, S 2048 with every scan call of
     a first run held against the plain version, ``decode`` B 4, prompt
     2048, 32 steps) and in fp32 at one superblock
     (``decode_consistency``, B 1, prompt 512 + 16 steps);
  9. the rest of the zoo, one model at a time in bf16 at full width
     (``zoo_prefill``, ``decode``, ``zoo_memory``): qwen3-moe-30b-a3b,
     chameleon-34b, granite-34b at 64 of its 88 layers and
     phi3.5-moe-42b-a6.6b at 24 of its 32: a prefill at B 4, S 2048 with
     every attention call held against the plain version, a timed and a
     profiled one (wall and device ms, idle and attention's share), 8
     decode steps as in phase 7, the weight bytes and the peak memory;
     then ``examples/quickstart_torch.py --queries 4`` in a process of
     its own (``quickstart``), which must exit 0, and every other entry
     point a user calls, each in a process of its own on the card at
     full width with small counts (``entry_points``): ``python -m
     repro_torch.launch.serve --queries 8``, ``python -m
     repro_torch.launch.train --full-config --steps 3`` with a checkpoint
     this process restores onto the card, ``serve_pipeline_torch.py`` on
     threads, on processes and its diamond (8 of 8 served each), and
     ``train_small_torch.py`` for 4 steps, resumed to 6, whose last loss
     must equal a straight run's; each must exit 0;
 10. training (run after phase 4, before the main path): the
     prefill-attention backward kernel against autograd through the
     plain version (``check_attention_bwd``: dq, dk, dv in fp32 and bf16
     at the train phase's own shapes (qwen3-0.6b B 4, S 2048 and
     whisper-medium's decoder self-attention), qwen3-0.6b's at a ragged
     S, qwen1.5-0.5b's, starcoder2-3b's windowed, granite-34b's G 48,
     whisper-medium's encoder and cross shapes, and on the wgmma route
     hd 128 causal with Sq < Skv, hd 64 with a window < S and
     granite-34b's G 48 at B 1, S 2048, whose query heads the dK/dV pass
     splits over blocks, each within BWD_TOL of the largest plain
     gradient), the scan backward through ``SSMScanFn``
     against autograd through the plain scan and the plain backward, bit
     for bit (``check_ssm_bwd``: B 1 L 1 D 3 ST 5, a ragged D*ST, L 17,
     Jamba's chunk), the mLSTM backward through ``MLSTMChunkFn`` against
     both, every gradient within MLSTM_BWD_TOL (``check_mlstm_bwd``: hd
     8-1024 x L 1-256, fp32 and bf16, first, carried and padded chunks),
     their times at the
     prefill rows' shapes beside autograd through the plain version, one
     SDPA backward and the bound (``time_attention_bwd``; the scan's at
     Jamba's chunk B 4 and 1, ``time_ssm_bwd``; the mLSTM's at
     xlstm-1.3b's train chunk, device ms by pass, ``time_mlstm_bwd``),
     then ``forward_train``'s loss and every gradient at full width, two
     layers, fp32, through the kernels against the plain op
     (``train_grads``: qwen3-0.6b's attention, xlstm-1.3b's mLSTM chunk,
     jamba's scan; starcoder2-3b's window at S 4096),
     ``make_train_step`` on qwen3-0.6b at
     full width and depth, bf16, B 4, S 2048, remat on (a warm-up, 3
     timed steps, one profiled: 56 forward and 28 backward launches a
     step), on whisper-medium (B 2, S 448 over 1,500 frames, one
     step), on xlstm-1.3b at full width and depth (B 4, S 512: 2 timed
     steps and one profiled, 168 forward and 84 backward mLSTM launches a
     step), jamba's first two layers (B 1, S 2048: 32 forward and 16
     backward scan launches), starcoder2-3b at full depth (B 2, S 4096:
     60 and 30 attention launches) and qwen3-moe-30b-a3b's first 4 of 48
     layers (B 4, S 2048: 8 and 4), each step's AdamW update in place
     and its memory held to three fp32 copies of the largest leaf, and
     decode attention raising under grad
     on the card, and attention whose last rows see no key refused under
     grad (``train_guards``);
 11. the control plane's anneal on the card (``SAConfig(mode="torch")``,
     ``core/anneal_torch.py``; torch ops, no kernel of its own): every
     ``multitenant_suite`` workload solved with mode "torch" on the card
     and mode "vectorized" at iterations 400, seed 3, then one solve of a
     synthetic datacenter (``ANNEAL_SCALE``: 192 tenants, ~600 nodes, 48
     devices) in both modes (``anneal``: objective, feasibility, solve
     wall time, walk steps, device launches a step and the device's idle
     share over the walk, from one profiled solve; mode not "torch",
     feasibility unlike "vectorized"'s or an objective ratio below
     ANNEAL_MIN_RATIO fails the run), then one ``CamelotSession`` on the
     suite's img-to-img (qwen3-0.6b -> qwen1.5-0.5b, full width) solved
     with ``SolverSpec(mode="torch")`` on the card and served, 32 queries
     at 20 qps on the threads backend, all completed
     (``session_anneal``);
 12. launch, analyses and no timings on the card: ``roofline_terms`` on
     the H100 spec (``configs.H100``) for every ARCH_IDS × INPUT_SHAPES
     cell, its dominant term and bound (``roofline``), and
     ``python -m repro_torch.launch.dryrun`` for qwen3-0.6b's train_4k and
     decode_32k on the 16×16 mesh of a fake process group, each in a
     process of its own: memory per device, collective bytes, FLOPs a
     device, ``fits_hbm`` (``dryrun``);
then a ``{"kernels": [...]}`` line (``launches``: each kernel's launches
on its path, counted from 0 just before the path and read just after:
the served traces for the prefill kernels, those of the ``serve`` phases
plus the ``camelot`` phases' profiling and served trace and the facade
phases' traces and the zoo's timed prefills (each also beside it;
``launches_processes``: the process phases', counted in the workers),
the timed decode steps (the zoo's too) for the decode kernel, the timed
jamba prefill for the scan kernel, the timed qwen3-0.6b train steps for
the attention backward, the timed xlstm-1.3b steps for the mLSTM
backward, the timed jamba step for the scan backward; the other paths'
counts beside them, and
``launches_serve`` of the kernels a served trace never launches, counted
over the served phases and held to 0), the
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
import re
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
WHISPER = "whisper-medium"
QWEN_MOE = "qwen3-moe-30b-a3b"
CHAMELEON = "chameleon-34b"
GRANITE = "granite-34b"
PHI = "phi3.5-moe-42b-a6.6b"
JAMBA_LAYERS = 16
JAMBA_CUT = ("num_layers 32 -> 16 (2 of 4 superblocks): 104 GB of bf16 "
             "weights do not fit one 80 GB card")


START = time.perf_counter()


def emit(obj) -> None:
    """One output line; a phase's line carries the script's elapsed
    seconds (``t_s``), so a run shows where its time went."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
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
    # (and phi3.5-moe-42b-a6.6b's)
    (4, 2048, 2048, 32, 8, 128, True, None, torch.bfloat16),
    # the rest of the zoo's prefills: chameleon-34b 64/8, qwen3-moe-30b-a3b
    # 32/4, granite-34b's MQA 48/1
    (4, 2048, 2048, 64, 8, 128, True, None, torch.bfloat16),
    (4, 2048, 2048, 32, 4, 128, True, None, torch.bfloat16),
    (4, 2048, 2048, 48, 1, 128, True, None, torch.bfloat16),
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
    # whisper-medium, 16/16/64: the encoder (no mask, 1,500 frames, off the
    # 128-key tile), the cross-attention of the serving stage's 16 decoder
    # tokens and of one token over them
    (4, 1500, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (4, 16, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (4, 1, 1500, 16, 16, 64, False, None, torch.bfloat16),
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

# (Sq, Skv, H, KVH, hd, causal, window, the model whose prefill has this
# shape), B 4
ATTN_TIME_SHAPES = [
    (2048, 2048, 16, 8, 128, True, None, "qwen3-0.6b"),
    (2048, 2048, 16, 16, 64, True, None, "qwen1.5-0.5b"),
    (2048, 2048, 32, 8, 128, True, None, f"{JAMBA}, {PHI}"),
    (2048, 2048, 64, 8, 128, True, None, CHAMELEON),
    (2048, 2048, 32, 4, 128, True, None, QWEN_MOE),
    (2048, 2048, 48, 1, 128, True, None, GRANITE),
    (4096, 4096, 24, 2, 128, True, 4096,
     "starcoder2-3b (decode path's prefill)"),
    (16, 16, 16, 8, 128, True, None, "qwen3-0.6b (serving)"),
    (16, 16, 16, 16, 64, True, None, "qwen1.5-0.5b (serving)"),
    (1500, 1500, 16, 16, 64, False, None, "whisper-medium (encoder)"),
    (16, 1500, 16, 16, 64, False, None,
     "whisper-medium (cross, serving)"),
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
    the serving shape, S = 16, and whisper-medium's encoder and
    cross-attention, unmasked): CUDA-event ms of the kernel on the TPU
    op's (B*H, S, hd) layout and on the model's (B, S, H, hd), the
    kernel's device ms from the profiler, and the same two times of one
    ``scaled_dot_product_attention`` call on the same values."""
    import torch.nn.functional as F
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    rows = []
    for sq, skv, h, kvh, hd, causal, window, model in ATTN_TIME_SHAPES:
        iters = 20 if sq > 16 else 200       # Sq = 16 launches take ~10 us
        dt = torch.bfloat16
        q = rand(gen, (b * h, sq, hd), dt)
        k = rand(gen, (b * kvh, skv, hd), dt)
        v = rand(gen, (b * kvh, skv, hd), dt)
        kw = dict(num_heads=h, num_kv_heads=kvh, causal=causal,
                  window=window)

        def kernel():
            return fa.flash_attention_bhsd(q, k, v, **kw)
        ms = cuda_ms(kernel, iters)
        device_ms = kernel_device_ms(kernel, (ATTN_KERNEL,),
                                     10 if sq > 16 else 50)[ATTN_KERNEL]
        # the model's layout: (B, S, H, hd) tensors of the same values
        q4, k4, v4 = (t.view(b, -1, t.shape[1], hd).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        ms_bshd = cuda_ms(lambda: ops.flash_attention(
            q4, k4, v4, causal=causal, window=window), iters)
        del q4, k4, v4
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, **kw),
                           max(iters // 4, 3))
        torch.cuda.empty_cache()
        # the library on (B, H, S, hd) views; every window here spans the
        # whole sequence, so causal is the same function
        if window is not None and window < skv:
            raise AssertionError("SDPA's is_causal is not this window")
        ql, kl, vl = (t.view(b, -1, t.shape[1], hd) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=kvh != h)
        lib_ms = cuda_ms(library, iters)
        lib_device_ms, lib_kernels = library_device_ms(
            library, 10 if sq > 16 else 50)
        # work these inputs need: every unmasked (q, k) pair, QK^T and PV
        pairs = sum(min(i + 1, window or skv) for i in range(sq)) \
            if causal else sq * skv
        flops = 4 * hd * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"model": model, "h": h, "kvh": kvh, "hd": hd, "b": b,
               "sq": sq, "skv": skv, "causal": causal,
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


def prefill_whisper(fa, ops, Transformer, get_config) -> int:
    """Full-width whisper-medium in bf16, B 4: a decoder prompt of 448
    tokens (Whisper's text context) over 1,500 zero frames, as its stage
    passes them.  A first run holds every attention call (24 encoder, 24
    self, 24 cross) to the plain version under ``check_kernels``'s
    bounds; then a timed run (the count from 0 just before it), a
    profiled one, and one on the plain op (argmax, logits).  Returns the
    timed prefill's launches."""
    cfg = get_config(WHISPER)
    n_calls = prefill_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(17)
    b, s = 4, 448
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.bfloat16, seed=2)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    frames = zero_frames(cfg, b, torch.bfloat16)
    errs: dict = {}
    with torch.inference_mode():
        checked, _ = model.serve_prefill(
            tokens, frames=frames, attention=checking_attention_op(ops, errs))
        torch.cuda.synchronize()
        fa.LAUNCHES = 0                   # the timed prefill only
        t0 = time.perf_counter()
        logits, cache = model.serve_prefill(tokens, frames=frames)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = fa.LAUNCHES
        shapes = {"self_cache": list(cache.layers[0].k.shape),
                  "cross_cache": list(cache.cross[0].k.shape)}
        del cache
        device_ms, kernels = device_profile(
            lambda: model.serve_prefill(tokens, frames=frames),
            expect={ATTN_KERNEL: n_calls})
        plain, _ = model.serve_prefill(tokens, frames=frames,
                                       attention=ops.flash_attention_plain)
        torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    ids, ids_plain = logits.argmax(-1), plain.argmax(-1)
    same = bool((ids == ids_plain).all())
    rel = (logits.float() - plain.float()).abs().max().item() \
        / plain.float().abs().max().item()
    attn_ms = sum(t for name, _, t in kernels if ATTN_KERNEL in name)
    emit({"phase": "prefill", "arch": cfg.name, "b": b, "s": s,
          "encoder_frames": cfg.encoder_seq_len, "frames": "zeros",
          "dtype": "bfloat16", "layers": cfg.num_layers,
          "encoder_layers": cfg.num_encoder_layers, "init_s": init_s,
          "prefill_s": prefill_s, "launches": launches,
          "device_ms": device_ms,
          "device_idle_share": max(0.0, 1 - device_ms / (prefill_s * 1e3)),
          "device_launches": sum(n for _, n, _ in kernels),
          "attention_kernel_ms": attn_ms,
          "attention_share": attn_ms / device_ms,
          "attention_errs_vs_plain": errs,
          "checked_run_equal": bool(torch.equal(checked, logits)),
          "logits_shape": list(logits.shape), "finite": finite,
          "argmax_equal_plain": same, "max_rel_logit_diff_plain": rel,
          **shapes, "top_device_kernels": kernels[:6]})
    if logits.shape != (b, cfg.vocab_size) or not finite:
        raise AssertionError(f"{cfg.name}: bad logits")
    if launches != n_calls:
        raise AssertionError(f"{cfg.name}: {launches} attention launches, "
                             f"want {n_calls}")
    if errs.get("calls") != n_calls or not errs["worst_ratio"] <= 1 \
            or not errs["worst_row_ratio"] <= 1:
        raise AssertionError(f"{cfg.name}: an attention call of the checked "
                             f"run disagrees with the plain version: {errs}")
    if not same or not rel <= LOGIT_REL_TOL:
        raise AssertionError(f"{cfg.name}: the plain-attention run differs: "
                             f"argmax {ids.tolist()} vs "
                             f"{ids_plain.tolist()}, {rel} of max |logit|")
    del model, logits, plain, checked
    gc_collect()
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
    ring); G 24 and 48 run as two and three blocks of 16 heads over the
    same slots (granite-34b's MQA is G 48); then whisper-medium's
    cross-attention step (B 4, the encoder's 1,500 slots, 16/16/64);
    returns the largest error and the largest error over its row's max
    |ref|."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, kvh = 2, 2
    worst = (0.0, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for g in (1, 2, 4, 12, 24, 48):
            for hd in (64, 128):
                for sc in (1, 7, 100, 2080, 4096):
                    layouts = ("model", "slice") if sc == 100 \
                        else ("model",)
                    for layout in layouts:
                        err, row = _check_decode_case(
                            dec, gen, b, sc, g * kvh, kvh, hd, dtype,
                            layout)
                        worst = (max(worst[0], err), max(worst[1], row))
        err, row = _check_decode_case(dec, gen, 4, 1500, 16, 16, 64, dtype,
                                      "model")
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
                 (f"{JAMBA}, {PHI}", 32, 8, 128, 2080),
                 (CHAMELEON, 64, 8, 128, 2080),
                 (QWEN_MOE, 32, 4, 128, 2080),
                 # MQA: G 48, the kernel's three groups of 16 heads
                 (GRANITE, 48, 1, 128, 2080),
                 # the cross-attention step over the encoder's output
                 ("whisper-medium (cross)", 16, 16, 64, 1500)]


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
    """Index of the model's first attention layer (ATTN or CROSS), or
    None."""
    from repro_torch.configs import ATTN, CROSS
    return next((i for i, (kind, _) in enumerate(model.kinds)
                 if kind in (ATTN, CROSS)), None)


def decode_launches_per_step(cfg) -> int:
    """Decode-kernel launches of one ``serve_decode`` step: one per ATTN
    layer, two per CROSS layer (its self- and its cross-attention)."""
    from repro_torch.configs import ATTN, CROSS
    return (cfg.block_pattern.count(ATTN)
            + 2 * cfg.block_pattern.count(CROSS)) * cfg.num_superblocks


def prefill_launches(cfg) -> int:
    """Prefill-kernel launches of one ``serve_prefill``: those of a decode
    step and one per encoder layer."""
    return decode_launches_per_step(cfg) + (
        cfg.num_encoder_layers if cfg.encoder_decoder else 0)


def zero_frames(cfg, b: int, dtype):
    """An encoder-decoder's frames as its stage server passes them (the
    stubbed front end: zeros, (B, S_enc, d)); None for other models."""
    if not cfg.encoder_decoder:
        return None
    return torch.zeros(b, cfg.encoder_seq_len, cfg.d_model, dtype=dtype,
                       device="cuda")


def decode_model(dec, ops, model, prompt: int, steps: int, gen,
                 b: int = 4, prof_steps: int = 8, **extra) -> int:
    """``serve_decode`` of ``model`` in bf16 after its prefill: a first
    run with every decode kernel call held against the plain version, a
    timed run (the count from 0 just before its steps) and a profiled
    one of ``prof_steps`` steps; returns the decode kernel's launches in
    the timed steps.  An encoder-decoder prefills over zero frames, as
    its stage does."""
    from repro_torch.configs import ATTN, CROSS
    cfg = model.cfg
    n_dec = decode_launches_per_step(cfg)
    ai = first_attention_layer(model)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device="cuda", dtype=torch.int32)
    frames = zero_frames(cfg, b, model.dtype)
    errs: dict = {}
    with torch.inference_mode():
        # run 1: every kernel call held against the plain version
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps,
                                            frames=frames)
        _, cache, fed_checked = decode_steps(
            model, logits, cache, steps,
            decode_attention=checking_decode_op(ops, errs))
        del cache
        # run 2, timed: the counts from 0 just before the steps
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps,
                                            frames=frames)
        s_cache = cache.layers[ai].k.shape[1] if n_dec else None
        k_ptr = cache.layers[ai].k.data_ptr() if n_dec else None
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
        prof_steps = min(prof_steps, steps)
        logits, cache = model.serve_prefill(tokens, cache_len=prompt + steps,
                                            frames=frames)
        torch.cuda.synchronize()
        device_ms, kernels = device_profile(
            lambda: decode_steps(model, logits, cache, prof_steps),
            expect={DECODE_BF16[0]: n_dec * prof_steps})
        del cache
    step_ms = wall_s * 1e3 / steps
    dev_step_ms = device_ms / prof_steps
    decode_kernel_ms = sum(t for name, _, t in kernels
                           if any(k in name for k in DECODE_KERNELS))
    finite = bool(torch.isfinite(last).all())
    emit({"phase": "decode", "arch": cfg.name, **extra, "b": b,
          "prompt": prompt, "steps": steps, "layers": cfg.num_layers,
          "attention_layers": sum(kind in (ATTN, CROSS)
                                  for kind, _ in model.kinds),
          "decode_launches_per_step": n_dec, "s_cache": s_cache,
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
    if launches != n_dec * steps:
        raise AssertionError(f"{cfg.name}: {launches} decode kernel "
                             f"launches for {n_dec} a step x {steps} "
                             f"steps")
    if n_dec and errs.get("calls") != n_dec * steps:
        raise AssertionError(f"{cfg.name}: {errs.get('calls')} checked calls")
    if n_dec and not (errs["worst_ratio"] <= 1.0
                       and errs["worst_row_ratio"] <= 1.0):
        raise AssertionError(f"{cfg.name}: a decode kernel call disagrees "
                             f"with the plain version: {errs}")
    if last.shape != (b, cfg.vocab_size) or not finite or not in_place:
        raise AssertionError(f"{cfg.name}: bad decode logits or cache")
    return launches


# (model, prompt, decode steps, seed): B = 4 for each
DECODE_RUNS = [("qwen3-0.6b", 2048, 32, 0), ("qwen1.5-0.5b", 2048, 32, 1),
               ("starcoder2-3b", 4096, 64, 4), ("xlstm-1.3b", 256, 16, 3),
               ("whisper-medium", 256, 32, 2)]


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
                    ("starcoder2-3b", 1, 4092, 12),
                    # the decode steps read the cross cache the prefill made
                    ("whisper-medium", 2, 256, 16)]


def decode_consistency(Transformer, runs, seed: int = 11) -> list:
    """In fp32: prefill(S) and N teacher-forced decode steps give the last
    logits of prefill(S + N).  ``runs``: (config, batch, prompt, decode
    steps, note) each.  An encoder-decoder gets the same random frames in
    both prefills."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for cfg, b, s, n, note in runs:
        model = Transformer(cfg, device="cuda", dtype=torch.float32, seed=5)
        ai = first_attention_layer(model)
        tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=gen,
                               device="cuda", dtype=torch.int32)
        frames = None
        if cfg.encoder_decoder:
            frames = rand(gen, (b, cfg.encoder_seq_len, cfg.d_model),
                          torch.float32)
        with torch.inference_mode():
            full, full_cache = model.serve_prefill(tokens, frames=frames)
            s_cache = full_cache.layers[ai].k.shape[1]
            del full_cache
            logits, cache = model.serve_prefill(tokens[:, :s],
                                                cache_len=s + n,
                                                frames=frames)
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
        # the plain version one sequence at a time: its fp32 score matrix
        # for a whole batch of chameleon-34b's 64 heads at S 2048 (4.3 GB,
        # twice over) does not fit beside the 68.6 GB of weights
        ref = torch.cat([ops.flash_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
            window=window).float() for i in range(q.shape[0])])
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


# --------------------------------------------------------------------------
# phase 9: the rest of the model zoo, then the quickstart twin
# --------------------------------------------------------------------------

# (arch, layers served (None: all), the depth cut, seed); each B 4, a
# prompt of ZOO_PROMPT tokens and ZOO_STEPS decode steps, bf16
ZOO_RUNS = [
    (QWEN_MOE, None, None, 21),
    (CHAMELEON, None, None, 22),
    (GRANITE, 64, "num_layers 88 -> 64: 93.9 GB of bf16 weights do not "
                  "fit one 80 GB card", 23),
    (PHI, 24, "num_layers 32 -> 24: 83.7 GB of bf16 weights do not fit "
              "one 80 GB card", 24),
]
ZOO_PROMPT, ZOO_STEPS = 2048, 8


def zoo_phase(fa, dec, ops, Transformer, get_config, param_bytes) -> tuple:
    """qwen3-moe-30b-a3b, chameleon-34b, granite-34b (64 of 88 layers) and
    phi3.5-moe-42b-a6.6b (24 of 32) at full width in bf16, random weights
    from the model's seeded generator on the card, one model at a time
    (each freed before the next): a prefill at B 4, S 2048 with every
    attention call held against the plain version, a timed one (the count
    from 0 just before it) and a profiled one (device ms, attention's
    share), then ``decode_model``'s 8 steps.  Prints the weight bytes and
    the peak memory.  Returns the prefill kernel's launches in each timed
    prefill and the decode kernel's in each model's timed steps."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    b, s = 4, ZOO_PROMPT
    prefills, decodes = {}, {}
    for arch, layers, cut, seed in ZOO_RUNS:
        full = get_config(arch)
        cfg = full if layers is None \
            else dataclasses.replace(full, num_layers=layers)
        n_attn = decode_launches_per_step(cfg)
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        free, _ = torch.cuda.mem_get_info()
        need = param_bytes(cfg, torch.bfloat16)
        if need > free:
            raise AssertionError(f"{arch}: {need / 1e9} GB of parameters, "
                                 f"{free / 1e9} GB free")
        t0 = time.perf_counter()
        model = Transformer(cfg, device="cuda", dtype=torch.bfloat16,
                            seed=seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        errs: dict = {}
        with torch.inference_mode():
            # run 1: every attention call held against the plain version
            checked, cache = model.serve_prefill(
                tokens, cache_len=s + ZOO_STEPS,
                attention=checking_attention_op(ops, errs))
            del cache
            torch.cuda.synchronize()
            fa.LAUNCHES = 0               # the timed prefill only
            t0 = time.perf_counter()
            logits, cache = model.serve_prefill(tokens,
                                                cache_len=s + ZOO_STEPS)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            prefills[arch] = fa.LAUNCHES
            del cache
            device_ms, kernels = device_profile(
                lambda: model.serve_prefill(tokens, cache_len=s + ZOO_STEPS),
                expect={ATTN_KERNEL: n_attn})
        prefill_peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        attn_ms = sum(t for name, _, t in kernels if ATTN_KERNEL in name)
        emit({"phase": "zoo_prefill", "arch": arch, "cut": cut,
              "layers": cfg.num_layers,
              "published_layers": full.num_layers, "b": b, "s": s,
              "dtype": "bfloat16", "h": cfg.num_heads,
              "kvh": cfg.num_kv_heads, "hd": cfg.resolved_head_dim,
              "moe": None if cfg.moe is None else
              [cfg.moe.num_experts, cfg.moe.top_k],
              "weight_bytes": weight_bytes, "param_bytes": need,
              "full_depth_param_gb": param_bytes(full, torch.bfloat16) / 1e9,
              "init_s": init_s, "prefill_wall_ms": prefill_s * 1e3,
              "device_ms": device_ms,
              "device_idle_share": max(0.0, 1 - device_ms
                                       / (prefill_s * 1e3)),
              "device_launches": sum(n for _, n, _ in kernels),
              "attention_kernel_ms": attn_ms,
              "attention_kernel_share": attn_ms / device_ms,
              "attention_launches": prefills[arch],
              "attention_errs_vs_plain": errs,
              "checked_run_equal": bool(torch.equal(checked, logits)),
              "peak_gb": prefill_peak / 1e9, "finite": finite,
              "logits_shape": list(logits.shape),
              "top_device_kernels": kernels[:6]})
        if logits.shape != (b, cfg.vocab_size) or not finite:
            raise AssertionError(f"{arch}: bad prefill logits")
        if prefills[arch] != n_attn:
            raise AssertionError(f"{arch}: {prefills[arch]} attention "
                                 f"launches for {n_attn} layers")
        if errs.get("calls") != n_attn or not errs["worst_ratio"] <= 1 \
                or not errs["worst_row_ratio"] <= 1:
            raise AssertionError(f"{arch}: an attention call of the checked "
                                 f"run disagrees with the plain version: "
                                 f"{errs}")
        del logits, checked
        # the profile of 2 steps: qwen3-moe's ~20,000 launches a step make
        # the profiler's own work the phase's largest cost
        decodes[arch] = decode_model(dec, ops, model, s, ZOO_STEPS, gen,
                                     prof_steps=2, cut=cut)
        emit({"phase": "zoo_memory", "arch": arch,
              "weight_gb": weight_bytes / 1e9,
              "prefill_peak_gb": prefill_peak / 1e9,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card_gb": torch.cuda.get_device_properties(0).total_memory
              / 1e9})
        del model
        gc_collect()
    return prefills, decodes


def run_command(phase: str, args: list, fields=None) -> dict:
    """``python args`` in a process of its own from the repo's root, on
    the card: emits one line with the command, its return code, seconds,
    ``fields(stdout lines)`` and the tails of its stdout and stderr.  A
    nonzero exit fails the run."""
    root = Path(__file__).resolve().parent
    gc_collect()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, *args], cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=600)
    lines = proc.stdout.splitlines()
    row = {"phase": phase, "command": " ".join(["python", *args]),
           "returncode": proc.returncode,
           "seconds": time.perf_counter() - t0,
           **(fields(lines) if fields else {}),
           "stdout_tail": lines[-6:],
           "stderr_tail": proc.stderr.splitlines()[-12:]}
    emit(row)
    if proc.returncode != 0:
        raise AssertionError(f"{row['command']} exited {proc.returncode}")
    return row


def quickstart_phase() -> dict:
    """``examples/quickstart_torch.py --queries 4`` in a process of its own,
    at full width on the card (the Camelot loop through the facade on the
    text-to-text chain and the diamond, each min-resource allocation
    replayed live, then the multi-tenant solve); a nonzero exit fails the
    run."""
    row = run_command("quickstart", ["examples/quickstart_torch.py",
                                     "--queries", "4"],
                      fields=lambda lines: {"live_replays": [
                          ln.strip() for ln in lines
                          if "live replay" in ln]})
    if len(row["live_replays"]) != 2 \
            or not all(ln.endswith("completed 4")
                       for ln in row["live_replays"]):
        raise AssertionError(f"quickstart_torch.py failed: {row}")
    return row


ENTRY_QUERIES = 8


def _completed(lines) -> dict:
    return {"completed": [int(m) for ln in lines
                          for m in re.findall(r"\| completed (\d+) \|", ln)]}


def _last_loss(lines) -> dict:
    losses = [ln.split()[3] for ln in lines
              if ln.startswith("step ") and " loss " in ln]
    return {"last_loss_line": next((ln for ln in reversed(lines)
                                    if ln.startswith("step ")), None),
            "last_loss": float(losses[-1]) if losses else None}


def _check(ok: bool, row: dict, what: str) -> None:
    if not ok:
        raise AssertionError(f"{row['command']}: {what}: {row}")


def entry_points_phase(Transformer, get_config) -> dict:
    """Each entry point a user calls, in a process of its own on the card
    at full width with small counts (``run_command``): the serving
    launcher; the training launcher, whose checkpoint this process
    restores onto the card; ``serve_pipeline_torch.py`` on threads, on
    processes and its diamond; ``train_small_torch.py`` for 4 steps with
    a checkpoint every 2, resumed to 6, against a straight run of 6.
    Checkpoints go to temporary directories, removed here."""
    import tempfile
    from repro_torch.training import CheckpointManager, init_adamw
    t0 = time.perf_counter()
    q = str(ENTRY_QUERIES)
    out = {}
    row = run_command("entry_serve", ["-m", "repro_torch.launch.serve",
                                      "--queries", q],
                      fields=lambda lines: {"served": [
                          ln for ln in lines if ln.startswith("served ")]})
    _check(any(ln.startswith(f"served {q} queries") for ln in row["served"]),
           row, f"no 'served {q} queries' line")
    with tempfile.TemporaryDirectory() as d:
        row = run_command("entry_train", [
            "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
            "--full-config", "--steps", "3", "--ckpt-dir", d])
        step_dir = Path(d) / "step_00000003"
        files = sorted(f.name for f in step_dir.iterdir())
        _check("done." in row["stdout_tail"]
               and files == ["opt_state.pt", "params.pt"], row,
               f"checkpoint files {files}")
        model = Transformer(get_config("qwen3-0.6b"), device="cuda",
                            dtype=torch.bfloat16, init=False)
        like = model.state_dict()
        opt_like = init_adamw(dict(model.named_parameters()))
        params, opt = CheckpointManager(d).restore(3, like, opt_like)
        pairs = [(params[k], like[k]) for k in like] + [
            (t[k], ref[k]) for t, ref in ((opt.mu, opt_like.mu),
                                          (opt.nu, opt_like.nu))
            for k in ref]
        bad = [tuple(t.shape) for t, ref in pairs
               if t.shape != ref.shape or t.dtype != ref.dtype
               or t.device != ref.device
               or not bool(torch.isfinite(t).all())]
        restored = {"phase": "entry_train_restore", "step": opt.step,
                    "leaves": len(pairs), "bad_leaves": bad,
                    "gb": sum(t.numel() * t.element_size()
                              for t, _ in pairs) / 1e9,
                    "device": str(pairs[0][0].device)}
        emit(restored)
        _check(not bad and opt.step == 3, row, f"restore {restored}")
        del model, like, opt_like, params, opt, pairs
        gc_collect()
    for flags in (["--backend", "threads"], ["--backend", "processes"],
                  ["--dag"]):
        row = run_command("entry_serve_pipeline", [
            "examples/serve_pipeline_torch.py", "--queries", q, *flags],
            fields=_completed)
        want = 1 if "--dag" in flags else 3        # host, device, auto
        _check(row["completed"] == [ENTRY_QUERIES] * want, row,
               f"completed {row['completed']}")
    with tempfile.TemporaryDirectory() as d:
        d1, d2 = str(Path(d) / "resumed"), str(Path(d) / "straight")
        small = "examples/train_small_torch.py"
        run_command("entry_train_small", [small, "--steps", "4",
                                          "--ckpt-every", "2",
                                          "--ckpt-dir", d1],
                    fields=_last_loss)
        resumed = run_command(
            "entry_train_small", [small, "--steps", "6", "--resume",
                                  "--ckpt-dir", d1],
            fields=lambda lines: {**_last_loss(lines), "resumed": [
                ln for ln in lines if ln.startswith("resumed from")]})
        _check(resumed["resumed"] == ["resumed from step 4"], resumed,
               "no 'resumed from step 4'")
        straight = run_command("entry_train_small", [
            small, "--steps", "6", "--ckpt-dir", d2], fields=_last_loss)
        a, b = resumed["last_loss"], straight["last_loss"]
        # the two runs' final parameters, against what the resumed run's
        # two steps moved them from its checkpoint of step 4: a resume
        # that lost the moments, the step count or the data's position
        # is off by O(1) of that movement
        p4, p1, p2 = (torch.load(Path(x) / f"step_{n:08d}" / "params.pt",
                                 weights_only=True)["leaves"]
                      for x, n in ((d1, 4), (d1, 6), (d2, 6)))
        diff, moved = (math.sqrt(sum(float((x.float() - y.float()).square()
                                           .sum()) for x, y in zip(u, v)))
                       for u, v in ((p1, p2), (p2, p4)))
        out["resume"] = {"phase": "entry_train_small_resume",
                         "resumed_last_loss": a, "straight_last_loss": b,
                         "rel_diff": abs(a - b) / abs(b),
                         "tol": TRAIN_LOSS_REL_TOL,
                         "params_rel_diff": diff / moved,
                         "params_tol": TRAIN_GRAD_REL_TOL,
                         "params_bit_equal": all(
                             torch.equal(x, y) for x, y in zip(p1, p2))}
        emit(out["resume"])
        _check(out["resume"]["rel_diff"] <= TRAIN_LOSS_REL_TOL, resumed,
               f"last loss {a} against the straight run's {b}")
        _check(moved > 0 and diff / moved <= TRAIN_GRAD_REL_TOL, resumed,
               f"final parameters {diff} apart, {moved} moved")
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "entry_points", "seconds": out["seconds"]})
    return out


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


def _device_kernels(prof) -> tuple:
    """The lead-in kernels recorded and ``device_profile``'s result
    (without host ops), summed by name straight from the profiler's
    kineto records: building its per-event objects for ``key_averages``
    takes minutes on a step of ~10^6 records (xlstm-1.3b's training
    step), this seconds."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    raw = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        n, ns = raw.get(e.name(), (0, 0))
        raw[e.name()] = (n + 1, ns + e.duration_ns())
    agg = {}                 # by the names key_averages gives (demangled)
    for name, (n, ns) in raw.items():
        key = _rewrite_name(name, with_wildcard=True)
        n0, ns0 = agg.get(key, (0, 0))
        agg[key] = (n0 + n, ns0 + ns)
    lead_in = sum(n for key, (n, _) in agg.items() if LEAD_IN_KERNEL in key)
    kernels = sorted(([key, n, ns / 1e6] for key, (n, ns) in agg.items()
                      if LEAD_IN_KERNEL not in key),
                     key=lambda r: r[2], reverse=True)
    return lead_in, (sum(ms for _, _, ms in kernels), kernels)


def _profile_once(fn, host_ops: bool):
    """One profile of ``fn`` after the lead-in: the lead-in kernels
    recorded, then ``device_profile``'s result.  The device rows come from
    the kineto records (``_device_kernels``); ``key_averages`` is built
    only for the host ops' top rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    lead_in, (device_ms, kernels) = _device_kernels(prof)
    if not host_ops:
        return lead_in, (device_ms, kernels)
    top = sorted((e for e in prof.key_averages()
                  if e.device_type != DeviceType.CUDA),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
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


def launches_per_call(stages, kind: str) -> int:
    """Launches of ``kind``'s kernel in one call of every stage at seq_len
    16: the attention kernel once per ATTN layer, twice per CROSS layer
    and once per encoder layer (``prefill_launches``); the mLSTM kernel
    once per MLSTM layer (one chunk)."""
    if kind == "attn":
        return sum(prefill_launches(st.cfg) for st in stages)
    return sum(st.cfg.block_pattern.count(kind) * st.cfg.num_superblocks
               for st in stages)


# ---------------------------------------------------------------------------
# the facade: CamelotSession / MultiServiceSession on the live stage servers
# ---------------------------------------------------------------------------

FACADE_SA_ITERATIONS = 1200
# each kernel of the served chains and the block kind that launches it
KERNEL_KINDS = (("flash_attention_bhsd", "attn"),
                ("mlstm_chunk_step", "mlstm"))
# the kernels a served trace never launches (it prefills under
# ``torch.inference_mode``): counted all the same, in the driver and in the
# workers, and held to 0
SERVE_NONE = ("flash_attention_bwd", "decode_attention_packed",
              "ssm_chunk_scan", "mlstm_chunk_bwd", "ssm_chunk_scan_bwd")
WORKER_KERNELS = tuple(name for name, _ in KERNEL_KINDS) + SERVE_NONE


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
        name: sum(launches_per_call([st], kind) * (c + 1)
                  for st, c in zip(stages, calls))
        for name, kind in KERNEL_KINDS
        if name in launches})
    return launches


def multi_session_phase(chains, kernels) -> dict:
    """``MultiServiceSession`` over both chains on one H100, each from its
    live-fitted profiles, served on their live servers
    (``serve_tenants``).  Returns the traces' launches."""
    from repro_torch.camelot import (ClusterSpec, MultiServiceSession,
                                     QoSSpec, TenantSpec)
    from repro_torch.core import H100
    t_phase = time.perf_counter()
    sess = MultiServiceSession(
        [TenantSpec(served_spec(chain, stages, profiles),
                    QoSSpec(latency_target=1.0))
         for chain, stages, profiles in chains],
        ClusterSpec(device=H100, devices=1), batch=4, name="paper-chains")
    sess.profile()
    return serve_tenants(sess, [stages for _, stages, _ in chains], kernels,
                         t_phase)


def two_chains_phase(kernels) -> dict:
    """``MultiServiceSession`` over the suite's ``two-chains`` scenario
    (``multitenant_suite``: img-to-text, qwen1.5-0.5b -> xlstm-1.3b, and
    text-to-text, qwen3-0.6b -> whisper-medium), its own profiles sized
    for the H100 and its own QoS targets; ``serve()`` builds the four
    stage servers itself, at full width on the card (``serve_tenants``).
    Returns the traces' launches."""
    from repro_torch.camelot import ClusterSpec, MultiServiceSession
    from repro_torch.core import H100
    from repro_torch.sim import multitenant_suite
    t_phase = time.perf_counter()
    sess = MultiServiceSession(multitenant_suite(H100)["two-chains"],
                               ClusterSpec(device=H100, devices=1), batch=4,
                               name="two-chains")
    sess.profile()
    launches = serve_tenants(sess, None, kernels, t_phase)
    gc_collect()
    return launches


def serve_tenants(sess, tenant_stages, kernels, t_phase: float) -> dict:
    """One joint ``solve("max-peak")`` of ``sess`` on one card,
    ``simulate`` at 20 qps a tenant, then ``serve(tenant_stages=...)``
    (None: the session builds the servers) with ``make_traces(32, 20 qps
    each, seed=7)`` on the shared pool: every query of every tenant
    completes, and each kernel launches exactly its per-call count per
    batch and warm-up.  Prints a ``multi_session`` line; returns the
    traces' launches."""
    from repro_torch.camelot import SAConfig
    t0 = time.perf_counter()
    res = sess.solve("max-peak", sa=SAConfig(
        iterations=FACADE_SA_ITERATIONS, seed=0))
    solve_s = time.perf_counter() - t0
    scenario = sess.spec.name
    if not res.feasible:
        raise AssertionError(f"multi_session {scenario}: no feasible joint "
                             "solve")
    on_one_card(f"multi_session {scenario}", res.allocation)
    qps = [20.0] * sess.n_tenants
    sim = sess.simulate(qps)
    t0 = time.perf_counter()
    eng = sess.serve(tenant_stages=tenant_stages)
    serve_s = time.perf_counter() - t0
    served = [t.stages for t in eng.tenants]
    traces = sess.make_traces(32, qps, seed=7)
    counts = zero_counts(kernels)
    stats = eng.run_traces(traces)
    launches = counts()
    rows = []
    for g, target, stages, st, sm, part in zip(
            sess.graphs, sess.qos_targets, served, stats, sim.per_tenant,
            sess.split()):
        s = st.summary()
        rows.append({"chain": g.name,
                     "archs": [x.cfg.name for x in stages],
                     "qos_target_s": target,
                     "stages": alloc_row(part),
                     "simulated": {"p99_ms": sm.p99 * 1e3,
                                   "mean_ms": sm.mean_latency * 1e3},
                     "measured": {"p99_ms": s["p99"] * 1e3,
                                  "mean_ms": s["mean"] * 1e3,
                                  "completed": s["completed"],
                                  "failed": s["failed"]},
                     "batches": st.batches})
    emit({"phase": "multi_session", "scenario": scenario, "queries": 32,
          "qps": qps, "stage_servers": "built by serve()"
          if tenant_stages is None else "the chains' live servers",
          "serve_s": serve_s,
          "solve": {"predicted_lambda": res.objective, "wall_s": solve_s},
          "tenants": rows, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    for g, st in zip(sess.graphs, stats):
        check_served(f"multi_session {g.name}", st.summary(), 32)
    check_launches(f"multi_session {scenario}", launches, {
        name: sum(launches_per_call(stages, kind) * (st.batches + 1)
                  for stages, st in zip(served, stats))
        for name, kind in KERNEL_KINDS})
    return launches


def facade_phases(chains, kernels) -> dict:
    """The facade phases; ``chains``: (name, live stage servers, fitted
    profiles) of the qwen chain, then text-to-img (the two chains of
    ``multi_session``).  Then the suite's ``two-chains`` scenario on
    stage servers its session builds."""
    qwen = chains[0]
    return {"session": session_phase(*qwen, kernels),
            "session_faults": session_faults_phase(*qwen, kernels),
            "multi_session": multi_session_phase(chains[:2], kernels),
            "multi_session_two_chains": two_chains_phase(kernels)}


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
            for name in WORKER_KERNELS}


def check_worker_launches(phase: str, stages, eng, batches: int) -> dict:
    """Every worker warms every stage once, and each batch passes every
    stage once: per call x (batches + workers) launches of each kernel,
    and none of the kernels a served trace never launches."""
    launches = worker_launches(eng)
    workers = len(eng.worker_reports)
    check_launches(phase, launches,
                   {**{name: launches_per_call(stages, kind)
                       * (batches + workers)
                       for name, kind in KERNEL_KINDS},
                    **{name: 0 for name in SERVE_NONE}})
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
    total = {name: 0 for name in WORKER_KERNELS}
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
    host/device/auto, text-to-img and text-to-text under auto) and
    ``session_processes`` on the qwen chain; ``threads``: each chain's
    ``serve`` summaries.  Returns the kernels' launches summed over the
    workers, by phase.  The driver's cached device blocks are released
    before each pool, so the workers' models fit beside the driver's."""
    crossover = transport_phase()
    qwen, t2i, t2t = chains
    return {"serve_processes_chain": serve_processes(
                qwen[0], qwen[1], ("host", "device", "auto"), crossover,
                threads[qwen[0]]),
            "serve_processes_text_to_img": serve_processes(
                t2i[0], t2i[1], ("auto",), crossover, threads[t2i[0]]),
            "serve_processes_text_to_text": serve_processes(
                t2t[0], t2t[1], ("auto",), crossover, threads[t2t[0]]),
            "session_processes": session_processes_phase(*qwen, crossover)}


def serve_pipelines(fa, ms) -> tuple:
    """The three chains of the paper's services, one after the other, each
    served on the hand-built allocation (``serve``; text-to-text under
    "auto" only) and then through Camelot's loop on the same stage
    servers (``camelot``); at seq_len 16 each mLSTM layer runs one chunk
    per batch, and the whisper-medium stage its encoder over 1,500 zero
    frames.  Then the facade phases, then the process backend's phases
    (the workers rebuild the servers from their pickles).  Returns each
    chain's kernel launches in the two phases, the facade phases'
    launches, and the process phases' launches (summed over their
    workers)."""
    from repro_torch.serving import ModelStageServer
    every = ("host", "device", "auto")
    chains = (
        ("qwen3-0.6b->qwen1.5-0.5b", (("stage0", "qwen3-0.6b", 0),
                                      ("stage1", "qwen1.5-0.5b", 1)),
         (0, 1), every),
        ("text-to-img", (("semantic-understanding", "xlstm-1.3b", 3),
                         ("image-generation", "qwen1.5-0.5b", 1)), (0,),
         every),
        ("text-to-text", (("text-summarization", "qwen3-0.6b", 0),
                          ("text-translation", WHISPER, 2)), (1,),
         ("auto",)))
    out, live, threads = [], [], {}
    for chain, specs, breakdown, mechanisms in chains:
        stages = [ModelStageServer(name, arch, seq_len=16, seed=seed)
                  for name, arch, seed in specs]
        kernels = [("flash_attention_bhsd", fa,
                    launches_per_call(stages, "attn")),
                   ("mlstm_chunk_step", ms,
                    launches_per_call(stages, "mlstm"))]
        for i in breakdown:
            emit(stage_breakdown(stages[i], batch=4))
        served, summaries = serve_chain(
            chain, stages, build_allocation(len(stages), instances=2,
                                            batch=4), kernels, mechanisms)
        camelot, profiles = camelot_chain(chain, stages, kernels,
                                          summaries["auto"])
        threads[chain] = summaries
        out.append((served, camelot))
        live.append((chain, stages, profiles))
    qwen_stages = live[0][1]
    facade = facade_phases(live, [
        ("flash_attention_bhsd", fa, launches_per_call(qwen_stages, "attn")),
        ("mlstm_chunk_step", ms, launches_per_call(qwen_stages, "mlstm"))])
    processes = process_phases(live, threads)
    del live, stages, qwen_stages
    gc_collect()
    return out, facade, processes


# --------------------------------------------------------------------------
# phase 11: the anneal on the card (SAConfig(mode="torch"))
# --------------------------------------------------------------------------

# the reference's contract for its jitted walk (tests/test_solver_scale.py:
# mode "jax" within 2% of "vectorized" on every suite workload)
ANNEAL_MIN_RATIO = 0.98
ANNEAL_SA = {"iterations": 400, "seed": 3}
# the datacenter solve: 192 tenants (598 nodes) on 48 devices, where the
# vectorized walk takes ~20 s on one host core; the default SA budget
ANNEAL_SCALE = {"tenants": 192, "devices": 48, "iterations": 2000,
                "seed": 3}


def _anneal_solve(ts, pred, device, n_devices: int, mode: str, sa: dict,
                  profile: bool = False):
    """One max-load solve in ``mode`` (its walk on the card for "torch"):
    (result, wall seconds, the walk's counts, the profiled walk's device
    kernels and busy ms or None)."""
    from repro_torch.core import anneal_torch
    from repro_torch.core.allocator import MultiTenantAllocator, SAConfig
    alloc = MultiTenantAllocator(ts, pred, device, n_devices,
                                 sa=SAConfig(mode=mode, device="cuda", **sa))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alloc.solve_max_load(4)
    wall = time.perf_counter() - t0
    walk = dict(anneal_torch.LAST_WALK) if mode == "torch" else None
    prof = None
    if profile:
        box = {}

        def solve():
            box["res"] = MultiTenantAllocator(
                ts, pred, device, n_devices,
                sa=SAConfig(mode=mode, device="cuda", **sa)).solve_max_load(4)
        _, (busy_ms, kernels) = _profile_once(solve, host_ops=False)
        launches = sum(n for name, n, _ in kernels
                       if "Memcpy" not in name and "Memset" not in name)
        prof = {"launches": launches, "busy_ms": busy_ms,
                "walk_s": anneal_torch.LAST_WALK["walk_s"],
                "steps": anneal_torch.LAST_WALK["steps"],
                "objective": box["res"].objective}
    return res, wall, walk, prof


def _anneal_row(name, out: dict) -> dict:
    tr, vec = out["torch"], out["vectorized"]
    ratio = tr["objective"] / vec["objective"] if vec["objective"] else None
    row = {"workload": name, "torch": tr, "vectorized": vec,
           "objective_ratio": ratio}
    if tr["mode"] != "torch":
        raise AssertionError(f"anneal {name}: mode {tr['mode']!r} ran")
    if tr["feasible"] != vec["feasible"]:
        raise AssertionError(f"anneal {name}: feasibility differs {row}")
    if ratio is not None and ratio < ANNEAL_MIN_RATIO:
        raise AssertionError(f"anneal {name}: objective ratio {ratio}")
    return row


def anneal_phase() -> dict:
    """Mode "torch" on the card against mode "vectorized": every suite
    workload at the reference test's budget, then the datacenter solve,
    profiled once (launches a step, the walk's idle share)."""
    from repro_torch.core.predictor import PipelinePredictor
    from repro_torch.core.types import H100, RTX_2080TI, TenantSet
    from repro_torch.sim.workloads import (multitenant_suite,
                                           synthetic_predictor,
                                           synthetic_tenant_set)
    t_phase = time.perf_counter()
    rows = []

    def side(res, wall, walk):
        return {"mode": res.mode, "feasible": res.feasible,
                "objective": res.objective, "solve_s": wall,
                "walk": walk}
    for name, tenants in multitenant_suite().items():
        ts = TenantSet(tenants)
        pred = PipelinePredictor.from_graph(ts.union_graph, RTX_2080TI,
                                            seed=0)
        out = {mode: side(*_anneal_solve(ts, pred, RTX_2080TI, 4, mode,
                                         ANNEAL_SA)[:3])
               for mode in ("torch", "vectorized")}
        rows.append(_anneal_row(name, out))
    sc = ANNEAL_SCALE
    ts = synthetic_tenant_set(sc["tenants"], H100, seed=0)
    pred = synthetic_predictor(ts, H100, seed=0)
    sa = {"iterations": sc["iterations"], "seed": sc["seed"]}
    res, wall, walk, prof = _anneal_solve(ts, pred, H100, sc["devices"],
                                          "torch", sa, profile=True)
    out = {"torch": side(res, wall, walk),
           "vectorized": side(*_anneal_solve(ts, pred, H100, sc["devices"],
                                             "vectorized", sa)[:3])}
    row = _anneal_row(f"synthetic-{sc['tenants']}", out)
    row.update(nodes=ts.n_nodes, devices=sc["devices"],
               launches_per_step=prof["launches"] / prof["steps"],
               profiled={**prof, "idle_share": 1.0 - prof["busy_ms"]
                         / (prof["walk_s"] * 1e3)})
    rows.append(row)
    emit({"phase": "anneal", "sa": ANNEAL_SA, "scale": sc, "rows": rows,
          "seconds": time.perf_counter() - t_phase})
    return {"rows": rows}


def session_anneal_phase() -> dict:
    """``CamelotSession`` on the suite's img-to-img, solved with
    ``SolverSpec(mode="torch")`` (the walk on the card), then served on
    the threads backend at full width: 32 queries at 20 qps, all
    completed."""
    from repro_torch.camelot import CamelotSession, ClusterSpec, SolverSpec
    from repro_torch.core import H100
    from repro_torch.sim import camelot_suite
    t_phase = time.perf_counter()
    sess = CamelotSession(camelot_suite(H100)["img-to-img"],
                          ClusterSpec(device=H100, devices=1), batch=4)
    sess.profile()
    t0 = time.perf_counter()
    res = sess.solve("max-peak", solver=SolverSpec(
        mode="torch", iterations=FACADE_SA_ITERATIONS, seed=0))
    solve_s = time.perf_counter() - t0
    if res.mode != "torch" or not res.feasible:
        raise AssertionError(f"session_anneal: mode {res.mode}, feasible "
                             f"{res.feasible}")
    on_one_card("session_anneal solve", res.allocation)
    eng = sess.serve()
    stats = eng.run_trace(sess.make_trace(32, 20.0, seed=7))
    s = stats.summary()
    emit({"phase": "session_anneal", "service": "img-to-img",
          "solve": {"mode": res.mode, "predicted_peak_qps": res.objective,
                    "wall_s": solve_s, "stages": alloc_row(res.allocation)},
          "queries": 32, "qps": 20.0,
          "measured": {"p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
                       "completed": s["completed"], "failed": s["failed"]},
          "seconds": time.perf_counter() - t_phase})
    check_served("session_anneal", s, 32)
    del eng, sess
    gc_collect()
    return s


# --------------------------------------------------------------------------
# phase 12: launch (roofline on the H100 spec, the dry run)
# --------------------------------------------------------------------------

DRYRUN_SHAPES = ("train_4k", "decode_32k")


def launch_phase() -> dict:
    """The roofline of every (arch, shape) cell on the H100 spec, and the
    dry run of qwen3-0.6b's DRYRUN_SHAPES on the 16×16 mesh of a fake
    process group, each in a process of its own (the fake group never
    shares a process with the card's work).  Analyses: nothing here is
    timed on the card."""
    import tempfile
    from repro_torch.configs import ARCH_IDS, H100, INPUT_SHAPES, get_config
    from repro_torch.launch.roofline import analytic_costs, roofline_terms
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", shape, "--out", out_dir], cwd=root,
        env={**os.environ, "PYTHONPATH": str(SRC)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for shape in DRYRUN_SHAPES}
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shp in INPUT_SHAPES.items():
            # the production mesh: 256 chips, inference weights re-read by
            # each of the 16 data-parallel replica groups; collectives are
            # the dry run's, here left out (0)
            a = analytic_costs(cfg, shp, weight_replicas=16
                               if shp.kind != "train" else 1)
            t = roofline_terms(a, 0.0, 256, H100)
            cells.append([arch, name, t["dominant"], t["bound_s"]])
    emit({"phase": "roofline", "hw": dataclasses.asdict(H100), "chips": 256,
          "collective_bytes": 0, "cells": cells})
    records = {}
    for shape, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        path = Path(out_dir) / f"qwen3-0.6b_{shape}_pod.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        mem = rec.get("memory_per_device", {})
        coll = rec.get("collectives", {})
        row = {"phase": "dryrun", "arch": "qwen3-0.6b", "shape": shape,
               "returncode": proc.returncode, "status": rec.get("status"),
               "line": stdout.strip().splitlines()[-1:],
               "mesh": rec.get("mesh"), "chips": rec.get("chips"),
               "memory_per_device": mem,
               "collective_bytes": coll.get("total_bytes"),
               "collective_counts": coll.get("counts"),
               "flops_per_device": rec.get("cost_analysis_raw", {})
               .get("flops"),
               "roofline": rec.get("roofline"),
               "fits_hbm": rec.get("fits_hbm"),
               "fits_hbm_resident": rec.get("fits_hbm_resident"),
               "t_compile_s": rec.get("t_compile_s"),
               "error": rec.get("error"),
               "stderr_tail": stderr.splitlines()[-6:]
               if proc.returncode else []}
        emit(row)
        if proc.returncode != 0 or rec.get("status") != "ok" \
                or rec.get("chips") != 256:
            raise AssertionError(f"dryrun {shape} failed: {row}")
        records[shape] = rec
    emit({"phase": "launch", "seconds": time.perf_counter() - t_phase})
    return records


# --------------------------------------------------------------------------
# phase 10: training — the attention backward kernel, then train steps
# --------------------------------------------------------------------------

# attention backward, kernel vs autograd through the plain version, per
# gradient: max |diff| <= BWD_TOL * max |plain gradient|.  fp32: both sum
# in fp32 in other orders (~1e-6 relative).  bf16: the kernel reads the
# bf16-rounded output in D = rowsum(dO * O) and writes bf16 gradients
# (2^-9 relative each) and the forward's lse comes from the tensor-core
# kernel; the plain version runs in fp32 on the same bf16-rounded
# inputs.  A lost or doubled tile, head or mask row moves a gradient by
# O(1) of its largest value.
BWD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# (label, B, Sq, Skv, H, KVH, hd, causal, window)
ATTN_BWD_CASES = [
    # the train phase's own shapes: qwen3-0.6b's timed steps, whisper-
    # medium's decoder self-attention
    ("qwen3-0.6b, train path", 4, 2048, 2048, 16, 8, 128, True, None),
    ("whisper-medium decoder self", 2, 448, 448, 16, 16, 64, True, None),
    ("qwen3-0.6b, ragged S", 2, 1000, 1000, 16, 8, 128, True, None),
    ("qwen1.5-0.5b", 2, 777, 777, 16, 16, 64, True, None),
    ("starcoder2-3b, window < S", 1, 1200, 1200, 24, 2, 128, True, 500),
    ("granite-34b, MQA G 48", 1, 520, 520, 48, 1, 128, True, None),
    ("whisper-medium encoder", 2, 1500, 1500, 16, 16, 64, False, None),
    ("whisper-medium cross", 2, 448, 1500, 16, 16, 64, False, None),
    # the CUDA-core route in bf16 (hd < 64): window 2, causal Sq < Skv.
    # (A window of 1 leaves every softmax one key wide, so the plain dq
    # and dk are exactly 0 and a bound relative to them holds nothing;
    # 2 is the narrowest window with a nonzero dq.)
    ("hd 8, window 2", 2, 70, 70, 4, 2, 8, True, 2),
    ("hd 32, Sq < Skv", 2, 33, 77, 4, 2, 32, True, None),
    # the wgmma route at its edges: causal Sq < Skv (keys no row sees),
    # a window narrower than S at hd 64, and granite-34b's G 48 at full
    # length, where the dK/dV pass splits the query heads over blocks
    ("hd 128, causal Sq < Skv", 2, 300, 520, 16, 8, 128, True, None),
    ("hd 64, window < S", 2, 700, 700, 16, 16, 64, True, 200),
    ("granite-34b, G-split, B 1", 1, 2048, 2048, 48, 1, 128, True, None),
]
ATTN_BWD_TIME_SHAPES = [
    s for s in ATTN_TIME_SHAPES if s[0] > 16] + [
    (448, 1500, 16, 16, 64, False, None, "whisper-medium (cross, train)")]
# the train phase, kernel vs plain attention in fp32 at full width and two
# layers: the loss and each parameter's gradient, max |diff| over max
# |plain gradient| of the leaf.  Both are fp32 and differ by the
# attention's summation order (~1e-6); a wrong attention gradient moves
# the projections' gradients by O(1)
TRAIN_LOSS_REL_TOL = 1e-5
TRAIN_GRAD_REL_TOL = 1e-3


def attn_inputs(gen, b, sq, skv, h, kvh, hd, dtype):
    """q (B, Sq, H, hd), k, v (B, Skv, KVH, hd) and an upstream gradient,
    the model's layout."""
    return (rand(gen, (b, sq, h, hd), dtype), rand(gen, (b, skv, kvh, hd),
                                                     dtype),
            rand(gen, (b, skv, kvh, hd), dtype),
            rand(gen, (b, sq, h, hd), dtype))


def check_attention_bwd(fa, ops) -> float:
    """dq, dk, dv of the kernels (``ops.flash_attention`` under grad: the
    forward with lse, then the backward kernel) against autograd through
    the plain version in fp32 on the same (bf16-rounded) inputs; one
    forward and one backward launch per call.  Returns the worst max abs
    error."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    worst = 0.0
    for label, b, sq, skv, h, kvh, hd, causal, window in ATTN_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = attn_inputs(gen, b, sq, skv, h, kvh, hd, dtype)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
            out = ops.flash_attention(*leaves, causal=causal, window=window)
            got = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            launched = (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd)
            ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
            ref_out = ops.flash_attention_plain(*ref_leaves, causal=causal,
                                                window=window)
            ref = torch.autograd.grad(ref_out, ref_leaves, dout.float())
            errs, rel = {}, {}
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                if g.dtype != dtype or g.shape != r.shape:
                    raise AssertionError(f"{label}: {name} {g.dtype} "
                                         f"{tuple(g.shape)}")
                errs[name] = (g.float() - r).abs().max().item()
                rel[name] = errs[name] / max(r.abs().max().item(), 1e-30)
            line = {"phase": "check_attention_bwd", "case": label, "b": b,
                    "sq": sq, "skv": skv, "h": h, "kvh": kvh, "hd": hd,
                    "causal": causal, "window": window, "dtype": str(dtype),
                    "max_abs_err": errs, "err_over_max_grad": rel,
                    "tol_over_max_grad": BWD_TOL[dtype],
                    "launches_fwd_bwd": launched}
            emit(line)
            if launched != (1, 1):
                raise AssertionError(f"{label}: launches {launched}")
            if max(rel.values()) > BWD_TOL[dtype] or not all(
                    math.isfinite(e) for e in errs.values()):
                raise AssertionError(f"attention backward off: {line}")
            worst = max(worst, *errs.values())
            del q, k, v, dout, leaves, out, got, ref_leaves, ref_out, ref
            torch.cuda.empty_cache()
    return worst


def time_attention_bwd(fa, ops, peaks) -> list:
    """The backward kernel's times at the train path's shapes (B 4, bf16):
    CUDA-event ms of one backward (all its passes), its device ms from
    the profiler by pass, autograd through the plain version, and one
    ``scaled_dot_product_attention`` backward (cuDNN or whichever kernel
    PyTorch picks; the port never calls it), with the factor of the
    kernel's device ms over the library's.  Bound: 2.5x the forward's
    FLOPs (S again, dP, dV, dK, dQ) at the tensor cores' rate, or the
    bytes (q, k, v, out, dout and lse read, dq, dk, dv written)."""
    import torch.nn.functional as F
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(32)
    b, dt = 4, torch.bfloat16
    rows = []
    for sq, skv, h, kvh, hd, causal, window, model in ATTN_BWD_TIME_SHAPES:
        q, k, v, dout = attn_inputs(gen, b, sq, skv, h, kvh, hd, dt)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, sq, dtype=torch.float32, device="cuda")
        fa._launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   out.transpose(1, 2), causal, window, lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

        def kernel():
            fa._launch_bwd(*(t.transpose(1, 2) for t in (q, k, v, out,
                                                         dout)),
                           lse, *(t.transpose(1, 2) for t in (dq, dk, dv)),
                           causal, window)
        ms = cuda_ms(kernel, 5, warmup=1)
        splits = fa.bwd_splits(b, kvh, skv, h // kvh)
        passes = kernel_device_ms(kernel, fa.bwd_passes(hd, dt, splits), 3)
        device_ms = sum(passes.values())

        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = ops.flash_attention_plain(*leaves, causal=causal,
                                              window=window)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True), 2, warmup=1)
        del plain_out, leaves
        torch.cuda.empty_cache()

        if window is not None and window < skv:
            raise AssertionError("SDPA's is_causal is not this window")
        lib = [t.transpose(1, 2).detach().requires_grad_(True)
               for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *lib, is_causal=causal, enable_gqa=kvh != h)
        lib_dout = dout.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, lib, lib_dout,
                                       retain_graph=True)
        lib_ms = cuda_ms(library, 5, warmup=1)
        lib_device_ms, lib_kernels = library_device_ms(library, 3)
        del lib_out, lib
        pairs = sum(min(i + 1, window or skv) for i in range(sq)) \
            if causal else sq * skv
        flops = 2.5 * 4 * hd * pairs * b * h
        # q, out and dout read and dq written; k, v read and dk, dv
        # written; lse read, and the delta scratch written and read once
        nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) \
            * q.element_size() + 2 * lse.numel() * 4
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"model": model, "h": h, "kvh": kvh, "hd": hd, "b": b,
               "sq": sq, "skv": skv, "causal": causal, "window": window,
               "splits": splits,
               "ms": ms, "device_ms": device_ms, "device_ms_by_pass": passes,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_device_ms": lib_device_ms,
               "library_kernels": lib_kernels, "flops": flops,
               "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share_device"] = row["bound_ms"] / device_ms
        row["device_over_library_device"] = device_ms / lib_device_ms
        emit({"phase": "time_attention_bwd", **row})
        rows.append(row)
        del q, k, v, dout, out, lse, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phase 10: the recurrent backwards (the mLSTM chunk and the selective scan)
# --------------------------------------------------------------------------

# (B, L, D, ST): the smallest scan, a ragged D*ST (63, not a multiple of 4:
# the scalar path), L 17 (two unrolled groups and a tail), Jamba's chunk
SSM_BWD_CASES = [(1, 1, 3, 5), (2, 40, 7, 9), (2, 17, 100, 16),
                 (4, 256, 8192, 16)]
# mLSTM backward: each gradient's max |diff| over the largest |plain
# gradient| of its leaf (di and df over the larger of the two: at L 1 from
# a zero carry the chunk does not depend on f, and df is 0 in exact
# arithmetic).  fp32: kernel and plain sum in fp32 in other orders and the
# gate chain's reverse cumsum adds terms of either sign (~1e-6 relative).
# bf16: q, k, v are the same rounded values on both sides, the kernel's h
# comes from the tensor-core forward (split bf16, ~2^-16 relative) and its
# dq, dk, dv are rounded to bf16 (2^-9).  A lost tile, row block or gate
# term moves a gradient by O(1) of its largest value.
MLSTM_BWD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
MLSTM_BWD_HD = (8, 16, 64, 128, 1024)
MLSTM_BWD_L = (1, 7, 16, 17, 256)
MLSTM_BWD_STATES = ("first", "carried", "padded")
# xlstm-1.3b's train chunk (MLSTM_CHUNK steps of its 1,024-wide heads):
# the bf16 step's backward route
MLSTM_TRAIN_L, MLSTM_TRAIN_HD = 256, 1024
# the Function's gradients (m_out is not differentiable, m_in gets none)
MLSTM_GRADS = ("dq", "dk", "dv", "di", "df", "dc_in", "dn_in")


def check_ssm_bwd(sm) -> float:
    """The scan's backward kernel through ``SSMScanFn`` (one forward and
    one backward launch) against autograd through ``ssm_chunk_scan_plain``
    and against ``ssm_chunk_scan_bwd_plain`` on the same inputs: bit for
    bit.  Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    worst = 0.0
    for b, l, d, st in SSM_BWD_CASES:
        da, dbx = ssm_inputs(gen, b, l, d, st)
        dh = rand(gen, (b, l, d, st), torch.float32)
        leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
        fwd, bwd = sm.LAUNCHES, sm.BWD_LAUNCHES
        h = sm.SSMScanFn.apply(*leaves)
        got = torch.autograd.grad(h, leaves, dh)
        torch.cuda.synchronize()
        launched = (sm.LAUNCHES - fwd, sm.BWD_LAUNCHES - bwd)
        ref_leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
        ref = torch.autograd.grad(sm.ssm_chunk_scan_plain(*ref_leaves),
                                  ref_leaves, dh)
        spec = sm.ssm_chunk_scan_bwd_plain(da, h.detach(), dh)
        errs = {n: (g - r).abs().max().item()
                for n, g, r in zip(("dda", "ddbx"), got, ref)}
        equal = all(torch.equal(g, r) for g, r in zip(got, ref)) and all(
            torch.equal(g, r) for g, r in zip(got, spec))
        line = {"phase": "check_ssm_bwd", "b": b, "l": l, "d": d, "st": st,
                "vector_path": (d * st) % 4 == 0, "max_abs_err": errs,
                "bit_equal_autograd_and_plain_bwd": equal,
                "launches_fwd_bwd": launched}
        emit(line)
        if not equal or launched != (1, 1):
            raise AssertionError(f"scan backward off: {line}")
        worst = max(worst, *errs.values())
        del da, dbx, dh, leaves, h, got, ref_leaves, ref, spec
        torch.cuda.empty_cache()
    return worst


def mlstm_bwd_cases() -> list:
    """(B*H, L, hd, dtype, state): every hd x L in both dtypes, the state
    kind turning over (a padded chunk needs L > 1); xlstm-1.3b's train
    chunk at B*H 16 (B 4, H 4)."""
    cases, turn = [], 0
    for hd in MLSTM_BWD_HD:
        for l in MLSTM_BWD_L:
            for dtype in (torch.float32, torch.bfloat16):
                state = MLSTM_BWD_STATES[turn % 3]
                turn += 1
                if state == "padded" and l == 1:
                    state = "carried"
                bh = 16 if hd == 1024 and l == 256 else 4
                cases.append((bh, l, hd, dtype, state))
    return cases


def _rel_errs(got, ref) -> dict:
    """Each gradient's max |diff| over the largest |ref| of its leaf (di
    and df over the larger of the two)."""
    gate = max(ref[3].abs().max().item(), ref[4].abs().max().item())
    out = {}
    for name, g, r in zip(MLSTM_GRADS, got, ref):
        scale = gate if name in ("di", "df") else r.abs().max().item()
        diff = (g.float() - r).abs().max().item()
        out[name] = diff / scale if scale > 0 else (0.0 if diff == 0
                                                    else math.inf)
    return out


def check_mlstm_bwd(ms) -> tuple:
    """The mLSTM backward kernel through ``MLSTMChunkFn`` (one forward and
    one backward launch) against autograd through ``mlstm_chunk_plain`` in
    fp32 on the same (rounded) inputs, with dm_out = <dc_out, c_out> +
    <dn_out, n_out> (the cotangent a chain of chunks hands back), and
    against ``mlstm_chunk_bwd_plain``: every gradient within
    MLSTM_BWD_TOL (the seven of MLSTM_GRADS; m_out is not differentiable,
    so ``torch.autograd.grad`` is asked for no m_in).  Returns the worst max abs error and the worst error
    over the largest plain gradient of its leaf."""
    gen = torch.Generator(device="cuda").manual_seed(52)
    worst = worst_rel = 0.0
    for bh, l, hd, dtype, state in mlstm_bwd_cases():
        pad = min(5, l - 1) if state == "padded" else 0
        xs = mlstm_inputs(gen, bh, l, hd, dtype, pad)
        carry = mlstm_carry(ms, gen, bh, l, hd, dtype, state != "first")
        dh = rand(gen, (bh, l, hd), torch.float32)
        dc = rand(gen, (bh, hd, hd), torch.float32)
        dn = rand(gen, (bh, hd), torch.float32)
        leaves = [t.clone().requires_grad_(True) for t in (*xs, *carry)]
        fwd, bwd = ms.LAUNCHES, ms.BWD_LAUNCHES
        h, c_out, n_out, m_out = ms.MLSTMChunkFn.apply(*leaves)
        got = torch.autograd.grad((h, c_out, n_out), leaves[:7],
                                  (dh, dc, dn))
        torch.cuda.synchronize()
        launched = (ms.LAUNCHES - fwd, ms.BWD_LAUNCHES - bwd)
        ref_leaves = [t.detach().float().requires_grad_(True)
                      for t in (*xs, *carry)]
        out = ms.mlstm_chunk_plain(*ref_leaves)
        dm = (dc * out[1]).sum((1, 2)) + (dn * out[2]).sum(-1)
        ref = torch.autograd.grad(out, ref_leaves, (dh, dc, dn, dm.detach()))
        spec = ms.mlstm_chunk_bwd_plain(*xs, *carry, out[0].detach(), dh,
                                        dc, dn)
        rel = _rel_errs(got, ref)
        rel_spec = _rel_errs(got, spec)
        errs = {n: (g.float() - r).abs().max().item()
                for n, g, r in zip(MLSTM_GRADS, got, ref)}
        dtypes_ok = all(g.dtype == t.dtype and g.shape == t.shape
                        for g, t in zip(got, leaves))
        tol = MLSTM_BWD_TOL[dtype]
        line = {"phase": "check_mlstm_bwd", "bh": bh, "l": l, "hd": hd,
                "dtype": str(dtype).split(".")[-1], "state": state,
                "pad": pad, "err_over_max_grad": rel,
                "err_over_max_grad_vs_plain_bwd": rel_spec,
                "max_abs_err": errs, "tol_over_max_grad": tol,
                "launches_fwd_bwd": launched,
                "m_out_differentiable": m_out.requires_grad}
        emit(line)
        if launched != (1, 1) or not dtypes_ok or m_out.requires_grad \
                or max(rel.values()) > tol or max(rel_spec.values()) > tol \
                or not all(math.isfinite(e) for e in errs.values()):
            raise AssertionError(f"mLSTM backward off: {line}")
        worst = max(worst, *errs.values())
        worst_rel = max(worst_rel, *rel.values())
        del xs, carry, dh, dc, dn, leaves, h, c_out, n_out, m_out, got
        del ref_leaves, out, ref, spec
        torch.cuda.empty_cache()
    return worst, worst_rel


def mlstm_bwd_routes(ms) -> list:
    """One profiled bf16 backward launch at hd 64, 128 and 1024: the mLSTM
    backward kernels it ran, each once, are exactly ``bwd_passes`` names
    (the tensor-core route, none of the CUDA-core passes)."""
    gen = torch.Generator(device="cuda").manual_seed(55)
    lines = []
    for bh, l, hd in ((4, 17, 64), (4, 256, 128), (4, 256, 1024)):
        dtype = torch.bfloat16
        xs = mlstm_inputs(gen, bh, l, hd, dtype)
        carry = mlstm_carry(ms, gen, bh, l, hd, dtype, True)
        h = ms.mlstm_chunk_step(*xs, *carry)[0]
        ups = (rand(gen, (bh, l, hd), torch.float32),
               rand(gen, (bh, hd, hd), torch.float32),
               rand(gen, (bh, hd), torch.float32))
        want = ms.bwd_passes(l, hd, dtype)
        _, kernels = device_profile(
            lambda: ms.mlstm_chunk_bwd(*xs, *carry, h, *ups),
            expect=dict.fromkeys(want, 1))
        ran = {}
        for key, cnt, _ in kernels:
            for name in ms.BWD_PASSES:
                if name in key:
                    ran[name] = ran.get(name, 0) + cnt
        line = {"phase": "mlstm_bwd_route", "bh": bh, "l": l, "hd": hd,
                "dtype": "bfloat16", "ran": ran, "bwd_passes": list(want)}
        emit(line)
        if ran != dict.fromkeys(want, 1):
            raise AssertionError(f"mLSTM backward route off: {line}")
        lines.append(line)
        del xs, carry, h, ups
    return lines


def time_ssm_bwd(sm, part: str, peaks) -> list:
    """The scan backward at Jamba's chunk (L 256, D 8192, ST 16), B 4 and
    B 1: CUDA-event ms, profiler device ms, autograd through the plain
    forward, the bound.  No single PyTorch call computes this gradient:
    library none."""
    _, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(53)
    rows = []
    for b in (4, 1):
        l, d, st = 256, 8192, 16
        da, dbx = ssm_inputs(gen, b, l, d, st)
        h = sm.ssm_chunk_scan(da, dbx)
        dh = rand(gen, (b, l, d, st), torch.float32)
        t_ms = cuda_ms(lambda: sm.ssm_chunk_scan_bwd(da, h, dh), 20)
        dev_ms = kernel_device_ms(lambda: sm.ssm_chunk_scan_bwd(da, h, dh),
                                  (sm.BWD_KERNEL,), 20)[sm.BWD_KERNEL]
        leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
        out = sm.ssm_chunk_scan_plain(*leaves)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, dh, retain_graph=True), 3, 1)
        del out, leaves
        # a multiply-add and a multiply per element; da, h, dh read once,
        # d da and d dbx written once, fp32
        flops = 3 * da.numel()
        nbytes = 5 * da.numel() * 4
        t_ops, t_bytes = flops / FP32_FLOPS[part], nbytes / mem_rate
        row = {"b": b, "l": l, "d": d, "st": st, "dtype": "float32",
               "ms": t_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": None, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / t_ms
        row["bound_share_device"] = row["bound_ms"] / dev_ms
        emit({"phase": "time_ssm_bwd", **row})
        rows.append(row)
        del da, dbx, h, dh
        torch.cuda.empty_cache()
    return rows


def time_mlstm_bwd(ms, part: str, peaks) -> list:
    """The mLSTM backward at xlstm-1.3b's train chunk (B*H 16 = B 4 x H 4,
    L 256, hd 1024, a carried state) in bf16 (the bf16 steps' path) and
    fp32 (the fp32 gradients' path): CUDA-event ms, profiler device ms by
    pass, autograd through the plain forward, the bound.  No single
    PyTorch call computes this gradient: library none."""
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(54)
    bh, l, hd = 16, 256, 1024
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        xs = mlstm_inputs(gen, bh, l, hd, dtype)
        carry = mlstm_carry(ms, gen, bh, l, hd, dtype, True)
        h = ms.mlstm_chunk_step(*xs, *carry)[0]
        ups = (rand(gen, (bh, l, hd), torch.float32),
               rand(gen, (bh, hd, hd), torch.float32),
               rand(gen, (bh, hd), torch.float32))

        def kernel():
            return ms.mlstm_chunk_bwd(*xs, *carry, h, *ups)
        t_ms = cuda_ms(kernel, 10, warmup=2)
        by_pass = kernel_device_ms(kernel, ms.bwd_passes(l, hd, dtype), 5)
        dev_ms = sum(by_pass.values())
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (*xs, *carry)]
        out = ms.mlstm_chunk_plain(*leaves)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            out[:3], leaves, ups, retain_graph=True), 3, 1)
        del out, leaves
        # the work these inputs need, 2 ops a multiply-add: the four
        # L x hd x hd products (C_in r, q r^T, dC_out v, dC_out^T k) and
        # the five causal L x L x hd ones (q k^T, dh v^T, dS k, dS^T q,
        # W^T r), beside the bytes: every input read once (q, k, v, the
        # carry, h, the upstream), every gradient written once.  The
        # operations at the rate of the inputs' type, as time_mlstm's: bf16
        # q, k, v at the bf16 tensor-core rate (their route's), fp32 at
        # fp32's (the CUDA-core route's)
        pairs = l * (l + 1) // 2
        flops = 2 * bh * (4 * l * hd * hd + 5 * pairs * hd)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*xs, *carry, h, *ups))
        nbytes += sum(t.numel() * t.element_size() for t in (*xs, *carry))
        rate = flops_rate if dtype == torch.bfloat16 else FP32_FLOPS[part]
        t_ops, t_bytes = flops / rate, nbytes / mem_rate
        row = {"bh": bh, "l": l, "hd": hd, "dtype": str(dtype).split(".")[-1],
               "route": "tensor cores" if ms.bwd_passes(l, hd, dtype)
               == ms.BWD_TC else "CUDA cores",
               "ms": t_ms, "device_ms": dev_ms, "device_ms_by_pass": by_pass,
               "plain_ms": plain_ms, "library_ms": None, "flops": flops,
               "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / t_ms
        row["bound_share_device"] = row["bound_ms"] / dev_ms
        emit({"phase": "time_mlstm_bwd", **row})
        rows.append(row)
        del xs, carry, h, ups
        torch.cuda.empty_cache()
    return rows


def _finite(x) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise AssertionError(f"not finite: {x}")
    return x


@dataclasses.dataclass(frozen=True)
class TrainOp:
    """One op of the loss with a backward kernel: its ``forward_train``
    keyword, the kernel and plain versions, the module that counts its
    forward and backward launches (``LAUNCHES``, ``BWD_LAUNCHES``), and
    the kernel symbols of each (the profile must record every launch of
    ``expect``)."""
    name: str
    kernel: object
    plain: object
    mod: object
    fwd: tuple
    bwd: tuple
    expect: str


def train_ops(fa, ms, sm, ops, hd: int) -> dict:
    return {
        "attention": TrainOp("attention", ops.flash_attention,
                             ops.flash_attention_plain, fa, (ATTN_KERNEL,),
                             fa.BWD_KERNELS,
                             fa.bwd_passes(hd, torch.bfloat16)[0]),
        "mlstm": TrainOp("mlstm", ops.mlstm_chunk, ops.mlstm_chunk_plain, ms,
                         ms.KERNELS, ms.BWD_PASSES,
                         ms.bwd_passes(MLSTM_TRAIN_L, MLSTM_TRAIN_HD,
                                       torch.bfloat16)[0]),
        "ssm": TrainOp("ssm", ops.ssm_scan, ops.ssm_scan_plain, sm,
                       (sm.KERNEL,), (sm.BWD_KERNEL,), sm.BWD_KERNEL)}


def train_grads_phase(op: TrainOp, Transformer, cfg, b: int, s: int,
                      seed: int, expect: tuple) -> dict:
    """``cfg`` at full width, fp32: one ``forward_train`` and its backward
    through ``op``'s kernels and through its plain version on the same
    weights; the loss and every leaf's gradient held to the plain run,
    and the kernel run's (forward, backward) launches to ``expect``."""
    from repro_torch.training import DataConfig, batch_to, make_batch
    model = Transformer(cfg, device="cuda", dtype=torch.float32, seed=seed)
    batch = batch_to(make_batch(cfg, DataConfig(seq_len=s, global_batch=b),
                                0), "cuda")
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    model.requires_grad_(True)
    runs = {}
    for label, fn in (("kernel", op.kernel), ("plain", op.plain)):
        fwd, bwd = op.mod.LAUNCHES, op.mod.BWD_LAUNCHES
        loss = model.forward_train(batch["tokens"], batch["labels"],
                                   remat=True, **{op.name: fn})
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        runs[label] = (loss.item(), grads, (op.mod.LAUNCHES - fwd,
                                            op.mod.BWD_LAUNCHES - bwd))
        del loss
    model.requires_grad_(False)
    (lk, gk, launched), (lp, gp, plain_launched) = runs["kernel"], \
        runs["plain"]
    rel = {n: ((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
           for n, a, c in zip(names, gk, gp)}
    worst_leaf = max(rel, key=rel.get)
    line = {"phase": "train_grads", "model": cfg.name, "op": op.name,
            "layers": cfg.num_layers, "dtype": "float32", "b": b, "s": s,
            "params": sum(p.numel() for p in params), "loss_kernel": lk,
            "loss_plain": lp, "loss_rel_diff": abs(lk - lp) / abs(lp),
            "worst_leaf": worst_leaf, "worst_grad_rel_err": rel[worst_leaf],
            "grad_rel_err": rel, "tol": [TRAIN_LOSS_REL_TOL,
                                         TRAIN_GRAD_REL_TOL],
            "launches_fwd_bwd": launched,
            "launches_fwd_bwd_plain_run": plain_launched}
    emit(line)
    # remat: each layer's forward runs again in the backward
    if launched != expect or plain_launched != (0, 0):
        raise AssertionError(f"train_grads {cfg.name} launches {launched} "
                             f"{plain_launched}, expected {expect}")
    if not (line["loss_rel_diff"] <= TRAIN_LOSS_REL_TOL
            and rel[worst_leaf] <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"train_grads {cfg.name} off: {worst_leaf} "
                             f"{rel[worst_leaf]}, loss {lk} vs {lp}")
    del model, runs, gk, gp, params
    gc_collect()
    return {"launches_fwd_bwd": launched}


def measured_update(step, opt, batch, peak_bytes_s: float):
    """One ``make_train_step`` step whose AdamW update alone is measured:
    the rise of the allocator's peak over what was allocated just before
    it, its CUDA-event ms (the gradient norm included), the host's ms to
    return from it before the device is waited on, and its bound, the
    bytes the update must move (each gradient, parameter and moment read
    once, each parameter and moment written once) at the card's rate.
    Returns (opt, the measurement)."""
    from repro_torch.training import train_step as ts
    real, got = ts.adamw_update, {}

    def update(grads, state, params, cfg):
        moved = sum(p.numel() * (g.element_size() + 2 * p.element_size()
                                 + 16) for g, p in zip(grads.values(),
                                                       params.values()))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        out = real(grads, state, params, cfg)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        torch.cuda.synchronize()
        got.update({"peak_gb": (torch.cuda.max_memory_allocated()
                                - base) / 1e9,
                    "ms": ev[0].elapsed_time(ev[1]), "host_ms": host_ms,
                    "bound_ms": moved / peak_bytes_s * 1e3})
        return out
    ts.adamw_update = update
    try:
        opt, _ = step(opt, batch)
    finally:
        ts.adamw_update = real
    return opt, got


def train_steps(op: TrainOp, model, batches, steps: int, label: str,
                profile: bool, peak_bytes_s: float, expect=None,
                **fields) -> dict:
    """``make_train_step`` on ``model`` (bf16): one warm-up step, then
    ``steps`` timed ones (``op``'s kernels' launches counted from 0 just
    before them), then one more, then, with ``profile``, one profiled
    step, which must record ``expect``'s launches besides the backward's.
    The AdamW update of the warm-up step and of the one after the timed
    steps is measured alone (``measured_update``): the line gives both
    readings, the warm-up's first.  Each batch is made on the host before
    its step's clock starts; ``fields`` join the line.  Raises if the
    update's memory rose past three fp32 copies of the largest leaf in
    either reading."""
    from repro_torch.training import (AdamWConfig, init_adamw,
                                      make_train_step)
    cfg = model.cfg
    first = batches(0)
    params = list(model.parameters())
    opt = init_adamw(dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2,
                                              total_steps=100))
    opt, warm = measured_update(step, opt, first, peak_bytes_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op.mod.LAUNCHES = op.mod.BWD_LAUNCHES = 0
    per_step, walls = [], []
    for i in range(1, steps + 1):
        batch = batches(i)            # made on the host, before the clock
        t0 = time.perf_counter()
        opt, met = step(opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({"loss": _finite(met["loss"]),
                         "grad_norm": _finite(met["grad_norm"]),
                         "lr": _finite(met["lr"])})
    launches = (op.mod.LAUNCHES, op.mod.BWD_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    opt, steady = measured_update(step, opt, batches(steps + 1),
                                  peak_bytes_s)
    readings = (warm, steady)
    update = {f"update_{k}": [r[k] for r in readings]
              for k in ("ms", "host_ms")}
    update.update({
        "update_peak_gb": max(r["peak_gb"] for r in readings),
        "update_bound_ms": warm["bound_ms"],
        "update_bound_gb": 3 * 4 * max(p.numel() for p in params) / 1e9,
        # weights and their gradients in the model's dtypes, fp32 moments
        "state_gb": sum(p.numel() * (2 * p.element_size() + 8)
                        for p in params) / 1e9})
    b, s = first["tokens"].shape
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    out = {"phase": "train_step", "model": cfg.name, "op": op.name,
           "layers": cfg.num_layers, "dtype": "bfloat16", "b": b, "s": s,
           "remat": True, "params": sum(p.numel() for p in params),
           "steps": per_step, "wall_ms": [w * 1e3 for w in walls],
           "wall_ms_median": wall_ms, "tokens_per_s": b * s / wall_ms * 1e3,
           "launches_fwd_bwd": launches,
           "launches_fwd_bwd_per_step": [n / steps for n in launches],
           "peak_memory_gb": peak_gb, **update, "label": label, **fields}
    if profile:
        batch = batches(steps + 2)

        def one():
            nonlocal opt
            opt, _ = step(opt, batch)
        device_ms, kernels = device_profile(
            one, expect={op.expect: launches[1] // steps, **(expect or {})})
        bwd_ms = sum(t for key, _, t in kernels
                     if any(n in key for n in op.bwd))
        fwd_ms = sum(t for key, _, t in kernels
                     if any(n in key for n in op.fwd))
        out.update({"device_ms": device_ms,
                    "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
                    f"{op.name}_bwd_device_ms": bwd_ms,
                    f"{op.name}_fwd_device_ms": fwd_ms,
                    f"{op.name}_bwd_share": bwd_ms / device_ms,
                    "device_launches": sum(n for _, n, _ in kernels),
                    "top_device_kernels": kernels[:6]})
    emit(out)
    if update["update_peak_gb"] > update["update_bound_gb"]:
        raise AssertionError(f"{label}: the AdamW update took "
                             f"{update['update_peak_gb']} GB, past its "
                             f"bound {update['update_bound_gb']} GB")
    del opt
    return out


def guards_phase(ops) -> list:
    """(e) decode attention, which has no backward, refuses a gradient on
    the card, and so does attention whose last rows see no key."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    f32 = torch.float32
    qd = rand(gen, (1, 1, 4, 64), f32).requires_grad_(True)
    kd, vd = (rand(gen, (1, 32, 2, 64), f32) for _ in range(2))
    raised = []
    try:
        ops.decode_attention(qd, kd, vd, 32)
    except NotImplementedError as e:
        if "no backward kernel" not in str(e):
            raise
        raised.append("decode_attention")
    else:
        raise AssertionError("decode_attention returned under grad on the "
                             "card")
    with torch.no_grad():
        ops.decode_attention(qd, kd, vd, 32)   # without grad it runs
    # attention whose last rows see no key (Sq >= Skv + window): their
    # output is the mean of V, whose gradient the backward kernel does not
    # give, so a call under grad is refused
    qa = rand(gen, (1, 12, 4, 64), f32).requires_grad_(True)
    ka = rand(gen, (1, 8, 2, 64), f32)
    try:
        ops.flash_attention(qa, ka, ka, causal=True, window=4)
    except ValueError as e:
        if "no key" not in str(e):
            raise
        raised.append("flash_attention, rows with no key")
    else:
        raise AssertionError("attention with rows that see no key "
                             "returned under grad")
    torch.cuda.synchronize()
    emit({"phase": "train_guards", "raised_under_grad": raised})
    return raised


QWEN3 = "qwen3-0.6b"
XLSTM = "xlstm-1.3b"
STARCODER = "starcoder2-3b"
JAMBA_TRAIN_LAYERS = 2       # a Mamba layer with a dense MLP, one with MoE
QWEN_MOE_TRAIN_LAYERS = 4


def train_phase(fa, ms, sm, ops, Transformer, get_config,
                peak_bytes_s: float) -> dict:
    """Phase 10's training part: (a) gradients through the kernels held to
    the plain ops at full width and two layers in fp32: qwen3-0.6b
    (attention), starcoder2-3b (its window, B 1, S 4096), xlstm-1.3b (two
    mLSTM layers, B 2, S 512: two chunks a layer) and jamba-v0.1-52b (two
    Mamba layers, the second with the 16-expert MoE, B 1, S 512); (b)
    qwen3-0.6b at full width and depth, bf16, B 4, S 2048, remat: a
    warm-up and 3 timed steps, then one profiled (the attention backward's
    path: its launches are the kernels line's); (c) whisper-medium at full
    width, B 2, S 448 over 1,500 frames, one timed step and one profiled;
    (d) xlstm-1.3b at full width and depth (42 mLSTM, 6 sLSTM layers),
    bf16, B 4, S 512: 2 timed steps and one profiled (the mLSTM backward's
    path), and jamba's two layers in bf16 at B 1, S 2048: one timed step
    and one profiled (the scan backward's path); (e) starcoder2-3b at full
    width and depth, B 2, S 4096 (its window's length): 2 timed steps and
    one profiled, and qwen3-moe-30b-a3b at 4 of its 48 layers, B 4, S
    2048 (the capacity dispatch over 128 experts at T·k = 65,536): one
    timed step and one profiled; (f) the guards.  Every step, the
    warm-up's included, updates the parameters and moments in place, the
    update's memory measured against three fp32 copies of the largest
    leaf (``train_steps``)."""
    from repro_torch.configs import MLSTM
    from repro_torch.models import param_bytes
    from repro_torch.models.ssm import SSM_CHUNK
    from repro_torch.models.xlstm import MLSTM_CHUNK
    from repro_torch.training import DataConfig, make_batch
    qcfg = get_config(QWEN3)
    xcfg = get_config(XLSTM)
    scfg = get_config(STARCODER)
    jcfg = jamba_config(get_config, JAMBA_TRAIN_LAYERS)
    top = train_ops(fa, ms, sm, ops, qcfg.resolved_head_dim)
    attn, mlstm, ssm = top["attention"], top["mlstm"], top["ssm"]
    # remat: every layer's forward runs again in the backward, so a step
    # launches each forward kernel twice per layer (and chunk) and each
    # backward once
    grads = {
        QWEN3: train_grads_phase(
            attn, Transformer, dataclasses.replace(qcfg, num_layers=2), 2,
            512, 41, (4, 2)),
        STARCODER: train_grads_phase(
            attn, Transformer, dataclasses.replace(scfg, num_layers=2), 1,
            4096, 49, (4, 2)),
        XLSTM: train_grads_phase(
            mlstm, Transformer, dataclasses.replace(xcfg, num_layers=2), 2,
            512, 45, (2 * 2 * 2, 2 * 2)),
        JAMBA: train_grads_phase(
            ssm, Transformer, jcfg, 1, 512, 46, (2 * 2 * 2, 2 * 2))}

    def run(cfg, seed, b, s, steps, label, check, op=attn, **kw):
        """``train_steps`` on ``cfg`` at full width in bf16; its launches a
        step must be ``check``."""
        model = Transformer(cfg, device="cuda", dtype=torch.bfloat16,
                            seed=seed)
        d = DataConfig(seq_len=s, global_batch=b)
        out = train_steps(op, model, lambda i: make_batch(cfg, d, i), steps,
                          label, True, peak_bytes_s, **kw)
        if out["launches_fwd_bwd_per_step"] != check:
            raise AssertionError(f"{label} train launches "
                                 f"{out['launches_fwd_bwd_per_step']} != "
                                 f"{check}")
        del model
        gc_collect()
        return out

    # remat: 56 and 28
    qwen = run(qcfg, 42, 4, 2048, 3, "qwen3-0.6b full depth",
               [2 * qcfg.num_layers, qcfg.num_layers])
    # encoder, self and cross attention per layer, each run twice (remat)
    wcfg = get_config(WHISPER)
    layers = wcfg.num_encoder_layers + 2 * wcfg.num_layers
    whisper = run(wcfg, 44, 2, 448, 1, "whisper-medium",
                  [2 * layers, layers])
    n_mlstm = sum(kind == MLSTM for kind in xcfg.block_pattern) \
        * xcfg.num_layers // len(xcfg.block_pattern)
    chunks = 512 // MLSTM_CHUNK
    # 2 * 42 * 2 = 168 forward and 84 backward launches a step
    xlstm = run(xcfg, 47, 4, 512, 2, "xlstm-1.3b full depth",
                [2 * n_mlstm * chunks, n_mlstm * chunks], op=mlstm)
    chunks = 2048 // SSM_CHUNK
    jamba = run(jcfg, 48, 1, 2048, 1, "jamba-v0.1-52b, 2 layers",
                [2 * 2 * chunks, 2 * chunks], op=ssm,
                cut=f"num_layers 32 -> {JAMBA_TRAIN_LAYERS}: the first "
                    f"Mamba layer (dense MLP) and the second (16-expert "
                    f"MoE), B 1")
    # the dK/dV pass splits a KV head's query heads over blocks, whose
    # partials a reduction pass sums: its launches are the backward's
    def split(cfg, b, s):
        splits = fa.bwd_splits(b, cfg.num_kv_heads, s,
                               cfg.num_heads // cfg.num_kv_heads)
        return {"expect": {fa.REDUCE: cfg.num_layers} if splits > 1
                else None, "bwd_splits": splits}

    starcoder = run(scfg, 50, 2, 4096, 2, "starcoder2-3b full depth",
                    [2 * scfg.num_layers, scfg.num_layers],
                    **split(scfg, 2, 4096))
    mcfg = dataclasses.replace(get_config(QWEN_MOE),
                               num_layers=QWEN_MOE_TRAIN_LAYERS)
    n, full = (param_bytes(c, torch.bfloat16) / 2e9
               for c in (mcfg, get_config(QWEN_MOE)))
    moe = run(mcfg, 51, 4, 2048, 1,
              f"qwen3-moe-30b-a3b, {QWEN_MOE_TRAIN_LAYERS} layers",
              [2 * mcfg.num_layers, mcfg.num_layers], **split(mcfg, 4, 2048),
              moe_pairs=4 * 2048 * mcfg.moe.top_k,
              experts=mcfg.moe.num_experts,
              cut=f"num_layers 48 -> {QWEN_MOE_TRAIN_LAYERS}: {n:.2f} B "
                  f"parameters, whose weights, gradients and moments "
                  f"({12 * n:.1f} GB) fit the card beside the step; 48 "
                  f"layers' {full:.2f} B would take {12 * full:.0f} GB")
    return {"grads": grads, "qwen": qwen, "whisper": whisper,
            "xlstm": xlstm, "jamba": jamba, "starcoder2": starcoder,
            "qwen3_moe": moe, "guards": guards_phase(ops)}


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
    worst_bwd = check_attention_bwd(fa, ops)
    worst_ssm_bwd = check_ssm_bwd(sm)
    worst_mlstm_bwd, worst_mlstm_bwd_rel = check_mlstm_bwd(ms)
    mlstm_bwd_route = mlstm_bwd_routes(ms)
    timing = time_kernels(fa, ops, peaks)
    timing_mlstm = time_mlstm(ms, peaks)
    timing_decode = time_decode(dec, ops, peaks)
    timing_bwd = time_attention_bwd(fa, ops, peaks)
    timing_ssm_bwd = time_ssm_bwd(sm, part, peaks)
    timing_mlstm_bwd = time_mlstm_bwd(ms, part, peaks)
    # training: the backward kernels' paths (each op's counts from 0 just
    # before its model's timed steps: qwen3-0.6b for attention, xlstm-1.3b
    # for the mLSTM chunk, jamba's two Mamba layers for the scan)
    train = train_phase(fa, ms, sm, ops, Transformer, get_config, peaks[1])

    # each path resets the counts just before it runs and reads them just
    # after: the full-width prefills, then the served chains (the main
    # path, whose counts are the kernels line's ``launches``)
    launches_prefill = prefill_full_width(fa, ops, Transformer, get_config)
    launches_prefill_mlstm = prefill_xlstm(ms, ops, Transformer, get_config)
    launches_prefill_whisper = prefill_whisper(fa, ops, Transformer,
                                               get_config)
    # the kernels a served trace never launches, counted in the driver
    # over every served phase (and in the workers by their exit reports)
    fa.BWD_LAUNCHES = dec.LAUNCHES = sm.LAUNCHES = 0
    ms.BWD_LAUNCHES = sm.BWD_LAUNCHES = 0
    ((first, camelot_first), (second, camelot_second),
     (third, camelot_third)), facade, processes = serve_pipelines(fa, ms)
    serve_none = {"flash_attention_bwd": fa.BWD_LAUNCHES,
                  "decode_attention_packed": dec.LAUNCHES,
                  "ssm_chunk_scan": sm.LAUNCHES,
                  "mlstm_chunk_bwd": ms.BWD_LAUNCHES,
                  "ssm_chunk_scan_bwd": sm.BWD_LAUNCHES}
    emit({"phase": "serve_none", "launches_driver": serve_none})
    if any(serve_none.values()):
        raise AssertionError(f"served phases launched {serve_none}")
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

    # the rest of the zoo: its timed prefills count the prefill kernel
    # from 0 each, its timed decode steps the decode kernel; then the
    # quickstart twin in a process of its own
    launches_zoo_prefill, launches_zoo_decode = zoo_phase(
        fa, dec, ops, Transformer, get_config, param_bytes)
    launches_decode.update(launches_zoo_decode)
    quickstart_phase()
    entry_points_phase(Transformer, get_config)
    # the control plane's walk on the card, then launch's analyses
    anneal_phase()
    session_anneal_phase()
    launch_phase()

    main_row = timing[0]
    attn_serve = first["flash_attention_bhsd"] \
        + second["flash_attention_bhsd"] + third["flash_attention_bhsd"]
    # the facade phases' launches, by phase, for each kernel
    facade_by = {name: {phase: n[name] for phase, n in facade.items()}
                 for name in ("flash_attention_bhsd", "mlstm_chunk_step")}
    # the process phases' launches (counted in the workers), by phase
    processes_by = {name: {phase: n[name] for phase, n in processes.items()}
                    for name in WORKER_KERNELS}
    mlstm_row = timing_mlstm[0]           # the serving shape, L = 16
    decode_row = timing_decode[0]         # qwen3-0.6b's, B 4, Sc 2080
    ssm_row = timing_ssm[0]               # jamba's chunk at B 4
    bwd_row = timing_bwd[0]               # qwen3-0.6b's, B 4, S 2048
    mlstm_bwd_row = timing_mlstm_bwd[0]   # xlstm-1.3b's chunk, bf16
    ssm_bwd_row = timing_ssm_bwd[0]       # jamba's chunk at B 4
    emit({"phase": "profiler", "profiles": len(LEAD_IN_LOST),
          "lead_in": PROFILE_LEAD_IN, "lead_in_lost": LEAD_IN_LOST})
    emit({"kernels": [{
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": attn_serve + camelot_first["flash_attention_bhsd"]
        + camelot_second["flash_attention_bhsd"]
        + camelot_third["flash_attention_bhsd"]
        + sum(facade_by["flash_attention_bhsd"].values())
        + sum(launches_zoo_prefill.values()),
        "launches_serve": attn_serve,
        "launches_facade": facade_by["flash_attention_bhsd"],
        "launches_processes": sum(
            processes_by["flash_attention_bhsd"].values()),
        "launches_processes_by_phase": processes_by["flash_attention_bhsd"],
        "launches_serve_chain": first["flash_attention_bhsd"],
        "launches_serve_text_to_img": second["flash_attention_bhsd"],
        "launches_serve_text_to_text": third["flash_attention_bhsd"],
        "launches_camelot_chain": camelot_first["flash_attention_bhsd"],
        "launches_camelot_text_to_img":
            camelot_second["flash_attention_bhsd"],
        "launches_camelot_text_to_text":
            camelot_third["flash_attention_bhsd"],
        "launches_prefill": launches_prefill,
        "launches_prefill_whisper": launches_prefill_whisper,
        "launches_jamba_prefill": launches_jamba["flash_attention_bhsd"],
        "launches_zoo_prefill": launches_zoo_prefill,
        "launches_decode_path_prefills":
            launches_decode_prefills["flash_attention_bhsd"],
        "launches_train_qwen": train["qwen"]["launches_fwd_bwd"][0],
        "launches_train_whisper": train["whisper"]["launches_fwd_bwd"][0],
        "launches_train_starcoder2":
            train["starcoder2"]["launches_fwd_bwd"][0],
        "launches_train_qwen3_moe": train["qwen3_moe"]["launches_fwd_bwd"][0],
        "max_abs_err": worst,
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "per_shape": timing}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "gradient of src/repro/kernels/flash_attention.py:89 "
                    "(XLA autodiff of src/repro/models/attention.py:97 in "
                    "the reference)",
        "launches": train["qwen"]["launches_fwd_bwd"][1],
        "launches_note": "3 timed make_train_step steps of qwen3-0.6b, "
                         "full width and depth, B 4, S 2048",
        "launches_train_whisper": train["whisper"]["launches_fwd_bwd"][1],
        "launches_train_starcoder2":
            train["starcoder2"]["launches_fwd_bwd"][1],
        "launches_train_qwen3_moe": train["qwen3_moe"]["launches_fwd_bwd"][1],
        "launches_train_grads": {
            k: train["grads"][k]["launches_fwd_bwd"][1]
            for k in (QWEN3, STARCODER)},
        "launches_serve": serve_none["flash_attention_bwd"],
        "launches_processes": sum(
            processes_by["flash_attention_bwd"].values()),
        "max_abs_err": worst_bwd,
        "ms": bwd_row["ms"], "device_ms": bwd_row["device_ms"],
        "plain_ms": bwd_row["plain_ms"], "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "library_device_ms": bwd_row["library_device_ms"],
        "per_shape": timing_bwd}, {
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
        "launches_serve": serve_none["decode_attention_packed"],
        "launches_processes": sum(
            processes_by["decode_attention_packed"].values()),
        "max_abs_err": worst_decode,
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
        "launches_serve": serve_none["ssm_chunk_scan"],
        "launches_processes": sum(processes_by["ssm_chunk_scan"].values()),
        "max_abs_err": worst_ssm,
        "ms": ssm_row["ms"], "device_ms": ssm_row["device_ms"],
        "plain_ms": ssm_row["plain_ms"], "bound_ms": ssm_row["bound_ms"],
        "bound_by": ssm_row["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this linear "
                        "recurrence",
        "per_shape": timing_ssm}, {
        "name": "mlstm_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
        "replaces": "gradient of src/repro/kernels/mlstm_scan.py:78 (XLA "
                    "autodiff of src/repro/models/xlstm.py:96 in the "
                    "reference)",
        "launches": train["xlstm"]["launches_fwd_bwd"][1],
        "launches_note": "2 timed make_train_step steps of xlstm-1.3b, "
                         "full width and depth, B 4, S 512",
        "launches_train_grads": {
            XLSTM: train["grads"][XLSTM]["launches_fwd_bwd"][1]},
        "launches_serve": serve_none["mlstm_chunk_bwd"],
        "launches_processes": sum(processes_by["mlstm_chunk_bwd"].values()),
        "routes": {"tensor cores (bf16 q, k, v, hd a multiple of 64)":
                   list(ms.BWD_TC),
                   "CUDA cores (fp32; hd 8, 16)": list(ms.BWD_CC)},
        "route_checks": mlstm_bwd_route,
        "max_abs_err": worst_mlstm_bwd,
        "max_err_over_max_grad": worst_mlstm_bwd_rel,
        "tol_over_max_grad": {str(k): v for k, v in MLSTM_BWD_TOL.items()},
        "ms": mlstm_bwd_row["ms"], "device_ms": mlstm_bwd_row["device_ms"],
        "plain_ms": mlstm_bwd_row["plain_ms"],
        "bound_ms": mlstm_bwd_row["bound_ms"],
        "bound_by": mlstm_bwd_row["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this gradient",
        "per_shape": timing_mlstm_bwd}, {
        "name": "ssm_chunk_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "gradient of src/repro/kernels/ssm_scan.py:39 (XLA "
                    "autodiff of src/repro/kernels/ref.py:55 in the "
                    "reference)",
        "launches": train["jamba"]["launches_fwd_bwd"][1],
        "launches_note": "1 timed make_train_step step of jamba-v0.1-52b's "
                         "first two layers, full width, B 1, S 2048",
        "launches_train_grads": {
            JAMBA: train["grads"][JAMBA]["launches_fwd_bwd"][1]},
        "launches_serve": serve_none["ssm_chunk_scan_bwd"],
        "launches_processes": sum(
            processes_by["ssm_chunk_scan_bwd"].values()),
        "max_abs_err": worst_ssm_bwd,
        "ms": ssm_bwd_row["ms"], "device_ms": ssm_bwd_row["device_ms"],
        "plain_ms": ssm_bwd_row["plain_ms"],
        "bound_ms": ssm_bwd_row["bound_ms"],
        "bound_by": ssm_bwd_row["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this gradient",
        "per_shape": timing_ssm_bwd}]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
