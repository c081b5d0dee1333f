"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one line:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels (nvcc, sm_90a) and its seconds;
  3. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at ragged/odd ones (max error per case);
  4. kernel, plain and library (``scaled_dot_product_attention``) times at
     the path's prefill (S=2048) and serving (S=16) shapes, beside the
     bound of the card;
  5. full-width prefill of qwen3-0.6b and qwen1.5-0.5b (B=4, S=2048): finite
     logits, one kernel launch per layer, argmax equal to the same model
     with plain attention, and its device time by kernel (torch.profiler);
  6. the two-stage pipeline qwen3-0.6b -> qwen1.5-0.5b served at full width
     through ``PipelineEngine`` under each communication mechanism, after
     one profiled call of each stage alone (wall time, device idle share);
then a ``{"kernels": [...]}`` line (``launches``: the kernel launches of
the served traces alone, counted from 0 just before them; the two timed
prefills' count beside it), the ``nvidia-smi`` line again, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero without that line.  It imports nothing of
jax or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
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
ATTN_KERNEL = "flash_attention_kernel"     # the CUDA kernel's symbol


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
        out = fa.flash_attention_bhsd(q, k, v, **kw)
        ref = fa.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"shape/dtype {out.shape} {out.dtype}")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        tol = TOL[dtype]
        row_max = ref.float().abs().amax(-1, keepdim=True)
        ok_abs = bool((diff <= tol + tol * ref.float().abs()).all())
        ok_row = bool((diff <= ROW_TOL[dtype] * row_max).all())
        ok = ok_abs and ok_row
        emit({"phase": "check", "b": b, "sq": sq, "skv": skv, "h": h,
              "kvh": kvh, "hd": hd, "causal": causal, "window": window,
              "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
              "mean_abs_err": diff.mean().item(),
              "max_err_over_row_max": (diff / row_max).max().item(),
              "tol": tol, "row_tol": ROW_TOL[dtype], "ok": ok})
        if not ok or not math.isfinite(err):
            raise AssertionError(f"kernel disagrees with plain: case "
                                 f"{(b, sq, skv, h, kvh, hd, causal, window)}")
        worst = max(worst, err)
    return worst


# --------------------------------------------------------------------------
# phase 4: timing at the path's prefill shapes
# --------------------------------------------------------------------------

def time_kernels(fa, peaks) -> list:
    """Kernel, plain and library times at the path's two geometries, at
    the prefill shape (S = 2048) and the serving shape (S = 16)."""
    import torch.nn.functional as F
    flops_rate, mem_rate = peaks
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    rows = []
    for s, (h, kvh, hd) in [(s, g) for s in (2048, 16)
                            for g in ((16, 8, 128), (16, 16, 64))]:
        iters = 20 if s > 16 else 200        # S = 16 launches take ~10 us
        dt = torch.bfloat16
        q = rand(gen, (b * h, s, hd), dt)
        k = rand(gen, (b * kvh, s, hd), dt)
        v = rand(gen, (b * kvh, s, hd), dt)
        kw = dict(num_heads=h, num_kv_heads=kvh, causal=True, window=None)
        ms = cuda_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw), iters)
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, **kw),
                           iters // 4)
        q4 = q.view(b, h, s, hd)
        k4 = k.view(b, kvh, s, hd)
        v4 = v.view(b, kvh, s, hd)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=kvh != h), iters)
        # work these inputs need: every unmasked (q, k) pair, QK^T and PV
        pairs = s * (s + 1) // 2
        flops = 4 * hd * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / flops_rate, nbytes / mem_rate
        row = {"h": h, "kvh": kvh, "hd": hd, "b": b, "s": s,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        row["bound_share"] = row["bound_ms"] / ms
        emit({"phase": "time", **row})
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
                lambda: model.serve_prefill(tokens))
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


def device_profile(fn, host_ops: bool = False):
    """Run ``fn`` once under torch.profiler: the device's busy ms and the
    device kernels (and copies) as [name, launches, ms], longest first
    (with ``host_ops``, also the host's top ops as [name, calls, self ms]).
    Only the device's own events are summed: a host op's row repeats the
    device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation),
                 key=lambda e: e.self_device_time_total, reverse=True)
    kernels = [[e.key, e.count, e.self_device_time_total / 1e3] for e in dev]
    device_ms = sum(ms for _, _, ms in kernels)
    if not host_ops:
        return device_ms, kernels
    top = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    return device_ms, kernels, [[e.key, e.count, e.self_cpu_time_total / 1e3]
                                for e in top[:6]]


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


def serve_pipeline(fa) -> int:
    """Returns the kernel launches of the three served traces, counted
    from 0 just before the first and read just after the last."""
    from repro_torch.serving import ModelStageServer, PipelineEngine, \
        make_trace
    stages = [ModelStageServer("stage0", "qwen3-0.6b", seq_len=16, seed=0),
              ModelStageServer("stage1", "qwen1.5-0.5b", seq_len=16, seed=1)]
    per_batch = sum(st.cfg.num_layers for st in stages)
    alloc = build_allocation(len(stages), instances=2, batch=4)
    for st in stages:
        emit(stage_breakdown(st, batch=4))
    fa.LAUNCHES = 0                       # the served traces only
    for mech in ("host", "device", "auto"):
        trace = make_trace(32, qps=40.0, seq_len=16,
                           vocab=stages[0].cfg.vocab_size, seed=7)
        before = fa.LAUNCHES
        busy = [(st.busy_time, st.calls) for st in stages]
        with PipelineEngine(stages, comm_mechanism=mech, qos_target=1.0,
                            batch_timeout=0.05, allocation=alloc) as eng:
            stats = eng.run_trace(trace)
        launches = fa.LAUNCHES - before
        stage_ms = [(st.busy_time - b) / max(st.calls - c, 1) * 1e3
                    for st, (b, c) in zip(stages, busy)]
        s = stats.summary()
        emit({"phase": "serve", "mechanism": mech, "queries": 32,
              "qps": 40.0, "batch": 4, "stage0_instances": 2,
              "p99_ms": s["p99"] * 1e3, "mean_ms": s["mean"] * 1e3,
              "completed": s["completed"], "failed": s["failed"],
              "batches": stats.batches, "comm_share": s["comm_frac"],
              "stage_ms_in_pipeline": stage_ms,
              "edge0_picks": eng.channels[0].picks, "launches": launches})
        if s["completed"] != 32 or s["failed"] != 0:
            raise AssertionError(f"{mech}: completed {s['completed']}, "
                                 f"failed {s['failed']}")
        # each batch passes both stages once, plus one warm-up per stage
        if launches != per_batch * (stats.batches + 1):
            raise AssertionError(f"{mech}: {launches} kernel launches for "
                                 f"{stats.batches} batches")
    return fa.LAUNCHES


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer

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
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "library": lib.name,
          "ptxas": ptxas})

    worst = check_kernels(fa)
    timing = time_kernels(fa, peaks)

    # each path resets the count just before it runs and reads it just
    # after: the full-width prefills, then the served traces (the main
    # path, whose count is the kernels line's ``launches``)
    launches_prefill = prefill_full_width(fa, ops, Transformer, get_config)
    launches_serve = serve_pipeline(fa)

    main_row = timing[0]
    emit({"kernels": [{
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches_serve, "launches_serve": launches_serve,
        "launches_prefill": launches_prefill, "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "per_shape": timing}]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
