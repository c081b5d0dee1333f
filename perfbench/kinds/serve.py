"""Serving cells: a chain of stages served open loop by
``repro_torch.serving.PipelineEngine`` on its process backend.

Set-up: the kernels' library is built (once a checkout), the device
hand-off is measured (``measure_device_transport``) and its crossover fed
to the comm model, the engine is made with the cell's hand-placed
allocation, and a short warm-up trace at the cell's shapes spawns the
workers (each warms every stage) and runs through the pool.  The window is
one trace of Poisson arrivals at the cell's rate over ``seconds``; queries
still queued when it closes are drained after it.  Then the workers are
stopped, and the plain reference of each stage's family
(``perfbench/families/<family>.py``) judges a sample of the served tokens.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import threading
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from perfbench import reference
from perfbench.stage import (DONE_FILE, HEAD, TRACE_FILE, RecordingStage,
                             StageSpec, collect_profiles, read_calls)
from perfbench.trace import busy_union, gaps, top_by_name
from perfbench.traffic import poisson_window
from perfbench.util import derive_seed, family, log
from perfbench.weights import make_weights

# a traced run fails where a worker's profile holds fewer device records
# in its calls inside the window than this share of the launches that its
# stages' warm calls made
PROFILE_COMPLETE = 0.5


class MemorySampler:
    """The card's used memory (all processes' allocations and contexts),
    sampled by the driver from ``cudaMemGetInfo``; its peak."""

    PERIOD = 0.05

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info()
            self.peak = max(self.peak, total - free)
            self._stop.wait(self.PERIOD)

    def __enter__(self):
        if torch.cuda.is_available():
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


class UtilizationSampler:
    """NVML's GPU utilization (``nvidia-smi``, every 100 ms), each sample
    stamped with the driver's clock when it is read."""

    def __init__(self):
        self.samples: List[tuple] = []
        self._proc = None
        self._thread = None

    def __enter__(self):
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return self
        import subprocess
        self._proc = subprocess.Popen(
            [exe, "--query-gpu=utilization.gpu", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                self.samples.append((time.time_ns(),
                                     float(line.split(",")[0])))
            except ValueError:
                continue

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5.0)
            except Exception:           # noqa: BLE001 — never leave it
                self._proc.kill()
                self._proc.wait(timeout=5.0)
            self._thread.join(timeout=5.0)


def allocation(spec: dict):
    """The cell's hand-placed ``Allocation``: per stage (instances, quota,
    batch), and per stage the (logical device, quota) of each instance."""
    from repro_torch.core.types import Allocation, Placement, StageAlloc
    return Allocation(
        stages=[StageAlloc(int(n), float(q), int(b))
                for n, q, b in spec["stages"]],
        placement=Placement(per_stage=[[(int(d), float(q)) for d, q in st]
                                       for st in spec["placement"]]))


def queries(trace):
    from repro_torch.serving import Query
    return [Query(qid=i, arrival=t, tokens=tok) for i, t, tok in trace]


def run(ctx) -> dict:
    """One run of a serving cell; returns the observations that the
    metric readers and the check read."""
    record_dir = tempfile.mkdtemp(prefix="perfbench-serve-")
    try:
        return _run(ctx, record_dir)
    finally:
        shutil.rmtree(record_dir, ignore_errors=True)


def open_engine(ctx, record_dir: str):
    """The cell's stages and engine, its comm model fed the crossover
    measured now: (engine, crossover bytes).  The workers spawn on the
    engine's first trace."""
    from repro_torch.core import H100, CommModel
    from repro_torch.serving import (PipelineEngine, measure_device_transport,
                                     measure_transport)
    cell, engine_cfg = ctx.cell, ctx.cell["engine"]
    stages = [RecordingStage(StageSpec(
        name=sc["name"], index=i, cfg=sc,
        seq_len=cell["traffic"]["prompt_tokens"],
        weight_seed=derive_seed(ctx.seed, "weights", i), device=ctx.device,
        record_dir=record_dir, trace=ctx.trace, fault=ctx.fault,
        reduced=ctx.reduced)) for i, sc in enumerate(ctx.config["stages"])]
    if ctx.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()                  # once a checkout, before the workers
        crossover = measure_device_transport(repeats=15)["crossover_bytes"]
    else:
        crossover = measure_transport(repeats=5)["crossover_bytes"]
    eng = PipelineEngine(
        stages, comm_mechanism=engine_cfg["comm_mechanism"],
        qos_target=engine_cfg["qos_target_s"], batch_size=engine_cfg["batch"],
        batch_timeout=engine_cfg["batch_timeout_s"],
        allocation=allocation(cell["allocation"]),
        comm_model=CommModel(H100, crossover_override=crossover),
        backend=engine_cfg["backend"])
    return eng, crossover


def _run(ctx, record_dir: str) -> dict:
    cell, seed, traffic = ctx.cell, ctx.seed, ctx.cell["traffic"]
    seq_len, batch = traffic["prompt_tokens"], cell["engine"]["batch"]
    stage_cfgs = ctx.config["stages"]
    eng, crossover = open_engine(ctx, record_dir)
    vocab = stage_cfgs[0]["vocab_size"]
    rate = float(traffic["rate_qps"])
    info: Dict = {"crossover_bytes": crossover,
                  "allocation": cell["allocation"], "rate_qps": rate}
    mem = MemorySampler()
    nvml = UtilizationSampler() if ctx.trace else None
    trace = poisson_window(rate, ctx.seconds, seq_len, vocab,
                           derive_seed(seed, "traffic"),
                           traffic.get("arrival_seed"))
    qs = queries(trace)
    with mem:
        try:
            warm = queries(poisson_window(
                rate, traffic["warmup_seconds"], seq_len, vocab,
                derive_seed(seed, "warm-up")))
            t_pool = time.time()
            eng.run_trace(warm)
            if ctx.device == "cuda":
                torch.cuda.synchronize()
            setup_s = time.time() - ctx.process_start
            info["setup_phases_s"] = {
                "to_engine": t_pool - ctx.process_start,
                "workers_and_warm_up": time.time() - t_pool}
            log(f"set-up {setup_s:.1f} s; {len(qs)} queries over "
                f"{ctx.seconds} s at {rate} qps")
            if nvml is not None:
                nvml.__enter__()
            t0_ns = time.time_ns()
            if ctx.trace:
                start = t0_ns + int(traffic["trace_at"] * ctx.seconds * 1e9)
                trace_window = (start,
                                start + int(traffic["trace_seconds"] * 1e9))
                # whole or not at all: the workers' threads poll for it
                tmp = f"{record_dir}/{TRACE_FILE}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"start_ns": trace_window[0],
                               "stop_ns": trace_window[1]}, f)
                os.replace(tmp, f"{record_dir}/{TRACE_FILE}")
            stats = eng.run_trace(qs)
            t1_ns = time.time_ns()
            # the workers stop their profiles now, outside the served trace
            profiles = collect_profiles(record_dir) if ctx.trace else None
        finally:
            if nvml is not None:
                nvml.__exit__()
            if ctx.trace:               # also where the run failed
                open(f"{record_dir}/{DONE_FILE}", "a").close()
            eng.close()
    reports = eng.worker_reports
    calls = [read_calls(record_dir, i) for i in range(len(stage_cfgs))]
    recorded = sum(len(c) for c in calls)
    reported = sum(c for r in reports.values() for row in r["calls"]
                   for c in row if c is not None)
    if recorded != reported:
        raise RuntimeError(f"{recorded} calls recorded, the workers report "
                           f"{reported}")
    window = [[c for c in cs if c[0] >= t0_ns] for cs in calls]
    summary = stats.summary()
    lat = np.array([q.done - q.arrival for q in qs if q.done is not None])
    done = np.array([q.done for q in qs if q.done is not None])
    obs = {
        "kind": "serve", "setup_s": setup_s, "seconds": ctx.seconds,
        "sent": len(qs), "completed": int(len(done)),
        "failed": int(summary["failed"]),
        "latencies_s": lat, "done_s": done,
        "completed_in_window": int((done <= ctx.seconds).sum()),
        "stage_calls": [len(w) for w in window], "batch": batch,
        "comm_frac": summary["comm_frac"],
        "compute_time_s": summary["compute_time"],
        "query_flops": sum(family(sc).prefill_flops(sc, 1, seq_len)
                           for sc in stage_cfgs),
        "memory_peak_bytes": int(mem.peak),
        "drain_s": max(0.0, (t1_ns - t0_ns) / 1e9 - ctx.seconds),
    }
    info.update(sent=len(qs), completed=obs["completed"],
                completed_in_window=obs["completed_in_window"],
                unfinished_at_close=len(qs) - obs["completed_in_window"],
                failed=obs["failed"], drain_s=obs["drain_s"],
                p50_ms=float(np.percentile(lat, 50) * 1e3) if len(lat) else None,
                p99_ms=float(np.percentile(lat, 99) * 1e3) if len(lat) else None,
                stage_calls=obs["stage_calls"],
                launches={w: r["launches"] for w, r in reports.items()},
                generator_lateness="not measured: the engine admits "
                                   "queries inside run_trace")
    if nvml is not None:
        lo, hi = t0_ns, t0_ns + int(ctx.seconds * 1e9)
        obs["utilization"] = [u for t, u in nvml.samples if lo <= t <= hi]
    if ctx.trace:
        obs.update(_profile_obs(record_dir, profiles, trace_window, window))
        info["lead_in_recorded"] = obs.pop("lead_in_recorded")
        info["profiles"] = obs.pop("profiles")
    obs["info"] = info
    # the workers are gone: the card is the reference's
    obs["checks"] = check(ctx, qs, stats, calls, window, stage_cfgs, seed)
    return obs


def _profile_obs(record_dir: str, profiles, trace_window, window) -> dict:
    """busy_s and window_s over the span of the traced window that every
    worker's profile covers, the device operations that took most time
    there, and its idle gaps by the stage calls open in each.  Each
    worker's profile must hold its work: in the worker's calls that lie
    inside the window, at least ``PROFILE_COMPLETE`` of the device records
    that its stages' warm calls made."""
    w0, w1 = trace_window
    profs = [p for p in profiles if p["events"] is not None]
    if not profs:
        raise RuntimeError("no worker profiled the traced window")
    per_worker = []
    for p in profs:
        starts = sorted(s for _, s, _ in p["events"])
        calls = [(i, c[0], c[1]) for i in range(len(window))
                 for c in read_calls(record_dir, i, p["pid"])
                 if w0 <= c[0] and c[1] <= w1]
        records = sum(bisect.bisect_right(starts, t1)
                      - bisect.bisect_left(starts, t0) for _, t0, t1 in calls)
        launches = sum(p["launches"].get(i, 0) for i, _, _ in calls)
        per_worker.append({"calls_in_window": len(calls),
                           "records": records, "launches": launches})
        if records < PROFILE_COMPLETE * launches:
            raise RuntimeError(
                f"worker {p['pid']}'s profile holds {records} device records "
                f"in its {len(calls)} calls inside the window, against "
                f"{launches} launches")
    lo = max([w0] + [p["start_ns"] for p in profs])
    hi = min([w1] + [p["stop_ns"] for p in profs])
    events = [e for p in profs for e in p["events"]]
    merged, busy = busy_union([(s, e) for _, s, e in events], lo, hi)
    by_label: Dict[str, float] = {}
    for s, e in gaps(merged, lo, hi):
        mid = (s + e) // 2
        open_ = sorted({i for i, cs in enumerate(window)
                        for c in cs if c[0] <= mid <= c[1]})
        label = ("stage call open: " + ", ".join(f"stage {i}" for i in open_)
                 if open_ else "no stage call open")
        by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e9
    idle = sorted(([k, v] for k, v in by_label.items()),
                  key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy / 1e9, "trace_window_s": max(hi - lo, 0) / 1e9,
            "device_ops": top_by_name(events, lo, hi), "idle_gaps": idle,
            "lead_in_recorded": [p["lead_in"] for p in profs],
            "profiles": per_worker}


def check(ctx, qs, stats, calls, window, stage_cfgs, seed) -> Dict:
    """The numbers that decide ``correct``, each with its limit.

    - ``not_served_once``: queries of the window that did not complete, or
      whose prompt did not reach stage 0 exactly once (limit 0);
    - ``handoff_mismatches``: stage-0 outputs of a call that no stage-1
      call took in as its rows (the token repeated over the row), and the
      other way round (limit 0);
    - ``gap_stage0``, ``gap_stage1``: over a sample of the served queries
      drawn from the seed, the widest gap by which the token a stage
      returned lies below the reference's best logit for that input."""
    limits = ctx.cell["limits"]
    head = {tuple(q.tokens[:HEAD].tolist()): q.qid for q in qs}
    seen = Counter()
    served0: Dict[int, int] = {}
    where: Dict[int, tuple] = {}
    for t0, t1, heads, out in window[0]:
        for r, row in enumerate(heads):
            qid = head.get(tuple(row.tolist()))
            if qid is not None:
                seen[qid] += 1
                served0[qid] = int(out[r])
                where[qid] = (tuple(out.tolist()), r)
    not_once = sum(1 for q in qs if q.done is None or seen[q.qid] != 1)
    stage1_by_input: Dict[tuple, tuple] = {}
    ins0 = Counter(tuple(out.tolist()) for _, _, _, out in window[0])
    ins1 = Counter()
    bad_rows = 0
    for _, _, heads, out in window[1]:
        bad_rows += int((heads != heads[:, :1]).any(axis=1).sum())
        key = tuple(heads[:, 0].tolist())
        ins1[key] += 1
        stage1_by_input[key] = tuple(out.tolist())
    mismatches = sum(((ins0 - ins1) + (ins1 - ins0)).values()) + bad_rows
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    done = [q for q in qs if q.qid in served0 and q.done is not None]
    n = min(int(ctx.cell["traffic"]["check_queries"]), len(done))
    sample = [done[i] for i in sorted(rng.choice(len(done), n,
                                                 replace=False))]
    gap0, gap1 = reference_gaps(ctx, sample, served0, where,
                                stage1_by_input, stage_cfgs, seed)
    return {"not_served_once": (not_once, limits["not_served_once"]),
            "handoff_mismatches": (mismatches, limits["handoff_mismatches"]),
            "gap_stage0": (gap0, limits["gap_stage0"]),
            "gap_stage1": (gap1, limits["gap_stage1"]),
            "checked_queries": (n, None)}


def reference_gaps(ctx, sample, served0, where, stage1_by_input,
                   stage_cfgs, seed, precision: str = "fp32") -> tuple:
    """The widest gap of the served tokens below the reference's best
    logit, for stage 0 over the sampled prompts and for stage 1 over each
    sampled query's stage-1 input (its stage-0 token repeated)."""
    if not sample:
        return float("inf"), float("inf")
    dev = ctx.device
    reference.no_tf32()
    seq_len = len(sample[0].tokens)
    w = {k: t.float() for k, t in make_weights(
        stage_cfgs[0], derive_seed(seed, "weights", 0), dev,
        torch.bfloat16).items()}
    prompts = torch.from_numpy(np.stack([q.tokens for q in sample])).to(dev)
    logits = family(stage_cfgs[0]).last_logits(w, stage_cfgs[0], prompts,
                                               precision)
    got = torch.tensor([served0[q.qid] for q in sample], device=dev)
    gap0 = float((logits.max(-1).values
                  - logits.gather(1, got[:, None].long())[:, 0]).max())
    del w, logits
    served1 = []
    for q in sample:
        outs, r = where[q.qid]
        ins = stage1_by_input.get(outs)
        served1.append(None if ins is None else ins[r])
    if any(s is None for s in served1):
        return gap0, float("inf")
    vocab1 = stage_cfgs[1]["vocab_size"]
    firsts = sorted({served0[q.qid] % vocab1 for q in sample})
    w = {k: t.float() for k, t in make_weights(
        stage_cfgs[1], derive_seed(seed, "weights", 1), dev,
        torch.bfloat16).items()}
    inputs = torch.tensor(firsts, device=dev)[:, None].repeat(1, seq_len)
    logits = family(stage_cfgs[1]).last_logits(w, stage_cfgs[1], inputs,
                                               precision)
    row = {t: i for i, t in enumerate(firsts)}
    idx = torch.tensor([row[served0[q.qid] % vocab1] for q in sample],
                       device=dev)
    got = torch.tensor(served1, device=dev)
    lg = logits[idx]
    gap1 = float((lg.max(-1).values
                  - lg.gather(1, got[:, None].long())[:, 0]).max())
    return gap0, gap1
