"""Find the knee of a serving cell: the highest offered rate that the
program sustains without a growing backlog.

    python3 perfbench/sweep.py --workload img-to-img.steady \
        --rates 40,50,60,70,80 --seconds 15 --seed 1

One engine and one pool of workers, set up as a run of the cell sets them
up; then one trace a rate, each of ``--seconds`` of Poisson arrivals.  A
row a rate: the completed rate inside the window, p50 and p99 of every
query, the drain after the window, the median latency of the last quarter
of arrivals against the second quarter, and whether the backlog grew (the
last quarter's median over twice the second's, or a drain of more than a
tenth of the window).  The knee is the highest rate below the first that
grew.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import util  # noqa: E402


def row(rate: float, seconds: float, qs, wall_s: float) -> dict:
    import numpy as np
    lat = np.array([q.done - q.arrival for q in qs])
    arr = np.array([q.arrival for q in qs])
    done = np.array([q.done for q in qs])
    q2 = lat[(arr >= seconds / 4) & (arr < seconds / 2)]
    q4 = lat[arr >= 3 * seconds / 4]
    ratio = float(np.median(q4) / np.median(q2))
    drain = max(0.0, wall_s - seconds)
    served = float((done <= seconds).sum() / seconds)
    return {"rate_qps": rate, "sent": len(qs), "served_qps": served,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "drain_s": drain, "last_over_second_quarter": ratio,
            "grew": bool(ratio > 2.0 or drain > 0.1 * seconds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    util.set_cache_dirs()
    import torch

    from perfbench.kinds.serve import open_engine, queries
    from perfbench.run import RunContext
    from perfbench.traffic import poisson_window
    if not torch.cuda.is_available():
        util.log("the sweep needs a CUDA device")
        return 3
    cell = util.cell(args.workload)
    ctx = RunContext(cell_name=args.workload, cell=cell,
                     config=util.config(cell["config"]), seed=args.seed,
                     seconds=args.seconds, trace=False, device="cuda",
                     process_start=time.time())
    traffic = cell["traffic"]
    seq, vocab = traffic["prompt_tokens"], ctx.config["stages"][0]["vocab_size"]
    record_dir = tempfile.mkdtemp(prefix="perfbench-sweep-")
    rows = []
    try:
        eng, crossover = open_engine(ctx, record_dir)
        try:
            rates = [float(r) for r in args.rates.split(",")]
            eng.run_trace(queries(poisson_window(
                rates[0], traffic["warmup_seconds"], seq, vocab,
                util.derive_seed(args.seed, "warm-up"))))
            for rate in rates:
                qs = queries(poisson_window(
                    rate, args.seconds, seq, vocab,
                    util.derive_seed(args.seed, "traffic", rate)))
                t0 = time.perf_counter()
                eng.run_trace(qs)
                rows.append(row(rate, args.seconds, qs,
                                time.perf_counter() - t0))
                print(json.dumps({"sweep": rows[-1]}), flush=True)
        finally:
            eng.close()
    finally:
        shutil.rmtree(record_dir, ignore_errors=True)
    knee = None
    for r in rows:
        if r["grew"]:
            break
        knee = r["rate_qps"]
    print(json.dumps({"knee_qps": knee, "crossover_bytes": crossover,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
