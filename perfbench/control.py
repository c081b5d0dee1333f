"""The controls that the benchmark's limits are set against: the plain
reference put in the program's place, computed in fp8 (the nearest
precision below the configurations' bf16), and for training the faults of
a step, planted in the reference.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 30]

Serving cells: per seed, the queries that a run of ``--seconds`` would
send and the sample that its check would draw; the fp32 reference's
logits over each sampled prompt, and the gap below its best logit of the
token that the fp8 reference puts first (stage 0); then the same over the
stage-1 inputs made from the fp32 reference's stage-0 tokens (stage 1).

Training cells: per seed, the fp32 reference's first three steps, and in
the program's place the fp8 reference's and the reference with half of
each batch left out (the mean over the rest); each compared as a run
compares the program.  A step that returns its state unchanged reads 1 on
the leaf gaps by their definition and needs no run.

Each reading is one JSON line; the card is required.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import util  # noqa: E402


def serve_control(cell: dict, cfg: dict, seed: int, seconds: float,
                  device: str) -> dict:
    """Stage 0's and stage 1's widest gaps of the fp8 reference's first
    tokens below the fp32 reference's best, over a run's sample."""
    import numpy as np
    import torch

    from perfbench import reference
    from perfbench.traffic import poisson_window
    from perfbench.weights import make_weights
    reference.no_tf32()
    traffic, stages = cell["traffic"], cfg["stages"]
    trace = poisson_window(float(traffic["rate_qps"]), seconds,
                           traffic["prompt_tokens"], stages[0]["vocab_size"],
                           util.derive_seed(seed, "traffic"),
                           traffic.get("arrival_seed"))
    rng = np.random.default_rng(util.derive_seed(seed, "sample"))
    n = min(int(traffic["check_queries"]), len(trace))
    pick = sorted(rng.choice(len(trace), n, replace=False))
    tokens = torch.from_numpy(np.stack([trace[i][2] for i in pick])).to(device)
    gaps, inputs = {}, tokens
    for i, sc in enumerate(stages):
        w = {k: t.float() for k, t in make_weights(
            sc, util.derive_seed(seed, "weights", i), device,
            torch.bfloat16).items()}
        last_logits = util.family(sc).last_logits
        ref = last_logits(w, sc, inputs, "fp32")
        low = last_logits(w, sc, inputs, "fp8")
        first = low.argmax(-1)
        gaps[f"gap_stage{i}"] = float((ref.max(-1).values - ref.gather(
            1, first[:, None])[:, 0]).max())
        nxt = ref.argmax(-1)
        del w, ref, low
        if i + 1 < len(stages):
            inputs = (nxt[:, None] % stages[i + 1]["vocab_size"]).repeat(
                1, traffic["prompt_tokens"])
    return {"control": "fp8", "queries": n, **gaps}


def train_control(cell: dict, cfg: dict, seed: int, device: str) -> list:
    """The fp8 reference and the half-batch fault against the fp32
    reference, by the run's comparison."""
    from perfbench.kinds.train import (CHECK_STEPS, compare, make_batch,
                                       reference_steps)
    traffic = cell["traffic"]
    b, s = traffic["batch"], traffic["seq_len"]
    data_seed = util.derive_seed(seed, "data") % 2 ** 32
    wseed = util.derive_seed(seed, "weights", 0)
    batches = [make_batch(cfg["vocab_size"], s, b, data_seed, k)
               for k in range(CHECK_STEPS)]
    ref = reference_steps(cfg, wseed, batches, device)
    out = []
    for name, kw in (("fp8", {"precision": "fp8"}),
                     ("half_batch", {"rows": range(b // 2)})):
        other = reference_steps(cfg, wseed, batches, device, **kw)
        checks = compare(other, ref, cell["limits"])
        out.append({"control": name,
                    **{k: v for k, (v, _) in checks.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float,
                    default=float(util.benchmark()["run_seconds"]))
    args = ap.parse_args(argv)
    util.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        util.log("the controls need a CUDA device")
        return 3
    cell = util.cell(args.workload)
    cfg = util.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cfg["kind"] == "serve":
            rows = [serve_control(cell, cfg, seed, args.seconds, "cuda")]
        else:
            rows = train_control(cell, cfg, seed, "cuda")
        for r in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, **r,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
