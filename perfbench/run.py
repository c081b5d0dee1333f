"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``perfbench/workloads/<cell>.json``) names its configuration
(``perfbench/configs/<config>.json``), whose ``kind`` names the driver
(``perfbench/kinds/<kind>.py``).  The driver runs set-up, the window and
the check, and returns its observations; each metric that
``BENCHMARK.json`` gives the cell (its end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``) is read from them
by its own reader, ``perfbench/metrics/<metric>.py``.  A reader that finds
nothing to read returns None, and the metric is left out.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit.
The last lines of standard error repeat the checks.  The run exits with
another code than 0, and prints no result, without a CUDA device (or
fewer than the cell asks for), or if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import util  # noqa: E402


@dataclass
class RunContext:
    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str                      # "cuda" on the card
    process_start: float
    fault: Optional[str] = None      # serving tests only
    reduced: bool = False            # the port's reduced configs (tests)


def metric_reader(name: str) -> Callable:
    path = util.PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The entries of the metrics ``BENCHMARK.json`` gives this cell in
    this mode: those without ``workloads``, and those that list it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def drive(ctx: RunContext) -> dict:
    """Set-up, window and check of one run: the driver's observations."""
    kind = ctx.config["kind"]
    return importlib.import_module(f"perfbench.kinds.{kind}").run(ctx)


def result(ctx: RunContext, obs: dict, metrics: list, device: dict) -> dict:
    values = {}
    for m in metrics:
        v = metric_reader(m["name"])(obs, device["kind"])
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = obs["checks"]
    correct = all(limit is None or value <= limit
                  for value, limit in checks.values())
    out = {"correct": bool(correct),
           "attempted": int(obs.get("sent", obs.get("steps", 0))),
           "failed": int(obs.get("failed", 0)),
           "metrics": values, "device": device}
    if ctx.trace and "device_ops" in obs:
        out["breakdown"] = {"device_ops": obs["device_ops"],
                            "idle_gaps": obs.get("idle_gaps", [])}
    # a check that found nothing to compare reads as far past its limit
    out["checks"] = {k: {"value": v if math.isfinite(v) else 1e30,
                         "limit": lim} for k, (v, lim) in checks.items()}
    return out


def device_line(obs: dict, ctx: RunContext, count: int) -> dict:
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(obs["memory_peak_bytes"])}
    if ctx.trace and "busy_s" in obs:
        dev["busy_s"] = float(obs["busy_s"])
        dev["window_s"] = float(obs["trace_window_s"])
    return dev


def main(argv=None) -> int:
    start = util.process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    util.set_cache_dirs()
    import torch
    bench = util.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        util.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        util.log(f"needs {entry['chips']} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    cell = util.cell(args.workload)
    ctx = RunContext(cell_name=args.workload, cell=cell,
                     config=util.config(cell["config"]), seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device="cuda", process_start=start)
    obs = drive(ctx)
    bad = util.forbidden_loaded()
    if bad:
        util.log(f"modules that the benchmark may not load are loaded: {bad}")
        return 4
    print(json.dumps({"info": obs.get("info", {})}, default=float),
          flush=True)
    out = result(ctx, obs, cell_metrics(bench, args.workload, ctx.trace),
                 device_line(obs, ctx, entry["chips"]))
    for k, c in out["checks"].items():
        util.log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
