"""Serving launcher: a Camelot-managed microservice pipeline on one H100.

Builds a pipeline of model-zoo stages at full width, profiles them live,
fits the predictor, runs the Camelot allocator, then serves a batched
request trace with the chosen communication mechanism.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --stages qwen3-0.6b qwen1.5-0.5b
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import (H100, CamelotAllocator, PipelinePredictor,
                              SAConfig, profile_from_engine)
from repro_torch.core.types import Pipeline
from repro_torch.serving import ModelStageServer, PipelineEngine, make_trace


def serve(stages: Sequence[str], queries: int = 24, qps: float = 30.0,
          batch: int = 4, qos: float = 1.0, devices: int = 2,
          comm: str = "device", *, reduced: bool = False,
          device=None) -> dict:
    """Profile -> fit -> solve -> serve, printing the launcher's two lines.

    ``reduced``/``device`` are the stage servers' own (full width on the
    card by default).  Returns the solve's ``SolveResult`` and the served
    trace's ``ServeStats.summary()``."""
    servers = [ModelStageServer(f"stage{i}", arch, seq_len=16, seed=i,
                                reduced=reduced, device=device)
               for i, arch in enumerate(stages)]
    profiles = []
    for sv in servers:
        timings = sv.profile_stage_timings(batches=(1, 2, 4), repeats=2)
        profiles.append(profile_from_engine(
            sv.name, timings, weights_bytes=1e9, act_bytes_per_query=2e7,
            device=H100, host_bytes_per_query=2e6))
    pipeline = Pipeline("serve", profiles, qos_target=qos)

    pred = PipelinePredictor.from_profiles(profiles, H100)
    alloc = CamelotAllocator(pipeline, pred, H100, devices,
                             sa=SAConfig(iterations=1200, seed=0))
    res = alloc.solve_max_load(batch)
    print(f"camelot allocation (predicted {res.objective:.0f} qps): "
          f"{[(s.n_instances, s.quota) for s in res.allocation.stages]}")

    eng = PipelineEngine(servers, comm_mechanism=comm, qos_target=qos,
                         batch_size=batch, batch_timeout=0.05)
    trace = make_trace(queries, qps=qps, seq_len=16,
                       vocab=servers[0].cfg.vocab_size)
    stats = eng.run_trace(trace)
    s = stats.summary()
    print(f"served {s['completed']} queries: p99 {s['p99'] * 1e3:.1f} ms "
          f"(target {qos * 1e3:.0f} ms), comm share "
          f"{s['comm_frac'] * 100:.2f}% [{comm}]")
    return {"solve": res, "served": s}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", nargs="+",
                    default=["qwen3-0.6b", "qwen1.5-0.5b"])
    ap.add_argument("--queries", type=int, default=24)
    ap.add_argument("--qps", type=float, default=30.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--qos", type=float, default=1.0)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--comm", choices=("device", "host"), default="device")
    args = ap.parse_args(argv)
    return serve(args.stages, queries=args.queries, qps=args.qps,
                 batch=args.batch, qos=args.qos, devices=args.devices,
                 comm=args.comm)


if __name__ == "__main__":
    main()
