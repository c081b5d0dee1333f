"""End-to-end serving driver of the PyTorch/CUDA port: a 2-stage pipeline
of real models served with batched requests through the execution core,
the twin of ``examples/serve_pipeline.py`` (paper Fig. 5 / Fig. 11).

The engine consumes an ``Allocation`` + ``Placement`` (here: N instances of
stage 0, built without the allocator) and runs the instances
concurrently; the inter-stage edge routes its payload by the Fig. 11
crossover ("auto"), or is pinned to one mechanism for the A/B rows.

``--backend processes`` runs the stages in worker processes, one per
placed device, each rebuilding every stage from its pickle; on the card
a payload above the crossover is handed off through the card's memory by
CUDA IPC, on the CPU through a host shared-memory ring.

``--dag`` serves a diamond ServiceGraph instead of the chain: one
extractor model fans out to two branch models whose outputs join
(fan-in barrier) at a fusion model.

The models run at their published width on the card; ``--reduced
--device cpu`` serves the reduced models on the CPU.  ``serve_chain`` and
``serve_dag`` return what they print, as dicts.

Run:  PYTHONPATH=src python examples/serve_pipeline_torch.py [--queries 32] [--dag]
      PYTHONPATH=src python examples/serve_pipeline_torch.py --reduced --device cpu
"""
import argparse

from repro_torch.camelot import ClusterSpec
from repro_torch.core.types import (Allocation, Placement, ServiceEdge,
                                    ServiceGraph, StageAlloc)
from repro_torch.serving import ModelStageServer, PipelineEngine, make_trace

LABELS = {"host": "host-staged (default, Fig. 8a)",
          "device": "global-memory hand-off (Camelot, Fig. 8b)",
          "auto": "per-edge crossover routing (Fig. 11)"}


def build_allocation(n_stages: int, instances: int, batch: int,
                     cluster: ClusterSpec = ClusterSpec(devices=1),
                     ) -> Allocation:
    """Stage 0 gets ``instances`` concurrent instances, the rest one each —
    the shape the Camelot allocator produces for a front-heavy pipeline.
    Quotas snap onto the cluster's ``quota_step`` lattice (floored, so the
    per-device sum stays packable), the grid the allocator solves over."""
    per_stage, stages = [], []
    for si in range(n_stages):
        n_i = instances if si == 0 else 1
        quota = cluster.quantize(1.0 / (n_stages * n_i))
        stages.append(StageAlloc(n_instances=n_i, quota=quota, batch=batch))
        per_stage.append([(0, quota) for _ in range(n_i)])
    return Allocation(stages=stages, placement=Placement(per_stage=per_stage))


def _stage(name, arch, args) -> ModelStageServer:
    return ModelStageServer(name, arch, seq_len=16, reduced=args.reduced,
                            device=args.device)


def _row(s: dict, picks) -> dict:
    return {"p99": s["p99"], "mean": s["mean"], "completed": s["completed"],
            "failed": s["failed"], "comm_frac": s["comm_frac"],
            "picks": picks}


def serve_dag(args) -> dict:
    """Diamond on real models: extract -> {branch-a, branch-b} -> fuse."""
    stages = [_stage("extract", args.arch1, args),
              _stage("branch-a", args.arch2, args),
              _stage("branch-b", args.arch1, args),
              _stage("fuse", args.arch2, args)]
    graph = ServiceGraph("diamond", [None] * 4,
                         [ServiceEdge(0, 1), ServiceEdge(0, 2),
                          ServiceEdge(1, 3), ServiceEdge(2, 3)],
                         qos_target=2.0)
    alloc = build_allocation(len(stages), args.instances, args.batch)
    trace = make_trace(args.queries, qps=args.qps, seq_len=16,
                       vocab=stages[0].cfg.vocab_size, seed=7)
    with PipelineEngine(stages, comm_mechanism="auto", qos_target=2.0,
                        batch_timeout=0.05, allocation=alloc, graph=graph,
                        backend=args.backend) as eng:
        stats = eng.run_trace(trace)
        picks = {k: dict(c.picks) for k, c in eng.channels.items()}
    s = stats.summary()
    print(f"diamond: {args.arch1} -> ({args.arch2}, {args.arch1}) -> "
          f"{args.arch2} ({args.queries} queries @ {args.qps} qps)")
    print(f"    p99 {s['p99'] * 1e3:7.1f} ms | mean {s['mean'] * 1e3:6.1f} ms"
          f" | completed {s['completed']} | "
          f"comm share {s['comm_frac'] * 100:.2f}% | "
          f"edge picks {list(picks.items())}")
    return {"topology": "diamond", "allocation": alloc,
            "auto": _row(s, picks)}


def serve_chain(args) -> dict:
    """The chain under each hand-off: host-staged, global-memory, auto."""
    stages = [_stage("stage0", args.arch1, args),
              _stage("stage1", args.arch2, args)]
    alloc = build_allocation(len(stages), args.instances, args.batch)
    print(f"pipeline: {args.arch1} -> {args.arch2} "
          f"({args.queries} queries @ {args.qps} qps, batch {args.batch}, "
          f"stage-0 x{args.instances} instances)")
    out = {"topology": "chain", "allocation": alloc}
    for mech in ("host", "device", "auto"):
        trace = make_trace(args.queries, qps=args.qps, seq_len=16,
                           vocab=stages[0].cfg.vocab_size, seed=7)
        with PipelineEngine(stages, comm_mechanism=mech, qos_target=1.0,
                            batch_timeout=0.05, allocation=alloc,
                            backend=args.backend) as eng:
            stats = eng.run_trace(trace)
            picks = dict(eng.channels[0].picks)
        s = stats.summary()
        out[mech] = _row(s, picks)
        print(f"  {LABELS[mech]}:")
        print(f"    p99 {s['p99'] * 1e3:7.1f} ms | mean "
              f"{s['mean'] * 1e3:6.1f} ms | completed {s['completed']} | "
              f"comm share {s['comm_frac'] * 100:.2f}% | "
              f"edge-0 picks {picks}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--instances", type=int, default=2,
                    help="concurrent instances of stage 0")
    ap.add_argument("--arch1", default="qwen3-0.6b")
    ap.add_argument("--arch2", default="qwen1.5-0.5b")
    ap.add_argument("--backend", choices=("threads", "processes"),
                    default="threads",
                    help="execution backend: shared thread pool or one "
                         "worker process per placed device")
    ap.add_argument("--dag", action="store_true",
                    help="serve the diamond ServiceGraph instead of a chain")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced models, not the published width")
    ap.add_argument("--device", default=None,
                    help="where the stages run (default: the card)")
    args = ap.parse_args(argv)
    if args.instances < 1:
        ap.error("--instances must be >= 1")
    return serve_dag(args) if args.dag else serve_chain(args)


if __name__ == "__main__":
    main()
