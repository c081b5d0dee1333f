"""Quickstart of the PyTorch/CUDA port: the full Camelot loop through the
``repro_torch.camelot`` facade, the twin of ``examples/quickstart.py``.

A workload is a ``ServiceSpec`` (pure data), the cluster a ``ClusterSpec``,
and a ``CamelotSession`` owns the lifecycle: profile, solve under a
policy, simulate, and serve the solved allocation live on real models.
The same steps drive the paper's text-to-text chain and the diamond DAG;
the multi-tenant section co-locates two services on one shared cluster
through ``MultiServiceSession`` (one joint solve, per-tenant QoS, against
the best static per-service partition).

The solver, predictor and simulator are numpy and give the reference
example's numbers under the same seeds.  The live replay serves the
models at their published width on the card (one GPU: every placed
device's instances share it; quotas are not enforced); ``--reduced
--device cpu`` serves the reduced models on the CPU instead.  Each
function returns what it prints, as a dict.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--queries 10]
      PYTHONPATH=src python examples/quickstart_torch.py --reduced --device cpu
"""
import argparse

from repro_torch.camelot import (CamelotSession, ClusterSpec,
                                 MultiServiceSession, SAConfig)
from repro_torch.sim import SimConfig, workload_specs


def _alloc(res) -> list:
    return [(s.n_instances, s.quota) for s in res.allocation.stages]


def run_workload(spec, queries: int, *, reduced: bool = False,
                 device=None) -> dict:
    kind = "chain" if spec.is_chain else "DAG"
    print(f"== {spec.name} ({kind}: {spec.n_nodes} nodes, "
          f"{len(spec.edges)} edges, QoS {spec.qos_target * 1e3:.0f} ms) ==")
    out = {"name": spec.name}

    sess = CamelotSession(spec, ClusterSpec(devices=2), batch=8)
    sess.profile()
    out["fit_errors"] = {sp.name: dict(sp.fit_errors)
                         for sp in sess.predictor.stages}
    for sp in sess.predictor.stages:
        print(f"  predictor[{sp.name}] holdout MAPE: " + ", ".join(
            f"{k}={v * 100:.1f}%" for k, v in sp.fit_errors.items()))

    # -- solve: peak capability, then right-size for 30% of it -----------
    peak = sess.solve(policy="max-peak", sa=SAConfig(iterations=1200))
    out["peak"] = {"objective": peak.objective, "allocation": _alloc(peak),
                   "solve_s": peak.solve_time}
    print(f"  max-peak: {peak.objective:.0f} qps predicted, alloc="
          f"{_alloc(peak)} ({peak.solve_time * 1e3:.0f} ms solve)")
    low = sess.solve(policy="min-resource", load=peak.objective * 0.3,
                     sa=SAConfig(iterations=1200))
    out["low"] = {"feasible": low.feasible, "allocation": _alloc(low),
                  "total_quota": low.allocation.total_quota()}
    print(f"  min-resource @30% load: total quota "
          f"{low.allocation.total_quota():.2f} GPUs "
          f"(peak used {peak.allocation.total_quota():.2f})")

    # -- validate the peak allocation in the simulator -------------------
    r = sess.simulate(load=peak.objective * 0.5, result=peak)
    out["simulated"] = {"normalized_p99": r.normalized_p99,
                        "completed": r.completed}
    print(f"  simulated @50% peak: p99/QoS = {r.normalized_p99:.2f} "
          f"({r.completed} completed)")

    # -- run the min-resource allocation LIVE (real models) --------------
    if not low.feasible or low.allocation.placement is None:
        print("  min-resource infeasible at this load — skipping live replay")
        out["live"] = None
        return out
    with sess.serve(result=low, reduced=reduced, device=device) as eng:
        s = eng.run_trace(sess.make_trace(queries, qps=20.0, seed=5)) \
            .summary()
    n_inst = [len(p) for p in low.allocation.placement.per_stage]
    out["live"] = {"instances": n_inst, "p99": s["p99"],
                   "completed": s["completed"], "failed": s["failed"]}
    print(f"  live replay: instances/node {n_inst} | "
          f"p99 {s['p99'] * 1e3:.1f} ms | completed {s['completed']}")
    return out


def run_multitenant(specs) -> dict:
    """Two services, ONE shared 3-device cluster: a joint solve packs them
    together QoS-safely; the best whole-device static split is the
    baseline it beats."""
    names = ["img-to-img", "diamond"]
    print(f"== multi-tenant: {' + '.join(names)} on one 3-device pool ==")
    sess = MultiServiceSession([specs[n] for n in names],
                               ClusterSpec(devices=3), batch=8)
    sess.profile()
    joint = sess.solve(policy="max-peak", sa=SAConfig(iterations=1200))
    lam_static, part, _ = sess.best_static_partition(
        sa=SAConfig(iterations=1200))
    print(f"  joint λ: {joint.objective:.0f} qps/tenant predicted vs best "
          f"static partition {part} at {lam_static:.0f} "
          f"(+{(joint.objective / max(lam_static, 1e-9) - 1) * 100:.0f}%)")
    sim = sess.simulate(loads=[joint.objective * 0.8] * 2,
                        sim=SimConfig(duration=6.0, warmup=1.0))
    out = {"names": names, "joint": joint.objective,
           "joint_allocation": _alloc(joint), "static": lam_static,
           "partition": list(part), "tenants": []}
    for t, r, target in zip(names, sim.per_tenant, sess.qos_targets):
        out["tenants"].append({"name": t, "p99": r.p99,
                               "completed": r.completed, "target": target})
        print(f"  {t}: simulated p99 {r.p99 * 1e3:.0f} ms vs own target "
              f"{target * 1e3:.0f} ms ({r.completed} completed)")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=10,
                    help="queries per live replay")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced models, not the published width")
    ap.add_argument("--device", default=None,
                    help="where the live replay runs (default: the card)")
    args = ap.parse_args(argv)
    specs = workload_specs()
    kw = dict(reduced=args.reduced, device=args.device)
    return [run_workload(specs["text-to-text"], args.queries, **kw),
            run_workload(specs["diamond"], args.queries, **kw),
            run_multitenant(specs)]


if __name__ == "__main__":
    main()
