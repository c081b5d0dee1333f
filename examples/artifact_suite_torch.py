"""Artifact-benchmark study (paper §VIII-E) through the port's
``repro_torch.camelot`` facade, the twin of ``examples/artifact_suite.py``:
each p_i+c_j+m_k pipeline is a ``ServiceSpec``, one ``CamelotSession`` per
pipeline charges the even-allocation baseline and Camelot max-peak through
the policy registry, and the simulated peak loads are compared.

The artifact stages are parametric profiles, not models: the study runs
the port's numpy solver and simulator on the host and gives the reference
example's numbers under the same seeds; it runs no model, so it takes no
device.  ``main`` returns what it prints.

Run:  PYTHONPATH=src python examples/artifact_suite_torch.py [--full]
"""
import argparse

from repro_torch.camelot import CamelotSession, ClusterSpec
from repro_torch.sim import SimConfig, workload_specs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="all 27 pipelines")
    args = ap.parse_args(argv)

    specs = workload_specs(include_artifacts=True)
    names = [n for n in specs if "+" in n] if args.full else \
        ["p1+c1+m1", "p1+c3+m1", "p3+c1+m2", "p2+c2+m2"]
    scfg = SimConfig(duration=8.0, warmup=1.0, seed=0)
    cluster = ClusterSpec(devices=2)
    print(f"{'pipeline':12s} {'EA qps':>9s} {'Camelot qps':>12s} {'gain':>7s}"
          f"  allocation")
    rows, gains = [], []
    for name in names:
        sess = CamelotSession(specs[name], cluster, batch=16)
        res_ea = sess.solve(policy="even")
        res_cm = sess.solve(policy="max-peak")
        if not res_cm.feasible:
            rows.append({"name": name, "feasible": False})
            print(f"{name:12s}  infeasible")
            continue
        p_ea, _ = sess.find_peak(result=res_ea, sim=scfg)
        p_cm, _ = sess.find_peak(result=res_cm, sim=scfg)
        gain = p_cm / max(p_ea, 1e-9) - 1
        gains.append(gain)
        alloc = [(s.n_instances, s.quota) for s in res_cm.allocation.stages]
        rows.append({"name": name, "feasible": True, "ea_peak": p_ea,
                     "camelot_peak": p_cm, "gain": gain,
                     "allocation": alloc})
        detail = " ".join(f"({n}x{q:.2f})" for n, q in alloc)
        print(f"{name:12s} {p_ea:9.0f} {p_cm:12.0f} {gain * 100:6.0f}%  "
              f"{detail}")
    mean_gain = sum(gains) / len(gains) if gains else None
    if gains:
        print(f"\nmean gain vs EA: {mean_gain * 100:.1f}% "
              f"(paper: 44.91% over 27 pipelines)")
    return {"pipelines": rows, "mean_gain": mean_gain}


if __name__ == "__main__":
    main()
