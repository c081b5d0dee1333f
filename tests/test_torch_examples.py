"""The port's example twins against the reference's examples, on the CPU.

``examples/quickstart_torch.py``, ``serve_pipeline_torch.py`` and
``artifact_suite_torch.py`` return what they print.  The reference's
examples print only, so each runs here with its facade session replaced
by a subclass that records what the example's own calls return
(fit errors, solved allocations, predicted objectives, simulated
verdicts, peaks).  Up to the live replay, the control plane is numpy in
both packages and must give equal numbers under the same seeds; the
twins' live replays serve the reduced models on the CPU (``--reduced
--device cpu``) and must complete every query.  ``train_small_torch.py``
trains from the weights the reference example draws (handed in as a
model), in fp32 on both sides, and must print the reference's losses,
learning rates and gradient norms.
"""
import ast
import importlib.util
import re
import sys
from pathlib import Path

import pytest

import repro.camelot as ref_camelot

ROOT = Path(__file__).resolve().parents[1]
QUERIES = 4


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _alloc(res):
    return [(s.n_instances, s.quota) for s in res.allocation.stages]


def _recording(base, log):
    """``base`` (a reference session class) logging what the example's
    calls return, as plain data."""
    class Recording(base):
        def profile(self, *a, **kw):
            out = super().profile(*a, **kw)
            if hasattr(self, "predictor"):
                log.append(("fit", {sp.name: dict(sp.fit_errors)
                                    for sp in self.predictor.stages}))
            return out

        def solve(self, *a, **kw):
            res = super().solve(*a, **kw)
            log.append(("solve", dict(objective=res.objective,
                                      allocation=_alloc(res),
                                      feasible=res.feasible)))
            return res

        def simulate(self, *a, **kw):
            r = super().simulate(*a, **kw)
            tenants = getattr(r, "per_tenant", None)
            log.append(("simulate",
                        [(t.p99, t.completed) for t in tenants]
                        if tenants is not None
                        else (r.normalized_p99, r.completed)))
            return r

        def best_static_partition(self, *a, **kw):
            out = super().best_static_partition(*a, **kw)
            log.append(("static", (out[0], list(out[1]))))
            return out

        def find_peak(self, *a, **kw):
            out = super().find_peak(*a, **kw)
            log.append(("peak", out[0]))
            return out
    return Recording


def _run_reference(monkeypatch, name, argv):
    mod = _load(name)
    log = []
    monkeypatch.setattr(mod, "CamelotSession",
                        _recording(ref_camelot.CamelotSession, log))
    if hasattr(mod, "MultiServiceSession"):
        monkeypatch.setattr(mod, "MultiServiceSession", _recording(
            ref_camelot.MultiServiceSession, log))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return log


def test_quickstart_twin_matches_reference(monkeypatch, capsys):
    """text-to-text and diamond (profile, max-peak and min-resource
    solves, simulation at half the peak, the live replay), then the
    multi-tenant joint solve against the best static partition."""
    log = _run_reference(monkeypatch, "quickstart",
                         ["--queries", str(QUERIES)])
    ref_out = capsys.readouterr().out
    assert ref_out.count(f"completed {QUERIES}\n") == 2
    chain, dag, multi = _load("quickstart_torch").main(
        ["--queries", str(QUERIES), "--reduced", "--device", "cpu"])
    tags = [t for t, _ in log]
    assert tags == ["fit", "solve", "solve", "simulate"] * 2 \
        + ["fit", "solve", "static", "simulate"]
    for i, out in enumerate((chain, dag)):
        (_, fit), (_, peak), (_, low), (_, sim) = log[4 * i:4 * i + 4]
        assert out["fit_errors"] == fit
        assert (out["peak"]["objective"], out["peak"]["allocation"]) == \
            (peak["objective"], peak["allocation"])
        assert (out["low"]["feasible"], out["low"]["allocation"]) == \
            (low["feasible"], low["allocation"])
        assert (out["simulated"]["normalized_p99"],
                out["simulated"]["completed"]) == sim
        live = out["live"]
        assert (live["completed"], live["failed"]) == (QUERIES, 0)
        assert len(live["instances"]) == len(low["allocation"])
    (_, joint), (_, static), (_, sim) = log[9:]
    assert (multi["joint"], multi["joint_allocation"]) == \
        (joint["objective"], joint["allocation"])
    assert (multi["static"], multi["partition"]) == static
    assert [(t["p99"], t["completed"]) for t in multi["tenants"]] == sim
    # everything the reference printed but timings and the live p99
    port_out = capsys.readouterr().out

    def untimed(text):
        text = re.sub(r"\(\d+ ms solve\)", "", text)
        return re.sub(r"p99 [\d.]+ ms \|", "", text)
    assert untimed(port_out) == untimed(ref_out)


def test_artifact_suite_twin_matches_reference(monkeypatch, capsys):
    """The four default pipelines: the even and max-peak solves and both
    simulated peaks, equal; so the gains and their mean are too."""
    log = _run_reference(monkeypatch, "artifact_suite", [])
    ref_out = capsys.readouterr().out
    out = _load("artifact_suite_torch").main([])
    rows = [r for r in out["pipelines"] if r["feasible"]]
    solves = [v for t, v in log if t == "solve"]
    peaks = [v for t, v in log if t == "peak"]
    assert len(solves) == 2 * len(out["pipelines"])
    assert [r["allocation"] for r in rows] == \
        [s["allocation"] for s in solves[1::2] if s["feasible"]]
    assert [(r["ea_peak"], r["camelot_peak"]) for r in rows] == \
        list(zip(peaks[0::2], peaks[1::2]))
    assert capsys.readouterr().out == ref_out


def _picked(text):
    """The mechanisms each printed ``picks`` dict used, in order."""
    return [sorted(k for k, n in ast.literal_eval(m).items() if n)
            for m in re.findall(r"picks (\{[^}]*\})", text)]


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_serve_pipeline_twin_serves_the_chain(backend, monkeypatch, capsys):
    """The chain under host / device / auto: the twin's hand-built
    allocation equals the reference's, every query completes, and each
    hand-off picks the mechanisms the reference example's picks."""
    ref = _load("serve_pipeline")
    port = _load("serve_pipeline_torch")
    assert repr(port.build_allocation(2, 2, 4)) == \
        repr(ref.build_allocation(2, 2, 4))
    monkeypatch.setattr(sys, "argv", ["serve_pipeline.py", "--queries", "8"])
    ref.main()
    ref_picks = _picked(capsys.readouterr().out)
    out = port.main(["--queries", "8", "--reduced", "--device", "cpu",
                     "--backend", backend])
    assert repr(out["allocation"]) == repr(ref.build_allocation(2, 2, 4))
    for mech in ("host", "device", "auto"):
        assert (out[mech]["completed"], out[mech]["failed"]) == (8, 0)
    assert _picked(capsys.readouterr().out) == ref_picks == \
        [["host-staged"], ["global-memory"], ["host-staged"]]


def test_serve_pipeline_twin_serves_the_diamond(monkeypatch, capsys):
    ref = _load("serve_pipeline")
    monkeypatch.setattr(sys, "argv", ["serve_pipeline.py", "--queries", "8",
                                      "--dag"])
    ref.main()
    ref_out = capsys.readouterr().out
    out = _load("serve_pipeline_torch").main(
        ["--queries", "8", "--dag", "--reduced", "--device", "cpu"])
    assert (out["auto"]["completed"], out["auto"]["failed"]) == (8, 0)
    assert sorted(out["auto"]["picks"]) == [(0, 1), (0, 2), (1, 3), (2, 3)]
    assert all(p["global-memory"] == 0 and p["host-staged"] > 0
               for p in out["auto"]["picks"].values())
    assert "completed 8 |" in ref_out


def _train_lines(text):
    """(step, loss, lr, gnorm) of each printed step line."""
    return [tuple(float(x) for x in m) for m in re.findall(
        r"step +(\d+) loss ([\d.]+) lr ([\d.e+-]+) gnorm ([\d.]+)", text)]


def test_train_small_twin_matches_reference(monkeypatch, capsys, tmp_path):
    """Five steps of reduced qwen3-0.6b in fp32 from the same weights (the
    reference example's ``init_params(PRNGKey(0))``): the same printed
    losses, learning rates and gradient norms, to the digits printed."""
    import dataclasses

    import jax
    import numpy as np
    import torch
    from repro.configs import get_config as ref_get_config
    from repro.models import init_params
    from repro_torch.configs import get_config
    from repro_torch.models import from_jax_params

    def fp32_config(name, reduced=False):
        return dataclasses.replace(ref_get_config(name, reduced=reduced),
                                   dtype="float32")
    ref = _load("train_small")
    monkeypatch.setattr(ref, "get_config", fp32_config)
    monkeypatch.setattr(sys, "argv", [
        "train_small.py", "--steps", "5", "--ckpt-dir", str(tmp_path / "r")])
    ref.main()
    ref_lines = _train_lines(capsys.readouterr().out)

    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    params = init_params(jax.random.PRNGKey(0), fp32_config("qwen3-0.6b",
                                                            reduced=True))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu", dtype=torch.float32)
    history = _load("train_small_torch").main(
        ["--steps", "5", "--ckpt-dir", str(tmp_path / "p")], model=model)
    port_lines = _train_lines(capsys.readouterr().out)
    assert [s for s, *_ in ref_lines] == [s for s, *_ in port_lines] \
        == [0.0, 4.0]
    for (_, loss, lr, gnorm), (_, l2, lr2, g2) in zip(ref_lines, port_lines):
        assert l2 == pytest.approx(loss, abs=2e-4)
        assert lr2 == lr
        assert g2 == pytest.approx(gnorm, abs=2e-2)
    assert len(history) == 5
    assert history[4]["loss"] == pytest.approx(port_lines[1][1], abs=1e-4)
    assert (tmp_path / "p" / "step_00000005" / "params.pt").exists()
