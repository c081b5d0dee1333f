"""The benchmark's data: every cell file parses and names a configuration
and a driver, every metric finds its reader by name, and a cell added as
files runs through the same loaders with no existing file edited."""
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import util
from perfbench.run import cell_metrics, metric_reader

BENCH = util.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = util.cell(name)
    assert cell["config"] == entry["config"]
    assert cell["traffic"]["name"] == entry["traffic"]
    cfg = util.config(cell["config"])
    assert (util.PKG / "kinds" / f"{cfg['kind']}.py").exists()
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"perfbench/configs/{cell['config']}.json"
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_what_the_contract_asks(name):
    e2e = [m["name"] for m in cell_metrics(BENCH, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(BENCH, name, True)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader(name):
    read = metric_reader(name)
    assert read({}, "NVIDIA H100 80GB HBM3") is None


def test_serving_readers_on_observations():
    import numpy as np
    obs = {"kind": "serve", "latencies_s": np.linspace(0.1, 0.2, 101),
           "seconds": 10.0, "completed_in_window": 500, "completed": 520,
           "stage_calls": [140, 140], "batch": 4, "comm_frac": 0.01,
           "compute_time_s": 14.0, "query_flops": 1.7e12,
           "utilization": [80.0, 90.0], "setup_s": 20.0}
    dev = "NVIDIA H100 80GB HBM3"
    assert metric_reader("p99_ms")(obs, dev) == pytest.approx(199.0)
    assert metric_reader("p50_ms")(obs, dev) == pytest.approx(150.0)
    assert metric_reader("served_qps")(obs, dev) == 50.0
    assert metric_reader("batch_fill.steady")(obs, dev) == pytest.approx(
        100 * 520 * 2 / (280 * 4))
    assert metric_reader("stage_call_ms.overload")(obs, dev) == 50.0
    assert metric_reader("prefill_mfu.overload")(obs, dev) == pytest.approx(
        100 * 500 * 1.7e12 / (10 * 989e12))
    assert metric_reader("busy_share.steady")(obs, dev) == 85.0


def test_training_readers_on_observations():
    obs = {"kind": "train", "tokens": 16384 * 40, "window_s": 25.0,
           "steps": 40, "step_flops": 7.0e13, "enqueue_s": [0.2, 0.3],
           "busy_s": 0.9, "trace_window_s": 1.0, "batch": 8, "seq_len": 2048,
           "config": util.config("qwen3-0.6b"),
           "kernels": {"void flash_attention_bf16_kernel<128>(x)": [56, 0.1],
                       "bwd_delta_kernel": [56, 0.01],
                       "bwd_dq_wgmma_kernel": [56, 0.2],
                       "bwd_dkdv_wgmma_kernel": [56, 0.25]}}
    dev = "NVIDIA H100 80GB HBM3"
    assert metric_reader("train_tokens_per_s")(obs, dev) == 16384 * 40 / 25
    assert metric_reader("step_enqueue_ms.train")(obs, dev) == \
        pytest.approx(250.0)
    assert metric_reader("idle_share.train")(obs, dev) == pytest.approx(10.0)
    assert metric_reader("train_mfu")(obs, dev) == pytest.approx(
        100 * 7e13 * 40 / 25 / 989e12)
    fwd = metric_reader("attn_fwd_roofline.train")(obs, dev)
    bwd = metric_reader("attn_bwd_roofline.train")(obs, dev)
    # B 8: twice PERF.md's B 4 bound a launch (0.139 ms; 0.347 ms)
    assert fwd == pytest.approx(100 * 56 * 0.1393e-3 / 0.1, rel=0.01)
    assert bwd == pytest.approx(100 * 56 * 0.3476e-3 / 0.46, rel=0.01)


# the copy's probe: its loaders find the added cell, configuration, kind
# and every metric's reader; with "check", the serving check runs on the
# CPU at the port's reduced sizes (as test_bench_checks.serve_run does)
PROBE = """
import importlib, json, sys, time
root, name, check = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, root)
from perfbench import util
from perfbench.run import RunContext, cell_metrics, drive, metric_reader, result
assert str(util.PKG).startswith(root)
c = util.cell(name)
cfg = util.config(c["config"])
importlib.import_module("perfbench.kinds." + cfg["kind"])
b = util.benchmark()
ms = cell_metrics(b, name, 0) + cell_metrics(b, name, 1)
[metric_reader(m["name"]) for m in ms]
out = {"rate_qps": c["traffic"]["rate_qps"], "metrics": len(ms)}
if check:
    cfg["stages"] = [util.reduced(s) for s in cfg["stages"]]
    c["traffic"].update(rate_qps=20.0, prompt_tokens=32, warmup_seconds=0.5,
                        check_queries=16)
    ctx = RunContext(name, c, cfg, 2 ** 31 + 777, 2.0, False, "cpu",
                     time.time(), reduced=True)
    res = result(ctx, drive(ctx), cell_metrics(b, name, False),
                 {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0})
    out.update(correct=res["correct"], checks=res["checks"], families={
        k: m.__file__ for k, m in sys.modules.items()
        if k.startswith("perfbench.families.")})
print(json.dumps(out))
"""


@pytest.mark.parametrize("added", ["traffic", "family"])
def test_a_cell_added_as_files_needs_no_edit(tmp_path, added):
    """A copy of the benchmark with one cell more, added as files and
    entries of BENCHMARK.json, with no existing file edited.

    - "traffic": a cell file, a new traffic mix on img-to-img: the copy's
      own loaders find the cell, its configuration, its kind and every
      metric's reader;
    - "family": a new model family (a copy of ``families/qwen.py`` under
      another name), a configuration whose stage 1 names it, and a cell
      on it: the same, and the serving check runs on the CPU at reduced
      size through the new family's file, and is correct."""
    pkg = tmp_path / "perfbench"
    shutil.copytree(util.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((util.ROOT / "BENCHMARK.json").read_text())
    cell = util.cell("img-to-img.steady")
    if added == "traffic":
        name, config = "img-to-img.slow", "img-to-img"
        cell["traffic"] = {**cell["traffic"], "name": "steady-slow",
                           "rate_qps": 10.0}
    else:
        name, config = "img-to-img-twin.steady", "img-to-img-twin"
        shutil.copy(pkg / "families" / "qwen.py", pkg / "families" /
                    "qwen_twin.py")
        cfg = json.loads((pkg / "configs" / "img-to-img.json").read_text())
        cfg["name"] = config
        cfg["stages"][1]["family"] = "qwen_twin"
        (pkg / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        conf = next(c for c in bench["configs"] if c["name"] == "img-to-img")
        bench["configs"].append({**conf, "name": config,
                                 "file": f"perfbench/configs/{config}.json"})
        cell["config"] = config
    (pkg / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": cell["traffic"]["name"],
                               "chips": 1, "why": "a cell added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "img-to-img.steady" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in util.PKG.rglob("*"):          # nothing there was edited
        if path.is_file() and "__pycache__" not in path.parts and \
                "tests" not in path.relative_to(util.PKG).parts:
            assert (pkg / path.relative_to(util.PKG)).read_bytes() == \
                path.read_bytes(), path
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(tmp_path), name,
         "1" if added == "family" else "0"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(util.ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["metrics"] == 7
    if added == "traffic":
        assert got["rate_qps"] == 10.0
        return
    assert got["correct"], got["checks"]
    assert got["checks"]["checked_queries"]["value"] > 0
    assert got["families"] == {
        "perfbench.families.qwen": str(pkg / "families" / "qwen.py"),
        "perfbench.families.qwen_twin": str(pkg / "families" /
                                            "qwen_twin.py")}
