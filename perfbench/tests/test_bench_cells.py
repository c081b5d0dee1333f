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


def test_a_cell_added_as_files_needs_no_edit(tmp_path):
    """A copy of the benchmark with one cell more, added as a cell file and
    an entry of BENCHMARK.json: the copy's own loaders find the cell, its
    configuration, its driver and every metric's reader."""
    shutil.copytree(util.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((util.ROOT / "BENCHMARK.json").read_text())
    cell = util.cell("img-to-img.steady")
    cell["traffic"] = {**cell["traffic"], "name": "steady-slow",
                       "rate_qps": 10.0}
    (tmp_path / "perfbench" / "workloads" / "img-to-img.slow.json").write_text(
        json.dumps(cell))
    bench["workloads"].append({"name": "img-to-img.slow",
                               "config": "img-to-img",
                               "traffic": "steady-slow", "chips": 1,
                               "why": "a cell added as data"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "img-to-img.steady" in m.get("workloads", []):
            m["workloads"].append("img-to-img.slow")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys, importlib; sys.path.insert(0, sys.argv[1]);"
        "from perfbench import util; from perfbench.run import "
        "cell_metrics, metric_reader;"
        "assert str(util.PKG).startswith(sys.argv[1]);"
        "c = util.cell('img-to-img.slow'); cfg = util.config(c['config']);"
        "importlib.import_module('perfbench.kinds.' + cfg['kind']);"
        "b = util.benchmark();"
        "ms = cell_metrics(b, 'img-to-img.slow', 0) + "
        "cell_metrics(b, 'img-to-img.slow', 1);"
        "[metric_reader(m['name']) for m in ms];"
        "print(c['traffic']['rate_qps'], len(ms))")
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(util.ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10.0", "7"]
