"""The port's dry run (``launch/dryrun.py``) on 4×4 fake meshes: the twin
of tests/test_sharding.py:71 against the reference's memory analysis, and
the CLI's train, decode and int8-decode records."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


def _run(args, timeout=240):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_forward_on_a_4x4_fake_mesh_matches_reference_arguments():
    """Twin of tests/test_sharding.py:71: reduced qwen3-0.6b's
    forward_train(params, batch) at batch 8, seq 64 on 16 ranks."""
    ref = _run(["-c", r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, jax.numpy as jnp, json
from repro.configs import get_config
from repro.launch.sharding import ShardingRules
from repro.models import abstract_params, forward_train, set_sharding_rules
from repro.launch.mesh import auto_axis_kwargs
mesh = jax.make_mesh((4, 4), ("data", "model"), **auto_axis_kwargs(2))
cfg = get_config("qwen3-0.6b", reduced=True)
rules = ShardingRules(cfg, mesh, "train", 8, 64)
set_sharding_rules(rules.activation_rules())
params = abstract_params(cfg)
batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32),
         "labels": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
with mesh:
    compiled = jax.jit(lambda p, b: forward_train(p, b, cfg),
                       in_shardings=(rules.params_shardings(params),
                                     rules.batch_shardings(batch))
                       ).lower(params, batch).compile()
print(json.dumps({"arg_bytes": compiled.memory_analysis()
                  .argument_size_in_bytes}))
"""])
    port = _run(["-c", r"""
import json, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.models import param_bytes
rec = dryrun.run_combo("qwen3-0.6b", "smoke", mesh_shape=(4, 4),
                       reduced=True, shp=InputShape("smoke", 64, 8, "train"),
                       loss_only=True)
cfg = get_config("qwen3-0.6b", reduced=True)
print(json.dumps({"chips": rec["chips"], "status": rec["status"],
                  "mem": rec["memory_per_device"],
                  "coll": rec["collectives"]["total_bytes"],
                  "flops": rec["cost_analysis_raw"]["flops"],
                  "param_bytes": param_bytes(cfg, torch.bfloat16)}))
"""])
    assert port["chips"] == 16 and port["status"] == "ok"
    arg = port["mem"]["argument_bytes"]
    assert 0 < arg < port["param_bytes"]
    assert arg == pytest.approx(ref["arg_bytes"], rel=0.01)
    assert port["mem"]["output_bytes"] > 0 and port["coll"] > 0
    assert port["flops"] > 0


def test_dryrun_cli_train_decode_and_int8_records(tmp_path):
    """The CLI on a 4×4 fake mesh: a reduced train step (forward, backward,
    AdamW), a decode step and its int8-weight twin; the records carry the
    reference's keys and the status line its format."""
    code = r"""
import json, os, sys
from repro_torch.launch import dryrun
out = sys.argv[1]
recs = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                    "--mesh", "4x4", "--reduced", "--out", out])
recs += dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--mesh", "4x4", "--reduced", "--out", out])
os.environ["REPRO_QUANTIZE_DECODE"] = "1"
recs += dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--mesh", "4x4", "--reduced", "--out", out + "/q"])
print(json.dumps(recs))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(ln.startswith("[ok] qwen3-0.6b_train_4k_4x4_reduced mem/dev=")
               and " coll=" in ln and " dom=" in ln for ln in lines)
    train, dec, dec8 = json.loads(lines[-1])
    ref_keys = {"arch", "shape", "mesh", "chips", "mode", "t_lower_s",
                "status", "t_compile_s", "memory_per_device",
                "cost_analysis_raw", "collectives", "analytic",
                "weight_replicas", "weight_bytes", "roofline", "fits_hbm",
                "fits_hbm_resident"}
    for rec in (train, dec, dec8):
        assert rec["status"] == "ok", rec.get("error")
        assert ref_keys <= set(rec)
        assert rec["chips"] == 16
        assert set(rec["memory_per_device"]) >= {
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes"}
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
    # the decode step writes its cache in place: outputs alias arguments;
    # the train step writes its parameters and moments in place, as the
    # reference's donated step: every output is an argument
    assert dec["memory_per_device"]["alias_bytes"] > 0
    assert train["memory_per_device"]["alias_bytes"] == \
        train["memory_per_device"]["output_bytes"] > 0
    for rec in (train, dec, dec8):
        mem = rec["memory_per_device"]
        assert mem["total_bytes"] == mem["peak_bytes"] or \
            mem["temp_bytes"] == 0
    assert train["collectives"]["counts"]["reduce-scatter"] > 0
    # int8 weights shrink the resident arguments
    assert dec8["weight_bytes"] == 1.0 and dec["weight_bytes"] == 2.0
    assert dec8["memory_per_device"]["argument_bytes"] < \
        dec["memory_per_device"]["argument_bytes"]
    assert (tmp_path / "qwen3-0.6b_train_4k_4x4_reduced.json").exists()


