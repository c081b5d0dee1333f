"""The two packages' dry runs of one combo side by side: per-device memory,
collective bytes by kind and FLOPs, from the reference's compiled HLO
(XLA's SPMD partitioner) and from the port's DTensor run.

  python tests/_dryrun_compare.py [ROWSxCOLS]      (default 4x4)

Runs reduced qwen3-0.6b's train step (batch 16, seq 64), prefill (batch 8,
seq 64) and decode step (batch 8 against a 256-deep cache) on a (data,
model) mesh: the reference in a process with that many fake XLA host
devices, the port in a process on a fake group of that many ranks.
Prints one JSON line per combo: {"combo", "ref": {...}, "port": {...}}.
A full-size combo is not run here: its XLA compile needs a large host."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COMBOS = (("train_4k", 64, 16), ("prefill_32k", 64, 8),
          ("decode_32k", 256, 8))

REF = r"""
import os, sys, json
rows, cols = (int(x) for x in sys.argv[1].split("x"))
os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={rows * cols}"
import jax
import repro.configs.base as cb
import repro.launch.dryrun as dr
import repro.launch.mesh as lm
from repro.configs import get_config
from repro.configs.base import InputShape
lm.make_production_mesh = dr.make_production_mesh = \
    lambda multi_pod=False: jax.make_mesh(
        (rows, cols), ("data", "model"), **lm.auto_axis_kwargs(2))
dr.get_config = lambda arch, reduced=False: get_config(arch, reduced=True)
for name, seq, batch in json.loads(sys.argv[2]):
    kind = cb.INPUT_SHAPES[name].kind
    cb.INPUT_SHAPES["cmp"] = InputShape("cmp", seq, batch, kind)
    dr.INPUT_SHAPES = cb.INPUT_SHAPES
    rec = dr.run_combo("qwen3-0.6b", "cmp")
    print(json.dumps({"combo": name, "memory": rec["memory_per_device"],
                      "collectives": {k: v for k, v in
                                      rec["collectives"].items()
                                      if k != "while_trip_counts"},
                      "flops": rec["cost_analysis_raw"]["flops"]}))
"""

PORT = r"""
import sys, json
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun
rows, cols = (int(x) for x in sys.argv[1].split("x"))
for name, seq, batch in json.loads(sys.argv[2]):
    shp = InputShape("cmp", seq, batch, INPUT_SHAPES[name].kind)
    rec = dryrun.run_combo("qwen3-0.6b", name, mesh_shape=(rows, cols),
                           reduced=True, shp=shp)
    print(json.dumps({"combo": name, "memory": rec["memory_per_device"],
                      "collectives": {k: v for k, v in
                                      rec["collectives"].items()
                                      if k != "while_trip_counts"},
                      "flops": rec["cost_analysis_raw"]["flops"]}))
"""


def _records(code: str, mesh: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, mesh,
                          json.dumps(COMBOS)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise SystemExit(out.stderr[-3000:])
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    return {r.pop("combo"): r for r in recs}


def main(mesh: str = "4x4") -> None:
    ref, port = _records(REF, mesh), _records(PORT, mesh)
    for name, _, _ in COMBOS:
        print(json.dumps({"combo": name, "mesh": mesh, "ref": ref[name],
                          "port": port[name]}))


if __name__ == "__main__":
    main(*sys.argv[1:])
