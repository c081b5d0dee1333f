"""The port's launch package against the reference's on the CPU: the
shapes and the H100 spec (``configs``), the roofline (``launch/roofline.py``
and the twins of tests/test_roofline.py), the sharding rules leaf for leaf
on a (1, 1) and a 4×4 mesh (``launch/sharding.py``, the reference on 16
fake XLA devices, the port on a 16-rank fake group, both in
subprocesses), the models' hooks without rules, and the train launcher's
mesh path.  The dry run is in tests/test_torch_dryrun.py, the hooks on
four real ranks in tests/test_torch_sharded*.py."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as ref_configs
import repro.launch.roofline as ref_roofline
import repro_torch.configs as port_configs
import repro_torch.launch.roofline as port_roofline
from repro_torch.core.types import H100 as H100_DEVICE
from repro_torch.launch.sharding import NamedSpec, normalize
from repro_torch.models.common import spec_placements

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
SHAPES = tuple(ref_configs.INPUT_SHAPES)
TPU_FIELDS = dataclasses.asdict(ref_configs.TPU_V5E)


def _run(args, timeout=240):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- configs -----------------------------------------------------------------

def test_input_shapes_equal_reference():
    assert {k: dataclasses.astuple(v)
            for k, v in port_configs.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v)
        for k, v in ref_configs.INPUT_SHAPES.items()}


def test_h100_spec_from_the_device_spec_data_sheet():
    hw = port_configs.H100
    assert hw.name == "h100"
    assert hw.peak_flops == H100_DEVICE.peak_flops == 989e12
    assert hw.hbm_bandwidth == H100_DEVICE.mem_bandwidth == 3.35e12
    assert hw.hbm_capacity == H100_DEVICE.mem_capacity == 80e9
    assert hw.ici_bandwidth == 450e9              # NVLink 4, a direction
    assert hw.host_link_effective == H100_DEVICE.host_link_total
    # the port carries no TPU spec
    assert not hasattr(port_configs, "TPU_V5E")
    assert set(dataclasses.asdict(hw)) == set(TPU_FIELDS)


# ---- roofline ----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_analytic_costs_equal_reference(arch, shape):
    for kw in ({}, {"weight_replicas": 16, "weight_bytes": 1.0}):
        port = port_roofline.analytic_costs(
            port_configs.get_config(arch), port_configs.INPUT_SHAPES[shape],
            **kw)
        ref = ref_roofline.analytic_costs(
            ref_configs.get_config(arch), ref_configs.INPUT_SHAPES[shape],
            **kw)
        assert port.keys() == ref.keys()
        for k in ref:
            assert port[k] == pytest.approx(ref[k], rel=1e-12), (k, kw)


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_roofline_terms_equal_reference_given_the_same_spec(arch):
    hw = port_configs.HardwareSpec(**TPU_FIELDS)
    for shape in SHAPES:
        a = port_roofline.analytic_costs(port_configs.get_config(arch),
                                         port_configs.INPUT_SHAPES[shape])
        for coll in (0.0, 3e9):
            assert port_roofline.roofline_terms(a, coll, 256, hw) == \
                ref_roofline.roofline_terms(a, coll, 256,
                                            ref_configs.TPU_V5E)


def test_analytic_matches_flop_counter_on_unrolled_smoke():
    """Twin of tests/test_roofline.py:62: the closed form against the
    FLOPs ``FlopCounterMode`` counts over the port's forward."""
    from repro_torch.models import Transformer
    cfg = port_configs.get_config("qwen3-0.6b", reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    b, s = 2, 64
    tokens = torch.zeros(b, s, dtype=torch.int32)
    with torch.no_grad():
        counted, _ = port_roofline.flop_count(
            model.forward_train, tokens, tokens, remat=False)
    shp = port_configs.InputShape("smoke", s, b, "prefill")
    analytic = port_roofline.analytic_costs(cfg, shp)["flops"]
    assert analytic == pytest.approx(counted, rel=0.35), (analytic, counted)


def test_roofline_terms_and_dominance():
    cfg = port_configs.get_config("chameleon-34b")
    a = port_roofline.analytic_costs(cfg, port_configs.INPUT_SHAPES[
        "train_4k"])
    t = port_roofline.roofline_terms(a, coll_bytes_per_dev=10e9, chips=256,
                                     hw=port_configs.H100)
    assert t["compute_s"] > 0 and t["memory_s"] > 0 and \
        t["collective_s"] > 0
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["mfu_upper_bound"] <= 1.0
    assert 0 < t["model_flops_ratio"] <= 1.0
    d = port_roofline.analytic_costs(cfg, port_configs.INPUT_SHAPES[
        "decode_32k"])
    assert a["flops"] > d["flops"] * 100


def test_decode_flops_scale_with_cache_for_full_attention():
    cfg = port_configs.get_config("granite-34b")
    d32 = port_roofline.analytic_costs(cfg, port_configs.INPUT_SHAPES[
        "decode_32k"])
    d500 = port_roofline.analytic_costs(cfg, port_configs.INPUT_SHAPES[
        "long_500k"])
    assert d500["flops"] < d32["flops"]


def test_moe_useful_ratio_accounts_active_params():
    cfg = port_configs.get_config("qwen3-moe-30b-a3b")
    a = port_roofline.analytic_costs(cfg, port_configs.INPUT_SHAPES[
        "train_4k"])
    assert 0.2 < a["useful_ratio"] <= 0.75


# ---- sharding rules ----------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x1", "4x4"])
def test_specs_equal_reference_leaf_for_leaf(mesh):
    rows, cols = mesh.split("x")
    ref = _run(["tests/_sharding_dump.py", "ref", rows, cols])
    port = _run(["tests/_sharding_dump.py", "port", rows, cols])
    assert port.keys() == ref.keys() and len(ref) == 40
    for combo in ref:
        for section in ("flags", "params", "batch", "cache", "acts"):
            assert port[combo][section] == ref[combo][section], \
                (combo, section)
    if mesh == "4x4":                 # the rules really shard there
        rec = port["qwen3-0.6b|train|16"]
        assert rec["params"]["layers.0.wq"] == ["data", "model"]
        assert port["qwen3-0.6b|decode|1"]["cache"]["layers.0.k"] == \
            [None, ["data", "model"], None, None]
        assert port["xlstm-1.3b|train|16"]["flags"] == [True, False, True]
        assert port["xlstm-1.3b|train|16"]["acts"]["residual"] == \
            [["data", "model"], None, None]


def test_pure_dp_for_attention_free_train():
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                             "size": lambda self, i=None: 1})()
    from repro_torch.launch.sharding import ShardingRules
    r = ShardingRules(port_configs.get_config("xlstm-1.3b", reduced=True),
                      mesh, "train", 16, 64)
    assert r.pure_dp and not r.tp_enabled
    r2 = ShardingRules(port_configs.get_config("qwen3-0.6b", reduced=True),
                       mesh, "train", 16, 64)
    assert not r2.pure_dp and r2.tp_enabled


def test_placements_shard_major_to_minor_as_partition_specs():
    """A tuple of axes on one dim is major to minor in JAX: mesh position
    (i, j) of a 4×4 (data, model) mesh holds chunk i*4 + j; the port's
    placements give every coordinate that chunk."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model")})()
    pl = spec_placements(mesh, normalize((("data", "model"), None)))
    assert pl == (Shard(0), Shard(0))
    for i in range(4):
        for j in range(4):
            shape, off = _compute_local_shape_and_global_offset(
                (32, 8), (4, 4), [i, j], pl)
            assert shape == (2, 8) and off == ((i * 4 + j) * 2, 0)
    assert spec_placements(mesh, (None, "model")) == (Replicate(),
                                                      Shard(1))
    with pytest.raises(ValueError, match="mesh's dim order"):
        spec_placements(mesh, (("model", "data"),))
    assert normalize((("data",), (), None)) == ("data", None, None)
    assert NamedSpec(mesh, (("data",),)).spec == ("data",)


# ---- the models' hooks ------------------------------------------------------

def test_hooks_are_no_ops_without_rules():
    from repro_torch.models import common
    x = torch.randn(2, 3, 4)
    assert common.get_sharding_rules() is None
    assert common.constrain(x, "residual") is x
    assert common.unshard_dims(x, (1,)) is x
    assert common.local_op(torch.neg, x).equal(-x)
    assert common.gather_params({"w": x})["w"] is x
    common.set_sharding_rules({"residual": NamedSpec(None, ("data",))})
    try:
        assert common.constrain(x, "residual") is x  # plain tensor
    finally:
        common.set_sharding_rules(None)


# ---- the train launcher ------------------------------------------------------

def test_train_launcher_mesh_path_equals_a_plain_step():
    """The launcher's (1, 1) host mesh and rules change nothing: its
    losses are those of ``make_train_step`` on the same batches."""
    code = r"""
import json, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import Transformer
from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                  make_batch, make_train_step)
hist = train.main(["--steps", "3", "--seq", "8", "--global-batch", "2",
                   "--device", "cpu"])
assert not dist.is_initialized()
cfg = get_config("qwen3-0.6b", reduced=True)
model = Transformer(cfg, device="cpu", dtype=getattr(torch, cfg.dtype))
step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=10,
                                          total_steps=3))
opt = init_adamw(dict(model.named_parameters()))
plain = []
for i in range(3):
    opt, m = step(opt, make_batch(cfg, DataConfig(seq_len=8,
                                                  global_batch=2), i))
    plain.append(float(m["loss"]))
print(json.dumps({"launcher": [h["loss"] for h in hist], "plain": plain}))
"""
    rec = _run(["-c", code])
    assert rec["launcher"] == rec["plain"]


def test_train_launcher_production_mesh_names_the_world_it_needs(capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--production-mesh", "--device", "cpu"])
    assert "256 ranks" in capsys.readouterr().err
