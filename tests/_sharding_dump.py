"""Every sharding spec of the reduced zoo as JSON, keyed by the port's leaf
names, from one package on one mesh; ``tests/test_torch_launch.py`` runs
it in subprocesses and compares the two packages' output.

  python tests/_sharding_dump.py ref|port ROWS COLS

``ref``: the reference's ``ShardingRules`` on a JAX mesh of ROWS×COLS
devices (fake XLA host devices past one); ``port``: the port's on a
``DeviceMesh`` over a process group of ROWS×COLS ranks (a one-rank gloo
group for 1×1, else a fake group).  Specs print as lists of entries
(``None``, an axis name, or a list of axis names)."""
import json
import os
import sys

COMBOS = (("train", 16, 64), ("prefill", 8, 64), ("decode", 8, 64),
          ("decode", 1, 64))


def _jsonable(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def dump_ref(rows, cols):
    if rows * cols > 1:
        os.environ["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={rows * cols}"
    import jax
    from repro.configs import ARCH_IDS, get_config
    from repro.launch.mesh import auto_axis_kwargs
    from repro.launch.sharding import ShardingRules
    from repro.models import abstract_cache, abstract_params
    from repro_torch.models.transformer import _flat_block

    mesh = jax.make_mesh((rows, cols), ("data", "model"),
                         **auto_axis_kwargs(2))
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        period = len(cfg.block_pattern)
        for mode, b, s in COMBOS:
            r = ShardingRules(cfg, mesh, mode, b, s)
            params = abstract_params(cfg)
            sh = r.params_shardings(params)
            rec = {"params": {}, "flags": [r.pure_dp, r.tp_enabled,
                                           r.batch_shardable]}
            for top in ("embed", "final_norm", "lm_head", "enc_final_norm"):
                if top in sh:
                    rec["params"][top] = _jsonable(sh[top].spec)

            def stacked(flat, prefix, layers):
                for n, ns in flat.items():
                    spec = tuple(ns.spec) + (None,) * (
                        len(flat_shapes[n]) - len(ns.spec))
                    assert spec[0] is None, (n, spec)
                    for li in layers:
                        rec["params"][f"{prefix}.{li}.{n}"] = \
                            _jsonable(spec[1:])
            for j in range(period):
                flat = _flat_block(sh["blocks"][j])
                flat_shapes = {n: x.shape for n, x in
                               _flat_block(params["blocks"][j]).items()}
                stacked(flat, "layers", range(j, cfg.num_layers, period))
            if cfg.encoder_decoder:
                flat = _flat_block(sh["enc_blocks"])
                flat_shapes = {n: x.shape for n, x in
                               _flat_block(params["enc_blocks"]).items()}
                stacked(flat, "enc_layers", range(cfg.num_encoder_layers))
            batch = {"tokens": jax.ShapeDtypeStruct((b, s), "int32"),
                     "labels": jax.ShapeDtypeStruct((b, s), "int32")}
            rec["batch"] = {k: _jsonable(v.spec) for k, v in
                            r.batch_shardings(batch).items()}
            rec["cache"] = {}
            if mode == "train":              # no cache in training
                out[f"{arch}|{mode}|{b}"] = rec
                rec["acts"] = {k: None if v is None else _jsonable(v.spec)
                               for k, v in r.activation_rules().items()}
                continue
            cache = abstract_cache(cfg, b, s)
            csh = r.cache_shardings(cache)
            for j in range(period):
                for f in cache.blocks[j]._fields:
                    spec = getattr(csh.blocks[j], f).spec
                    nd = getattr(cache.blocks[j], f).ndim
                    spec = tuple(spec) + (None,) * (nd - len(spec))
                    for li in range(j, cfg.num_layers, period):
                        rec["cache"][f"layers.{li}.{f}"] = _jsonable(spec[1:])
                    if cache.cross is not None:
                        spec = getattr(csh.cross[j], f).spec
                        spec = tuple(spec) + (None,) * (nd - len(spec))
                        for li in range(j, cfg.num_layers, period):
                            rec["cache"][f"cross.{li}.{f}"] = \
                                _jsonable(spec[1:])
            rec["cache"]["pos"] = _jsonable(csh.pos.spec)
            rec["acts"] = {k: None if v is None else _jsonable(v.spec)
                           for k, v in r.activation_rules().items()}
            out[f"{arch}|{mode}|{b}"] = rec
    return out


def dump_port(rows, cols):
    import torch
    import torch.distributed as dist
    if rows * cols > 1:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=rows * cols)
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.models import Transformer
    from repro_torch.training import init_adamw

    ensure_process_group("cpu")
    mesh = make_host_mesh(model_axis=cols, device_type="cpu")
    assert tuple(mesh.shape) == (rows, cols), mesh
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        model = Transformer(cfg, device="meta", init=False)
        named = dict(model.named_parameters())
        for mode, b, s in COMBOS:
            r = ShardingRules(cfg, mesh, mode, b, s)
            sh = r.params_shardings(named)
            rec = {"params": {n: _jsonable(v.spec) for n, v in sh.items()},
                   "flags": [r.pure_dp, r.tp_enabled, r.batch_shardable]}
            opt = r.opt_shardings(init_adamw(named), named)
            assert opt.mu == sh and opt.nu == sh and opt.step.spec == ()
            for v in sh.values():          # every spec makes placements
                assert len(v.placements) == 2
            batch = {"tokens": torch.empty(b, s, device="meta"),
                     "labels": torch.empty(b, s, device="meta")}
            rec["batch"] = {k: _jsonable(v.spec) for k, v in
                            r.batch_shardings(batch).items()}
            rec["acts"] = {k: None if v is None else _jsonable(v.spec)
                           for k, v in r.activation_rules().items()}
            rec["cache"] = {}
            out[f"{arch}|{mode}|{b}"] = rec
            if mode == "train":              # no cache in training
                continue
            cache = model.init_cache(b, s)
            csh = r.cache_shardings(type("C", (), {
                "layers": cache, "cross": None if not cfg.encoder_decoder
                else [model.init_cache(b, cfg.encoder_seq_len)[li]
                      for li in range(cfg.num_layers)]})())
            for li, st in enumerate(csh.layers):
                for f in st._fields:
                    rec["cache"][f"layers.{li}.{f}"] = \
                        _jsonable(getattr(st, f).spec)
            for li, st in enumerate(csh.cross or []):
                for f in st._fields:
                    rec["cache"][f"cross.{li}.{f}"] = \
                        _jsonable(getattr(st, f).spec)
            rec["cache"]["pos"] = _jsonable(csh.pos.spec)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    which, rows, cols = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    rec = (dump_ref if which == "ref" else dump_port)(rows, cols)
    print(json.dumps(rec, sort_keys=True))
