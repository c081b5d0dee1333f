"""Multi-pod dry run of the port: trace every (architecture × input shape)
on the production meshes with no card and extract the roofline inputs
(the counterpart of ``repro/launch/dryrun.py``).

How it traces: the process joins a fake process group of the mesh's world
(``torch.testing``'s "fake" backend: collectives return at once, nothing
moves), builds the model on the ``meta`` device and gives it DTensor
parameters on the mesh, each a fake local shard laid out by
``ShardingRules``; the combo's step then runs eagerly under
``FakeTensorMode`` with the rules installed, through the kernels' plain
versions (the tensors are CPU fakes), as the reference traces with
``impl="xla"``.  The train step is ``forward_train`` + backward + the
port's AdamW; prefill is ``serve_prefill``; decode one ``serve_decode``
step against a seq_len-deep cache.

Per combo this writes a JSON record with the reference's keys:
  - ``memory_per_device`` from ``MemTracker`` over the step, mapped onto
    the reference's ``memory_analysis`` fields: ``argument_bytes`` = the
    local shards of the parameters, optimizer state and batch (or cache)
    held before the step; ``output_bytes`` = what the step returns (the
    parameters and optimizer state, the logits and new cache);
    ``alias_bytes`` = outputs that are argument storage (the decode
    cache, and the train step's parameters and moments, written in place
    as the reference's donated ones); ``temp_bytes`` = the peak above
    arguments + outputs − alias; ``total_bytes`` their sum;
  - ``cost_analysis_raw``: FLOPs from ``FlopCounterMode`` over the step
    (per device: the local shards' products), bytes not counted;
  - ``collectives``: per-device bytes of the collectives the partitioner
    inserted (``roofline.CollectiveCounter``);
  - ``analytic`` and ``roofline`` on the H100 spec (``configs.H100``);
    ``fits_hbm`` and ``fits_hbm_resident`` against its 80 GB.
``REPRO_QUANTIZE_DECODE=1`` keeps the reference's switch: decode weight
matrices held as int8 with a per-tensor fp32 scale, dequantised to bf16
into each product.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      [--multi-pod] [--mesh 4x4] [--reduced]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

A process joins one fake group: run the dry run as its own process, never
beside work on the card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, H100, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import (axis_names, dp_size,
                                     make_production_mesh, production_world)
from repro_torch.launch.roofline import (ShardCounter, analytic_costs,
                                         in_sharding_propagation,
                                         roofline_terms)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models.common import (set_param_gather, set_shard_context,
                                       set_sharding_rules)

def init_fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0."""
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: Optional[tuple] = None, multi_pod: bool = False):
    """The production mesh on a fake group, or a (data, model) mesh of
    ``shape`` (a reduced check, e.g. (4, 4))."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        init_fake_world(production_world(multi_pod))
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    init_fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def install(rules: Optional[ShardingRules]) -> None:
    """The model hooks of one combo's rules (``None``: removed): the
    activation rules, the shard-local dispatch context and, in training,
    the FSDP gather over the data axes."""
    set_sharding_rules(rules and rules.activation_rules())
    set_shard_context(rules and rules.shard_context())
    set_param_gather(rules.dp if rules and rules.mode == "train" else None)


def input_specs(cfg, shp: InputShape) -> dict:
    """(shape, dtype) of every model input of this combo."""
    b, s = shp.global_batch, shp.seq_len
    i32 = torch.int32
    if shp.kind == "train":
        out = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
    elif shp.kind == "prefill":
        out = {"tokens": ((b, s), i32)}
    else:                     # decode: one new token a sequence
        return {"tokens": ((b,), i32)}
    if cfg.encoder_decoder:
        out["frames"] = ((b, cfg.encoder_seq_len, cfg.d_model),
                         torch.bfloat16)
    return out


def _local(global_shape, mesh, placements) -> tuple:
    """A shard's shape: every rule shards only dims that divide."""
    from torch.distributed.tensor import Shard
    local = list(global_shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            assert local[p.dim] % mesh.size(i) == 0, (global_shape, p)
            local[p.dim] //= mesh.size(i)
    return tuple(local)


def _dtensor(shape, dtype, spec):
    """A DTensor of global ``shape`` laid out by ``spec`` (a NamedSpec),
    its local shard an empty ``meta`` tensor."""
    from torch.distributed.tensor import DTensor
    pl = spec.placements
    local = torch.empty(_local(tuple(shape), spec.mesh, pl), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, spec.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _mem_tracker():
    """``MemTracker`` that leaves out the ops of DTensor's sharding
    propagation (global-shaped stand-ins: no device's memory), whichever
    way the installed torch runs them."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class ShardMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_sharding_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return ShardMemTracker()


class _ViewAsReshape(TorchDispatchMode):
    """DTensor's sharding propagation turns some reshapes of the backward
    into ``view`` calls on the local shards, and a shard laid out
    transposed (the strided output of a redistribution) cannot be viewed.
    Eager ``reshape`` copies there; so does this mode, for the local
    (plain) tensors of the traced step only."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops.aten.view.default and \
                isinstance(args[0], torch.Tensor) and \
                not args[0].is_contiguous():
            return torch.ops.aten._unsafe_view.default(
                args[0].contiguous(), *args[1:], **kwargs)
        return func(*args, **kwargs)


def _set_param(model, name: str, value) -> None:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    param = torch.nn.Parameter(value, requires_grad=False)
    if isinstance(mod, torch.nn.ParameterDict):
        mod[leaf] = param
    else:
        setattr(mod, leaf, param)


def _nbytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _quantized(model, mesh):
    """The reference's ``REPRO_QUANTIZE_DECODE`` storage: every bf16
    weight matrix as an int8 shard with a per-tensor fp32 scale."""
    from repro_torch.launch.sharding import NamedSpec
    q, scales = {}, {}
    for name, p in model.named_parameters():
        if p.ndim >= 2 and p.dtype == torch.bfloat16:
            q[name] = _dtensor(p.shape, torch.int8,
                               NamedSpec(mesh, _spec_of(p)))
            scales[name] = _dtensor((), torch.float32, NamedSpec(mesh, ()))
    return q, scales


def _spec_of(t) -> tuple:
    """A DTensor's spec (one entry per dim) from its placements."""
    from torch.distributed.tensor import Shard
    spec = [[] for _ in range(t.ndim)]
    names = t.device_mesh.mesh_dim_names
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            spec[p.dim].append(names[i])
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in spec)


def _lower_combo(arch: str, shape_name: str, mesh, *, reduced: bool = False,
                 shp: Optional[InputShape] = None, remat: bool = True,
                 loss_only: bool = False):
    """Builds the combo on ``mesh`` and returns (cfg, shp, rules, the step
    as a no-argument callable, its argument leaves).  Every tensor is a ``meta`` tensor: its shape, dtype and
    storage size without memory.  ``loss_only``: a train combo's program
    is ``forward_train(params, batch)`` alone."""
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import ModelCache
    from repro_torch.training import AdamWConfig, init_adamw
    from repro_torch.training.optimizer import adamw_update

    cfg = get_config(arch, reduced=reduced)
    shp = shp or INPUT_SHAPES[shape_name]
    b, s = shp.global_batch, shp.seq_len
    rules = ShardingRules(cfg, mesh, shp.kind, global_batch=b, seq_len=s)
    dtype = getattr(torch, cfg.dtype)
    plain = dict(attention=ops.flash_attention_plain,
                 mlstm=ops.mlstm_chunk_plain, ssm=ops.ssm_scan_plain)
    model = Transformer(cfg, device="meta", dtype=dtype, init=False)
    named = dict(model.named_parameters())
    psh = rules.params_shardings(named)
    for n, p in named.items():
        _set_param(model, n, _dtensor(p.shape, p.dtype, psh[n]))
    params = dict(model.named_parameters())
    specs = input_specs(cfg, shp)
    bsh = rules.batch_shardings({k: torch.empty(sh, device="meta")
                                 for k, (sh, _) in specs.items()})
    ins = {k: _dtensor(sh, dt, bsh[k]) for k, (sh, dt) in specs.items()}
    if shp.kind == "train" and loss_only:
        def step():
            with torch.no_grad():
                return model.forward_train(ins["tokens"], ins["labels"],
                                           ins.get("frames"), remat=remat,
                                           **plain)
        return cfg, shp, rules, step, list(params.values()) \
            + _leaves(ins)
    if shp.kind == "train":
        osh = rules.opt_shardings(None, named)
        opt = init_adamw(named)._replace(
            mu={n: _dtensor(p.shape, torch.float32, osh.mu[n])
                for n, p in named.items()},
            nu={n: _dtensor(p.shape, torch.float32, osh.nu[n])
                for n, p in named.items()})
        names, plist = list(params), list(params.values())
        opt_cfg = AdamWConfig()

        def step():
            for p in plist:
                p.requires_grad_(True)
            loss = model.forward_train(ins["tokens"], ins["labels"],
                                       ins.get("frames"), remat=remat,
                                       **plain)
            grads = torch.autograd.grad(loss, plist)
            for p in plist:
                p.requires_grad_(False)
            return adamw_update(dict(zip(names, grads)), opt, params,
                                opt_cfg)[:2]
        args = plist + _leaves(opt.mu) + _leaves(opt.nu) + _leaves(ins)
        return cfg, shp, rules, step, args
    if shp.kind == "prefill":
        def step():
            with torch.no_grad():
                return model.serve_prefill(ins["tokens"], cache_len=s,
                                           frames=ins.get("frames"), **plain)
        return cfg, shp, rules, step, list(params.values()) \
            + _leaves(ins)
    # decode: one step against a seq_len-deep cache
    meta_cache = model.init_cache(b, s)
    cross = None
    if cfg.encoder_decoder:
        from repro_torch.models.attention import make_kv_cache
        cross = [make_kv_cache(b, cfg.encoder_seq_len, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, "meta")
                 for _ in range(cfg.num_layers)]
    csh = rules.cache_shardings(ModelCache(meta_cache, s, cross))

    def dist_state(st, sh):
        return type(st)(*(_dtensor(t.shape, t.dtype, spec)
                          for t, spec in zip(st, sh)))
    cache = ModelCache(
        [dist_state(st, sh) for st, sh in zip(meta_cache, csh.layers)],
        s - 1, None if cross is None else
        [dist_state(st, sh) for st, sh in zip(cross, csh.cross)])
    argp = list(params.values())
    qp, scales = {}, {}
    if os.environ.get("REPRO_QUANTIZE_DECODE") == "1":
        qp, scales = _quantized(model, mesh)
        argp = [qp.get(n, p) for n, p in params.items()] \
            + list(scales.values())

    def step():
        with torch.no_grad():
            for n, w in qp.items():      # dequantised into the products
                _set_param(model, n, w.to(torch.bfloat16)
                           * scales[n].to(torch.bfloat16))
            return model.serve_decode(
                ins["tokens"], cache,
                decode_attention=ops.decode_attention_plain)
    return cfg, shp, rules, step, argp + _leaves(cache) + _leaves(ins)


def run_combo(arch: str, shape_name: str, multi_pod: bool = False,
              compile_: bool = True, *, mesh_shape: Optional[tuple] = None,
              reduced: bool = False, shp: Optional[InputShape] = None,
              loss_only: bool = False) -> dict:
    """One combo's record (the reference's keys; see the module's doc)."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    mesh = make_mesh(mesh_shape, multi_pod)
    n_chips = mesh.size()
    cfg, shp, rules, step, args = _lower_combo(
        arch, shape_name, mesh, reduced=reduced, shp=shp,
        loss_only=loss_only)
    tag = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    rec = {"arch": arch, "shape": shp.name, "mesh": tag,
           "mesh_axes": list(axis_names(mesh)), "chips": int(n_chips),
           "mode": shp.kind, "t_lower_s": round(time.time() - t0, 2),
           "status": "lowered"}
    if not compile_:
        return rec
    t0 = time.time()
    counter = ShardCounter()
    arg_b = _nbytes(args)
    install(rules)
    try:
        with implicit_replication():
            mt = _mem_tracker()
            mt.track_external(*args)
            with mt, counter, _ViewAsReshape():
                out = step()
            snap = mt.get_tracker_snapshot("peak")
            peak = max((v.get("Total", 0) for v in snap.values()),
                       default=0)
    finally:
        install(None)
    rec["t_compile_s"] = round(time.time() - t0, 2)
    outs = _leaves(out)
    out_b = _nbytes(outs)
    arg_ids = {id(a) for a in args}
    alias_b = _nbytes([t for t in outs if id(t) in arg_ids])
    resident = arg_b + out_b - alias_b
    temp_b = max(0, int(peak) - resident)
    rec["memory_per_device"] = {
        "argument_bytes": int(arg_b), "output_bytes": int(out_b),
        "temp_bytes": int(temp_b), "alias_bytes": int(alias_b),
        "total_bytes": int(resident + temp_b), "peak_bytes": int(peak)}
    rec["cost_analysis_raw"] = {"flops": counter.flops,
                                "bytes_accessed": 0.0}
    rec["collectives"] = counter.summary()
    # inference shards weights over the model axis only: every data-
    # parallel replica group re-reads its own weight copy each step
    replicas = dp_size(mesh) if shp.kind in ("prefill", "decode") else 1
    wb = 1.0 if os.environ.get("REPRO_QUANTIZE_DECODE") == "1" \
        and shp.kind == "decode" else 2.0
    analytic = analytic_costs(cfg, shp, weight_replicas=replicas,
                              weight_bytes=wb)
    rec["analytic"] = analytic
    rec["weight_replicas"] = replicas
    rec["weight_bytes"] = wb
    rec["roofline"] = roofline_terms(analytic,
                                     rec["collectives"]["total_bytes"],
                                     n_chips, H100)
    rec["status"] = "ok"
    rec["fits_hbm"] = bool(resident + temp_b <= H100.hbm_capacity)
    rec["fits_hbm_resident"] = bool(resident <= H100.hbm_capacity)
    return rec


def status_line(rec: dict, tag: str) -> str:
    """The reference's ``[status] tag mem/dev=… coll=… dom=…`` line."""
    mem = rec.get("memory_per_device", {}).get("total_bytes", 0) / 1e9
    return (f"[{rec['status']}] {tag} mem/dev={mem:.2f}GB "
            f"coll={rec.get('collectives', {}).get('total_bytes', 0)/1e9:.2f}"
            f"GB dom={rec.get('roofline', {}).get('dominant', '-')}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="ROWSxCOLS (data, model) instead of the "
                    "production mesh, e.g. 4x4")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configuration of the arch")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) \
        if args.mesh else None
    combos = ([(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    mesh_tag = args.mesh or ("multipod" if args.multi_pod else "pod")
    recs = []
    for arch, shape in combos:
        tag = f"{arch}_{shape}_{mesh_tag}" + ("_reduced" if args.reduced
                                              else "")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        try:
            rec = run_combo(arch, shape, multi_pod=args.multi_pod,
                            compile_=not args.no_compile,
                            mesh_shape=mesh_shape, reduced=args.reduced)
        except Exception as e:   # noqa: BLE001 — record the failure
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        recs.append(rec)
        print(status_line(rec, tag), flush=True)
    return recs


if __name__ == "__main__":
    main()
