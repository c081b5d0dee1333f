"""Training launcher (the port of ``repro/launch/train.py``).

Trains a model of the zoo with AdamW on the synthetic data pipeline, on
the card by default, and saves a checkpoint at the end when given a
directory.  Reduced configurations unless ``--full-config``.  As the
reference, it builds ``ShardingRules`` over the host mesh (the ranks of
the process group: (1, 1) on one card, whose step runs as on one device)
and installs the model's hooks; on more ranks (a ``torchrun`` world) the
parameters, moments and batches are DTensors laid out by the rules.
``--production-mesh`` needs a world of 256 ranks (16×16) started by the
caller, and refuses any other.  On the card
every model trains through the kernels' backwards (attention, the mLSTM
chunk, the selective scan): xlstm-1.3b, for one, with
``--arch xlstm-1.3b --full-config``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 [--full-config] [--ckpt-dir D] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (ensure_process_group, make_host_mesh,
                                     make_production_mesh, production_world)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models import Transformer
from repro_torch.models.common import (set_param_gather, set_shard_context,
                                       set_sharding_rules)
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  init_adamw, make_batch, make_train_step)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Runs the launcher; returns the per-step metrics (floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-config", action="store_true",
                    help="the published (non-reduced) architecture")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh: needs a world of 256 ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        need = production_world()
        world = dist.get_world_size() if dist.is_initialized() \
            else int(os.environ.get("WORLD_SIZE", "1"))
        if world != need:
            ap.error(f"--production-mesh needs a world of {need} ranks "
                     f"(16x16), not {world}")

    cfg = get_config(args.arch, reduced=not args.full_config)
    if args.device is None and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))  # a card each
    model = Transformer(cfg, device=args.device, dtype=getattr(torch,
                                                                cfg.dtype))
    started = ensure_process_group(model.device.type)
    try:
        mesh = (make_production_mesh(device_type=model.device.type)
                if args.production_mesh
                else make_host_mesh(device_type=model.device.type))
        rules = ShardingRules(cfg, mesh, "train", args.global_batch,
                              args.seq)
        set_sharding_rules(rules.activation_rules())
        set_shard_context(rules.shard_context())
        if mesh.size() == 1:
            return _train(args, cfg, model)
        # more than one rank: parameters, moments and batches as DTensors
        # laid out by the rules, each layer's parameters gathered over the
        # data axes before use (FSDP); plain constants count as replicated
        for name, spec in rules.params_shardings(
                dict(model.named_parameters())).items():
            _set_param(model, name, distribute_tensor(
                model.get_parameter(name).detach(), mesh, spec.placements))
        set_param_gather(rules.dp)
        with implicit_replication():
            return _train(args, cfg, model, rules)
    finally:
        set_sharding_rules(None)
        set_shard_context(None)
        set_param_gather(None)
        if started:
            dist.destroy_process_group()


def _set_param(model, name: str, value) -> None:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    param = torch.nn.Parameter(value, requires_grad=False)
    if isinstance(mod, torch.nn.ParameterDict):
        mod[leaf] = param
    else:
        setattr(mod, leaf, param)


def _train(args, cfg, model, rules=None) -> list:
    """The loop; with ``rules`` each batch is laid out by them."""
    opt = init_adamw(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.global_batch)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    history = []
    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch(cfg, dcfg, step)
        if rules is not None:
            specs = rules.batch_shardings(batch)
            batch = {k: distribute_tensor(torch.as_tensor(v).to(
                model.device), rules.mesh, specs[k].placements)
                for k, v in batch.items()}
        opt, metrics = step_fn(opt, batch)
        history.append({"loss": _scalar(metrics["loss"]),
                        "grad_norm": _scalar(metrics["grad_norm"]),
                        "lr": metrics["lr"]})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {history[-1]['loss']:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f} s/step)",
                  flush=True)
    if mgr:
        mgr.save(args.steps, model.state_dict(), opt)
    print("done.")
    return history


def _scalar(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


if __name__ == "__main__":
    main()
