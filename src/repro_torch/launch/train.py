"""Training launcher on one GPU (the port of ``repro/launch/train.py``).

Trains a model of the zoo with AdamW on the synthetic data pipeline, on
the card by default, and saves a checkpoint at the end when given a
directory.  Reduced configurations unless ``--full-config``.  The
reference's mesh and sharding (``--production-mesh``) wait for ROADMAP
Queue A 6 and are refused.  On the card only models whose kernels have
backwards train (attention: every dense and MoE transformer, whisper);
xlstm-1.3b and jamba raise there until Queue A 4b, and train on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 [--full-config] [--ckpt-dir D] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Transformer
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
                    help="refused: mesh and sharding are ROADMAP Queue A 6")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh: the port trains on one device; mesh "
                 "and sharding wait for ROADMAP Queue A 6")

    cfg = get_config(args.arch, reduced=not args.full_config)
    model = Transformer(cfg, device=args.device, dtype=getattr(torch,
                                                                cfg.dtype))
    opt = init_adamw(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.global_batch)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    history = []
    t0 = time.time()
    for step in range(args.steps):
        opt, metrics = step_fn(opt, make_batch(cfg, dcfg, step))
        history.append({"loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": metrics["lr"]})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {history[-1]['loss']:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f} s/step)",
                  flush=True)
    if mgr:
        mgr.save(args.steps, model.state_dict(), opt)
    print("done.")
    return history


if __name__ == "__main__":
    main()
