"""Train a model for a few hundred steps with the full substrate of the
PyTorch/CUDA port: synthetic data pipeline, AdamW with the cosine schedule,
periodic checkpoints, resume.  The twin of ``examples/train_small.py``.

On the card by default, at the published width (the loss's attention runs
forward and backward through the hand-written kernels); ``--reduced
--device cpu`` trains the reduced model on the CPU, as the reference
example does.  ``main`` returns each step's metrics, and takes an initial
model in place of the seeded one.

Run:  PYTHONPATH=src python examples/train_small_torch.py --arch qwen3-0.6b \\
          --steps 200 [--resume]
      PYTHONPATH=src python examples/train_small_torch.py --reduced --device cpu
"""
import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.models import Transformer
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  init_adamw, make_batch, make_train_step)

CKPT_DIR = Path(__file__).resolve().parents[1] / "checkpoints" / \
    "train_small_torch"


def main(argv: Optional[Sequence[str]] = None,
         model: Optional[Transformer] = None) -> list:
    """Trains; returns each step's {"loss", "lr", "grad_norm"}.  With
    ``model`` given, trains that model (its config, device and dtype) and
    ignores ``--arch``, ``--reduced`` and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced model (the reference example's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = Transformer(cfg, device=args.device,
                            dtype=getattr(torch, cfg.dtype))
    cfg = model.cfg
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}")
    opt = init_adamw(dict(model.named_parameters()))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start = mgr.latest_step()
        params, opt = mgr.restore(start, model.state_dict(), opt)
        model.load_state_dict(params)
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)

    history = []
    t0 = time.time()
    for step in range(start, args.steps):
        opt, metrics = step_fn(opt, make_batch(cfg, dcfg, step))
        history.append({"loss": float(metrics["loss"]), "lr": metrics["lr"],
                        "grad_norm": float(metrics["grad_norm"])})
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {history[-1]['grad_norm']:.2f} "
                  f"({dt / max(step - start, 1):.2f} s/step)")
        if step > start and step % args.ckpt_every == 0:
            path = mgr.save(step, model.state_dict(), opt)
            print(f"  checkpoint -> {path}")
    mgr.save(args.steps, model.state_dict(), opt)
    print("done.")
    return history


if __name__ == "__main__":
    main()
