"""What every model family's plain reference shares: fp32 PyTorch with
TF32 off, the fp8 control's rounding, the norms and RoPE of the published
layer equations, and AdamW over a family's loss.  Each family's own
equations are in ``perfbench/families/<family>.py``.  Nothing here imports
``jax`` or anything of ``repro_torch``.

``precision`` selects the arithmetic of every matmul: "fp32" with TF32
off, or "fp8", each operand rounded to float8 e4m3 with a per-tensor scale
(amax / 448) before an fp32 product: the control that has to fail the
benchmark's comparison.  Everything else runs in fp32 in both.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    """fp32 matmuls in fp32 on the card (not TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in fp32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (N, S, H, hd); rotate halves by position·theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def schedule(step: int, opt: Mapping) -> float:
    """Linear warm-up, then a cosine to ``min_lr_frac`` of ``lr``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def adamw_steps(loss_and_grads: Callable, w: Dict[str, torch.Tensor],
                cfg: Mapping, batches: List[dict], opt: Mapping,
                store_dtype: torch.dtype, precision: str = "fp32",
                rows=None) -> dict:
    """AdamW over ``batches`` from the weights ``w`` (fp32 tensors, updated
    in place) on the gradients of a family's ``loss_and_grads``:
    global-norm clipping, bias correction, decoupled decay of the
    matrices, the new value rounded to ``store_dtype`` as the
    configuration keeps its parameters.  Returns each step's loss, the
    first step's global gradient norm before clipping, each leaf's norm of
    the first clipped gradient and each leaf's change after the last
    step."""
    start = {n: t.clone() for n, t in w.items()}
    mu = {n: torch.zeros_like(t) for n, t in w.items()}
    nu = {n: torch.zeros_like(t) for n, t in w.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, first = [], {}
    gnorm1 = None
    for k, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(w, cfg, batch["tokens"], batch["labels"],
                                     precision, rows)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = schedule(k, opt)
        with torch.no_grad():
            for n, g in grads.items():
                g = g * scale
                if k == 1:
                    first[n] = float(g.norm())
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (mu[n] / (1 - b1 ** k)) / (
                    (nu[n] / (1 - b2 ** k)).sqrt() + opt["eps"])
                if w[n].dim() >= 2:
                    upd = upd + opt["weight_decay"] * w[n]
                w[n].copy_((w[n] - lr * upd).to(store_dtype).float())
        if k == 1:
            gnorm1 = gnorm
        del grads
    change = {n: float((w[n] - start[n]).norm()) for n in w}
    return {"losses": losses, "grad_norm": gnorm1, "first_grad": first,
            "change": change}
