"""AdamW, functional, on a dict of named tensors (the port of
``repro/training/optimizer.py``).

State: fp32 first and second moments per leaf and the step count.
Global-norm gradient clipping, a cosine learning-rate schedule with linear
warm-up, and bias correction at ``step + 1``, as in the reference.  The
update runs in fp32 and is cast back to each leaf's dtype, so the leaves
a bf16 model keeps in fp32 stay fp32.

Weight decay applies to the leaves that are matrices in one layer.  The
reference decays a leaf when ``p.ndim >= 2`` to spare norms and biases,
but it stacks every block parameter on a leading superblock axis, so its
per-layer norm scales, qk-norm scales and biases are 2-D there and get
decayed (all but ``final_norm`` and ``enc_final_norm``).  The port's
leaves are per layer, so the same rule decays exactly the matrices, as
the reference meant (ROADMAP Queue C 4): the port diverges from the
reference in the decay of those vectors and nowhere else.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Tensors
    nu: Tensors


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_adamw(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero fp32 moments beside each leaf, on its device; step 0."""
    def zeros():          # laid out as the leaf (a DTensor's placements)
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(step: int, cfg: AdamWConfig) -> float:
    """The learning rate at ``step``: linear warm-up over ``warmup_steps``,
    then a cosine from ``lr`` down to ``min_lr_frac * lr`` at
    ``total_steps`` (computed in fp32, as the reference)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tensors.values()))


def decays(p: torch.Tensor) -> bool:
    """Whether weight decay applies to a per-layer leaf: its matrices (and
    stacks of matrices, as the MoE experts), not its norm scales and
    biases."""
    return p.dim() >= 2


def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Tensors, AdamWState, dict]:
    """Returns (new params, new state, {"grad_norm", "lr"}).  Nothing is
    updated in place: the new params and moments are new tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1 - _f32(b1) ** step)
    bc2 = float(1 - _f32(b2) ** step)
    new_p, new_m, new_v = {}, {}, {}
    for n, g in grads.items():
        p = params[n]
        g = g.float() * scale
        m2 = b1 * state.mu[n] + (1 - b1) * g
        v2 = b2 * state.nu[n] + (1 - b2) * g.square()
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if decays(p):
            delta = delta + cfg.weight_decay * p.float()
        new_p[n] = (p.float() - lr * delta).to(p.dtype)
        new_m[n], new_v[n] = m2, v2
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {
        "grad_norm": gnorm, "lr": lr}
