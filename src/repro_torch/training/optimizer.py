"""AdamW on a dict of named tensors, updated in place (the port of
``repro/training/optimizer.py``, whose jitted step donates its parameters
and moments, so XLA writes the new values over the old).

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
    the leaves' device).  Each leaf's norm is reduced in fp32 without an
    fp32 copy of the leaf."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float32).square()
        for x in tensors.values()))


def decays(p: torch.Tensor) -> bool:
    """Whether weight decay applies to a per-layer leaf: its matrices (and
    stacks of matrices, as the MoE experts), not its norm scales and
    biases."""
    return p.dim() >= 2


def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Tensors, AdamWState, dict]:
    """Updates ``params`` and the moments of ``state`` in place and returns
    (the same params, ``AdamWState(step + 1)`` holding the same moment
    tensors, {"grad_norm", "lr"}).  ``grads`` is consumed: each leaf's
    gradient is popped once its leaf is done, so its memory can go back.

    Leaf by leaf, in fp32, through two scratch tensors the size of the
    leaf (the update's transient memory: two fp32 copies of the largest
    leaf), with the reference's elementary operations in its order, each
    rounded to fp32 as the functional form rounds it."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1 - _f32(b1) ** step)
    bc2 = float(1 - _f32(b2) ** step)
    with torch.no_grad():
        for n in list(grads):
            p, m, v = params[n], state.mu[n], state.nu[n]
            a = torch.empty_like(p, dtype=torch.float32)
            b = torch.empty_like(a)
            a.copy_(grads.pop(n))
            a.mul_(scale)                   # g = g scale
            m.mul_(b1)
            torch.mul(a, 1 - b1, out=b)
            m.add_(b)                       # m = b1 m + (1 - b1) g
            v.mul_(b2)
            torch.square(a, out=b)
            b.mul_(1 - b2)
            v.add_(b)                       # v = b2 v + (1 - b2) g^2
            torch.div(v, bc2, out=b)
            b.sqrt_()
            b.add_(cfg.eps)
            torch.div(m, bc1, out=a)
            a.div_(b)                       # delta = m^ / (sqrt(v^) + eps)
            if decays(p):
                b.copy_(p)
                b.mul_(cfg.weight_decay)
                a.add_(b)                   # delta = delta + wd p
            a.mul_(lr)
            b.copy_(p)
            b.sub_(a)                       # p - lr delta, cast back below
            p.copy_(b)
            del a, b        # freed before the next leaf's are allocated
    return dict(params), AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "lr": lr}
