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

from repro_torch.kernels import adamw
from repro_torch.kernels.adamw import decays
from repro_torch.models.common import _is_dtensor

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "decays",
           "global_norm", "hyper", "init_adamw", "schedule"]

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


def hyper(step: int, cfg: AdamWConfig) -> adamw.Hyper:
    """The scalars of update number ``step`` (from 1): the scheduled
    learning rate and the bias corrections 1 - beta^step in fp32, as the
    reference."""
    return adamw.Hyper(lr=schedule(step, cfg), beta1=cfg.beta1,
                       beta2=cfg.beta2, eps=cfg.eps,
                       weight_decay=cfg.weight_decay,
                       bc1=float(1 - _f32(cfg.beta1) ** step),
                       bc2=float(1 - _f32(cfg.beta2) ** step))


def _clip_scale(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if _is_dtensor(x) else x


def _local_grad(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's part of gradient ``g`` laid out as leaf ``p``'s local
    tensor (what the leaf loop's ``copy_`` into a scratch like ``p``
    does); a plain tensor beside a DTensor counts as replicated."""
    if not _is_dtensor(p):
        return g.full_tensor() if _is_dtensor(g) else g
    if not _is_dtensor(g):
        from torch.distributed.tensor import DTensor, Replicate
        g = DTensor.from_local(g, p.device_mesh,
                               [Replicate()] * p.device_mesh.ndim,
                               run_check=False)
    return g.redistribute(p.device_mesh, p.placements).to_local()


def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Tensors, AdamWState, dict]:
    """Updates ``params`` and the moments of ``state`` in place and returns
    (the same params, ``AdamWState(step + 1)`` holding the same moment
    tensors, {"grad_norm", "lr"}).  ``grads`` is consumed: it is empty on
    return, so the gradients' memory can go back.

    The route follows the leaves.  On the CPU, the leaf loop
    (``kernels.adamw.adamw_step_plain``: two fp32 scratch tensors the size
    of the leaf, the reference's elementary operations in its order, each
    rounded to fp32 as the functional form rounds it).  On the card, the
    multi-tensor kernels (``kernels/adamw.py``): the global norm and the
    clip scale in two launches, with no host sync, then one launch that
    updates every leaf, bit for bit the leaf loop's values given the same
    scale.  DTensor leaves (a sharded launch) keep the DTensor reduction
    for the norm, which knows the placements, and run the update kernel
    on each leaf's local shard, the gradient laid out as its leaf first
    (what the leaf loop's ``copy_`` into a scratch like the leaf does)."""
    step = state.step + 1
    h = hyper(step, cfg)
    if params[next(iter(grads))].device.type != "cuda":
        gnorm = global_norm(grads)
        adamw.adamw_step_plain(grads, params, state.mu, state.nu,
                               _clip_scale(gnorm, cfg), h)
    elif any(_is_dtensor(params[n]) or _is_dtensor(g)
             for n, g in grads.items()):
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg)
        if _is_dtensor(scale):
            scale = scale.full_tensor()
        table = adamw.leaf_table(
            {n: _local_grad(g, params[n]) for n, g in grads.items()},
            *({n: _local(d[n]) for n in grads}
              for d in (params, state.mu, state.nu)))
        adamw.adamw_step(table, scale, h)
    else:
        table = adamw.leaf_table(grads, params, state.mu, state.nu)
        gnorm, scale = adamw.grad_norm(table, cfg.clip_norm)
        adamw.adamw_step(table, scale, h)
    grads.clear()
    return dict(params), AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "lr": h.lr}
