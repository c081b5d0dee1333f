"""The assembled training step: loss, gradients, AdamW (the port of
``repro/training/train_step.py``).

The reference's step is a pure function of (params, opt_state, batch);
here the parameters live in the model, so the step takes (opt_state,
batch), computes the loss with its gradients (the parameters require
grad only for the call), and AdamW writes the new values over the
model's parameters and the old moments, as the reference's donated step
lets XLA do.

Traced (``make_train_step(..., trace=True)``), a step records three spans
on its tracer, ``train_step.tracer`` (``repro_torch.core.trace``):
``batch_in`` (the batch to the device), ``fwd_bwd`` (the loss and its
gradients) and ``update`` (AdamW), each the host's time to dispatch its
part; and, where the update ran on the card's kernels, the counter
``update_launches``: their launches in this step's update
(``kernels.adamw.LAUNCHES``)."""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.trace import Tracer
from repro_torch.kernels import adamw
from repro_torch.models.transformer import Transformer
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)


def batch_to(batch: Mapping[str, np.ndarray], device) -> dict:
    """A batch of ``make_batch`` (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: Transformer,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True, trace: bool = False
                    ) -> Callable[[AdamWState, Mapping], Tuple[AdamWState,
                                                                dict]]:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``;
    the model's parameters and the state's moments are updated in place
    (the returned state holds the same moment tensors).  ``metrics``: ``loss``
    and ``grad_norm`` (0-d tensors on the model's device, so a step does
    not wait for the card) and ``lr`` (a float).  The optimizer state
    comes from ``init_adamw(dict(model.named_parameters()))``.  ``trace``
    turns on the step's tracer, ``train_step.tracer``."""
    named = dict(model.named_parameters())
    names, params = list(named), list(named.values())
    tracer = Tracer(on=trace)

    def train_step(opt_state: AdamWState, batch: Mapping):
        if tracer.on:
            t0 = tracer.now()
        b = batch_to(batch, model.device)
        if tracer.on:
            t1 = tracer.now()
            tracer.span("batch_in", t0, t1)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = model.forward_train(b["tokens"], b["labels"],
                                       b.get("frames"), remat=remat)
            grads = dict(zip(names, torch.autograd.grad(loss, params)))
        finally:
            for p in params:
                p.requires_grad_(False)
        if tracer.on:
            t2 = tracer.now()
            tracer.span("fwd_bwd", t1, t2)
            launched = adamw.LAUNCHES
        _, opt_state, stats = adamw_update(grads, opt_state, named, opt_cfg)
        if tracer.on:
            tracer.span("update", t2, tracer.now())
            if adamw.LAUNCHES != launched:
                tracer.count("update_launches", adamw.LAUNCHES - launched)
        return opt_state, {"loss": loss.detach(), **stats}

    train_step.tracer = tracer
    return train_step


def loss_only_step(model: Transformer, remat: bool = True
                   ) -> Callable[[Mapping], torch.Tensor]:
    """Returns ``step(batch) -> loss`` (no gradient)."""
    def step(batch: Mapping) -> torch.Tensor:
        b = batch_to(batch, model.device)
        with torch.no_grad():
            return model.forward_train(b["tokens"], b["labels"],
                                       b.get("frames"), remat=remat)
    return step
