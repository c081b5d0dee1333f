"""The assembled training step: loss, gradients, AdamW (the port of
``repro/training/train_step.py``).

The reference's step is a pure function of (params, opt_state, batch);
here the parameters live in the model, so the step takes (opt_state,
batch), computes the loss with its gradients (the parameters require
grad only for the call), and copies AdamW's new values into the model's
parameters in place."""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import Transformer
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)


def batch_to(batch: Mapping[str, np.ndarray], device) -> dict:
    """A batch of ``make_batch`` (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: Transformer,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True
                    ) -> Callable[[AdamWState, Mapping], Tuple[AdamWState,
                                                                dict]]:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``;
    the model's parameters are updated in place.  ``metrics``: ``loss``
    and ``grad_norm`` (0-d tensors on the model's device, so a step does
    not wait for the card) and ``lr`` (a float).  The optimizer state
    comes from ``init_adamw(dict(model.named_parameters()))``."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def train_step(opt_state: AdamWState, batch: Mapping):
        b = batch_to(batch, model.device)
        for p in params:
            p.requires_grad_(True)
        try:
            loss = model.forward_train(b["tokens"], b["labels"],
                                       b.get("frames"), remat=remat)
            grads = torch.autograd.grad(loss, params)
        finally:
            for p in params:
                p.requires_grad_(False)
        new, opt_state, stats = adamw_update(
            dict(zip(names, grads)), opt_state,
            dict(zip(names, params)), opt_cfg)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.copy_(new[n])
        return opt_state, {"loss": loss.detach(), **stats}

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
