"""Training (the port of ``repro.training``): AdamW, the synthetic data
pipeline, checkpoints and the train step, on ``Transformer.forward_train``.
On the card the loss's attention, mLSTM chunks and selective scans run
forward and backward through the hand-written kernels, so every model of
the zoo trains there."""
from repro_torch.training.checkpoint import (CheckpointManager, load_pytree,
                                             save_pytree)
from repro_torch.training.data import DataConfig, batch_iterator, make_batch
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, global_norm,
                                            init_adamw, schedule)
from repro_torch.training.train_step import (batch_to, loss_only_step,
                                             make_train_step)

__all__ = [
    "CheckpointManager", "load_pytree", "save_pytree", "DataConfig",
    "batch_iterator", "make_batch", "AdamWConfig", "AdamWState",
    "adamw_update", "global_norm", "init_adamw", "schedule", "batch_to",
    "loss_only_step", "make_train_step",
]
