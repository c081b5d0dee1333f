"""Synthetic data pipeline (a copy of ``repro/training/data.py``, numpy
only; its batches are bit-equal to the reference's).

Deterministic, seekable token stream (hash-based, no RNG state to carry),
shifted-label batching, and an iterator suitable for multi-host sharding
(each host reads its own slice by index arithmetic, the standard pattern).
For enc-dec (whisper) batches, frame embeddings are generated alongside.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _hash_tokens(indices: np.ndarray, vocab: int, seed: int) -> np.ndarray:
    """SplitMix64-style position hash -> tokens, vectorised."""
    z = (indices.astype(np.uint64) + np.uint64(seed)
         + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> dict:
    """Batch `step` of this host's shard: {tokens, labels[, frames]}."""
    local_batch = dcfg.global_batch // dcfg.num_hosts
    # absolute sample ids for this host at this step
    base = step * dcfg.global_batch + dcfg.host_id * local_batch
    sample_ids = np.arange(local_batch) + base
    # token stream: sample i covers positions [i*(S+1), (i+1)*(S+1))
    s = dcfg.seq_len
    offsets = sample_ids[:, None] * (s + 1) + np.arange(s + 1)[None]
    stream = _hash_tokens(offsets, cfg.vocab_size, dcfg.seed)
    batch = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    if cfg.encoder_decoder:
        fl = _hash_tokens(
            sample_ids[:, None, None] * 7919
            + np.arange(cfg.encoder_seq_len)[None, :, None] * 31
            + np.arange(cfg.d_model)[None, None, :],
            2 ** 16, dcfg.seed + 1)
        frames = (fl.astype(np.float32) / 2 ** 15 - 1.0) * 0.02
        batch["frames"] = frames.astype(np.float32)
    return batch


def batch_iterator(cfg: ModelConfig, dcfg: DataConfig,
                   start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, dcfg, step)
        step += 1
