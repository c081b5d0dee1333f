"""Open-loop traffic: a copy of ``repro_torch.serving.engine.make_trace``
(kept here so that the yardstick does not move with the program), and the
window form the cells use."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def make_trace(n: int, qps: float, seq_len: int, vocab: int,
               seed: int = 0) -> List[Tuple[int, float, np.ndarray]]:
    """``n`` queries with Poisson arrivals at ``qps`` and uniform token ids:
    (qid, arrival s, tokens (seq_len,) int32), drawn as the program's
    ``make_trace`` draws them."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / qps, n))
    return [(i, float(t[i]),
             rng.integers(0, vocab, seq_len).astype(np.int32))
            for i in range(n)]


def poisson_window(qps: float, seconds: float, seq_len: int, vocab: int,
                   seed: int, arrival_seed: Optional[int] = None
                   ) -> List[Tuple[int, float, np.ndarray]]:
    """Exactly round(qps x seconds) queries in [0, seconds): a Poisson
    process conditioned on that count (its arrival times are then uniform
    order statistics: the cumulative sums of n + 1 exponential gaps scaled
    to end at ``seconds``), so every seed sends the same number of queries.
    The arrival times are drawn from ``arrival_seed`` where it is given
    (the same schedule for every seed, other prompts), else from
    ``seed``; the prompts always from ``seed``."""
    n = int(round(qps * seconds))
    rng = np.random.default_rng(seed)
    times = rng if arrival_seed is None else \
        np.random.default_rng(arrival_seed)
    gaps = times.exponential(1.0, n + 1)
    t = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    return [(i, float(t[i]),
             rng.integers(0, vocab, seq_len).astype(np.int32))
            for i in range(n)]
