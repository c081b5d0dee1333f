"""QoS tracking: latency percentiles, violation accounting.

The latency buffer is a *bounded sliding window* (``deque(maxlen=window)``):
a long-running engine or a months-long simulated trace records millions of
latencies, and an unbounded list would grow memory without limit.
``tail_latency``/``mean`` are charged over the most recent ``window``
samples — at the 200k default every repo workload (sim ``max_queries`` is
60k) still sees every sample, so percentile semantics are unchanged —
while ``count()`` reports ALL samples ever recorded (completion
accounting must not forget evicted queries).

``over_target`` counts samples strictly above the target as they are
recorded; together with :func:`abort_threshold` it gives the simulator an
*exact* early-abort rule for infeasibility probes: once the count of
over-target latencies reaches the threshold for the run's eventual sample
total, the final percentile provably exceeds the target whatever the
remaining samples turn out to be.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np


def abort_threshold(n_total: int, percentile: float = 99.0) -> int:
    """Exact counting bound for QoS early-abort.

    With ``n_total`` latencies eventually recorded, the ``percentile``-ile
    under numpy's default linear interpolation sits at position
    ``pos = (percentile/100)·(n_total-1)`` of the sorted samples.  Samples
    over the target are the largest ones, so once ``k`` of them exist the
    smallest index over target is ``n_total - k``; the percentile is then
    interpolated between two over-target values — hence provably over the
    target — exactly when ``floor(pos) >= n_total - k``, i.e.

        k >= n_total - floor(pos)

    The bound is monotone in ``n_total`` (the threshold for any partial
    prefix is no larger), so reaching it mid-run certifies both the final
    AND the current percentile exceed the target: aborting cannot flip a
    feasible verdict to infeasible.  Returns 1 for ``n_total <= 0`` (no
    recordable samples — the threshold is never consulted)."""
    if n_total <= 0:
        return 1
    return n_total - math.floor((percentile / 100.0) * (n_total - 1))


@dataclass
class QoSTracker:
    target: float                      # end-to-end 99%-ile target (seconds)
    percentile: float = 99.0
    window: Optional[int] = 200_000    # sliding-window bound (None: unbounded)
    latencies: Deque[float] = field(default_factory=deque)
    recorded: int = 0                  # total samples ever recorded
    over_target: int = 0               # samples strictly above the target

    def __post_init__(self):
        # normalise whatever was passed (list literals in tests, a deque
        # with the wrong bound) onto a deque bounded by ``window``
        if not isinstance(self.latencies, deque) \
                or self.latencies.maxlen != self.window:
            self.latencies = deque(self.latencies, maxlen=self.window)
        self.recorded = max(self.recorded, len(self.latencies))

    def record(self, latency: float) -> None:
        self.latencies.append(latency)
        self.recorded += 1
        if latency > self.target:
            self.over_target += 1

    def tail_latency(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies),
                                   self.percentile))

    def normalized_tail(self) -> float:
        """p99 / target: > 1.0 means QoS violation (paper Figs. 14/17)."""
        return self.tail_latency() / self.target if self.target else 0.0

    def violated(self) -> bool:
        return self.tail_latency() > self.target

    def mean(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.mean(np.asarray(self.latencies)))

    def count(self) -> int:
        """Total latencies recorded (NOT capped by the window)."""
        return self.recorded
