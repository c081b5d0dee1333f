"""Reductions of a profiler's device records to what the metrics read:
the busy time inside a window, its idle gaps, and the device operations
that took most time."""
from __future__ import annotations

from typing import Dict

# torch.cuda._sleep's kernel: the lead-in launched before each profile
# (the profiler can lose a session's first device records), left out of
# every sum
LEAD_IN_KERNEL = "spin_kernel"


def busy_union(intervals, lo: int, hi: int) -> tuple:
    """The merged intervals of ``intervals`` ((start, end) ns) inside
    [lo, hi], and their total length in ns."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def top_by_name(events, lo: int, hi: int, n: int = 10) -> list:
    """[name, seconds] of the ``n`` device operations that took most time
    among ``events`` (name, start, end) starting inside [lo, hi]."""
    tot: Dict[str, int] = {}
    for name, s, e in events:
        if lo <= s < hi:
            tot[name] = tot.get(name, 0) + (e - s)
    rows = sorted(tot.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[k, v / 1e9] for k, v in rows]


def gaps(merged, lo: int, hi: int) -> list:
    """(start, end) ns of the idle stretches of [lo, hi] between the
    merged busy intervals."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out
