"""The port's span tracer: host spans and counters on the device trace's
clock.

A ``Tracer`` records spans ``(name, start_ns, end_ns, ids)`` and counters
``(name, value, ids)``.  ``ids`` is a dict of small ints naming what the
record belongs to: ``ti`` (tenant), ``stage``, ``bid`` (batch), ``fid``
(a stage call's task) and ``qid`` (query); a training step's spans carry
none.  Records go into plain lists that the tracer's owner hands out with
``take()`` at the end of a run; this module writes no file and has no
exporter (a caller that wants a Chrome trace writes the records itself).

Off, which is the default, a call site pays one attribute test,
``if tracer.on:``, and reads no clock, allocates nothing and keeps no
record.  ``enable()`` turns a tracer on.

The clock.  Every stamp is ``time.time_ns()``, the epoch's clock, which is
the clock that ``torch.profiler``'s kineto records carry in this process
on the machines seen so far, so a span and a device interval of the same
process compare directly.  The first tracer turned on in a process checks
this once: it stamps the host clock on both sides of a marked region
under a CPU-only profile, and if kineto places the region outside those
stamps it keeps kineto's offset from the host clock and adds it to every
stamp (``clock_shift``).

Records from two processes.  A worker process has its own tracer,
``PROCESS`` (the stage servers' calls record into it, under the ids the
worker sets in ``PROCESS.ids`` before each call); it ships its records
once, in its exit report, and nothing crosses the task or completion
queues per call.  So the two spans that cross the process boundary are
stamped on the side where they end, with a start of ``None``:
``to_worker`` (submitted by the driver -> taken by the worker, recorded by
the worker) and ``from_worker`` (put by the worker -> folded by the
driver, recorded by the driver).  ``link`` fills those starts from the
other side: a task's ``queue`` span ends where it was submitted, its
``publish`` span ends where its completion was put.

The spans of a served query, by where they are stamped:

===============  ==========================================================
``admit``        the driver, at admission: its due time -> admitted
``batch_wait``   the driver: admitted -> its batch formed (``bid``)
``queue``        the driver: the batch entered a stage's ready queue
                 (formed, or delivered by its producer) -> submitted
                 (``fid``)
``to_worker``    the worker: submitted -> the worker took the task
``resolve``      the worker: the task's input mapped onto the stage's
                 device
``enqueue``      the stage server: the host's dispatch of the call
``encode``       the model, inside ``enqueue``: the host's dispatch of an
                 encoder-decoder's encoder (``Transformer.serve_prefill``)
``sync``         the stage server: the wait on the device
``publish``      the worker: the output handed to its consumers
``from_worker``  the driver: the completion put -> folded by the driver
``done``         the driver: the query's due time -> completed
===============  ==========================================================

and of a training step: ``batch_in``, ``fwd_bwd`` and ``update``.
Counters: ``launches_per_call``, the device kernels of one warm call of a
stage, per (``ti``, ``stage``), counted by each worker at warm-up; and
``update_launches``, the AdamW kernels' launches in one training step's
update (``kernels.adamw.LAUNCHES``), recorded by the step where its
update ran on the card.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Tracer", "PROCESS", "clock_shift", "link"]

Span = Tuple[str, Optional[int], Optional[int], dict]
Counter = Tuple[str, float, dict]

# kineto's clock minus the host's, once checked in this process
_shift_ns: Optional[int] = None


def clock_shift() -> int:
    """Nanoseconds to add to ``time.time_ns()`` to read kineto's clock
    (0 where the two are one clock); checked once a process."""
    global _shift_ns
    if _shift_ns is None:
        from torch.profiler import ProfilerActivity, profile, record_function
        name = "repro_torch.trace.clock_check"
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            lo = time.time_ns()
            with record_function(name):
                pass
            hi = time.time_ns()
        start = next((e.start_ns()
                      for e in prof.profiler.kineto_results.events()
                      if e.name() == name), None)
        # a profiler that recorded nothing has no clock to meet
        _shift_ns = 0 if start is None or lo <= start <= hi \
            else start - (lo + hi) // 2
    return _shift_ns


class Tracer:
    """Spans and counters of one owner (see the module docstring)."""

    __slots__ = ("on", "spans", "counters", "ids", "_shift")

    def __init__(self, on: bool = False):
        self.on = False
        self.spans: List[Span] = []
        self.counters: List[Counter] = []
        self.ids: dict = {}            # of the spans recorded without ids
        self._shift = 0
        if on:
            self.enable()

    def enable(self) -> None:
        self._shift = clock_shift()
        self.on = True

    def now(self) -> int:
        """A stamp on kineto's clock, in ns."""
        return time.time_ns() + self._shift

    def span(self, name: str, start_ns: Optional[int],
             end_ns: Optional[int], ids: Optional[dict] = None) -> None:
        self.spans.append((name, start_ns, end_ns,
                           self.ids if ids is None else ids))

    def count(self, name: str, value: float,
              ids: Optional[dict] = None) -> None:
        self.counters.append((name, value, self.ids if ids is None else ids))

    def take(self) -> Dict[str, list]:
        """The records so far, ``{"spans": [...], "counters": [...]}``;
        the tracer starts again empty."""
        out = {"spans": self.spans, "counters": self.counters}
        self.spans, self.counters = [], []
        return out


#: this process's tracer: a worker turns it on, and the stage servers it
#: runs record into it
PROCESS = Tracer()


def link(driver: Iterable[Span], workers: Iterable[Span]) -> List[Span]:
    """One run's spans from the driver and its workers as one list, each
    span complete.  Worker spans of tasks that the driver did not submit
    in this run (another trace's) are left out, and each kept one gets its
    task's ``bid``; ``to_worker`` starts where its task's ``queue`` ended
    and ``from_worker`` where its task's ``publish`` ended.  A
    ``from_worker`` whose task published nothing (its worker died) is
    left out."""
    driver = list(driver)
    submitted = {s[3]["fid"]: s for s in driver if s[0] == "queue"}
    put: Dict[int, int] = {}
    out: List[Span] = []
    for name, start, end, ids in workers:
        q = submitted.get(ids.get("fid"))
        if q is None:
            continue
        if name == "to_worker":
            start = q[2]
        elif name == "publish":
            put[ids["fid"]] = end
        out.append((name, start, end, {**ids, "bid": q[3]["bid"]}))
    for name, start, end, ids in driver:
        if name == "from_worker":
            start = put.get(ids["fid"])
            if start is None:
                continue
        out.append((name, start, end, ids))
    return out
