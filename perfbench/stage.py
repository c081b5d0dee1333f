"""The served stage as the benchmark runs it: ``repro_torch``'s
``ModelStageServer``, unchanged, inside a picklable wrapper that records
what each call took in and gave out.

The engine keeps no result of a query, so the wrapper, which runs in the
worker process, appends one record a call to a file of its own under the
run's record directory: the call's start and end (``time.time_ns``), the
first ``HEAD`` token ids of each input row (a prompt's identity, or the
token that a stage-1 row repeats) and the (B,) int32 ids it returned.

The wrapper crosses the process boundary as its ``StageSpec`` alone: the
worker builds the ``ModelStageServer`` there and writes the benchmark's
seeded weights (``perfbench.weights``) over the model's parameters, so no
worker receives weights by pickle.

With ``trace`` on, the worker also profiles its device work
(``torch.profiler``, CUDA activity) over the window that the driver writes
into ``trace_window.json`` in the record directory, and leaves the device
records in a file beside its calls.

``fault`` (tests only) breaks the stage's output where it is produced:
"alter_token" changes the first row's token, "half_batch" runs the first
half of the rows and returns token 0 for the rest.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.trace import LEAD_IN_KERNEL

HEAD = 8                       # token ids kept of each input row
TRACE_FILE = "trace_window.json"
LEAD_IN = 64                   # spin kernels before a profile, left out
LEAD_NS = 1_000_000_000         # a worker's profile starts this early
FAULTS = ("alter_token", "half_batch")


@dataclass(frozen=True)
class StageSpec:
    name: str
    index: int                 # the stage's node in the chain
    cfg: dict                  # the stage's entry of the config file
    seq_len: int
    weight_seed: int
    device: str                # "cuda" on the card; "cpu" in the tests
    record_dir: str
    trace: bool = False
    fault: Optional[str] = None
    reduced: bool = False      # the port's reduced config (CPU tests)


class RecordingStage:
    """A stage of the served chain (see the module docstring).  In the
    driver it is only its spec; in a worker it holds the live stage."""

    def __init__(self, spec: StageSpec, inner=None):
        self.spec = spec
        self.name = spec.name
        self.seq_len = spec.seq_len
        self.vocab_size = spec.cfg["vocab_size"]
        self.device = torch.device(spec.device)
        self._inner = inner
        self._out = None

    def __reduce__(self):
        return (_live_stage, (self.spec,))

    @property
    def calls(self) -> int:
        return 0 if self._inner is None else self._inner.calls

    def warmup(self, batch: int) -> None:
        self._inner.warmup(batch)

    def process(self, tokens: torch.Tensor) -> torch.Tensor:
        prof = _PROFILER if self.spec.trace else None
        if prof is not None:
            prof.before_call()
        t0 = time.time_ns()
        if self.spec.fault == "half_batch":
            half = tokens.shape[0] // 2
            out = torch.zeros(tokens.shape[0], dtype=torch.int32,
                              device=tokens.device)
            out[:half] = self._inner.process(tokens[:half])
        else:
            out = self._inner.process(tokens)
        if self.spec.fault == "alter_token":
            out = out.clone()
            out[0] = (out[0] + 1) % self.vocab_size
        t1 = time.time_ns()
        self._record(t0, t1, tokens, out)
        if prof is not None:
            prof.after_call()
        return out

    def _record(self, t0: int, t1: int, tokens, out) -> None:
        if self._out is None:
            path = Path(self.spec.record_dir) / \
                f"calls-{self.spec.index}-{os.getpid()}.pkl"
            self._out = open(path, "ab")
        pickle.dump((t0, t1, tokens[:, :HEAD].cpu().numpy(),
                     out.cpu().numpy()), self._out)
        self._out.flush()


def _live_stage(spec: StageSpec) -> RecordingStage:
    """The worker's side of ``RecordingStage.__reduce__``."""
    from repro_torch.serving import ModelStageServer

    from perfbench import util
    from perfbench.weights import make_weights
    if spec.fault is not None and spec.fault not in FAULTS:
        raise ValueError(f"fault {spec.fault!r}")
    inner = ModelStageServer(spec.name, spec.cfg["arch"], spec.seq_len,
                             seed=0, reduced=spec.reduced,
                             device=spec.device, dtype=torch.bfloat16)
    util.check_port_config(inner.cfg, spec.cfg)
    make_weights(spec.cfg, spec.weight_seed, inner.device, torch.bfloat16,
                 out=dict(inner.model.named_parameters()))
    if spec.trace:
        _PROFILER.attach(spec.record_dir)
    return RecordingStage(spec, inner)


def read_calls(record_dir: str, index: int) -> List[tuple]:
    """Every recorded call of stage ``index``, in start order."""
    out = []
    for path in sorted(Path(record_dir).glob(f"calls-{index}-*.pkl")):
        with open(path, "rb") as f:
            while True:
                try:
                    out.append(pickle.load(f))
                except EOFError:
                    break
    return sorted(out, key=lambda r: r[0])


# --------------------------------------------------------------------------
# The worker's profile of its device work over the driver's trace window
# --------------------------------------------------------------------------

class _WorkerProfiler:
    """One a worker process: every stage of the worker shares it."""

    def __init__(self):
        self.dir: Optional[Path] = None
        self.window = None
        self.prof = None
        self.started_ns = 0
        self.done = False

    def attach(self, record_dir: str) -> None:
        """Start CUPTI once before any window (its first start is slow)."""
        if self.dir is not None:
            return
        self.dir = Path(record_dir)
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.cuda._sleep(1)
                torch.cuda.synchronize()

    def _read_window(self) -> None:
        path = self.dir / TRACE_FILE
        if self.window is None and path.exists():
            with open(path) as f:
                w = json.load(f)
            self.window = (int(w["start_ns"]), int(w["stop_ns"]))

    def before_call(self) -> None:
        if self.done or self.dir is None or not torch.cuda.is_available():
            return
        self._read_window()
        if self.window is None:
            return
        now = time.time_ns()
        # start a little before the window, so that no worker's start
        # (which can stall the card) falls inside it
        if self.prof is None and now >= self.window[0] - LEAD_NS:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.started_ns = time.time_ns()
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
        elif self.prof is not None and now >= self.window[1]:
            self._stop()

    def after_call(self) -> None:
        if self.prof is not None and not self.done and \
                time.time_ns() >= self.window[1]:
            self._stop()

    def _stop(self) -> None:
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.prof.stop()
        stopped_ns = time.time_ns()
        res = self.prof.profiler.kineto_results
        # kineto's clock is the epoch's on the machines seen so far; a
        # clock of another base is moved onto ours by its start
        shift = res.trace_start_ns() - self.started_ns
        shift = shift if abs(shift) > 1_000_000_000 else 0
        events, lead_in = [], 0
        for e in res.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            if LEAD_IN_KERNEL in e.name():
                lead_in += 1
                continue
            events.append((e.name(), e.start_ns() - shift,
                           e.start_ns() + e.duration_ns() - shift))
        with open(self.dir / f"prof-{os.getpid()}.pkl", "wb") as f:
            pickle.dump({"start_ns": self.started_ns, "stop_ns": stopped_ns,
                         "window": self.window,
                         "lead_in": lead_in, "events": events}, f)
        self.prof = None
        self.done = True


_PROFILER = _WorkerProfiler()


def read_profiles(record_dir: str) -> List[Dict]:
    out = []
    for path in sorted(Path(record_dir).glob("prof-*.pkl")):
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out
