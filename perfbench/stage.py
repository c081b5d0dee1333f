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
records in a file beside its calls.  A thread of the worker has the
profile started by the window's clock, whether or not the worker is called
inside it, and stopped only after the driver has served the whole trace.

``fault`` (tests only) breaks the stage's output where it is produced:
"alter_token" changes the first row's token, "half_batch" runs the first
half of the rows and returns token 0 for the rest.
"""
from __future__ import annotations

import json
import os
import pickle
import signal
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.trace import LEAD_IN_KERNEL

HEAD = 8                       # token ids kept of each input row
TRACE_FILE = "trace_window.json"
LEAD_IN = 64                   # spin kernels before a profile, left out
LEAD_NS = 1_000_000_000         # a worker's profile starts this early
DONE_FILE = "trace_served"     # the driver's word that the trace is served
PROFILE_WAIT_S = 120.0         # the driver's wait for the workers' profiles
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
        if self.spec.trace:
            _PROFILER.count_launches(self.spec.index,
                                     lambda: self._inner.warmup(batch))

    def process(self, tokens: torch.Tensor) -> torch.Tensor:
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
    util.family(spec.cfg).check_port(inner.cfg, spec.cfg)
    make_weights(spec.cfg, spec.weight_seed, inner.device, torch.bfloat16,
                 out=dict(inner.model.named_parameters()))
    if spec.trace:
        _PROFILER.attach(spec.record_dir)
    return RecordingStage(spec, inner)


def read_calls(record_dir: str, index: int,
               pid: Optional[int] = None) -> List[tuple]:
    """Every recorded call of stage ``index`` (by the worker ``pid``, or by
    every worker), in start order."""
    out = []
    who = "*" if pid is None else pid
    for path in sorted(Path(record_dir).glob(f"calls-{index}-{who}.pkl")):
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

def _device_events(prof):
    """The device records (name, start, end) of a finished
    ``torch.profiler.profile`` on its own clock, and its lead-in kernels'
    count."""
    from torch.autograd import DeviceType
    events, lead_in = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if LEAD_IN_KERNEL in e.name():
            lead_in += 1
            continue
        events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return events, lead_in


class CudaProfile:
    """One profile of this process's device work over the traced window:
    ``start`` starts the profiler and launches ``LEAD_IN`` spin kernels (the
    profiler can lose a profile's first device records); ``stop`` stops it
    and returns its record."""

    def __init__(self):
        self.prof = None
        self.started_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.started_ns = time.time_ns()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)

    def stop(self) -> Dict:
        torch.cuda.synchronize()
        self.prof.stop()
        stopped_ns = time.time_ns()
        # kineto's clock is the epoch's on the machines seen so far; a
        # clock of another base is moved onto ours by its start
        shift = self.prof.profiler.kineto_results.trace_start_ns() \
            - self.started_ns
        shift = shift if abs(shift) > 1_000_000_000 else 0
        events, lead_in = _device_events(self.prof)
        self.prof = None
        return {"start_ns": self.started_ns, "stop_ns": stopped_ns,
                "lead_in": lead_in,
                "events": [(n, s - shift, e - shift) for n, s, e in events]}


def _write(path: Path, record: Dict) -> None:
    """``record`` pickled to ``path`` whole or not at all."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(record, f)
    os.replace(tmp, path)


class _WorkerProfiler:
    """One a worker process: every stage of the worker shares it.

    ``attach`` leaves a ``worker-<pid>`` mark in the record directory and
    starts a thread that waits for the traced window (``TRACE_FILE``).
    ``LEAD_NS`` before the window opens, so that no worker's start (which
    can stall the card) falls inside it, the thread has the process's main
    thread start one profile; once the driver has served the whole trace
    (``DONE_FILE``), it has the main thread stop it, which holds the
    process for seconds, and write ``prof-<pid>.pkl``: the profile, or,
    where the worker read the window only after it had closed (a worker
    restarted late), a record with no events.  The worker's calls play no
    part: a worker that is not called inside the window still covers it.

    The main thread is the one that launches the stages' kernels: a
    profile started or stopped from another thread lost most of a
    worker's device records in some runs on the H100.  The thread reaches
    it by ``SIGNAL``, whose handler runs there between two bytecodes, also
    where it waits for its next task; it repeats the signal every
    ``RESEND_S`` until the main thread has acted.  The thread is not a
    daemon, so the worker's process ends only after it.  ``launches`` holds
    each stage's device records of one warm call (``count_launches``),
    against which the driver checks the profile.  ``clock``, ``wait`` and
    ``profile`` (a ``CudaProfile``-like factory) are the tests' to replace.
    """

    POLL_S = 0.05
    RESEND_S = 1.0
    SIGNAL = signal.SIGUSR1

    def __init__(self, clock: Callable[[], int] = time.time_ns,
                 wait: Callable[[float], None] = time.sleep,
                 profile: Optional[Callable] = None):
        self.clock, self.wait, self.profile = clock, wait, profile
        self.dir: Optional[Path] = None
        self.thread: Optional[threading.Thread] = None
        self.launches: Dict[int, int] = {}
        self.window: Optional[Tuple[int, int]] = None
        self.want: Optional[str] = None     # the thread's ask of the main
        self.acting = False
        self.prof = None

    def attach(self, record_dir: str) -> None:
        if self.dir is not None:
            return
        if self.profile is None and not torch.cuda.is_available():
            return
        self.dir = Path(record_dir)
        signal.signal(self.SIGNAL, self._on_signal)
        (self.dir / f"worker-{os.getpid()}").touch()
        self.thread = threading.Thread(
            target=self._watch, args=(threading.main_thread().ident,),
            name="perfbench-profile")
        self.thread.start()

    def count_launches(self, index: int, call: Callable[[], None]) -> None:
        """Device records of one ``call`` of stage ``index``, profiled
        alone (which also starts CUPTI before any window: its first start
        is slow)."""
        if self.dir is None or self.profile is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        self.launches[index] = len(_device_events(prof)[0])

    def _watch(self, main: int) -> None:
        path = self.dir / TRACE_FILE
        if self._poll(path.exists):
            with open(path) as f:
                w = json.load(f)
            self.window = window = (int(w["start_ns"]), int(w["stop_ns"]))
            if self.clock() < window[1] and \
                    self._poll(lambda: self.clock() >= window[0] - LEAD_NS):
                self._ask(main, "start")
        self._poll(lambda: False)
        self._ask(main, "stop")

    def _ask(self, main: int, what: str) -> None:
        """Have the main thread ``what`` the profile; wait until it has."""
        self.want = what
        while self.want is not None:
            signal.pthread_kill(main, self.SIGNAL)
            waited = 0.0
            while self.want is not None and waited < self.RESEND_S:
                self.wait(self.POLL_S)
                waited += self.POLL_S

    def _on_signal(self, *_) -> None:
        """The main thread's side of ``_ask``."""
        if self.acting or self.want is None:
            return
        self.acting = True
        try:
            if self.want == "start":
                self.prof = (self.profile or CudaProfile)()
                self.prof.start()
            else:
                record = self.prof.stop() if self.prof is not None \
                    else {"events": None}
                self.prof = None
                _write(self.dir / f"prof-{os.getpid()}.pkl",
                       {**record, "pid": os.getpid(), "window": self.window,
                        "launches": dict(self.launches)})
            self.want = None
        finally:
            self.acting = False

    def _poll(self, ready: Callable[[], bool]) -> bool:
        """Wait until ``ready()`` or the driver's ``DONE_FILE``; whether
        ``ready()`` came first."""
        done = self.dir / DONE_FILE
        while not ready():
            if done.exists():
                return False
            self.wait(self.POLL_S)
        return True


_PROFILER = _WorkerProfiler()


def read_profiles(record_dir: str) -> List[Dict]:
    out = []
    for path in sorted(Path(record_dir).glob("prof-*.pkl")):
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def collect_profiles(record_dir: str,
                     timeout_s: float = PROFILE_WAIT_S) -> List[Dict]:
    """Tell the workers that the trace is served (``DONE_FILE``), then wait
    for the profile record of every worker that left its mark and is
    alive; every record written."""
    d = Path(record_dir)
    (d / DONE_FILE).touch()
    deadline = time.time() + timeout_s
    while True:
        marks = {int(p.name.split("-")[1]) for p in d.glob("worker-*")}
        have = {int(p.stem.split("-")[1]) for p in d.glob("prof-*.pkl")}
        missing = sorted(pid for pid in marks - have if _alive(pid))
        if not missing:
            return read_profiles(record_dir)
        if time.time() > deadline:
            raise RuntimeError(f"workers {missing} wrote no profile in "
                               f"{timeout_s:.0f} s")
        time.sleep(0.1)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True
