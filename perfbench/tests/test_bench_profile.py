"""A serving worker's profile of the run's traced window, on a stand-in
clock and profiler: the worker's thread has the main thread start one
profile ``LEAD_NS`` before the window and stop it only once the driver has
served the trace, though the worker is never called, and it profiles once
only.  The driver waits for every worker's profile and refuses one that
lost the worker's device records."""
import json
import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest

from perfbench.kinds.serve import _profile_obs
from perfbench.stage import (DONE_FILE, LEAD_NS, TRACE_FILE, _WorkerProfiler,
                             collect_profiles, read_profiles)

START = 1_700_000_000_000_000_000
S = 10 ** 9


@pytest.fixture(autouse=True)
def keep_signal_handler():
    old = signal.getsignal(_WorkerProfiler.SIGNAL)
    yield
    signal.signal(_WorkerProfiler.SIGNAL, old)


class Clock:
    """Time that passes only when waited on (a waiter also yields to the
    other threads for a moment); ``at`` runs an action once the clock has
    reached its time."""

    def __init__(self):
        self.now = START
        self.lock = threading.Lock()
        self.actions = []

    def __call__(self) -> int:
        with self.lock:
            return self.now

    def wait(self, seconds: float) -> None:
        with self.lock:
            self.now += max(int(seconds * 1e9), 1)
            now = self.now
        time.sleep(0.001)
        for a in [a for a in self.actions if a[0] <= now]:
            self.actions.remove(a)
            a[1]()

    def at(self, t_ns: int, action) -> None:
        self.actions.append((t_ns, action))


def stand_in(clock, log):
    class Profile:
        def __init__(self):
            log.append(("made", None))

        def start(self):
            assert threading.current_thread() is threading.main_thread()
            log.append(("start", clock()))

        def stop(self):
            assert threading.current_thread() is threading.main_thread()
            log.append(("stop", clock()))
            return {"start_ns": log[1][1], "stop_ns": clock(), "lead_in": 64,
                    "events": [("k", log[1][1] + S, log[1][1] + 2 * S)]}
    return Profile


def write_window(d, window):
    (d / TRACE_FILE).write_text(json.dumps(
        {"start_ns": window[0], "stop_ns": window[1]}))


def done(d):
    return lambda: (d / DONE_FILE).touch()


def test_a_worker_without_calls_covers_the_window(tmp_path):
    clock, log = Clock(), []
    window = (START + 30 * S, START + 31_500_000_000)
    write_window(tmp_path, window)
    clock.at(window[1] + 7 * S, done(tmp_path))
    prof = _WorkerProfiler(clock=clock, wait=clock.wait,
                           profile=stand_in(clock, log))
    prof.attach(str(tmp_path))
    prof.attach(str(tmp_path))                   # a second stage: no-op
    prof.thread.join(timeout=30)
    assert not prof.thread.is_alive() and not prof.thread.daemon
    assert [e[0] for e in log] == ["made", "start", "stop"]
    started, stopped = log[1][1], log[2][1]
    assert window[0] - LEAD_NS <= started < window[0]
    assert stopped >= window[1] + 7 * S
    [rec] = read_profiles(str(tmp_path))
    assert rec["pid"] == os.getpid() and rec["window"] == window
    assert rec["start_ns"] == started and rec["lead_in"] == 64
    assert (tmp_path / f"worker-{os.getpid()}").exists()


def test_the_profile_waits_for_the_window_file(tmp_path):
    clock, log = Clock(), []
    clock.at(START + 5 * S, lambda: write_window(
        tmp_path, (START + 20 * S, START + 21 * S)))
    clock.at(START + 25 * S, done(tmp_path))
    prof = _WorkerProfiler(clock=clock, wait=clock.wait,
                           profile=stand_in(clock, log))
    prof.attach(str(tmp_path))
    prof.thread.join(timeout=30)
    assert not prof.thread.is_alive()
    assert [e[0] for e in log] == ["made", "start", "stop"]
    assert START + 19 * S <= log[1][1] < START + 20 * S
    assert log[2][1] >= START + 25 * S


def test_a_worker_that_reads_a_closed_window_makes_no_profile(tmp_path):
    clock, log = Clock(), []
    write_window(tmp_path, (START - 3 * S, START - S))
    clock.at(START + S, done(tmp_path))
    prof = _WorkerProfiler(clock=clock, wait=clock.wait,
                           profile=stand_in(clock, log))
    prof.attach(str(tmp_path))
    prof.thread.join(timeout=30)
    assert not prof.thread.is_alive() and log == []
    [rec] = read_profiles(str(tmp_path))
    assert rec["events"] is None and rec["pid"] == os.getpid()


def test_a_run_that_ends_before_the_window_ends_the_thread(tmp_path):
    clock, log = Clock(), []
    write_window(tmp_path, (START + 30 * S, START + 31 * S))
    clock.at(START + 2 * S, done(tmp_path))
    prof = _WorkerProfiler(clock=clock, wait=clock.wait,
                           profile=stand_in(clock, log))
    prof.attach(str(tmp_path))
    prof.thread.join(timeout=30)
    assert not prof.thread.is_alive() and log == []
    assert read_profiles(str(tmp_path))[0]["events"] is None


def test_the_driver_waits_for_every_live_workers_profile(tmp_path):
    (tmp_path / f"worker-{os.getpid()}").touch()
    (tmp_path / "worker-999999999").touch()     # no such process: skipped

    def worker():
        assert (tmp_path / DONE_FILE).exists()
        with open(tmp_path / f"prof-{os.getpid()}.pkl", "wb") as f:
            pickle.dump({"pid": os.getpid(), "events": None}, f)

    timer = threading.Timer(0.5, worker)
    timer.start()
    try:
        profs = collect_profiles(str(tmp_path), timeout_s=30)
    finally:
        timer.join()
    assert profs == [{"pid": os.getpid(), "events": None}]


def test_the_driver_refuses_a_live_worker_without_a_profile(tmp_path):
    (tmp_path / f"worker-{os.getpid()}").touch()
    with pytest.raises(RuntimeError, match="wrote no profile"):
        collect_profiles(str(tmp_path), timeout_s=0.3)


def calls_file(d, index, pid, calls):
    with open(d / f"calls-{index}-{pid}.pkl", "wb") as f:
        for t0, t1 in calls:
            pickle.dump((t0, t1, np.zeros((1, 8), np.int32),
                         np.zeros(1, np.int32)), f)


@pytest.mark.parametrize("kept", [100, 40])
def test_a_profile_that_lost_its_workers_records_is_refused(tmp_path, kept):
    """Two calls of 100 launches inside the window: a profile that holds
    them reads window_s whole; one that kept 40 of each is refused."""
    w = (START + 10 * S, START + 12 * S)
    calls = [(w[0] + S // 10, w[0] + S // 2), (w[0] + S, w[0] + 3 * S // 2)]
    calls_file(tmp_path, 0, 11, calls)
    events = [("k", t0 + j * 1000, t0 + j * 1000 + 500)
              for t0, _ in calls for j in range(kept)]
    prof = {"pid": 11, "window": w, "start_ns": w[0] - S,
            "stop_ns": w[1] + 5 * S, "lead_in": 64, "events": events,
            "launches": {0: 100}}
    window = [[(t0, t1, None, None) for t0, t1 in calls]]
    if kept < 50:
        with pytest.raises(RuntimeError, match="holds 80 device records"):
            _profile_obs(str(tmp_path), [prof], w, window)
        return
    obs = _profile_obs(str(tmp_path), [prof, {"pid": 12, "events": None}],
                       w, window)
    assert obs["trace_window_s"] == 2.0 and obs["lead_in_recorded"] == [64]
    assert obs["profiles"] == [{"calls_in_window": 2, "records": 200,
                                "launches": 200}]
