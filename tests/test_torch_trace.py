"""The port's span tracer (``repro_torch.core.trace``) on the CPU: a served
query's spans on the processes backend, from its due time to its
completion, joined across the driver and its workers; the tracer off
reads no clock and keeps nothing, and serves the same outputs; a span and
``torch.profiler``'s records share one clock; the training step's three
spans, with the losses of the untraced step; an encoder-decoder stage's
``encode`` span."""
import collections
import json
import time

import numpy as np
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.core import trace
from repro_torch.core.types import Allocation, Placement, StageAlloc
from repro_torch.models import Transformer
from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                  make_batch, make_train_step)

#: a stage call's spans, in order, from its batch's queue to its fold
CALL = ("queue", "to_worker", "resolve", "enqueue", "sync", "publish",
        "from_worker")
WORKER = ("to_worker", "resolve", "enqueue", "sync", "publish")


class LoggedStage(serving.CpuStageServer):
    """A ``CpuStageServer`` that appends each call's first input column and
    its output ids to a file (the engine keeps no output)."""

    def __init__(self, name, path, **kw):
        super().__init__(name, **kw)
        self.path = path

    def process(self, tokens):
        out = super().process(tokens)
        with open(self.path, "a") as f:
            f.write(json.dumps([np.asarray(tokens)[:, 0].tolist(),
                                out.tolist()]) + "\n")
        return out


def _serve(tmp_path, tag, traced, n, qps):
    """A two-stage chain on two workers: (queries, stats, exit reports,
    each stage's logged calls after the warm-ups)."""
    paths = [tmp_path / f"{tag}-{i}.jsonl" for i in range(2)]
    stages = [LoggedStage(f"s{i}", str(p), seq_len=8, vocab=64, spin=200)
              for i, p in enumerate(paths)]
    alloc = Allocation(stages=[StageAlloc(1, 1.0, 4) for _ in range(2)],
                       placement=Placement(per_stage=[[(0, 1.0)],
                                                      [(1, 1.0)]]))
    queries = serving.make_trace(n, qps=qps, seq_len=8, vocab=64, seed=5)
    with serving.PipelineEngine(stages, batch_size=4, batch_timeout=0.02,
                                qos_target=30.0, backend="processes",
                                allocation=alloc, trace=traced) as eng:
        stats = eng.run_trace(queries)
    logs = [[json.loads(line) for line in p.read_text().splitlines()]
            for p in paths]
    # each worker warmed both stages once before its first task
    return queries, stats, eng.worker_reports, [log[2:] for log in logs]


def _query_spans(queries, spans):
    """Per query: its own spans by name, and its batch's call spans by
    (stage, name)."""
    by_bid = collections.defaultdict(lambda: collections.defaultdict(list))
    own = collections.defaultdict(lambda: collections.defaultdict(list))
    for s in spans:
        ids = s[3]
        if "qid" in ids:
            own[ids["qid"]][s[0]].append(s)
        else:
            by_bid[ids["bid"]][(ids["stage"], s[0])].append(s)
    out = {}
    for q in queries:
        mine = own[q.qid]
        out[q.qid] = (mine, by_bid[mine["batch_wait"][0][3]["bid"]])
    return out


def test_every_served_query_has_its_spans_and_they_tile_its_latency(
        tmp_path):
    """Every completed query has ``admit``, ``batch_wait`` and ``done``
    once and each stage call's spans once per stage; none is negative; a
    worker's spans lie inside the driver's submit -> fold of the same task;
    and the spans follow one another end to start, so that with the two
    gaps inside the worker's call of the stage (into and out of
    ``process``) they add up to ``done``, from due to completion."""
    queries, stats, reports, _ = _serve(tmp_path, "traced", True, 40,
                                        qps=400.0)
    assert stats.qos.count() == 40 and stats.failed == 0
    worker = [s for r in reports.values() for s in r["spans"]]
    assert {s[0] for s in worker} == set(WORKER)
    spans = trace.link(stats.spans, worker)
    assert all(s[1] is not None and s[2] >= s[1] >= 0 for s in spans)
    for q in queries:
        own, calls = _query_spans(queries, spans)[q.qid]
        assert {k: len(v) for k, v in own.items()} == \
            {"admit": 1, "batch_wait": 1, "done": 1}
        assert sorted(calls) == sorted((u, n) for u in (0, 1) for n in CALL)
        assert all(len(v) == 1 for v in calls.values())
        (admit,), (wait,), (done,) = own["admit"], own["batch_wait"], \
            own["done"]
        one = {k: v[0] for k, v in calls.items()}
        # the engine's own latency, read on its own clock beside it
        assert abs((done[2] - done[1]) / 1e9 - (q.done - q.arrival)) < 5e-3
        assert admit[1] == done[1] and admit[2] == wait[1]
        assert wait[2] == one[(0, "queue")][1]
        assert one[(0, "from_worker")][2] == one[(1, "queue")][1]
        assert one[(1, "from_worker")][2] == done[2]
        gaps = 0
        for u in (0, 1):
            c = [one[(u, n)] for n in CALL]
            fid = c[0][3]["fid"]
            assert all(s[3]["fid"] == fid for s in c)
            # inside the driver's submit -> fold of the same task
            assert c[0][2] <= c[2][1] and c[5][2] <= c[6][2]
            for a, b in zip(c, c[1:]):
                assert b[1] >= a[2]
                if (a[0], b[0]) not in (("resolve", "enqueue"),
                                        ("sync", "publish")):
                    assert b[1] == a[2], (a, b)
                gaps += b[1] - a[2]
        parts = admit[2] - admit[1] + wait[2] - wait[1] + sum(
            s[2] - s[1] for s in one.values())
        assert parts + gaps == done[2] - done[1]


def test_the_tracer_off_keeps_nothing_and_serves_the_same(tmp_path):
    """The same queries, arriving at once (so the batches are the same), on
    a traced and an untraced engine: the same completions, the same calls
    with the same outputs, and the untraced one recorded nothing."""
    runs = {on: _serve(tmp_path, f"on{on}", on, 16, qps=1e6)
            for on in (False, True)}
    (_, off, off_reports, off_calls) = runs[False]
    (_, on, on_reports, on_calls) = runs[True]
    assert off.qos.count() == on.qos.count() == 16
    assert off_calls == on_calls and len(off_calls[0]) == 4
    assert off.spans == [] and on.spans
    assert all(r["spans"] == [] and r["counters"] == []
               for r in off_reports.values())
    assert all(r["spans"] for r in on_reports.values())


def test_the_tracer_off_reads_no_clock(monkeypatch):
    """The threads backend runs the driver's call sites and the stage
    server's in this process: with the tracer off none reads its clock."""
    def no_clock(self):
        raise AssertionError("a clock read with the tracer off")
    monkeypatch.setattr(trace.Tracer, "now", no_clock)
    stages = [serving.CpuStageServer(f"s{i}", seq_len=8, vocab=64, spin=20)
              for i in range(2)]
    queries = serving.make_trace(12, qps=500.0, seq_len=8, vocab=64, seed=2)
    with serving.PipelineEngine(stages, batch_size=4, batch_timeout=0.01,
                                qos_target=30.0) as eng:
        stats = eng.run_trace(queries)
    assert stats.qos.count() == 12 and stats.spans == []
    assert trace.PROCESS.take() == {"spans": [], "counters": []}


def test_the_threads_backend_records_the_drivers_spans():
    """Traced, the threads backend records each query's ``admit``,
    ``batch_wait`` and ``done`` and each call's ``queue``."""
    stages = [serving.CpuStageServer(f"s{i}", seq_len=8, vocab=64, spin=20)
              for i in range(2)]
    queries = serving.make_trace(12, qps=500.0, seq_len=8, vocab=64, seed=2)
    with serving.PipelineEngine(stages, batch_size=4, batch_timeout=0.01,
                                qos_target=30.0, trace=True) as eng:
        stats = eng.run_trace(queries)
    names = collections.Counter(s[0] for s in stats.spans)
    assert names["admit"] == names["batch_wait"] == names["done"] == 12
    assert names["queue"] == 2 * stats.batches
    assert all(s[2] >= s[1] for s in stats.spans)


def test_link_joins_the_two_sides_of_a_task():
    """Worker spans of a task this run did not submit are left out; a
    task's ``to_worker`` starts at its submit and its ``from_worker`` at
    its publish; a fold with no publish (its worker died) is left out."""
    driver = [("queue", 10, 20, {"ti": 0, "stage": 0, "bid": 3, "fid": 7}),
              ("from_worker", None, 90, {"ti": 0, "stage": 0, "bid": 3,
                                         "fid": 7}),
              ("queue", 30, 40, {"ti": 0, "stage": 0, "bid": 4, "fid": 8}),
              ("from_worker", None, 95, {"ti": 0, "stage": 0, "bid": 4,
                                         "fid": 8})]
    ids = {"ti": 0, "stage": 0, "fid": 7}
    workers = [("to_worker", None, 25, ids), ("publish", 60, 80, ids),
               ("to_worker", None, 5, {"ti": 0, "stage": 0, "fid": 1})]
    got = trace.link(driver, workers)
    assert ("to_worker", 20, 25, {**ids, "bid": 3}) in got
    assert ("from_worker", 80, 90, driver[1][3]) in got
    assert not any(s[3]["fid"] == 1 for s in got)
    assert not any(s[0] == "from_worker" and s[3]["fid"] == 8 for s in got)
    assert len(got) == 5


def test_a_span_and_the_profilers_records_share_one_clock():
    """A CPU op run inside a span lies within it in ``torch.profiler``'s
    records."""
    from torch.profiler import ProfilerActivity, profile
    tracer = trace.Tracer(on=True)
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.001)
        t0 = tracer.now()
        torch.mm(x, x)
        t1 = tracer.now()
        tracer.span("mm", t0, t1)
        time.sleep(0.001)
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert t0 <= mm.start_ns() and mm.start_ns() + mm.duration_ns() <= t1
    assert tracer.take()["spans"] == [("mm", t0, t1, {})]


def test_a_traced_training_step_records_its_three_spans():
    """``batch_in``, ``fwd_bwd`` and ``update`` follow one another inside
    each call, and the losses are bit-equal to the untraced step's."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    data = DataConfig(seq_len=16, global_batch=2)
    losses, steps = {}, {}
    for on in (False, True):
        model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3)
        step = make_train_step(model, AdamWConfig(warmup_steps=0),
                               trace=on)
        state = init_adamw(dict(model.named_parameters()))
        losses[on], calls = [], []
        for k in range(3):
            t0 = time.time_ns()
            state, m = step(state, make_batch(cfg, data, k))
            calls.append((t0, time.time_ns()))
            losses[on].append(m["loss"].item())
        steps[on] = (step.tracer.take()["spans"], calls)
    assert losses[True] == losses[False]
    assert steps[False][0] == []
    spans, calls = steps[True]
    assert [s[0] for s in spans] == ["batch_in", "fwd_bwd", "update"] * 3
    for k, (t0, t1) in enumerate(calls):
        a, b, c = spans[3 * k: 3 * k + 3]
        assert t0 <= a[1] <= a[2] == b[1] <= b[2] == c[1] <= c[2] <= t1


def test_a_whisper_call_records_one_encode_inside_its_enqueue():
    """With the process's tracer on, one call of a reduced whisper stage
    records exactly one ``encode`` inside its ``enqueue``, under the
    call's ids; with it off, the same call records nothing and serves the
    same ids."""
    st = serving.ModelStageServer("text-translation", "whisper-medium", 16,
                                  reduced=True, device="cpu",
                                  dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, st.cfg.vocab_size, (3, 16)).astype(np.int32))
    tr = trace.PROCESS
    assert not tr.on
    off = st.process(tokens)
    assert tr.take() == {"spans": [], "counters": []}
    ids = {"ti": 0, "stage": 1, "fid": 5}
    tr.enable()
    try:
        tr.ids = ids
        on = st.process(tokens)
        spans = tr.take()["spans"]
    finally:
        tr.on, tr.ids = False, {}
    assert torch.equal(on, off)
    by = collections.defaultdict(list)
    for s in spans:
        by[s[0]].append(s)
    assert {k: len(v) for k, v in by.items()} == \
        {"enqueue": 1, "encode": 1, "sync": 1}
    (enq,), (enc,) = by["enqueue"], by["encode"]
    assert enq[1] <= enc[1] <= enc[2] <= enq[2]
    assert all(s[3] == ids for s in spans)
