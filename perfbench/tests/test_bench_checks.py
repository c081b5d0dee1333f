"""The check that decides ``correct``, driven through the rest of a run on
the CPU at the port's reduced sizes (the look for a card skipped): a sound
run is correct, and each fault that a cell can have, planted underneath
the timed path, makes ``correct`` false.

Serving: a token altered where a stage produces it; half of the batch
left out.  Training: a step that returns its state unchanged; half of the
batch left out, the mean taken over the rest.  No cell crosses chips, so
no exchange between chips can be left out."""
import time

import pytest

from perfbench import util
from perfbench.run import RunContext, cell_metrics, drive, result

DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1,
          "memory_peak_bytes": 0}


def serve_run(fault=None):
    cfg = util.config("img-to-img")
    cfg["stages"] = [util.reduced(s) for s in cfg["stages"]]
    cell = util.cell("img-to-img.steady")
    cell["traffic"].update(rate_qps=20.0, prompt_tokens=32,
                           warmup_seconds=0.5, check_queries=16)
    ctx = RunContext("img-to-img.steady", cell, cfg, 2 ** 31 + 12345, 2.0,
                     False, "cpu", time.time(), fault=fault, reduced=True)
    obs = drive(ctx)
    return result(ctx, obs, cell_metrics(util.benchmark(), ctx.cell_name,
                                         False), DEVICE)


def train_run():
    cfg = util.reduced(util.config("qwen3-0.6b"))
    cell = util.cell("qwen3-0.6b.train")
    cell["traffic"].update(batch=4, seq_len=64)
    ctx = RunContext("qwen3-0.6b.train", cell, cfg, 2 ** 31 + 54321, 1.0,
                     False, "cpu", time.time(), reduced=True)
    obs = drive(ctx)
    return result(ctx, obs, cell_metrics(util.benchmark(), ctx.cell_name,
                                         False), DEVICE)


def test_serving_sound_run_is_correct():
    out = serve_run()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 40 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"p99_ms", "p50_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["alter_token", "half_batch"])
def test_serving_fault_is_not_correct(fault):
    out = serve_run(fault)
    assert not out["correct"], out["checks"]


def test_training_sound_run_is_correct():
    out = train_run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_training_state_unchanged_is_not_correct(monkeypatch):
    import repro_torch.training.train_step as ts
    from repro_torch.training.optimizer import AdamWState, global_norm

    def unchanged(grads, state, params, cfg):
        return dict(params), AdamWState(state.step + 1, state.mu,
                                        state.nu), {
            "grad_norm": global_norm(grads), "lr": 0.0}
    monkeypatch.setattr(ts, "adamw_update", unchanged)
    out = train_run()
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_is_not_correct(monkeypatch):
    from repro_torch.models import Transformer
    full = Transformer.forward_train

    def half(self, tokens, labels, *a, **k):
        n = tokens.shape[0] // 2
        return full(self, tokens[:n], labels[:n], *a, **k)
    monkeypatch.setattr(Transformer, "forward_train", half)
    out = train_run()
    assert not out["correct"], out["checks"]
