"""The Whisper family (``perfbench/families/whisper.py``) and the cell
``text-to-text.steady`` on the CPU, at the port's reduced whisper-medium
(d 256, 4 heads of 64, ffn 512, 2 encoder layers over 64 frames, 1
decoder layer, vocab 512) on seeded weights.

Tolerances: the port and the reference both in fp32, the logits within
1e-4 (absolute and relative; they read within ~2e-6 here, the two sum in
other orders) and the loss within 1e-5 relative, the gradients within
1e-4 relative and 1e-6 absolute, as ``test_bench_reference.py`` holds the
Qwen family."""
import time

import numpy as np
import pytest
import torch

from perfbench import util
from perfbench.run import RunContext, cell_metrics, drive, metric_reader, result
from perfbench.weights import make_weights, names_and_shapes

CELL = "text-to-text.steady"
FULL = util.config("text-to-text")["stages"][1]
CFG = util.reduced(FULL)
WHISPER = util.family(FULL)
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1,
          "memory_peak_bytes": 0}
# the published keys of stage 1 and the port's norm eps, each of which the
# port's model has to run as stated
KEYS = ("d_model", "encoder_layers", "decoder_layers",
        "encoder_attention_heads", "decoder_attention_heads",
        "encoder_ffn_dim", "decoder_ffn_dim", "vocab_size",
        "max_source_positions", "max_target_positions", "norm_eps")


def port_config(reduced=True):
    from repro_torch.configs import get_config
    return get_config(FULL["arch"], reduced=reduced)


def port_model(seed, dtype=torch.float32):
    from repro_torch.models import Transformer
    m = Transformer(port_config(), device="cpu", dtype=dtype, init=False)
    make_weights(CFG, seed, "cpu", dtype, out=dict(m.named_parameters()))
    return m


def ref_weights(seed):
    return make_weights(CFG, seed, "cpu", torch.float32)


def prompts(n=3, s=40, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n, s)).astype(np.int32))


def zero_frames(n):
    pc = port_config()
    return torch.zeros(n, pc.encoder_seq_len, pc.d_model)


def test_the_family_is_the_configs_and_loads():
    assert FULL["family"] == "whisper"
    assert WHISPER.__file__ == str(util.PKG / "families" / "whisper.py")


def test_prefill_logits():
    tokens = prompts()
    with torch.no_grad():
        got, _ = port_model(11).serve_prefill(tokens,
                                              frames=zero_frames(3))
    want = WHISPER.last_logits(ref_weights(11), CFG, tokens, block=2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_served_token_is_the_references_argmax():
    """``ModelStageServer`` as a worker runs it (zero frames), with the
    benchmark's weights written over its model."""
    from repro_torch.serving import ModelStageServer
    tokens = prompts(4, 32, seed=5)
    st = ModelStageServer("text-translation", FULL["arch"], 32, reduced=True,
                          device="cpu", dtype=torch.float32)
    WHISPER.check_port(st.cfg, CFG)
    make_weights(CFG, 23, "cpu", torch.float32,
                 out=dict(st.model.named_parameters()))
    got = st.process(tokens)
    want = WHISPER.last_logits(ref_weights(23), CFG, tokens).argmax(-1)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got.long(), want)


def test_weight_groups_cover_every_leaf_once():
    names = [n for g in WHISPER.weight_groups(CFG) for n, _, _ in g]
    assert len(names) == len(set(names))
    params = {n: tuple(p.shape) for n, p in
              port_model(1).named_parameters()}
    assert names_and_shapes(CFG) == params
    assert {n.split(".")[0] for n in params} == {
        "embed", "final_norm", "lm_head", "layers", "enc_layers",
        "enc_final_norm"}


def test_check_port_passes_at_the_published_sizes():
    WHISPER.check_port(port_config(reduced=False), FULL)


@pytest.mark.parametrize("key", KEYS)
def test_check_port_raises_on_a_changed_key(key):
    port = port_config(reduced=False)
    bad = dict(FULL)
    if key == "max_target_positions":
        bad[key] = port.max_position_embeddings + 1
    elif key == "norm_eps":
        bad[key] = 1e-6
    else:
        bad[key] = FULL[key] * 2
    with pytest.raises(ValueError, match=key):
        WHISPER.check_port(port, bad)


def test_check_port_raises_on_another_model():
    from repro_torch.configs import get_config
    with pytest.raises(ValueError, match="layers"):
        WHISPER.check_port(get_config("qwen1.5-0.5b"), FULL)


def test_a_prompt_longer_than_the_decoder_takes_is_refused():
    tokens = torch.zeros(1, CFG["max_target_positions"] + 1,
                         dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        WHISPER.last_logits(ref_weights(1), CFG, tokens)


def test_training_loss_and_gradients():
    tokens, labels = prompts(2, 24, seed=7), prompts(2, 24, seed=8)
    m = port_model(13)
    params = dict(m.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = m.forward_train(tokens, labels, frames=zero_frames(2), remat=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    rloss, rgrads = WHISPER.loss_and_grads(ref_weights(13), CFG, tokens,
                                           labels)
    assert float(loss.detach()) == pytest.approx(rloss, rel=1e-5)
    for n in grads:
        torch.testing.assert_close(grads[n], rgrads[n], rtol=1e-4,
                                   atol=1e-6)


def test_prefill_flops():
    """B 1 x 448 tokens over 1,500 frames at the published sizes, by hand:
    encoder GEMMs 2 x 1,500 x (4 x 1024^2 + 3 x 1024 x 4096) x 24 and
    unmasked attention 4 x 16 x 1,500^2 x 64 x 24; decoder GEMMs 2 x 448 x
    (6 x 1024^2 + 3 x 1024 x 4096) x 24, cross k/v 2 x 1,500 x 2 x 1024^2 x
    24, causal self-attention 4 x 16 x 448^2 x 64 / 2 x 24, cross-attention
    4 x 16 x 448 x 1,500 x 64 x 24; the head 2 x 1024 x 51,865."""
    enc = 1_207_959_552_000 + 221_184_000_000
    dec = 405_874_409_472 + 150_994_944_000 + 9_865_003_008 + 66_060_288_000
    head = 106_219_520
    assert WHISPER.prefill_flops(FULL, 1, 448) == enc + dec + head
    assert enc + dec + head == 2_062_044_416_000
    assert WHISPER.prefill_flops(FULL, 4, 448) == 4 * (enc + dec + head)
    # training: 3x the forward, the head over every position
    assert WHISPER.train_flops(FULL, 1, 448) == 3 * (enc + dec + 448 * head)


def test_the_cell_loads_and_each_metric_has_a_reader():
    bench = util.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    cell = util.cell(CELL)
    assert entry["config"] == cell["config"] == "text-to-text"
    assert entry["chips"] == 1
    cfg = util.config(cell["config"])
    assert cfg["kind"] == "serve_vocab"
    assert [s["family"] for s in cfg["stages"]] == ["qwen", "whisper"]
    assert cfg["stages"][0] == {**util.config("img-to-img")["stages"][0],
                                "name": "text-summarization"}
    assert cell["traffic"]["prompt_tokens"] == FULL["max_target_positions"]
    e2e = {m["name"] for m in cell_metrics(bench, CELL, False)}
    layer = {m["name"] for m in cell_metrics(bench, CELL, True)}
    assert e2e == {"p99_ms", "p50_ms", "setup_s"}
    assert layer == {"stage_call_ms.t2t", "busy_share.t2t",
                     "batch_fill.t2t", "comm_share.t2t"}
    for name in e2e | layer:
        assert metric_reader(name)({}, "NVIDIA H100 80GB HBM3") is None


def test_the_text_to_text_readers_on_observations():
    """Each reader of the cell reads what the serving kind observes, as
    its ``.steady`` reader reads img-to-img."""
    obs = {"kind": "serve", "stage_calls": [100, 100], "batch": 4,
           "completed": 300, "comm_frac": 0.015, "compute_time_s": 12.0,
           "utilization": [70.0, 80.0]}
    dev = "NVIDIA H100 80GB HBM3"
    assert metric_reader("stage_call_ms.t2t")(obs, dev) == 60.0
    assert metric_reader("busy_share.t2t")(obs, dev) == 75.0
    assert metric_reader("batch_fill.t2t")(obs, dev) == 75.0
    assert metric_reader("comm_share.t2t")(obs, dev) == pytest.approx(1.5)
    for name in ("stage_call_ms", "busy_share", "batch_fill", "comm_share"):
        assert metric_reader(f"{name}.t2t")(obs, dev) == \
            metric_reader(f"{name}.steady")(obs, dev)


def test_the_hand_off_check_reduces_stage_0s_tokens_by_stage_1s_vocabulary(
        monkeypatch):
    """At the published vocabularies (151,936 into 51,865), the reduced
    models' being one (512): stage-1 rows that hold stage 0's tokens
    modulo 51,865 are the hand-off, and each sampled query finds its
    stage-1 call; ``serve.check``, which compares the tokens as produced,
    counts every call as a mismatch and finds no stage-1 call."""
    from types import SimpleNamespace

    from perfbench.kinds import serve, serve_vocab
    cfg = util.config("text-to-text")
    vocab1 = cfg["stages"][1]["vocab_size"]
    rng = np.random.default_rng(0)
    qs = [SimpleNamespace(qid=i, tokens=rng.integers(0, 151_936, 16),
                          done=1.0) for i in range(8)]
    outs = [np.array([60_000 + i, 70_000 + i, 51_864, 3 + i], np.int32)
            for i in range(2)]
    handed = [np.repeat((o % vocab1)[:, None], 16, axis=1) for o in outs]
    window = [[(0, 1, np.stack([q.tokens[:8] for q in qs[4 * c:4 * c + 4]]),
                outs[c]) for c in range(2)],
              [(2, 3, handed[c][:, :8], np.arange(4, dtype=np.int32))
               for c in range(2)]]
    found = {}

    def gaps(ctx, sample, served0, where, by_input, stage_cfgs, seed):
        found[len(found)] = [by_input.get(where[q.qid][0]) is not None
                             for q in sample]
        return 0.0, 0.0 if all(found[len(found) - 1]) else float("inf")
    monkeypatch.setattr(serve, "reference_gaps", gaps)
    ctx = SimpleNamespace(cell=util.cell(CELL))
    got = serve_vocab.check(ctx, qs, None, None, window, cfg["stages"], 5)
    assert {k: v for k, (v, _) in got.items()} == {
        "not_served_once": 0, "handoff_mismatches": 0, "gap_stage0": 0.0,
        "gap_stage1": 0.0, "checked_queries": 8}
    assert found[0] == [True] * 8
    old = serve.check(ctx, qs, None, None, window, cfg["stages"], 5)
    assert old["handoff_mismatches"][0] == 4
    assert old["gap_stage1"][0] == float("inf") and found[1] == [False] * 8
    # a stage-1 call that took another token in is a mismatch here too
    window[1][0] = (2, 3, handed[0][:, :8] + 1, np.arange(4, dtype=np.int32))
    got = serve_vocab.check(ctx, qs, None, None, window, cfg["stages"], 5)
    assert got["handoff_mismatches"][0] == 2


def test_the_hand_off_check_pairs_calls_whose_tokens_share_a_residue(
        monkeypatch):
    """Two one-row stage-0 calls whose tokens differ by 51,865 hand stage 1
    the same row: each stage-1 call is paired with one of them, so a sound
    hand-off reads no mismatch and every sampled query finds its stage-1
    output; a third stage-1 call of that row is one mismatch."""
    from types import SimpleNamespace

    from perfbench.kinds import serve, serve_vocab
    cfg = util.config("text-to-text")
    vocab1 = cfg["stages"][1]["vocab_size"]
    rng = np.random.default_rng(1)
    qs = [SimpleNamespace(qid=i, tokens=rng.integers(0, 151_936, 16),
                          done=1.0) for i in range(2)]
    outs = [np.array([9 + vocab1], np.int32), np.array([9 + 2 * vocab1],
                                                       np.int32)]
    window = [[(0, 1, q.tokens[None, :8], o) for q, o in zip(qs, outs)],
              [(2, 3, np.full((1, 8), 9, np.int32), np.array([4], np.int32))
               for _ in outs]]
    monkeypatch.setattr(serve, "reference_gaps",
                        lambda ctx, sample, served0, where, by_input, *a: (
                            0.0, 0.0 if all(where[q.qid][0] in by_input
                                            for q in sample) else 1.0))
    ctx = SimpleNamespace(cell=util.cell(CELL))
    got = serve_vocab.check(ctx, qs, None, None, window, cfg["stages"], 5)
    assert {k: v for k, (v, _) in got.items()} == {
        "not_served_once": 0, "handoff_mismatches": 0, "gap_stage0": 0.0,
        "gap_stage1": 0.0, "checked_queries": 2}
    window[1].append(window[1][0])
    got = serve_vocab.check(ctx, qs, None, None, window, cfg["stages"], 5)
    assert got["handoff_mismatches"][0] == 1


def serve_run(monkeypatch, fault=None):
    # one intra-op thread a spawned worker: three workers, each with both
    # stages, beside the other tests' processes on a few cores would
    # otherwise stall a worker past the engine's 5-s heartbeat
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = util.config("text-to-text")
    cfg["stages"] = [util.reduced(s) for s in cfg["stages"]]
    cell = util.cell(CELL)
    cell["traffic"].update(rate_qps=20.0, prompt_tokens=32,
                           warmup_seconds=0.5, check_queries=16)
    ctx = RunContext(CELL, cell, cfg, 2 ** 31 + 4321, 2.0, False, "cpu",
                     time.time(), fault=fault, reduced=True)
    obs = drive(ctx)
    return result(ctx, obs, cell_metrics(util.benchmark(), CELL, False),
                  DEVICE)


def test_serving_sound_run_is_correct(monkeypatch):
    out = serve_run(monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 40 and out["failed"] == 0
    assert out["checks"]["checked_queries"]["value"] == 16
    assert set(out["metrics"]) == {"p99_ms", "p50_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["alter_token", "half_batch"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    out = serve_run(monkeypatch, fault)
    assert not out["correct"], out["checks"]
