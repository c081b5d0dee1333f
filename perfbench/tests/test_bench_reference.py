"""The plain reference (each config's family, ``perfbench/families/``)
against the port on the CPU at the port's reduced sizes, both in fp32 from
the same seeded weights: the prefill's last logits, the training loss and
gradients, and AdamW's first steps."""
import numpy as np
import pytest
import torch

from perfbench import reference, util
from perfbench.kinds.train import make_batch, opt_config
from perfbench.weights import make_weights, names_and_shapes

STAGES = [util.reduced(s) for s in util.config("img-to-img")["stages"]]
TRAIN = util.reduced(util.config("qwen3-0.6b"))


def port_model(cfg, seed, dtype=torch.float32):
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    m = Transformer(get_config(cfg["arch"], reduced=True), device="cpu",
                    dtype=dtype, init=False)
    make_weights(cfg, seed, "cpu", dtype, out=dict(m.named_parameters()))
    return m


def ref_weights(cfg, seed):
    return make_weights(cfg, seed, "cpu", torch.float32)


def test_weight_names_are_the_ports():
    for cfg in STAGES:
        m = port_model(cfg, 1)
        assert {n: tuple(p.shape) for n, p in m.named_parameters()} == \
            names_and_shapes(cfg)


def test_weights_repeat_from_the_seed():
    a = make_weights(STAGES[1], 7, "cpu", torch.bfloat16)
    b = make_weights(STAGES[1], 7, "cpu", torch.bfloat16)
    c = make_weights(STAGES[1], 8, "cpu", torch.bfloat16)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.wq"], c["layers.0.wq"])
    assert float(a["layers.0.bq"].abs().max()) > 0      # biases are drawn


@pytest.mark.parametrize("stage", [0, 1])
def test_prefill_logits(stage):
    cfg = STAGES[stage]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (3, 40)).astype(np.int32))
    with torch.no_grad():
        got, _ = port_model(cfg, 11).serve_prefill(tokens)
    want = util.family(cfg).last_logits(ref_weights(cfg, 11), cfg, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_training_loss_and_gradients():
    cfg = TRAIN
    bt = make_batch(cfg["vocab_size"], 32, 2, 5, 0)
    m = port_model(cfg, 13)
    params = dict(m.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = m.forward_train(torch.from_numpy(bt["tokens"]),
                           torch.from_numpy(bt["labels"]), remat=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    rloss, rgrads = util.family(cfg).loss_and_grads(
        ref_weights(cfg, 13), cfg, torch.from_numpy(bt["tokens"]),
        torch.from_numpy(bt["labels"]))
    assert float(loss) == pytest.approx(rloss, rel=1e-5)
    for n in grads:
        torch.testing.assert_close(grads[n], rgrads[n], rtol=1e-4,
                                   atol=1e-6)


def test_the_batches_are_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.training import DataConfig
    from repro_torch.training import make_batch as port_batch
    c = get_config("qwen3-0.6b", reduced=True)
    for step in (0, 3):
        got = make_batch(c.vocab_size, 16, 4, 2 ** 31 + 5, step)
        want = port_batch(c, DataConfig(seq_len=16, global_batch=4,
                                        seed=2 ** 31 + 5), step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_adamw_steps(store):
    """The reference's AdamW against the port's train step: in fp32 the
    parameters agree after two steps; stored in bf16, each leaf's change
    agrees (the program computes in bf16, so a few elements round the
    other way)."""
    from repro_torch.training import AdamWConfig, init_adamw, make_train_step
    cfg = TRAIN
    opt = opt_config(util.config("qwen3-0.6b"))
    batches = [make_batch(cfg["vocab_size"], 16, 2, 9, k) for k in range(2)]
    m = port_model(cfg, 17, store)
    named = dict(m.named_parameters())
    step = make_train_step(m, AdamWConfig(**opt), remat=False)
    state = init_adamw(named)
    for bt in batches:
        state, _ = step(state, bt)
    w = ref_weights(cfg, 17)
    w = {n: t.to(store).float() for n, t in w.items()}
    start = {n: t.clone() for n, t in w.items()}
    tb = [{k: torch.from_numpy(v) for k, v in bt.items()} for bt in batches]
    out = reference.adamw_steps(util.family(cfg).loss_and_grads, w, cfg, tb,
                                opt, store)
    if store == torch.float32:
        # elements whose gradient is near Adam's eps may turn either way:
        # held by the norm of the leaf's difference against its change
        for n in named:
            diff = float((named[n] - w[n]).norm())
            assert diff <= 1e-3 * out["change"][n] + 1e-9, n
    else:
        for n in named:
            ch = float((named[n].float() - start[n]).norm())
            assert ch == pytest.approx(out["change"][n], rel=0.05, abs=1e-6)
