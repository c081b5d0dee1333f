"""The controls: the fp8 reference in the program's place.  On the CPU at
the reduced sizes its readings lie above the bf16 program's; on the card
(skipped here) at the cells' own sizes, on one seed, it fails the cells'
limits, as ``perfbench/control.py`` shows over more seeds."""

import numpy as np
import pytest
import torch

from perfbench import reference, util
from perfbench.weights import make_weights


def test_fp8_rounding():
    x = torch.tensor([0.0, 1.0, -3.0, 448.0, 1e-3])
    y = reference.fp8_round(x)
    assert y[0] == 0 and y[3] == 448.0 and y[1] == 1.0
    assert float((y - x).abs().max()) > 0          # 1e-3 is not kept
    g = torch.ones(5, requires_grad=True)
    reference.fp8_round(g * 3).sum().backward()
    assert torch.equal(g.grad, torch.full((5,), 3.0))


def test_fp8_control_departs_more_than_bf16_on_the_cpu():
    cfg = util.reduced(util.config("img-to-img")["stages"][0])
    w = make_weights(cfg, 21, "cpu", torch.bfloat16)
    w = {k: t.float() for k, t in w.items()}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], (16, 64)).astype(np.int32))
    last_logits = util.family(cfg).last_logits
    ref = last_logits(w, cfg, tokens, "fp32")
    low = last_logits(w, cfg, tokens, "fp8")
    assert float((low - ref).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["img-to-img.steady", "qwen3-0.6b.train"])
def test_control_fails_the_limits_on_the_card(card, name):
    from perfbench.control import serve_control, train_control
    cell = util.cell(name)
    cfg = util.config(cell["config"])
    limits = cell["limits"]
    if cfg["kind"] == "serve":
        r = serve_control(cell, cfg, 2 ** 31 + 7, util.benchmark()[
            "run_seconds"], card)
        assert any(r[k] > limits[k] for k in ("gap_stage0", "gap_stage1"))
    else:
        for r in train_control(cell, cfg, 2 ** 31 + 7, card):
            assert any(r[k] > limits[k] for k in limits), r
