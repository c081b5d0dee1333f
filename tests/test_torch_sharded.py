"""The models' sharding hooks for real, the dense, mixture-of-experts and encoder-decoder models: four CPU
processes (gloo, a 2×2 (data, model) mesh) run the training loss and every
gradient, a prefill's logits and a decode step's with the parameters,
batch and cache laid out by ``ShardingRules`` as DTensors, against one
device (``tests/_sharded_loss.py``)."""
import pytest

from _sharded_loss import run, run_launcher


@pytest.mark.parametrize("arch", ['qwen3-0.6b', 'qwen3-moe-30b-a3b', 'whisper-medium'])
def test_sharded_run_on_four_gloo_ranks_equals_one_device(arch):
    """Within 1e-4 of the largest value (fp32; the sums run in another
    order)."""
    rec = run(arch)
    assert rec["sharded_params"] > 0
    for key in ("loss", "grads", "prefill_logits", "decode_logits"):
        assert rec[key] < 1e-4, (key, rec)


def test_train_launcher_on_four_gloo_ranks_equals_one_process():
    """``python -m repro_torch.launch.train`` (reduced qwen3-0.6b, bf16)
    on a torchrun-style world of four CPU ranks, its (4, 1) host mesh
    sharding the batch and the parameters by the rules, against one
    process: the same losses and gradient norms within bf16's rounding
    (2^-7 relative), the same learning rates."""
    sharded, one = run_launcher()
    assert len(sharded) == len(one) == 3
    for a, b in zip(sharded, one):
        assert a["lr"] == b["lr"]
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 2.0 ** -7 * abs(b[key]), \
                (key, a, b)
