"""The models' sharding hooks for real, the recurrent models (Mamba with MoE; mLSTM and sLSTM, trained pure-DP): four CPU
processes (gloo, a 2×2 (data, model) mesh) run the training loss and every
gradient, a prefill's logits and a decode step's with the parameters,
batch and cache laid out by ``ShardingRules`` as DTensors, against one
device (``tests/_sharded_loss.py``)."""
import pytest

from _sharded_loss import run


@pytest.mark.parametrize("arch", ['jamba-v0.1-52b', 'xlstm-1.3b'])
def test_sharded_run_on_four_gloo_ranks_equals_one_device(arch):
    """Within 1e-4 of the largest value (fp32; the sums run in another
    order)."""
    rec = run(arch)
    assert rec["sharded_params"] > 0
    for key in ("loss", "grads", "prefill_logits", "decode_logits"):
        assert rec[key] < 1e-4, (key, rec)
