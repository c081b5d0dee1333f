"""Operations and bytes against values worked by hand from the published
shapes of qwen3-0.6b and qwen1.5-0.5b: the shared counts of
``perfbench.counts``, and the Qwen family's (``families/qwen.py``)."""
import pytest

from perfbench import counts, util

QWEN3 = util.config("qwen3-0.6b")
QWEN15 = util.config("img-to-img")["stages"][1]
QWEN = util.family(QWEN3)


def test_layer_weights():
    # q 1024x2048, k and v 1024x1024 each, o 2048x1024, gate/up/down 3x1024x3072
    assert QWEN.layer_matmul_params(QWEN3) == 15_728_640
    # q, k, v, o 1024x1024 each; 3x1024x2816
    assert QWEN.layer_matmul_params(QWEN15) == 12_845_056


def test_train_step_flops():
    # 6 x (28 x 15,728,640 + 1024 x 151,936) x 16,384 tokens
    linear = 6 * 595_984_384 * 16_384
    # 3 x 28 layers x 4 x B 8 x H 16 x 2048^2 x 128 / 2
    attn = 3 * 28 * 137_438_953_472
    assert QWEN.train_flops(QWEN3, 8, 2048) == linear + attn
    assert QWEN.train_flops(QWEN3, 8, 2048) == pytest.approx(7.0133e13,
                                                             rel=1e-4)


def test_prefill_flops():
    # qwen3: 2 x 440,401,920 x 1024 + 28 x 4,294,967,296 + 2 x 1024 x 151,936
    q3 = 2 * 440_401_920 * 1024 + 28 * 4_294_967_296 + 311_164_928
    assert QWEN.prefill_flops(QWEN3, 1, 1024) == q3
    # qwen1.5: 2 x 308,281,344 x 1024 + 24 x 4 x 16 x 1024^2 x 64 / 2 + head
    q15 = 2 * 308_281_344 * 1024 + 24 * 2_147_483_648 + 311_164_928
    assert QWEN.prefill_flops(QWEN15, 1, 1024) == q15
    assert (q3 + q15) == pytest.approx(1.7057e12, rel=1e-3)


def test_attention_kernels():
    # B 4, S 2048, 16/8/128: PERF.md's forward bound of 0.0695 ms
    flops, nbytes = counts.attention_fwd_kernel(4, 2048, 16, 8, 128,
                                                writes_lse=False)
    assert flops == 68_719_476_736
    assert nbytes == 2 * 4 * 2048 * 16 * 128 * 2 + 2 * 4 * 2048 * 8 * 128 * 2
    assert counts.roofline_s(flops, nbytes, "NVIDIA H100 80GB HBM3") * 1e3 \
        == pytest.approx(0.0695, abs=1e-4)
    bflops, bbytes = counts.attention_bwd_kernel(4, 2048, 16, 8, 128)
    assert bflops == 2.5 * flops
    assert counts.roofline_s(bflops, bbytes, "H100") * 1e3 == pytest.approx(
        0.1737, abs=1e-3)
    # with the log-sum-exp the forward writes under grad
    assert counts.attention_fwd_kernel(4, 2048, 16, 8, 128)[1] == \
        nbytes + 4 * 16 * 2048 * 4


def test_peaks_by_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert counts.peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
