"""The port on the card: the CUDA kernel against its plain version, and the
entry points' default device.  Every test here needs a CUDA device and
``nvcc`` and skips without them.  The file imports neither jax nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window,dtype", [
    (2, 16, 16, 16, 8, 128, True, None, torch.bfloat16),
    (2, 77, 77, 16, 16, 64, True, None, torch.bfloat16),
    (2, 77, 130, 4, 2, 32, True, None, torch.float32),
    (2, 100, 100, 4, 2, 16, True, 7, torch.float32),
    (2, 77, 90, 4, 2, 8, False, None, torch.float32),
])
def test_cuda_kernel_matches_plain(card, b, sq, skv, h, kvh, hd, causal,
                                   window, dtype):
    q, k, v = (torch.randn(*s, generator=card, device="cuda").to(dtype)
               for s in ((b * h, sq, hd), (b * kvh, skv, hd),
                         (b * kvh, skv, hd)))
    kw = dict(num_heads=h, num_kv_heads=kvh, causal=causal, window=window)
    before = fa.LAUNCHES
    out = fa.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        fa.attention_plain(q, k, v, **kw).float().cpu().numpy(),
        atol=tol, rtol=tol)


def test_cuda_kernel_refuses_unsupported_head_dim(card):
    q = torch.zeros(4, 8, 48, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bhsd(q, k, k, num_heads=4, num_kv_heads=2)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-0.5b"])
def test_cuda_prefill_runs_the_kernel_once_per_layer(card, arch):
    from repro_torch.models import Transformer
    cfg = get_config(arch, reduced=True)
    # device=None: the card; fp32, so that the argmax cannot turn on rounding
    model = Transformer(cfg, dtype=torch.float32, seed=0)
    assert model.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                           device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        before = fa.LAUNCHES
        logits, _ = model.serve_prefill(tokens)
        launched = fa.LAUNCHES - before
        plain, _ = model.serve_prefill(tokens,
                                       attention=ops.flash_attention_plain)
    assert launched == cfg.num_layers
    assert torch.isfinite(logits).all()
    assert torch.equal(logits.argmax(-1), plain.argmax(-1))


def test_cuda_stage_server_defaults_to_the_card(card):
    from repro_torch.serving import ModelStageServer
    stage = ModelStageServer("s0", "qwen3-0.6b", seq_len=8, reduced=True)
    out = stage.process(torch.zeros(2, 8, dtype=torch.int32, device="cuda"))
    assert out.device.type == "cuda"
    assert out.dtype == torch.int32 and out.shape == (2,)
