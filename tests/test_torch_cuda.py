"""The port on the card: the CUDA kernels against their plain versions (the
prefill-attention, mLSTM and scan backwards against autograd through the
plain versions or their plain backwards), the entry points' default
device, training through the kernels, and the
process backend's device arena (CUDA IPC between spawned processes).  Every test here needs a CUDA device and
``nvcc`` and skips without them.  The file imports neither jax nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import mlstm_scan, ops
from repro_torch.kernels import ssm_scan
from repro_torch.serving.transport import DeviceArena

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
    # bf16 twins on the tensor-core kernel: Sq = 1, Skv off the 128-key
    # tile, windows 1 / 7 / 64, a window without causal, no key left
    (2, 1, 77, 4, 2, 128, True, None, torch.bfloat16),
    (2, 77, 130, 4, 2, 32, True, None, torch.bfloat16),
    (2, 130, 77, 4, 4, 8, True, None, torch.bfloat16),
    (2, 300, 300, 4, 2, 128, True, 1, torch.bfloat16),
    (2, 100, 100, 4, 2, 16, True, 7, torch.bfloat16),
    (2, 300, 300, 4, 2, 64, True, 64, torch.bfloat16),
    (2, 77, 90, 4, 2, 8, False, None, torch.bfloat16),
    (2, 77, 77, 4, 2, 32, False, 7, torch.bfloat16),
    (2, 300, 100, 4, 2, 128, True, 64, torch.bfloat16),
    # starcoder2-3b's heads and window, shortened
    (1, 600, 600, 24, 2, 128, True, 512, torch.bfloat16),
    # whisper-medium: the encoder (no mask, 1,500 frames off the 128-key
    # tile) and the cross-attention of 16 and 1 decoder tokens over it
    (1, 1500, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (2, 16, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (2, 1, 1500, 16, 16, 64, False, None, torch.bfloat16),
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


@pytest.mark.parametrize("hd,dtype", [(128, torch.bfloat16),
                                      (64, torch.bfloat16),
                                      (8, torch.bfloat16),
                                      (32, torch.float32)])
def test_cuda_kernel_reads_the_model_layout_in_place(card, hd, dtype):
    """q, k, v as strided (B, S, H, hd) slices of one fused projection go
    through ``ops.flash_attention`` with one launch and no copy; the
    output is (B, S, H, hd) and contiguous."""
    b, s, h, kvh = 2, 150, 8, 2
    qkv = torch.randn(b, s, h + 2 * kvh, hd, generator=card,
                      device="cuda").to(dtype)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    before = fa.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        ops.flash_attention_plain(q, k, v, causal=True).float().cpu()
        .numpy(), atol=tol, rtol=tol)


def test_cuda_kernel_refuses_misaligned_rows(card):
    q = torch.zeros(1, 8, 4, 17, device="cuda",
                    dtype=torch.bfloat16)[..., :16]
    k = torch.zeros(1, 8, 2, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bshd(q, k, k)


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


def test_cuda_whisper_prefill_and_decode_run_the_kernels(card):
    """Reduced whisper-medium in fp32 on the card (device=None): a prefill
    launches the prefill kernel for each encoder layer and twice per
    decoder layer (self and cross), a decode step the decode kernel twice
    per decoder layer; argmax equal to the plain ops' run."""
    from repro_torch.models import Transformer
    cfg = get_config("whisper-medium", reduced=True)
    model = Transformer(cfg, dtype=torch.float32, seed=0)
    assert model.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=card,
                           device="cuda", dtype=torch.int32)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model,
                         generator=card, device="cuda")
    with torch.inference_mode():
        before = fa.LAUNCHES
        logits, cache = model.serve_prefill(tokens, cache_len=23,
                                            frames=frames)
        launched = fa.LAUNCHES - before
        plain, plain_cache = model.serve_prefill(
            tokens, cache_len=23, frames=frames,
            attention=ops.flash_attention_plain)
        assert torch.equal(logits.argmax(-1), plain.argmax(-1))
        before = dec.LAUNCHES
        for _ in range(3):
            t = logits.argmax(-1)
            logits, cache = model.serve_decode(t, cache)
            plain, plain_cache = model.serve_decode(
                t, plain_cache, decode_attention=ops.decode_attention_plain)
            assert torch.equal(logits.argmax(-1), plain.argmax(-1))
        decoded = dec.LAUNCHES - before
    assert launched == cfg.num_encoder_layers + 2 * cfg.num_layers
    assert decoded == 2 * cfg.num_layers * 3
    assert torch.isfinite(logits).all()


def test_cuda_whisper_stage_serves_on_the_card(card):
    from repro_torch.serving import ModelStageServer
    stage = ModelStageServer("text-translation", "whisper-medium",
                             seq_len=8, reduced=True)
    before = fa.LAUNCHES
    out = stage.process(torch.zeros(2, 8, dtype=torch.int32, device="cuda"))
    assert fa.LAUNCHES - before == stage.cfg.num_encoder_layers \
        + 2 * stage.cfg.num_layers
    assert out.device.type == "cuda"
    assert out.dtype == torch.int32 and out.shape == (2,)


def test_cuda_stage_server_defaults_to_the_card(card):
    from repro_torch.serving import ModelStageServer
    stage = ModelStageServer("s0", "qwen3-0.6b", seq_len=8, reduced=True)
    out = stage.process(torch.zeros(2, 8, dtype=torch.int32, device="cuda"))
    assert out.device.type == "cuda"
    assert out.dtype == torch.int32 and out.shape == (2,)


# attention backward: (B, Sq, Skv, H, KVH, hd, causal, window) at the
# model zoo's heads (qwen3 16/8/128, qwen1.5 16/16/64, starcoder2's window,
# granite's MQA G 48, whisper's encoder and cross-attention), shortened
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", [
    (2, 200, 200, 16, 8, 128, True, None),
    (2, 131, 131, 16, 16, 64, True, None),
    (1, 300, 300, 24, 2, 128, True, 100),
    (1, 130, 130, 48, 1, 128, True, None),
    (2, 150, 150, 16, 16, 64, False, None),
    (2, 45, 150, 16, 16, 64, False, None),
    # window 2, not 1: a one-key softmax has dq = dk = 0 exactly, which a
    # bound relative to the plain gradient cannot hold the kernel to
    (2, 70, 70, 4, 2, 8, True, 2),
    (2, 33, 77, 4, 2, 16, True, None),
    # the wgmma route (bf16) at its edges: causal with Sq < Skv, a window
    # narrower than S at hd 64, and G 48 at a length whose dK/dV pass
    # splits the query heads over blocks
    (2, 150, 260, 16, 8, 128, True, None),
    (2, 300, 300, 16, 16, 64, True, 64),
    (1, 260, 260, 48, 1, 128, True, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_backward_matches_plain(card, b, sq, skv, h, kvh, hd,
                                               causal, window, dtype):
    """dq, dk, dv of the backward kernel against autograd through the
    plain version in fp32 on the same (rounded) inputs, each within 1e-3
    (fp32) or 2e-2 (bf16: the output and the gradients rounded to bf16) of
    the plain gradient's largest entry."""
    q, dout = (torch.randn(b, sq, h, hd, generator=card,
                           device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, kvh, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd) == (1, 1)
    ref_leaves = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(ops.flash_attention_plain(
        *ref_leaves, causal=causal, window=window), ref_leaves, dout.float())
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert (g.float() - r).abs().max() <= tol * r.abs().max()


@pytest.mark.parametrize("b,s,h,kvh,splits", [(2, 2304, 16, 8, 1),
                                              (1, 260, 48, 1, 48)])
def test_cuda_attention_backward_runs_its_route(card, b, s, h, kvh, splits):
    """One bf16 backward launch at hd 128 runs, each once, exactly the
    kernels ``bwd_passes`` names: the wgmma passes, with the reduction of
    the dK/dV partials where ``bwd_splits`` splits the query heads (G 48
    at a short S) and without it where it does not (16/8 with 288 dK/dV
    blocks)."""
    hd = 128
    q, dout = (torch.randn(b, s, h, hd, generator=card, device="cuda")
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, kvh, hd, generator=card, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    fa._launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               out.transpose(1, 2), True, None, lse)
    grads = [torch.empty_like(t) for t in (q, k, v)]

    def backward():
        fa._launch_bwd(*(t.transpose(1, 2) for t in (q, k, v, out, dout)),
                       lse, *(t.transpose(1, 2) for t in grads), True, None)
    backward()                                     # built, warm
    torch.cuda.synchronize()
    ran = sorted(_kernels_run(backward, fa.BWD_KERNELS))
    assert fa.bwd_splits(b, kvh, s, h // kvh) == splits
    assert ran == sorted(fa.bwd_passes(hd, torch.bfloat16, splits))
    assert ("bwd_dkdv_reduce_kernel" in ran) == (splits > 1)


def test_cuda_serving_writes_no_lse_and_launches_no_backward(card):
    q = torch.randn(1, 64, 4, 64, generator=card, device="cuda")
    k = torch.randn(1, 64, 2, 64, generator=card, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    bwd = fa.BWD_LAUNCHES
    with torch.no_grad():
        out = ops.flash_attention(*leaves)
    assert out.grad_fn is None
    out = ops.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert fa.BWD_LAUNCHES == bwd


def test_cuda_attention_refuses_grad_through_rows_with_no_key(card):
    """Sq >= Skv + window leaves the last rows with no key: their output is
    the mean of V, whose gradient the backward kernel does not give, so the
    call is refused under grad; without grad it runs."""
    q = torch.randn(1, 12, 4, 64, generator=card, device="cuda")
    k = torch.randn(1, 8, 2, 64, generator=card, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(*leaves, causal=True, window=4)
    ops.flash_attention(*leaves, causal=True, window=5)   # Sq < Skv + 5
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=True, window=4)


@pytest.mark.parametrize("op", ["decode_attention"])
def test_cuda_kernels_without_backward_raise_under_grad(card, op):
    qd = torch.randn(1, 1, 4, 64, generator=card, device="cuda") \
        .requires_grad_(True)
    kd = torch.randn(1, 32, 2, 64, generator=card, device="cuda")
    call = {"decode_attention": lambda: ops.decode_attention(qd, kd, kd,
                                                             32)}[op]
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call()
    with torch.no_grad():
        call()


def test_cuda_mlstm_and_scan_are_differentiable(card):
    """``ops.mlstm_chunk`` and ``ops.ssm_scan`` under grad on the card: one
    forward and one backward launch per call, finite gradients for every
    input that asks for one."""
    q, k, v = (torch.randn(1, 2, 16, 64, generator=card, device="cuda")
               .requires_grad_(True) for _ in range(3))
    gates = [torch.randn(1, 2, 16, generator=card, device="cuda")
             .requires_grad_(True) for _ in range(2)]
    carry = (torch.zeros(1, 2, 64, 64, device="cuda"),
             torch.zeros(1, 2, 64, device="cuda"),
             torch.full((1, 2), -1e30, device="cuda"))
    fwd, bwd = mlstm_scan.LAUNCHES, mlstm_scan.BWD_LAUNCHES
    h, _ = ops.mlstm_chunk(q, k, v, *gates, *carry)
    grads = torch.autograd.grad(h.square().sum(), [q, k, v, *gates])
    torch.cuda.synchronize()
    assert (mlstm_scan.LAUNCHES - fwd, mlstm_scan.BWD_LAUNCHES - bwd) \
        == (1, 1)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    da = torch.rand(1, 8, 16, 4, generator=card, device="cuda") \
        .requires_grad_(True)
    dbx = torch.randn(1, 8, 16, 4, generator=card, device="cuda") \
        .requires_grad_(True)
    fwd, bwd = ssm_scan.LAUNCHES, ssm_scan.BWD_LAUNCHES
    g_da, g_dbx = torch.autograd.grad(ops.ssm_scan(da, dbx).sum(),
                                      [da, dbx])
    torch.cuda.synchronize()
    assert (ssm_scan.LAUNCHES - fwd, ssm_scan.BWD_LAUNCHES - bwd) == (1, 1)
    assert torch.isfinite(g_da).all() and torch.isfinite(g_dbx).all()


@pytest.mark.parametrize("b,l,d,st", [(1, 1, 3, 5), (2, 40, 7, 9),
                                      (2, 17, 100, 16), (1, 256, 512, 16)])
def test_cuda_ssm_backward_matches_plain(card, b, l, d, st):
    """The scan's backward kernel against autograd through the plain scan
    and against ``ssm_chunk_scan_bwd_plain``: equal bit for bit (each
    product and each two-term sum rounded to fp32 on its own)."""
    da = torch.sigmoid(torch.randn(b, l, d, st, generator=card,
                                   device="cuda"))
    dbx = torch.randn(b, l, d, st, generator=card, device="cuda") * 0.1
    dh = torch.randn(b, l, d, st, generator=card, device="cuda")
    h = ssm_scan.ssm_chunk_scan(da, dbx)
    before = ssm_scan.BWD_LAUNCHES
    got = ssm_scan.ssm_chunk_scan_bwd(da, h, dh)
    torch.cuda.synchronize()
    assert ssm_scan.BWD_LAUNCHES == before + 1
    leaves = [t.clone().requires_grad_(True) for t in (da, dbx)]
    ref = torch.autograd.grad(ssm_scan.ssm_chunk_scan_plain(*leaves),
                              leaves, dh)
    spec = ssm_scan.ssm_chunk_scan_bwd_plain(da, h, dh)
    for g, r, p in zip(got, ref, spec):
        assert torch.equal(g, r) and torch.equal(g, p)


@pytest.mark.parametrize("bh,l,hd,dtype,state", [
    (4, 1, 8, torch.float32, "first"),
    (4, 17, 16, torch.bfloat16, "padded"),
    (4, 7, 64, torch.float32, "padded"),
    (4, 16, 128, torch.bfloat16, "carried"),
    (2, 256, 1024, torch.bfloat16, "carried"),   # xlstm-1.3b's train chunk
    (2, 256, 1024, torch.float32, "first"),
    # the tensor-core route at its edges: one step padded to 16 from the
    # first state, and a two-block chunk with padded steps
    (4, 1, 64, torch.bfloat16, "first"),
    (2, 17, 1024, torch.bfloat16, "padded"),
])
def test_cuda_mlstm_backward_matches_plain(card, bh, l, hd, dtype, state):
    """Every gradient of the mLSTM backward kernel against
    ``mlstm_chunk_bwd_plain`` on the same (rounded) inputs and the plain
    forward's h: max |diff| within 1e-3 (fp32) or 2e-2 (bf16: the kernel's
    h from the tensor-core forward, dq, dk, dv rounded to bf16) of the
    leaf's largest |plain| entry (di and df over the larger of the two),
    chip_smoke.py's MLSTM_BWD_TOL."""
    pad = 5 if state == "padded" else 0
    xs = _mlstm_chunk(card, bh, l, hd, dtype, pad)
    if state == "first":
        carry = (torch.zeros(bh, hd, hd, device="cuda"),
                 torch.zeros(bh, hd, device="cuda"),
                 torch.full((bh,), -1e30, device="cuda"))
    else:
        carry = (torch.randn(bh, hd, hd, generator=card, device="cuda"),
                 torch.randn(bh, hd, generator=card, device="cuda"),
                 torch.randn(bh, generator=card, device="cuda"))
    ups = (torch.randn(bh, l, hd, generator=card, device="cuda"),
           torch.randn(bh, hd, hd, generator=card, device="cuda"),
           torch.randn(bh, hd, generator=card, device="cuda"))
    h = mlstm_scan.mlstm_chunk_step(*xs, *carry)[0]
    before = mlstm_scan.BWD_LAUNCHES
    got = mlstm_scan.mlstm_chunk_bwd(*xs, *carry, h, *ups)
    torch.cuda.synchronize()
    assert mlstm_scan.BWD_LAUNCHES == before + 1
    h_plain = mlstm_scan.mlstm_chunk_plain(*xs, *carry)[0]
    ref = mlstm_scan.mlstm_chunk_bwd_plain(*xs, *carry, h_plain, *ups)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    gate = max(ref[3].abs().max().item(), ref[4].abs().max().item())
    for i, (g, r, x) in enumerate(zip(got, ref, (*xs, *carry))):
        assert g.dtype == x.dtype and g.shape == x.shape
        scale = gate if i in (3, 4) else r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        assert err <= tol * scale if scale > 0 else err == 0, (i, err, scale)


def _kernels_run(fn, names) -> list:
    """Which of the kernels ``names`` (matched as substrings) one call of
    ``fn`` launches, in launch order, by torch.profiler.  The call follows
    256 spin kernels, as chip_smoke.py's profiles do: the profiler can lose
    the first device records of a profile, so one that kept none of the
    spins is taken again, up to three times."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(256):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA),
                        key=lambda e: e.start_ns())
        if any("spin_kernel" in e.name() for e in events):
            break
    return [next(n for n in names if n in e.name()) for e in events
            if any(n in e.name() for n in names)]


def test_cuda_mlstm_backward_runs_its_route(card):
    """One bf16 backward launch at hd 1024 runs, each once, exactly the
    kernels ``bwd_passes`` names (the tensor-core route), in that order."""
    bh, l, hd = 2, 256, 1024
    xs = _mlstm_chunk(card, bh, l, hd, torch.bfloat16, 0)
    carry = (torch.randn(bh, hd, hd, generator=card, device="cuda"),
             torch.randn(bh, hd, generator=card, device="cuda"),
             torch.randn(bh, generator=card, device="cuda"))
    ups = (torch.randn(bh, l, hd, generator=card, device="cuda"),
           torch.randn(bh, hd, hd, generator=card, device="cuda"),
           torch.randn(bh, hd, generator=card, device="cuda"))
    h = mlstm_scan.mlstm_chunk_step(*xs, *carry)[0]
    mlstm_scan.mlstm_chunk_bwd(*xs, *carry, h, *ups)     # built, warm
    torch.cuda.synchronize()
    ran = _kernels_run(lambda: mlstm_scan.mlstm_chunk_bwd(*xs, *carry, h,
                                                          *ups),
                       mlstm_scan.BWD_PASSES)
    assert ran == list(mlstm_scan.bwd_passes(l, hd, torch.bfloat16))
    assert ran == list(mlstm_scan.BWD_TC)


def _train_launches(cfg, mod, steps: int, seq: int, batch: int):
    """Run ``steps`` of ``make_train_step`` on a reduced bf16 model on the
    card; the (forward, backward) launches of ``mod``'s kernels."""
    from repro_torch.models import Transformer
    from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                      make_batch, make_train_step)
    model = Transformer(cfg, seed=0)
    opt = init_adamw(dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    fwd, bwd = mod.LAUNCHES, mod.BWD_LAUNCHES
    for i in range(steps):
        opt, m = step(opt, make_batch(cfg, DataConfig(seq, batch), i))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    return mod.LAUNCHES - fwd, mod.BWD_LAUNCHES - bwd


def test_cuda_xlstm_train_step_runs_the_mlstm_kernels(card):
    """Reduced xlstm-1.3b, bf16, remat, S 300 (two chunks of 256): each
    step launches the mLSTM forward twice per mLSTM layer and chunk and
    the backward once."""
    from repro_torch.configs import MLSTM
    cfg = get_config("xlstm-1.3b", reduced=True)
    n = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == MLSTM
            for i in range(cfg.num_layers))
    fwd, bwd = _train_launches(cfg, mlstm_scan, 2, 300, 2)
    assert (fwd, bwd) == (2 * 2 * 2 * n, 2 * 2 * n)


def test_cuda_jamba_train_step_runs_the_scan_kernels(card):
    """Reduced jamba-v0.1-52b, bf16, remat, S 300 (two chunks of 256): each
    step launches the scan twice per Mamba layer and chunk and its
    backward once."""
    from repro_torch.configs import MAMBA
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    n = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == MAMBA
            for i in range(cfg.num_layers))
    fwd, bwd = _train_launches(cfg, ssm_scan, 2, 300, 2)
    assert (fwd, bwd) == (2 * 2 * 2 * n, 2 * 2 * n)


def test_cuda_train_step_runs_the_kernels(card):
    """Reduced qwen3-0.6b, bf16, remat on, on the card by default: each
    step launches the forward kernel twice a layer and the backward once,
    and the loss stays finite."""
    from repro_torch.models import Transformer
    from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                      make_batch, make_train_step)
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Transformer(cfg, seed=0)
    opt = init_adamw(dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    for i in range(2):
        opt, m = step(opt, make_batch(cfg, DataConfig(64, 2), i))
        assert torch.isfinite(m["loss"])
    assert fa.LAUNCHES - fwd == 2 * 2 * cfg.num_layers
    assert fa.BWD_LAUNCHES - bwd == 2 * cfg.num_layers


def test_cuda_adamw_update_stays_within_its_bound(card, monkeypatch):
    """Reduced qwen3-0.6b in bf16 on the card: two train steps write over
    the parameters and moments they were given (each keeps its storage),
    and the AdamW update alone raises the allocator's peak by at most
    three fp32 copies of the largest leaf."""
    from repro_torch.models import Transformer
    from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                      make_batch, make_train_step)
    from repro_torch.training import train_step as ts
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Transformer(cfg, seed=0)
    named = dict(model.named_parameters())
    opt = init_adamw(named)

    def storage(opt):
        return [t.data_ptr() for t in (*named.values(), *opt.mu.values(),
                                       *opt.nu.values())]
    ptrs = storage(opt)
    real, rises = ts.adamw_update, []

    def update(*args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(*args)
        torch.cuda.synchronize()
        rises.append(torch.cuda.max_memory_allocated() - base)
        return out
    monkeypatch.setattr(ts, "adamw_update", update)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    before = {n: p.clone() for n, p in named.items()}
    for i in range(2):
        opt, m = step(opt, make_batch(cfg, DataConfig(64, 2), i))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert storage(opt) == ptrs
    assert any(not torch.equal(p, before[n]) for n, p in named.items())
    bound = 3 * 4 * max(p.numel() for p in named.values())
    assert len(rises) == 2 and 0 < max(rises) <= bound, (rises, bound)


def _mlstm_chunk(gen, bh, l, hd, dtype, pad=0):
    """q, k (pre-scaled), v in ``dtype`` and fp32 gates, as the model
    makes them; the last ``pad`` steps carry its padding."""
    q, k, v = (torch.randn(bh, l, hd, generator=gen, device="cuda")
               for _ in range(3))
    k = k / hd ** 0.5
    i_raw = torch.randn(bh, l, generator=gen, device="cuda")
    f_raw = torch.randn(bh, l, generator=gen, device="cuda") + 2.0
    if pad:
        for t in (q, k, v):
            t[:, l - pad:] = 0.0
        i_raw[:, l - pad:] = -1e30
        f_raw[:, l - pad:] = 30.0
    return q.to(dtype), k.to(dtype), v.to(dtype), i_raw, f_raw


@pytest.mark.parametrize("bh,l,hd,chunks,pad,dtype", [
    (16, 16, 1024, 1, 0, torch.bfloat16),    # the serving path's chunk
    (16, 16, 1024, 3, 0, torch.bfloat16),    # carried across chunks
    (4, 100, 64, 3, 0, torch.float32),       # ragged L
    (3, 7, 16, 2, 3, torch.float32),         # padded tail
    (2, 1, 8, 3, 0, torch.float32),
    # past the one pass: the tensor-core passes (bf16), ragged and padded
    (16, 17, 1024, 2, 0, torch.bfloat16),
    (4, 256, 1024, 2, 0, torch.bfloat16),    # the prefill's chunk
    (2, 100, 1024, 2, 37, torch.bfloat16),
    (4, 16, 128, 2, 3, torch.float32),       # the one pass in fp32
])
def test_cuda_mlstm_kernel_matches_plain(card, bh, l, hd, chunks, pad,
                                         dtype):
    """The carry threaded through ``chunks`` chunks on each side: h, C, n
    within 2e-3 + 2e-2 |ref| and m within 1e-4 (the repo's mLSTM kernel
    tolerances); both compute in fp32 from the same inputs."""
    carry = (torch.zeros(bh, hd, hd, device="cuda"),
             torch.zeros(bh, hd, device="cuda"),
             torch.full((bh,), -1e30, device="cuda"))
    kern, plain = carry, carry
    for ci in range(chunks):
        xs = _mlstm_chunk(card, bh, l, hd, dtype,
                          pad if ci == chunks - 1 else 0)
        before = mlstm_scan.LAUNCHES
        h_k, *kern = mlstm_scan.mlstm_chunk_step(*xs, *kern)
        torch.cuda.synchronize()
        assert mlstm_scan.LAUNCHES == before + 1
        h_p, *plain = mlstm_scan.mlstm_chunk_plain(*xs, *plain)
        for name, a, b in zip(("h", "c", "n", "m"), (h_k, *kern),
                              (h_p, *plain)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            tol = 1e-4 if name == "m" else 2e-3
            rtol = 1e-4 if name == "m" else 2e-2
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       atol=tol, rtol=rtol,
                                       err_msg=f"{name} chunk {ci}")


def test_cuda_mlstm_kernel_refuses_unsupported_sizes(card):
    for l, hd in ((257, 64), (16, 48), (16, 2048)):
        xs = _mlstm_chunk(card, 2, l, hd, torch.bfloat16)
        carry = (torch.zeros(2, hd, hd, device="cuda"),
                 torch.zeros(2, hd, device="cuda"),
                 torch.zeros(2, device="cuda"))
        with pytest.raises(ValueError, match="chunk length|head_dim"):
            mlstm_scan.mlstm_chunk_step(*xs, *carry)
    # the kernel copies q, k, v, c and n in 16-byte pieces
    xs = _mlstm_chunk(card, 2, 16, 64, torch.bfloat16)
    carry = (torch.zeros(2, 64, 64, device="cuda"),
             torch.zeros(2 * 64 + 1, device="cuda")[1:].view(2, 64),
             torch.zeros(2, device="cuda"))
    before = mlstm_scan.LAUNCHES
    with pytest.raises(ValueError, match="aligned"):
        mlstm_scan.mlstm_chunk_step(*xs, *carry)
    assert mlstm_scan.LAUNCHES == before


def test_cuda_xlstm_prefill_runs_the_kernel_per_layer_and_chunk(card):
    """Reduced xlstm-1.3b (7 mLSTM layers, hd 128), S = 40 in the model's
    chunks of 256: one chunk, so 7 launches; then chunks of 16 through
    ``mlstm_mix`` directly: 3 chunks, the last one padded."""
    from repro_torch.models import Transformer, make_mlstm_state, mlstm_mix
    cfg = get_config("xlstm-1.3b", reduced=True)
    model = Transformer(cfg, dtype=torch.float32, seed=0)
    assert model.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                           device="cuda", dtype=torch.int32)
    n_mlstm = cfg.block_pattern.count("mlstm")
    with torch.inference_mode():
        before = mlstm_scan.LAUNCHES
        logits, _ = model.serve_prefill(tokens)
        launched = mlstm_scan.LAUNCHES - before
        plain, _ = model.serve_prefill(tokens, mlstm=ops.mlstm_chunk_plain)
        x = torch.randn(2, 40, cfg.d_model, generator=card, device="cuda")
        state = make_mlstm_state(2, cfg, torch.float32, "cuda")
        before = mlstm_scan.LAUNCHES
        out, _ = mlstm_mix(x, model.layers[0], cfg, state, chunk=16)
        chunked = mlstm_scan.LAUNCHES - before
        out_p, _ = mlstm_mix(x, model.layers[0], cfg, state, chunk=16,
                             mlstm=ops.mlstm_chunk_plain)
    assert launched == n_mlstm * 1
    assert chunked == 3
    assert torch.isfinite(logits).all()
    assert torch.equal(logits.argmax(-1), plain.argmax(-1))
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(),
                               atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("b,sc,h,kvh,hd,valid,dtype", [
    (4, 2080, 16, 8, 128, 2049, torch.bfloat16),   # qwen3-0.6b's step
    (4, 2080, 16, 16, 64, 2080, torch.bfloat16),   # qwen1.5-0.5b's
    (4, 4096, 24, 2, 128, 4096, torch.bfloat16),   # starcoder2-3b's ring
    (4, 2080, 32, 8, 128, 1999, torch.bfloat16),   # jamba's G 4, off tile
    (2, 100, 24, 2, 128, 61, torch.bfloat16),      # a ragged tile, G 12
    (2, 100, 24, 2, 128, 61, torch.float32),       # split, ragged tile
    (2, 7, 4, 2, 64, 7, torch.float32),
    (3, 40, 8, 1, 64, 1, torch.float32),
    (2, 9, 4, 2, 64, 0, torch.bfloat16),           # no valid slot: zeros
    # whisper-medium's cross-attention step: the encoder's 1,500 slots,
    # all valid from the first step (off the 32-slot tile), G 1
    (4, 1500, 16, 16, 64, 1500, torch.bfloat16),
    (4, 1500, 16, 16, 64, 1500, torch.float32),
    # G > 16: the heads cut into blocks of 16 over the same slots; G 24
    # (a full and a half group) and granite-34b's MQA G 48 (three), on a
    # ring past its size and on a partly filled cache, in both dtypes
    (2, 300, 48, 2, 128, 1000, torch.bfloat16),
    (2, 300, 48, 2, 64, 203, torch.float32),
    (4, 2080, 48, 1, 128, 2049, torch.bfloat16),   # granite-34b's step
    (2, 300, 48, 1, 128, 1000, torch.float32),
    (2, 100, 48, 1, 64, 61, torch.bfloat16),
])
def test_cuda_decode_kernel_matches_plain(card, b, sc, h, kvh, hd, valid,
                                          dtype):
    """The kernel on the model's (B, Sc, KVH, hd) cache, read in place,
    against the plain version: 3e-3 in fp32 and 2e-2 in bf16, the
    reference's decode tolerances, and within 1e-4 (fp32) or 2^-6 (bf16)
    of each head's largest |output|, which catches a lost or doubled tile
    where outputs are small.  Both compute in fp32, but for the bf16
    tensor-core kernel's P, rounded to bf16 for PV (its budget is held to
    the reference in test_torch_decode_tiles.py)."""
    q = torch.randn(b, 1, h, hd, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(b, sc, kvh, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    before = dec.LAUNCHES
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-3
    row_tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    got = out.float().cpu().numpy()
    ref = ops.decode_attention_plain(q, k, v, valid).float().cpu().numpy()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    row_max = np.abs(ref).max(-1, keepdims=True)
    assert np.all(np.abs(got - ref) <= row_tol * row_max)
    if valid == 0:
        assert not out.any()


def test_cuda_decode_kernel_refuses_unsupported_sizes(card):
    def args(g, hd, sc=16, dtype=torch.bfloat16):
        q = torch.zeros(2 * 2, g, hd, device="cuda", dtype=dtype)
        k = torch.zeros(2, sc, 2, hd, device="cuda", dtype=dtype)
        return q, k
    q, k = args(2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        dec.decode_attention_packed(q, k, k, 4, num_heads=4, num_kv_heads=2)
    q, k = args(49, 64)
    with pytest.raises(ValueError, match="at most"):
        dec.decode_attention_packed(q, k, k, 4, num_heads=98, num_kv_heads=2)
    q, k = args(2, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dec.decode_attention_packed(q.half(), k.half(), k.half(), 4,
                                    num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError, match="host int"):
        dec.decode_attention_packed(q, k, k, torch.tensor(4, device="cuda"),
                                    num_heads=4, num_kv_heads=2)
    buf = torch.zeros(2, 16, 2, 65, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        dec.decode_attention_packed(q, buf[..., 1:], buf[..., 1:], 4,
                                    num_heads=4, num_kv_heads=2)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-3b"])
def test_cuda_serve_decode_runs_the_kernel_once_per_layer_and_step(card,
                                                                   arch):
    """Reduced models in fp32: 3 decode steps launch the kernel once per
    attention layer per step, and give the argmax of the plain op's run
    (each side from its own prefill: a decode step advances its cache in
    place).  starcoder2-3b's 64-token prompt fills its ring."""
    from repro_torch.models import Transformer
    cfg = get_config(arch, reduced=True)
    model = Transformer(cfg, dtype=torch.float32, seed=0)
    s = cfg.sliding_window or 40
    tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=card,
                           device="cuda", dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (3, 2), generator=card,
                          device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        _, cache = model.serve_prefill(tokens, cache_len=s + 3)
        _, plain_cache = model.serve_prefill(tokens, cache_len=s + 3)
        before = dec.LAUNCHES
        for t in steps:
            logits, cache = model.serve_decode(t, cache)
            plain, plain_cache = model.serve_decode(
                t, plain_cache, decode_attention=ops.decode_attention_plain)
            assert torch.equal(logits.argmax(-1), plain.argmax(-1))
        launched = dec.LAUNCHES - before
    assert launched == cfg.num_layers * 3
    assert cache.pos == s + 3
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "chameleon-34b",
                                  "granite-34b", "phi3.5-moe-42b-a6.6b"])
def test_cuda_zoo_runs_the_kernels_at_published_heads(card, arch):
    """The reduced width at the published head counts (granite-34b: 48
    query heads over one KV head, so the decode kernel's three groups of
    16), bf16: a prefill launches the prefill kernel once a layer, each of
    3 decode steps the decode kernel once a layer, and every launch agrees
    with the plain ops' run on the same inputs within 2e-2 and 2^-6 of its
    rows' largest |output|."""
    import dataclasses
    from repro_torch.models import Transformer
    h, kvh = get_config(arch).num_heads, get_config(arch).num_kv_heads
    cfg = dataclasses.replace(get_config(arch, reduced=True), num_layers=2,
                              num_heads=h, num_kv_heads=kvh, head_dim=64)
    model = Transformer(cfg, dtype=torch.bfloat16, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                           device="cuda", dtype=torch.int32)
    worst = []

    def held(kernel, plain):
        def op(*a, **kw):
            out, ref = kernel(*a, **kw), plain(*a, **kw).float()
            diff = (out.float() - ref).abs()
            worst.append(max(
                (diff / (2e-2 + 2e-2 * ref.abs())).max().item(),
                (diff / (2.0 ** -6 * ref.abs().amax(-1, keepdim=True)))
                .max().item()))
            return out
        return op
    with torch.inference_mode():
        before = (fa.LAUNCHES, dec.LAUNCHES)
        logits, cache = model.serve_prefill(
            tokens, cache_len=43,
            attention=held(ops.flash_attention, ops.flash_attention_plain))
        for _ in range(3):
            logits, cache = model.serve_decode(
                logits.argmax(-1), cache, decode_attention=held(
                    ops.decode_attention, ops.decode_attention_plain))
        torch.cuda.synchronize()
    assert (fa.LAUNCHES - before[0], dec.LAUNCHES - before[1]) == \
        (cfg.num_layers, cfg.num_layers * 3)
    assert len(worst) == cfg.num_layers * 4 and max(worst) <= 1
    assert torch.isfinite(logits).all()


# chip_smoke.py's check_ssm cases: B 1/4 x L 1/7/256 x D 8/100/8192 x ST
# 4/16, then the scalar path (D*ST not a multiple of 4; buffers one float
# off the vector path's 16-byte alignment)
@pytest.mark.parametrize("b,l,d,st,offset", [
    (b, l, d, st, 0) for b in (1, 4) for l in (1, 7, 256)
    for d in (8, 100, 8192) for st in (4, 16)]
    + [(2, 33, 7, 3, 0), (2, 9, 100, 16, 1), (3, 256, 8192, 16, 1)])
def test_cuda_ssm_kernel_matches_plain(card, b, l, d, st, offset):
    """The scan kernel against its plain version: atol 1e-4 / rtol 1e-3
    (the repo's scan tolerances); both round each step's product and sum
    to fp32 separately, so they agree bit for bit."""
    n = b * l * d * st

    def buf(t):
        out = torch.empty(n + offset, device="cuda")[offset:]
        return out.view(b, l, d, st).copy_(t)
    da = buf(torch.sigmoid(torch.randn(b, l, d, st, generator=card,
                                       device="cuda")))
    dbx = buf(torch.randn(b, l, d, st, generator=card, device="cuda") * 0.1)
    before = ssm_scan.LAUNCHES
    out = ops.ssm_scan(da, dbx)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES == before + 1
    ref = ops.ssm_scan_plain(da, dbx)
    assert out.dtype == torch.float32 and out.shape == (b, l, d, st)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)
    assert torch.equal(out, ref)


def test_cuda_ssm_kernel_refuses_what_it_cannot_take(card):
    da = torch.rand(2, 5, 8, 4, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ssm_scan.ssm_chunk_scan(da.bfloat16(), da.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_chunk_scan(da.transpose(1, 2), da.transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        ssm_scan.ssm_chunk_scan(da, da.cpu())


def test_cuda_jamba_prefill_runs_the_kernel_per_mamba_layer_and_chunk(card):
    """Reduced jamba-v0.1-52b (7 Mamba layers) in fp32, S = 40 in the
    model's chunks of 256: one chunk, so 7 launches, and the argmax of the
    plain op's run; then chunks of 16 through ``mamba_mix`` directly: 3
    chunks, the last one padded; then 3 decode steps."""
    from repro_torch.models import (Transformer, make_mamba_state,
                                    mamba_mix)
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    model = Transformer(cfg, dtype=torch.float32, seed=0)
    assert model.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                           device="cuda", dtype=torch.int32)
    n_mamba = cfg.block_pattern.count("mamba")
    with torch.inference_mode():
        before = ssm_scan.LAUNCHES
        logits, cache = model.serve_prefill(tokens, cache_len=43)
        launched = ssm_scan.LAUNCHES - before
        plain, _ = model.serve_prefill(tokens, ssm=ops.ssm_scan_plain)
        for _ in range(3):
            logits_d, cache = model.serve_decode(logits.argmax(-1), cache)
        x = torch.randn(2, 40, cfg.d_model, generator=card, device="cuda")
        state = make_mamba_state(2, cfg, torch.float32, "cuda")
        before = ssm_scan.LAUNCHES
        out, _ = mamba_mix(x, model.layers[0], cfg, state, chunk=16)
        chunked = ssm_scan.LAUNCHES - before
        out_p, _ = mamba_mix(x, model.layers[0], cfg, state, chunk=16,
                             ssm=ops.ssm_scan_plain)
    assert launched == n_mamba
    assert chunked == 3
    assert torch.isfinite(logits).all() and torch.isfinite(logits_d).all()
    assert torch.equal(logits.argmax(-1), plain.argmax(-1))
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)


def test_cuda_camelot_session_serves_on_the_card(card):
    """``CamelotSession.serve()`` builds the port's stage servers on the
    card (reduced width here): the solved allocation serves every query,
    and each batch runs the attention kernel once per layer."""
    from repro_torch.camelot import CamelotSession, ClusterSpec, SAConfig
    from repro_torch.sim import workload_specs
    sess = CamelotSession(workload_specs()["img-to-img"],
                          ClusterSpec(devices=1), batch=4)
    res = sess.solve(policy="max-peak", sa=SAConfig(iterations=300, seed=0))
    eng = sess.serve(result=res, reduced=True)
    assert all(st.device.type == "cuda" for st in eng.stages)
    layers = sum(st.cfg.block_pattern.count("attn") * st.cfg.num_superblocks
                 for st in eng.stages)
    before = fa.LAUNCHES
    stats = eng.run_trace(sess.make_trace(8, qps=40.0, seed=1))
    s = stats.summary()
    assert s["completed"] == 8 and s["failed"] == 0
    assert fa.LAUNCHES - before == layers * (stats.batches + 1)


def test_cuda_text_to_text_session_serves_full_width(card):
    """``CamelotSession.serve()`` on the suite's text-to-text service
    builds qwen3-0.6b and whisper-medium at full width on the card and
    serves every query; each batch launches the attention kernel 28 +
    72 times (whisper: 24 encoder layers, 24 decoder layers twice)."""
    from repro_torch.camelot import CamelotSession, ClusterSpec, SAConfig
    from repro_torch.core import H100
    from repro_torch.sim import workload_specs
    sess = CamelotSession(workload_specs(H100)["text-to-text"],
                          ClusterSpec(device=H100, devices=1), batch=4)
    sess.profile()
    res = sess.solve(policy="max-peak", sa=SAConfig(iterations=300, seed=0))
    eng = sess.serve(result=res)
    assert [st.cfg.name for st in eng.stages] == ["qwen3-0.6b",
                                                  "whisper-medium"]
    assert all(st.device.type == "cuda" for st in eng.stages)
    before = fa.LAUNCHES
    stats = eng.run_trace(sess.make_trace(8, qps=40.0, seed=1))
    s = stats.summary()
    assert s["completed"] == 8 and s["failed"] == 0
    assert fa.LAUNCHES - before == (28 + 72) * (stats.batches + 1)


# ---- the process backend's device arena: CUDA IPC between processes -------

def _arena_consumer(arena, refs, out_q):
    """A spawned consumer: map the driver's device arena by CUDA IPC and
    hand each slot's bytes back (plain bytes: a CPU tensor would be
    shared through a descriptor that dies with this process)."""
    out_q.put([_raw(arena.get(r)) for r in refs])


def _raw(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()


def _arena_producer(arena, n, die, out_q):
    """A spawned worker: write ``n`` payloads into the driver's arena
    (None once the ring is full) and post the refs; with ``die``, exit
    at once without releasing anything."""
    refs = [arena.try_put(torch.full((256,), i, dtype=torch.int32,
                                     device="cuda")) for i in range(n)]
    out_q.put(refs)
    if die:
        out_q.close()
        out_q.join_thread()         # the refs are in the pipe
        os._exit(3)


def _spawned(target, *args):
    """Run ``target(*args, out_q)`` in a spawned process; its one message
    and its exit code."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=target, args=(*args, out_q))
    proc.start()
    msg = out_q.get(timeout=120)
    proc.join(timeout=60)
    assert not proc.is_alive()
    return msg, proc.exitcode


def test_cuda_device_arena_hands_off_to_a_spawned_consumer(card):
    arena = DeviceArena(slots=4, slot_bytes=1 << 16)
    try:
        payloads = [
            torch.randn(4, 128, generator=card,
                        device="cuda").to(torch.bfloat16),
            torch.randint(0, 1000, (4,), generator=card, device="cuda",
                          dtype=torch.int32),
            torch.randn(64, 64, generator=card, device="cuda")[:, ::2]]
        refs = [arena.try_put(t) for t in payloads]
        got, code = _spawned(_arena_consumer, arena, refs)
        assert code == 0
        assert [r.shape for r in refs] == [tuple(t.shape) for t in payloads]
        assert got == [_raw(t) for t in payloads]
    finally:
        arena.close()
        arena.unlink()


def test_cuda_device_arena_backpressures_a_full_ring(card):
    arena = DeviceArena(slots=3, slot_bytes=1024)
    try:
        refs, code = _spawned(_arena_producer, arena, 4, False)
        assert code == 0
        assert [r is None for r in refs] == [False, False, False, True]
        assert arena.in_use() == 3
        for i, r in enumerate(refs[:3]):
            assert torch.equal(arena.get(r).cpu(),
                               torch.full((256,), i, dtype=torch.int32))
        arena.free(refs[1])
        again, _ = _spawned(_arena_producer, arena, 1, False)
        assert again[0].slot == refs[1].slot
    finally:
        arena.close()
        arena.unlink()


def test_cuda_slot_of_a_dead_worker_stays_readable(card):
    """The buffer is the driver's: what a worker published before it died
    is read by another worker afterwards."""
    arena = DeviceArena(slots=4, slot_bytes=1024)
    try:
        refs, code = _spawned(_arena_producer, arena, 2, True)
        assert code == 3
        got, code = _spawned(_arena_consumer, arena, refs)
        assert code == 0
        assert got == [_raw(torch.full((256,), i, dtype=torch.int32))
                       for i in range(2)]
    finally:
        arena.close()
        arena.unlink()


def test_cuda_processes_backend_hands_off_by_cuda_ipc(card):
    """Reduced qwen stages on the card, one worker per stage: under
    "device" every edge pick is global-memory (the workers' device
    arenas), all queries complete, and the workers' exit reports count
    one attention launch per layer for every batch and every warm-up."""
    from repro_torch.core.comm import GLOBAL_MEMORY
    from repro_torch.core.types import Allocation, Placement, StageAlloc
    from repro_torch.serving import ModelStageServer, PipelineEngine, \
        make_trace
    stages = [ModelStageServer(f"s{i}", arch, seq_len=16, seed=i,
                               reduced=True)
              for i, arch in enumerate(("qwen3-0.6b", "qwen1.5-0.5b"))]
    alloc = Allocation(stages=[StageAlloc(1, 0.5, 4), StageAlloc(1, 0.5, 4)],
                       placement=Placement(per_stage=[[(0, 0.5)],
                                                      [(1, 0.5)]]))
    with PipelineEngine(stages, comm_mechanism="device", qos_target=30.0,
                        batch_timeout=0.5, allocation=alloc,
                        backend="processes") as eng:
        stats = eng.run_trace(make_trace(8, qps=1e6, seq_len=16,
                                         vocab=stages[0].cfg.vocab_size,
                                         seed=2))
        picks = dict(eng.channels[0].picks)
    s = stats.summary()
    assert (s["completed"], s["failed"]) == (8, 0)
    assert picks == {GLOBAL_MEMORY: stats.batches, "host-staged": 0}
    layers = sum(st.cfg.block_pattern.count("attn") * st.cfg.num_superblocks
                 for st in stages)
    launched = sum(r["launches"]["flash_attention_bhsd"]
                   for r in eng.worker_reports.values())
    assert launched == layers * (stats.batches + 2)


def test_cuda_traced_workers_count_launches_and_time_their_calls(card):
    """Reduced qwen stages on the card, traced: each worker counts the
    kernels of one warm call of each stage at warm-up (at least one
    attention launch a layer, and the same count in both workers), and
    every stage call has its ``enqueue`` and ``sync`` spans."""
    from repro_torch.core.trace import link
    from repro_torch.core.types import Allocation, Placement, StageAlloc
    from repro_torch.serving import ModelStageServer, PipelineEngine, \
        make_trace
    stages = [ModelStageServer(f"s{i}", arch, seq_len=16, seed=i,
                               reduced=True)
              for i, arch in enumerate(("qwen3-0.6b", "qwen1.5-0.5b"))]
    alloc = Allocation(stages=[StageAlloc(1, 0.5, 4), StageAlloc(1, 0.5, 4)],
                       placement=Placement(per_stage=[[(0, 0.5)],
                                                      [(1, 0.5)]]))
    with PipelineEngine(stages, qos_target=30.0, batch_timeout=0.5,
                        allocation=alloc, backend="processes",
                        trace=True) as eng:
        stats = eng.run_trace(make_trace(8, qps=1e6, seq_len=16,
                                         vocab=stages[0].cfg.vocab_size,
                                         seed=2))
    reports = eng.worker_reports.values()
    counts = [{(c[2]["ti"], c[2]["stage"]): c[1] for c in r["counters"]
               if c[0] == "launches_per_call"} for r in reports]
    assert len(counts) == 2 and counts[0] == counts[1]
    for si, st in enumerate(stages):
        layers = st.cfg.block_pattern.count("attn") * st.cfg.num_superblocks
        assert counts[0][(0, si)] > layers
    spans = link(stats.spans, [s for r in reports for s in r["spans"]])
    calls = 2 * stats.batches
    for name in ("queue", "to_worker", "resolve", "enqueue", "sync",
                 "publish", "from_worker"):
        assert sum(s[0] == name for s in spans) == calls, name
    assert all(s[2] >= s[1] for s in spans)
