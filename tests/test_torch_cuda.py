"""The port on the card: the CUDA kernels against their plain versions, the
entry points' default device, and the process backend's device arena
(CUDA IPC between spawned processes).  Every test here needs a CUDA device and
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


def test_cuda_stage_server_defaults_to_the_card(card):
    from repro_torch.serving import ModelStageServer
    stage = ModelStageServer("s0", "qwen3-0.6b", seq_len=8, reduced=True)
    out = stage.process(torch.zeros(2, 8, dtype=torch.int32, device="cuda"))
    assert out.device.type == "cuda"
    assert out.dtype == torch.int32 and out.shape == (2,)


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
    q, k = args(17, 64)
    with pytest.raises(ValueError, match="at most"):
        dec.decode_attention_packed(q, k, k, 4, num_heads=34, num_kv_heads=2)
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
