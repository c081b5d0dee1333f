"""The port's decode path against the reference's.

On CPU tensors ``repro_torch.kernels.ops.decode_attention`` runs the plain
version (``decode_attention_plain``); it is held against the reference's
oracle (``impl="ref"``) and its Pallas kernel in interpret mode on the same
numpy inputs.  Then the layers (``cache_write``, ``attn_forward`` in decode
mode, ``mlstm_decode``, ``slstm_decode``) and whole models
(``Transformer.serve_decode`` after ``serve_prefill``) against
``repro.models``, with the reference's parameters carried over by
``from_jax_params``.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.

Tolerances: decode attention 3e-3 in fp32 and 2e-2 in bf16, those of the
reference's own kernel sweep (``tests/test_kernels.py``); fp32 models 1e-3
(absolute and relative), as the prefill parity tests; bf16 dense models
2e-2 of max |logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # degrade to deterministic example sweeps
    from _hypothesis_fallback import given, settings, st

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro.models import init_params, serve_decode, serve_prefill
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops
from repro_torch.models import (KVCache, attn_forward, cache_write,
                                from_jax_params, make_mlstm_state,
                                make_slstm_state, mlstm_decode, mlstm_mix,
                                slstm_decode, slstm_mix)

SETTINGS = dict(max_examples=12, deadline=None)
ATTN_TOL = {"float32": 3e-3, "bfloat16": 2e-2}
MODEL_TOL = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cmp(a, b, name, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------

def _decode_inputs(seed, b, sc, h, kvh, hd, dtype="float32"):
    """q (B, 1, H, hd) and a cache (B, Sc, KVH, hd) for both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, 1, h, hd), (b, sc, kvh, hd), (b, sc, kvh, hd))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _both_decode(jq, tq, valid, dtype):
    out = ops.decode_attention(*tq, valid).float().numpy()
    ref = ref_ops.decode_attention(*jq, jnp.asarray(valid, jnp.int32),
                                   impl="ref")
    pal = ref_ops.decode_attention(*jq, jnp.asarray(valid, jnp.int32),
                                   impl="pallas_interpret")
    _cmp(out, ref, "vs ref", ATTN_TOL[dtype])
    _cmp(out, pal, "vs pallas", ATTN_TOL[dtype])
    return out


@settings(**SETTINGS)
@given(
    b=st.integers(1, 3),
    sc=st.integers(4, 96),
    kvh=st.sampled_from([1, 2, 4]),
    g=st.sampled_from([1, 4]),
    valid_frac=st.floats(0.1, 1.0),
)
def test_plain_decode_attention_sweep(b, sc, kvh, g, valid_frac):
    """The reference's own sweep (tests/test_kernels.py), hd 16, fp32."""
    jq, tq = _decode_inputs(sc, b, sc, kvh * g, kvh, 16)
    _both_decode(jq, tq, max(1, int(sc * valid_frac)), "float32")


@pytest.mark.parametrize("b,sc,h,kvh,hd,valid,dtype", [
    (2, 100, 24, 2, 128, 61, "float32"),     # starcoder2-3b's G = 12
    (2, 100, 24, 2, 128, 100, "bfloat16"),
    (2, 70, 16, 8, 128, 33, "bfloat16"),     # qwen3-0.6b's heads
    (2, 70, 16, 16, 64, 70, "bfloat16"),     # qwen1.5-0.5b's heads
    (1, 7, 4, 2, 64, 1, "float32"),
])
def test_plain_decode_attention_path_heads(b, sc, h, kvh, hd, valid, dtype):
    jq, tq = _decode_inputs(h * sc, b, sc, h, kvh, hd, dtype)
    _both_decode(jq, tq, valid, dtype)


def test_valid_zero_gives_zeros_like_the_pallas_kernel():
    """No valid slot: the Pallas kernel's acc / max(l, 1e-30) is 0, and so
    is the port's; the reference oracle's softmax over an all-masked row
    averages V instead."""
    jq, tq = _decode_inputs(5, 2, 9, 4, 2, 16)
    out = ops.decode_attention(*tq, 0).numpy()
    pal = ref_ops.decode_attention(*jq, jnp.asarray(0, jnp.int32),
                                   impl="pallas_interpret")
    assert not out.any()
    np.testing.assert_array_equal(np.asarray(pal), out)
    ref = np.asarray(ref_ops.decode_attention(
        *jq, jnp.asarray(0, jnp.int32), impl="ref"))
    mean_v = np.repeat(np.asarray(jq[2]).mean(1, keepdims=True), 2, axis=2)
    np.testing.assert_allclose(ref, mean_v, atol=1e-5)


def test_ops_decode_attention_reads_a_strided_cache_in_place():
    """The cache as a slice of a larger buffer (strided in every axis but
    hd): the same answer as the contiguous cache, and as the reference."""
    b, sc, h, kvh, hd = 2, 40, 8, 2, 32
    jq, tq = _decode_inputs(11, b, sc, h, kvh, hd)
    buf_k = torch.zeros(b + 1, sc + 6, kvh + 1, hd)
    buf_v = torch.zeros(b + 1, sc + 6, kvh + 1, hd)
    buf_k[1:, 3:3 + sc, 1:] = tq[1]
    buf_v[1:, 3:3 + sc, 1:] = tq[2]
    k_s, v_s = buf_k[1:, 3:3 + sc, 1:], buf_v[1:, 3:3 + sc, 1:]
    assert not k_s.is_contiguous()
    for valid in (1, 23, sc):
        out = _both_decode(jq, tq, valid, "float32")
        strided = ops.decode_attention(tq[0], k_s, v_s, valid).numpy()
        np.testing.assert_array_equal(strided, out)


def test_plain_decode_attention_refuses_bad_arguments():
    q = torch.zeros(4, 2, 16)
    k = torch.zeros(2, 9, 2, 16)
    with pytest.raises(ValueError, match="valid"):
        dec.decode_attention_plain(q, k, k, torch.tensor(3), num_heads=4,
                                   num_kv_heads=2)
    with pytest.raises(ValueError, match="heads"):
        dec.decode_attention_plain(q, k, k, 3, num_heads=6, num_kv_heads=2)
    with pytest.raises(ValueError, match="cache must be"):    # (B·KVH, Sc, hd)
        dec.decode_attention_plain(q, k.transpose(1, 2).reshape(4, 9, 16),
                                   k, 3, num_heads=4, num_kv_heads=2)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention_packed(q, k, k, 3, num_heads=4, num_kv_heads=2)


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

def _configs(arch, reduced=True, dtype="float32", **changes):
    ref = dataclasses.replace(ref_get_config(arch, reduced=reduced),
                              dtype=dtype, **changes)
    port = dataclasses.replace(get_config(arch, reduced=reduced),
                               dtype=dtype, **changes)
    return ref, port


def _np(tree):
    """numpy fp32 leaves (writable copies: torch.from_numpy shares them)."""
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _perturb_vectors(params, seed):
    """Noise on every norm scale and bias (init makes them ones, zeros or
    3.0), so the comparison exercises them."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


@pytest.mark.parametrize("pos", [0, 3, 7, 8, 10, 17])
def test_cache_write_matches_reference(pos):
    """Slot pos % Sc, below and past Sc = 8; the port writes in place."""
    rng = np.random.default_rng(pos)
    k, v, kn, vn = (rng.standard_normal(s, dtype=np.float32)
                    for s in ((2, 8, 2, 4), (2, 8, 2, 4), (2, 1, 2, 4),
                              (2, 1, 2, 4)))
    ref = ref_attn.cache_write(ref_attn.KVCache(jnp.asarray(k),
                                                jnp.asarray(v)),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(pos, jnp.int32))
    cache = KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    out = cache_write(cache, torch.from_numpy(kn), torch.from_numpy(vn), pos)
    assert out.k is cache.k and out.v is cache.v
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(ref.v))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-0.5b",
                                  "starcoder2-3b"])
def test_attn_forward_decode_matches_reference(arch):
    """A prefilled cache of 12 slots (the prompt's 9, then 3 decode steps),
    with qk-norm (qwen3) or non-zero qkv biases (qwen1.5, starcoder2)."""
    ref_cfg, port_cfg = _configs(arch)
    p = ref_attn.init_attn_params(jax.random.PRNGKey(4), ref_cfg,
                                  dtype=jnp.float32)
    p = _perturb_vectors(p, 4)
    pt = {n: torch.from_numpy(a) for n, a in _np(p).items()}
    rng = np.random.default_rng(6)
    s, s_cache = 9, 12
    x = rng.standard_normal((2, s, ref_cfg.d_model), dtype=np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    hd = ref_cfg.resolved_head_dim
    base = ref_attn.make_kv_cache(2, s_cache, ref_cfg.num_kv_heads, hd,
                                  jnp.float32)
    _, cr = ref_attn.attn_forward(jnp.asarray(x), p, ref_cfg,
                                  positions=jnp.asarray(pos),
                                  mode="prefill", cache=base)
    _, ct = attn_forward(torch.from_numpy(x), pt, port_cfg,
                         positions=torch.from_numpy(pos), mode="prefill",
                         cache=KVCache(torch.zeros(2, s_cache,
                                                   ref_cfg.num_kv_heads, hd),
                                       torch.zeros(2, s_cache,
                                                   ref_cfg.num_kv_heads, hd)))
    for step in range(3):
        at = s + step
        xd = rng.standard_normal((2, 1, ref_cfg.d_model), dtype=np.float32)
        out_r, cr = ref_attn.attn_forward(
            jnp.asarray(xd), p, ref_cfg, positions=jnp.full((1, 1), at),
            mode="decode", cache=cr, pos=jnp.asarray(at, jnp.int32))
        out_t, ct = attn_forward(
            torch.from_numpy(xd), pt, port_cfg,
            positions=torch.full((1, 1), at), mode="decode", cache=ct,
            pos=at)
        _cmp(out_t.numpy(), out_r, f"step {step} out", 1e-4)
        _cmp(ct.k.numpy(), cr.k, f"step {step} cache k", 1e-5)
        _cmp(ct.v.numpy(), cr.v, f"step {step} cache v", 1e-5)


def test_mlstm_decode_matches_reference_from_a_prefilled_state():
    ref_cfg, port_cfg = _configs("xlstm-1.3b")
    p = _perturb_vectors(ref_xlstm.init_mlstm_params(
        jax.random.PRNGKey(1), ref_cfg, dtype=jnp.float32), 1)
    pt = {n: torch.from_numpy(a) for n, a in _np(p).items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, ref_cfg.d_model), dtype=np.float32)
    _, st_r = ref_xlstm.mlstm_mix(jnp.asarray(x), p, ref_cfg,
                                  ref_xlstm.make_mlstm_state(2, ref_cfg,
                                                             jnp.float32))
    _, st_t = mlstm_mix(torch.from_numpy(x), pt, port_cfg,
                        make_mlstm_state(2, port_cfg, torch.float32, "cpu"))
    for step in range(3):
        xd = rng.standard_normal((2, 1, ref_cfg.d_model), dtype=np.float32)
        out_r, st_r = ref_xlstm.mlstm_decode(jnp.asarray(xd), p, ref_cfg,
                                             st_r)
        out_t, st_t = mlstm_decode(torch.from_numpy(xd), pt, port_cfg, st_t)
        _cmp(out_t.numpy(), out_r, f"step {step} out", 1e-4)
        for name in st_r._fields:
            _cmp(getattr(st_t, name).float().numpy(), getattr(st_r, name),
                 f"step {step} state.{name}", 1e-4)


def test_slstm_decode_matches_reference_from_a_prefilled_state():
    ref_cfg, port_cfg = _configs("xlstm-1.3b")
    p = _perturb_vectors(ref_xlstm.init_slstm_params(
        jax.random.PRNGKey(2), ref_cfg, dtype=jnp.float32), 2)
    pt = {n: torch.from_numpy(a) for n, a in _np(p).items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, ref_cfg.d_model), dtype=np.float32)
    _, st_r = ref_xlstm.slstm_mix(jnp.asarray(x), p, ref_cfg,
                                  ref_xlstm.make_slstm_state(2, ref_cfg))
    _, st_t = slstm_mix(torch.from_numpy(x), pt, port_cfg,
                        make_slstm_state(2, port_cfg, "cpu"))
    for step in range(3):
        xd = rng.standard_normal((2, 1, ref_cfg.d_model), dtype=np.float32)
        out_r, st_r = ref_xlstm.slstm_decode(jnp.asarray(xd), p, ref_cfg,
                                             st_r)
        out_t, st_t = slstm_decode(torch.from_numpy(xd), pt, port_cfg, st_t)
        _cmp(out_t.numpy(), out_r, f"step {step} out", 1e-4)
        for name in st_r._fields:
            _cmp(getattr(st_t, name).numpy(), getattr(st_r, name),
                 f"step {step} state.{name}", 1e-4)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

def _tokens(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _decode_against_reference(ref_cfg, port_cfg, params, tokens, steps,
                              cache_len, dtype=torch.float32,
                              tol=MODEL_TOL, rel_tol=None):
    """Prefill, then ``steps`` greedy steps on both sides, each fed the
    reference's greedy token; logits compared after the prefill and at
    every step.  Returns the port's model and its tokens so far."""
    tree = _np(params) if dtype == torch.float32 \
        else jax.tree.map(np.asarray, params)
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=cache_len)
    model = from_jax_params(tree, port_cfg, device="cpu", dtype=dtype)
    lt, ct = model.serve_prefill(torch.from_numpy(tokens),
                                 cache_len=cache_len)
    step = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref_cfg))

    def check(lt, lr, where):
        lr = np.asarray(lr, np.float32)
        lt = lt.float().numpy()
        if rel_tol is None:
            _cmp(lt, lr, where, tol)
            np.testing.assert_array_equal(lt.argmax(-1), lr.argmax(-1),
                                          err_msg=where)
        else:
            assert np.abs(lt - lr).max() <= rel_tol * np.abs(lr).max(), where
    check(lt, lr, "prefill")
    seq = [tokens]
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        seq.append(nxt[:, None])
        lr, cr = step(params, cr, jnp.asarray(nxt))
        lt, ct = model.serve_decode(torch.from_numpy(nxt), ct)
        assert ct.pos == tokens.shape[1] + i + 1
        assert lt.shape == (tokens.shape[0], port_cfg.vocab_size)
        check(lt, lr, f"decode step {i}")
    return model, np.concatenate(seq, axis=1), lt


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-0.5b",
                                  "xlstm-1.3b", "starcoder2-3b"])
def test_serve_decode_matches_reference_fp32(arch):
    ref_cfg, port_cfg = _configs(arch)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(0), ref_cfg), 0)
    tokens = _tokens(ref_cfg.vocab_size)
    _decode_against_reference(ref_cfg, port_cfg, params, tokens, steps=3,
                              cache_len=tokens.shape[1] + 3)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-3b"])
def test_serve_decode_matches_reference_bf16(arch):
    """bf16 parameters, caches and activations on both sides: logits
    within 2e-2 of max |logit| (the two frameworks round at other
    places)."""
    ref_cfg, port_cfg = _configs(arch, dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(2), ref_cfg)
    tokens = _tokens(ref_cfg.vocab_size, seed=2)
    _decode_against_reference(ref_cfg, port_cfg, params, tokens, steps=3,
                              cache_len=tokens.shape[1] + 3,
                              dtype=torch.bfloat16, rel_tol=2e-2)


def test_serve_decode_with_twelve_heads_per_kv_head():
    """starcoder2-3b's packing, G = 24 / 2 = 12, at small width (d 256,
    hd 32)."""
    ref_cfg, port_cfg = _configs("starcoder2-3b", num_heads=24,
                                 num_kv_heads=2, head_dim=32)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(7), ref_cfg), 7)
    tokens = _tokens(ref_cfg.vocab_size, seed=7)
    _decode_against_reference(ref_cfg, port_cfg, params, tokens, steps=3,
                              cache_len=tokens.shape[1] + 3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, MODEL_TOL),
                                       (torch.bfloat16, 0.15)])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-1.3b",
                                  "starcoder2-3b"])
def test_prefill_matches_incremental_decode(arch, dtype, tol):
    """The port's own twin of tests/test_models.py's: prefill of 16 tokens
    equals prefill of the first 8 and 8 decode steps.  bf16 at that
    test's tolerance (0.15), fp32 at 1e-3."""
    cfg = get_config(arch, reduced=True)
    model = from_jax_params(
        _np(init_params(jax.random.PRNGKey(0), ref_get_config(
            arch, reduced=True))), cfg, device="cpu", dtype=dtype)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, b=1, s=16, seed=3))
    with torch.inference_mode():
        full, _ = model.serve_prefill(tokens, cache_len=16)
        logits, cache = model.serve_prefill(tokens[:, :8], cache_len=16)
        for i in range(8, 16):
            logits, cache = model.serve_decode(tokens[:, i], cache)
    assert cache.pos == 16
    _cmp(logits.float().numpy(), full.float().numpy(),
         "incremental decode vs prefill", tol)


def test_ring_buffer_decode_past_the_window():
    """Reduced starcoder2-3b (window 64): a full ring after a 64-token
    prompt, then 68 greedy steps, each overwriting the oldest slot; logits
    equal to the reference's at every step, and the last ones equal to the
    port's windowed prefill of the whole sequence."""
    ref_cfg, port_cfg = _configs("starcoder2-3b")
    win = port_cfg.sliding_window
    assert win == 64
    params = _perturb_vectors(init_params(jax.random.PRNGKey(5), ref_cfg), 5)
    tokens = _tokens(ref_cfg.vocab_size, b=1, s=win, seed=5)
    model, seq, last = _decode_against_reference(
        ref_cfg, port_cfg, params, tokens, steps=win + 4, cache_len=win)
    with torch.inference_mode():
        full, cache = model.serve_prefill(torch.from_numpy(seq))
    assert cache.layers[0].k.shape[1] == win
    _cmp(last.numpy(), full.numpy(), "ring decode vs windowed prefill",
         MODEL_TOL)


def test_starcoder2_configs_match_reference():
    for reduced in (False, True):
        port = get_config("starcoder2-3b", reduced=reduced)
        ref = ref_get_config("starcoder2-3b", reduced=reduced)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    full = get_config("starcoder2-3b")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.sliding_window) == (30, 3072, 24, 2,
                                                         4096)
    small = get_config("starcoder2-3b", reduced=True)
    assert (small.num_heads, small.num_kv_heads, small.sliding_window) == \
        (4, 2, 64)
