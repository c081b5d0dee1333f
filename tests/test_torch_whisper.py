"""The port's encoder-decoder (whisper-medium) against the reference's.

The reference's parameters (``repro.models.init_params``) go into the
port through ``from_jax_params``; the same numpy tokens and encoder frames
go through ``repro.models`` (``encode``, ``serve_prefill``,
``serve_decode``) and ``Transformer`` on the CPU, where the port's
attention ops run their plain versions (the encoder's and the
cross-attention's prefill through ``ops.flash_attention`` with
``causal=False``, the cross-attention's decode through
``ops.decode_attention`` over the whole encoder).

Tolerances: fp32 1e-3 (absolute and relative) and argmax equal; bf16
within 2e-2 of max |logit| (the two frameworks round at other places), as
``tests/test_torch_decode.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import init_params, serve_decode, serve_prefill
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.models import (Transformer, from_jax_params, param_bytes,
                                sinusoidal_pos)
from repro_torch.models import attention as attn_mod

ARCH = "whisper-medium"
TOL = 1e-3
BF16_REL_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="float32", reduced=True, **changes):
    ref = dataclasses.replace(ref_get_config(ARCH, reduced=reduced),
                              dtype=dtype, **changes)
    port = dataclasses.replace(get_config(ARCH, reduced=reduced),
                               dtype=dtype, **changes)
    return ref, port


def _np(tree):
    """numpy fp32 leaves (writable copies: torch.from_numpy shares them)."""
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _perturb_vectors(params, seed):
    """Noise on every norm scale (init makes them ones), so the comparison
    exercises them."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


def _tokens(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _frames(cfg, b=2, seed=0):
    return np.random.default_rng(seed + 100).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)


def _cmp(a, b, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


def _near(a, b, name, rel=BF16_REL_TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), name


def _setup(dtype="float32", seed=0, **changes):
    ref_cfg, port_cfg = _configs(dtype, **changes)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(seed), ref_cfg),
                              seed)
    jdt, tdt = DTYPES[dtype]
    tree = _np(params) if dtype == "float32" \
        else jax.tree.map(np.asarray, params)
    model = from_jax_params(tree, port_cfg, device="cpu", dtype=tdt)
    return ref_cfg, port_cfg, params, model, jdt, tdt


# --------------------------------------------------------------------------
# config and positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_whisper_configs_match_reference(reduced):
    port = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(
        ref_get_config(ARCH, reduced=reduced))
    want = (24, 24, 1024, 16, 16, 64, 4096, 51865, 1500) if not reduced \
        else (1, 2, 256, 4, 4, 64, 512, 512, 64)
    assert (port.num_layers, port.num_encoder_layers, port.d_model,
            port.num_heads, port.num_kv_heads, port.resolved_head_dim,
            port.d_ff, port.vocab_size, port.encoder_seq_len) == want
    assert port.encoder_decoder and port.learned_pos_emb and not port.rope


def test_sinusoidal_pos_matches_reference():
    """Positions 0-600 at d 1024.  Both tables are fp32 from the same
    formula; the frequencies may differ by an ulp between the two exp
    implementations, which the angles (up to 600 rad) carry to ~4e-5."""
    pos = np.arange(601, dtype=np.int32)[None]
    ref = np.asarray(ref_tf._sinusoidal_pos(jnp.asarray(pos), 1024))
    out = sinusoidal_pos(torch.from_numpy(pos), 1024)
    assert out.dtype == torch.float32 and out.shape == (1, 601, 1024)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    # the reference's exact frequencies: exp(-log(1e4) i / (half - 1))
    np.testing.assert_allclose(out[0, 1, :512].numpy(), np.sin(np.exp(
        -np.log(1e4) * np.arange(512) / 511)), atol=1e-6)


def test_param_bytes_counts_encoder_and_cross_leaves():
    cfg = get_config(ARCH, reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.float32)
    assert param_bytes(cfg, torch.float32) == sum(
        p.numel() * 4 for p in model.parameters())
    assert len(model.enc_layers) == 2
    assert set(model.layers[0].keys()) >= {
        "norm_cross", "cross_wq", "cross_wk", "cross_wv", "cross_wo"}
    # published width and depth: 1.01 B parameters, 2.02 GB of bf16
    assert param_bytes(get_config(ARCH)) == 2_024_628_224


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    ref_cfg, port_cfg, params, model, jdt, tdt = _setup(dtype, seed=1)
    frames = _frames(port_cfg, seed=1)
    ref = ref_tf.encode(params, jnp.asarray(frames, jdt), ref_cfg)
    with torch.inference_mode():
        out = model.encode(torch.from_numpy(frames).to(tdt))
    assert out.shape == (2, port_cfg.encoder_seq_len, port_cfg.d_model)
    assert out.dtype == tdt
    if dtype == "float32":
        _cmp(out.numpy(), ref, "encode")
    else:
        _near(out.float().numpy(), ref, "encode")


@pytest.mark.parametrize("sq,mode", [(8, "prefill"), (1, "prefill"),
                                     (1, "decode")])
def test_cross_attention_matches_reference(sq, mode):
    """``encode_cross_kv`` and ``cross_attn_forward`` at Sq 8 and Sq 1 (the
    decode path's: through the decode op, valid = S_enc)."""
    ref_cfg, port_cfg = _configs()
    p = ref_attn.init_attn_params(jax.random.PRNGKey(3), ref_cfg,
                                  jnp.float32)
    pt = {n: torch.from_numpy(a) for n, a in _np(p).items()}
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 64, 256), dtype=np.float32)
    x = rng.standard_normal((2, sq, 256), dtype=np.float32)
    kv_ref = ref_attn.encode_cross_kv(jnp.asarray(enc), p, ref_cfg)
    kv = attn_mod.encode_cross_kv(torch.from_numpy(enc), pt, port_cfg)
    assert kv.k.shape == (2, 64, 4, 64)
    _cmp(kv.k.numpy(), kv_ref.k, "cross k")
    _cmp(kv.v.numpy(), kv_ref.v, "cross v")
    ref = ref_attn.cross_attn_forward(jnp.asarray(x), p, ref_cfg, kv_ref)
    out = attn_mod.cross_attn_forward(torch.from_numpy(x), pt, port_cfg, kv,
                                      mode=mode)
    assert out.shape == (2, sq, 256)
    _cmp(out.numpy(), ref, f"cross attention, {mode}")


def test_cross_attention_decode_goes_through_the_decode_op():
    """Decode hands the decode op the whole encoder (valid = S_enc) and
    never calls the prefill op; prefill calls it without a mask."""
    _, cfg = _configs()
    pt = {n: torch.randn(*s) for n, s in
          dict(wq=(256, 256), wk=(256, 256), wv=(256, 256),
               wo=(256, 256)).items()}
    kv = attn_mod.encode_cross_kv(torch.randn(1, 64, 256), pt, cfg)
    calls = []

    def dec(q, k, v, valid):
        calls.append(("decode", q.shape[1], valid))
        return torch.zeros_like(q)

    def pre(q, k, v, *, causal, window):
        calls.append(("prefill", causal, window))
        return torch.zeros_like(q)
    attn_mod.cross_attn_forward(torch.randn(1, 1, 256), pt, cfg, kv,
                                mode="decode", attention=pre,
                                decode_attention=dec)
    attn_mod.cross_attn_forward(torch.randn(1, 5, 256), pt, cfg, kv,
                                attention=pre, decode_attention=dec)
    assert calls == [("decode", 1, 64), ("prefill", False, None)]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_prefill_matches_reference(dtype):
    """Logits, the decoder's self-attention cache and the cross cache."""
    ref_cfg, port_cfg, params, model, jdt, tdt = _setup(dtype, seed=2)
    tokens = _tokens(port_cfg.vocab_size, seed=2)
    frames = _frames(port_cfg, seed=2)
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=16, frames=jnp.asarray(frames, jdt))
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens), cache_len=16,
                                     frames=torch.from_numpy(frames).to(tdt))
    assert ct.pos == 12 and len(ct.cross) == 1
    assert ct.layers[0].k.shape == (2, 16, 4, 64)
    assert ct.cross[0].k.shape == (2, 64, 4, 64)
    pairs = [("logits", lt, lr),
             ("self k", ct.layers[0].k, cr.blocks[0].k[0]),
             ("self v", ct.layers[0].v, cr.blocks[0].v[0]),
             ("cross k", ct.cross[0].k, cr.cross[0].k[0]),
             ("cross v", ct.cross[0].v, cr.cross[0].v[0])]
    for name, t, r in pairs:
        if dtype == "float32":
            _cmp(t.numpy(), r, name)
        else:
            _near(t.float().numpy(), r, name)
    if dtype == "float32":
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      np.asarray(lr).argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_decode_matches_reference(dtype):
    """Prefill, then 8 steps on both sides, each fed the reference's greedy
    token; logits compared after the prefill and at every step, and the
    cross cache left as the prefill made it."""
    ref_cfg, port_cfg, params, model, jdt, tdt = _setup(dtype, seed=4)
    tokens = _tokens(port_cfg.vocab_size, seed=4)
    frames = _frames(port_cfg, seed=4)
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=20, frames=jnp.asarray(frames, jdt))
    step = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref_cfg))
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens), cache_len=20,
                                     frames=torch.from_numpy(frames).to(tdt))
        cross_k = ct.cross[0].k.clone()
        for i in range(8):
            nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
            lr, cr = step(params, cr, jnp.asarray(nxt))
            lt, ct = model.serve_decode(torch.from_numpy(nxt), ct)
            assert ct.pos == 13 + i
            if dtype == "float32":
                _cmp(lt.numpy(), lr, f"decode step {i}")
                np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                              np.asarray(lr).argmax(-1))
            else:
                _near(lt.float().numpy(), lr, f"decode step {i}")
    assert torch.equal(ct.cross[0].k, cross_k)


def test_prefill_matches_prefill_and_teacher_forced_decode():
    """prefill(16) equals prefill(8) and 8 decode steps fed the same
    tokens: the cross cache is read as the prefill computed it."""
    _, port_cfg, _, model, _, _ = _setup(seed=5)
    tokens = torch.from_numpy(_tokens(port_cfg.vocab_size, b=1, s=16,
                                      seed=5))
    frames = torch.from_numpy(_frames(port_cfg, b=1, seed=5))
    with torch.inference_mode():
        full, _ = model.serve_prefill(tokens, frames=frames)
        logits, cache = model.serve_prefill(tokens[:, :8], cache_len=16,
                                            frames=frames)
        for i in range(8, 16):
            logits, cache = model.serve_decode(tokens[:, i], cache)
    assert cache.pos == 16
    _cmp(logits.numpy(), full.numpy(), "prefill + decode vs prefill")


def test_frames_change_the_logits():
    """The twin of tests/test_models.py's: other frames, other logits."""
    cfg = get_config(ARCH, reduced=True)
    model = Transformer(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, b=1, s=8))
    f1 = torch.zeros(1, cfg.encoder_seq_len, cfg.d_model,
                     dtype=torch.bfloat16)
    f2 = torch.from_numpy(_frames(cfg, b=1)).to(torch.bfloat16)
    with torch.inference_mode():
        l1, _ = model.serve_prefill(tokens, frames=f1)
        l2, _ = model.serve_prefill(tokens, frames=f2)
    assert torch.isfinite(l1.float()).all() and torch.isfinite(
        l2.float()).all()
    assert not torch.allclose(l1.float(), l2.float())


def test_prefill_needs_frames_and_only_an_encoder_decoder_takes_them():
    cfg = get_config(ARCH, reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.float32)
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="frames"):
        model.serve_prefill(tokens)
    qwen = Transformer(get_config("qwen3-0.6b", reduced=True), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        qwen.serve_prefill(tokens, frames=torch.zeros(1, 64, 256))
    with pytest.raises(ValueError, match="no encoder"):
        qwen.encode(torch.zeros(1, 64, 256))


def test_full_width_two_layer_model_matches_reference():
    """d 1024, 16 heads of 64, d_ff 4096: two decoder and two encoder
    layers over the published 1,500 frames, fp32, B 1 (vocab cut to 512:
    the head is a plain GEMM and the rest of the width is whole)."""
    ref_cfg, port_cfg, params, model, _, _ = _setup(
        seed=6, reduced=False, num_layers=2, num_encoder_layers=2,
        vocab_size=512)
    assert port_cfg.encoder_seq_len == 1500 and port_cfg.d_model == 1024
    tokens = _tokens(512, b=1, s=8, seed=6)
    frames = _frames(port_cfg, b=1, seed=6)
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=9, frames=jnp.asarray(frames))
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens), cache_len=9,
                                     frames=torch.from_numpy(frames))
        _cmp(lt.numpy(), lr, "prefill logits")
        _cmp(ct.cross[1].k.numpy(), cr.cross[0].k[1], "layer 1 cross k")
        nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        lr, _ = serve_decode(params, cr, jnp.asarray(nxt), ref_cfg)
        lt, _ = model.serve_decode(torch.from_numpy(nxt), ct)
    _cmp(lt.numpy(), lr, "decode logits")
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lr).argmax(-1))


@pytest.mark.parametrize("drop", ["enc_blocks leaf", "enc_blocks",
                                  "cross leaf"])
def test_from_jax_params_refuses_a_missing_leaf(drop):
    ref_cfg, port_cfg = _configs()
    tree = _np(init_params(jax.random.PRNGKey(0), ref_cfg))
    if drop == "enc_blocks leaf":
        del tree["enc_blocks"]["mix"]["wq"]
    elif drop == "enc_blocks":
        del tree["enc_blocks"]
    else:
        del tree["blocks"][0]["cross"]["wv"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, port_cfg, device="cpu", dtype=torch.float32)


def test_from_jax_params_refuses_an_extra_leaf():
    ref_cfg, port_cfg = _configs()
    tree = _np(init_params(jax.random.PRNGKey(0), ref_cfg))
    tree["enc_blocks"]["mix"]["bq"] = tree["enc_blocks"]["mix"]["wq"][:, 0]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, port_cfg, device="cpu", dtype=torch.float32)
