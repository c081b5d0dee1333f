"""The rest of the model zoo against the reference, on the CPU:
qwen3-moe-30b-a3b (128 experts, top 8, qk-norm), chameleon-34b (dense,
qk-norm, 64/8 heads), granite-34b (MQA 48/1, qkv bias, tied head) and
phi3.5-moe-42b-a6.6b (16 experts, top 2).

Each arch's reduced configuration (cut to two layers) is held to
``repro.models``: the reference's parameters carried over by
``from_jax_params``, the same numpy token batch through
``serve_prefill`` and four greedy ``serve_decode`` steps on both sides.
The port's attention ops run their plain versions on CPU tensors.  The
reduced configs keep at most 4 heads, so each arch also runs at its
published head counts (head dim cut to 16), where the decode op packs
granite-34b's 48 query heads over its one KV head (G 48).

Tolerances are the other archs' parity tests': fp32 logits 1e-3 absolute
and relative with argmax equal (``test_torch_decode.py``,
``test_torch_ssm.py``); bf16 logits within 2e-2 of max |logit| of the
reference's bf16 ones (``test_torch_models.py``, ``test_torch_decode.py``);
prefill against prefill + incremental decode 1e-3 in fp32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import param_count as ref_param_count
from repro.models import init_params, serve_decode, serve_prefill
from repro_torch.configs import get_config
from repro_torch.models import Transformer, from_jax_params, param_bytes

ARCHS = ("qwen3-moe-30b-a3b", "chameleon-34b", "granite-34b",
         "phi3.5-moe-42b-a6.6b")
# published (heads, KV heads) of each
HEADS = {"qwen3-moe-30b-a3b": (32, 4), "chameleon-34b": (64, 8),
         "granite-34b": (48, 1), "phi3.5-moe-42b-a6.6b": (32, 8)}
MODEL_TOL = 1e-3
STEPS = 4


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
    """Noise on every norm scale and bias (init makes them ones/zeros), so
    the comparison exercises them."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


def _tokens(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _cmp(a, b, where, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol, err_msg=where)


def _against_reference(ref_cfg, port_cfg, params, tokens, steps=STEPS):
    """fp32: prefill, then ``steps`` greedy steps on both sides, each fed
    the reference's greedy token; logits (and argmax) compared after the
    prefill and at every step, the KV caches after the last step."""
    cache_len = tokens.shape[1] + steps
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=cache_len)
    model = from_jax_params(_np(params), port_cfg, device="cpu",
                            dtype=torch.float32)
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens),
                                     cache_len=cache_len)
    step = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref_cfg))

    def check(lt, lr, where):
        lr = np.asarray(lr, np.float32)
        _cmp(lt.numpy(), lr, where)
        np.testing.assert_array_equal(lt.numpy().argmax(-1), lr.argmax(-1),
                                      err_msg=where)
    check(lt, lr, "prefill")
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        lr, cr = step(params, cr, jnp.asarray(nxt))
        with torch.inference_mode():
            lt, ct = model.serve_decode(torch.from_numpy(nxt), ct)
        assert ct.pos == tokens.shape[1] + i + 1
        check(lt, lr, f"decode step {i}")
    for li, layer in enumerate(ct.layers):
        _cmp(layer.k.numpy(), np.asarray(cr.blocks[0].k[li]),
             f"layer {li} k")
        _cmp(layer.v.numpy(), np.asarray(cr.blocks[0].v[li]),
             f"layer {li} v")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_configs_match_reference(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(arch, reduced=reduced))
    full = get_config(arch)
    assert (full.num_heads, full.num_kv_heads) == HEADS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_prefill_and_decode_match_reference_fp32(arch):
    """The reduced config at two layers: prefill of 12 tokens, then 4
    decode steps."""
    ref_cfg, port_cfg = _configs(arch, num_layers=2)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(0), ref_cfg), 0)
    _against_reference(ref_cfg, port_cfg, params,
                       _tokens(ref_cfg.vocab_size))


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_published_heads_match_reference_fp32(arch):
    """The published head counts (granite-34b: 48 query heads over one KV
    head) at head dim 16 on the reduced width."""
    h, kvh = HEADS[arch]
    ref_cfg, port_cfg = _configs(arch, num_layers=2, num_heads=h,
                                 num_kv_heads=kvh, head_dim=16)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(1), ref_cfg), 1)
    _against_reference(ref_cfg, port_cfg, params,
                       _tokens(ref_cfg.vocab_size, seed=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_bf16_matches_reference(arch):
    """bf16 parameters, caches and activations on both sides: after the
    prefill and at each of 4 decode steps, the port's logits sit within
    2e-2 of max |logit| of the reference's bf16 logits, the dense models'
    bf16 bound.  (The two frameworks round bf16 at other places, so the
    port's distance to the reference's bf16 logits is a rounding error of
    its own beside the reference's: for qwen3-moe here, 0.039 at the
    prefill where the reference's bf16 logits sit 0.033 from its fp32
    ones.)"""
    ref_cfg, port_cfg = _configs(arch, dtype="bfloat16", num_layers=2)
    params = init_params(jax.random.PRNGKey(2), ref_cfg)
    tokens = _tokens(ref_cfg.vocab_size, seed=2)
    cache_len = tokens.shape[1] + STEPS
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=cache_len)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg,
                            device="cpu", dtype=torch.bfloat16)
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens),
                                     cache_len=cache_len)
    step16 = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref_cfg))

    def check(where):
        ref = np.asarray(lr, np.float32)
        assert np.abs(lt.float().numpy() - ref).max() \
            <= 2e-2 * np.abs(ref).max(), where
    check("prefill")
    for i in range(STEPS):
        nxt = jnp.asarray(np.asarray(jnp.argmax(lr, -1)).astype(np.int32))
        lr, cr = step16(params, cr, nxt)
        with torch.inference_mode():
            lt, ct = model.serve_decode(torch.from_numpy(np.array(nxt)), ct)
        check(f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_prefill_matches_incremental_decode(arch):
    """fp32: the prefill of 16 tokens equals the prefill of the first 8
    and 8 decode steps (no MoE pair is dropped at 16 tokens: every
    expert's capacity holds them all)."""
    ref_cfg, cfg = _configs(arch, num_layers=2)
    model = from_jax_params(_np(init_params(jax.random.PRNGKey(3), ref_cfg)),
                            cfg, device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, b=1, s=16, seed=3))
    with torch.inference_mode():
        full, _ = model.serve_prefill(tokens, cache_len=16)
        logits, cache = model.serve_prefill(tokens[:, :8], cache_len=16)
        for i in range(8, 16):
            logits, cache = model.serve_decode(tokens[:, i], cache)
    assert cache.pos == 16
    _cmp(logits.numpy(), full.numpy(), "incremental decode vs prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_from_jax_params_refuses_a_missing_or_extra_leaf(arch):
    ref_cfg, port_cfg = _configs(arch)
    tree = _np(init_params(jax.random.PRNGKey(0), ref_cfg))
    mlp = tree["blocks"][0]["mlp"]
    dropped = "router" if port_cfg.moe is not None else "w_up"
    leaf = mlp.pop(dropped)
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, port_cfg, device="cpu", dtype=torch.float32)
    mlp[dropped] = leaf
    mlp["extra"] = leaf
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, port_cfg, device="cpu", dtype=torch.float32)
    del mlp["extra"]
    if port_cfg.tie_embeddings:       # granite-34b: no lm_head leaf
        tree["lm_head"] = tree["embed"].T
        with pytest.raises(ValueError, match="top-level keys"):
            from_jax_params(tree, port_cfg, device="cpu",
                            dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_seeded_model_on_cpu(arch):
    """A seeded reduced model: ``param_bytes`` counts its tensors, the MoE
    router stays fp32 in a bf16 model, and the full config's bytes are
    the reference's ``param_count`` in bf16 up to what that count
    approximates (qkv biases and qk-norm scales, under 0.1 %)."""
    cfg = get_config(arch, reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    assert held == param_bytes(cfg, torch.bfloat16)
    for p in model.layers:
        for name, t in p.items():
            assert t.dtype == (torch.float32 if name == "router"
                               else torch.bfloat16), name
    with torch.inference_mode():
        logits, cache = model.serve_prefill(
            torch.from_numpy(_tokens(cfg.vocab_size, b=2, s=8)),
            cache_len=9)
        logits, _ = model.serve_decode(logits.argmax(-1), cache)
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    full = get_config(arch)
    assert math.isclose(param_bytes(full, torch.float32) / 4,
                        ref_param_count(ref_get_config(arch)), rel_tol=1e-3)
