"""The port's dense transformer prefill against the reference's.

The reference's parameters (``repro.models.init_params``) are carried into
the port with ``from_jax_params``; the same token batch goes through
``repro.models.serve_prefill`` and ``Transformer.serve_prefill`` on the
CPU (the port's attention then runs its plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import init_params, serve_prefill
from repro_torch.configs import get_config
from repro_torch.models import attn_forward, from_jax_params

ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b")


def _configs(arch, reduced=True, dtype="float32", **changes):
    ref = dataclasses.replace(ref_get_config(arch, reduced=reduced),
                              dtype=dtype, **changes)
    port = dataclasses.replace(get_config(arch, reduced=reduced),
                               dtype=dtype, **changes)
    return ref, port


def _fp32_tree(params):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _tokens(vocab, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _both_prefill(ref_cfg, port_cfg, params, tree, tokens, dtype,
                  cache_len=None):
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=cache_len)
    model = from_jax_params(tree, port_cfg, device="cpu", dtype=dtype)
    lt, ct = model.serve_prefill(torch.from_numpy(tokens),
                                 cache_len=cache_len)
    return np.asarray(lr, np.float32), lt.float().numpy(), cr, ct


def _perturb_vectors(params, seed):
    """Noise on every norm scale and bias (init makes them ones/zeros), so
    the comparison exercises them."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference_fp32(arch):
    ref_cfg, port_cfg = _configs(arch)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(0), ref_cfg), 0)
    tokens = _tokens(ref_cfg.vocab_size)
    lr, lt, _, _ = _both_prefill(ref_cfg, port_cfg, params,
                                 _fp32_tree(params), tokens, torch.float32)
    np.testing.assert_allclose(lt, lr, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(lt.argmax(-1), lr.argmax(-1))


def test_prefill_full_width_two_layers_fp32():
    """qwen3-0.6b at its published width (d 1024, 16/8 heads at hd 128,
    d_ff 3072), cut to 2 layers and a 512-token vocabulary."""
    ref_cfg, port_cfg = _configs("qwen3-0.6b", reduced=False, num_layers=2,
                                 vocab_size=512)
    params = init_params(jax.random.PRNGKey(1), ref_cfg)
    tokens = _tokens(512, b=2, s=16, seed=1)
    lr, lt, _, _ = _both_prefill(ref_cfg, port_cfg, params,
                                 _fp32_tree(params), tokens, torch.float32)
    np.testing.assert_allclose(lt, lr, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(lt.argmax(-1), lr.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference_bf16(arch):
    """bf16 parameters handed over as ml_dtypes arrays (cast to fp32 and
    back inside ``from_jax_params``, which is exact)."""
    ref_cfg, port_cfg = _configs(arch, dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(2), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    tokens = _tokens(ref_cfg.vocab_size, seed=2)
    lr, lt, _, _ = _both_prefill(ref_cfg, port_cfg, params, tree, tokens,
                                 torch.bfloat16)
    scale = np.abs(lr).max()
    assert np.abs(lt - lr).max() <= 2e-2 * scale


@pytest.mark.parametrize("cache_len", [10, 40])
def test_prefill_cache_matches_reference(cache_len):
    """cache_len < S: the last tokens, ring-rolled; cache_len > S: the
    prompt at the front of a zero cache."""
    ref_cfg, port_cfg = _configs("qwen3-0.6b")
    params = init_params(jax.random.PRNGKey(3), ref_cfg)
    tokens = _tokens(ref_cfg.vocab_size, s=24, seed=3)
    _, _, cr, ct = _both_prefill(ref_cfg, port_cfg, params,
                                 _fp32_tree(params), tokens, torch.float32,
                                 cache_len=cache_len)
    assert ct.pos == 24
    for i, layer in enumerate(ct.layers):
        assert layer.k.shape[1] == cache_len
        np.testing.assert_allclose(layer.k.numpy(),
                                   np.asarray(cr.blocks[0].k[i]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(layer.v.numpy(),
                                   np.asarray(cr.blocks[0].v[i]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_forward_train_mode_matches_reference(arch):
    ref_cfg, port_cfg = _configs(arch)
    p = ref_attn.init_attn_params(jax.random.PRNGKey(4), ref_cfg,
                                  dtype=jnp.float32)
    if ref_cfg.qkv_bias:   # non-zero biases, so they are exercised
        rng = np.random.default_rng(4)
        p = {**p, **{n: jnp.asarray(rng.standard_normal(p[n].shape),
                                    jnp.float32) * 0.1
                     for n in ("bq", "bk", "bv")}}
    x = np.random.default_rng(5).standard_normal(
        (2, 12, ref_cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None]
    ref_out, _ = ref_attn.attn_forward(jnp.asarray(x), p, ref_cfg,
                                       positions=jnp.asarray(pos),
                                       mode="train")
    port_out, cache = attn_forward(
        torch.from_numpy(x), {n: torch.from_numpy(np.array(a))
                              for n, a in p.items()},
        port_cfg, positions=torch.from_numpy(pos), mode="train")
    assert cache is None
    np.testing.assert_allclose(port_out.numpy(), np.asarray(ref_out),
                               atol=1e-4, rtol=1e-4)
