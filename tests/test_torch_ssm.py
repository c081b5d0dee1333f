"""The port's Mamba/MoE path (jamba-v0.1-52b) against the reference's, on
the CPU.

The scan op: ``ssm_chunk_scan_plain`` (the CPU path of ``ops.ssm_scan``
and the card's yardstick) against the Pallas kernel in interpret mode, the
sequential oracle ``ssm_chunk_scan_ref`` and the reference model's own
associative scan ``_chunk_scan``.  Then the layers (``causal_conv``,
``mamba_mix``, ``mamba_decode``, ``moe_forward``, ``moe_forward_decode``)
and the reduced jamba-v0.1-52b (``serve_prefill``, ``serve_decode``)
against ``repro.models``, with the reference's parameters carried over by
``from_jax_params``.  Inputs are made with numpy and handed to both
packages.  The CUDA kernel itself is held against the plain version on
the card in ``test_torch_cuda.py``.

Tolerances: the scan atol 1e-4 / rtol 1e-3, those of the reference's own
kernel sweep (``tests/test_kernels.py``); fp32 layers 1e-4 and fp32
models 1e-3 (absolute and relative), as the decode parity tests; bf16
layers and models 2e-2 of max |output| (the two frameworks round bf16 at
other places); prefill against incremental decode 1e-3 in fp32 and 0.15
in bf16, ``tests/test_models.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssm_chunk_scan_ref
from repro.kernels.ssm_scan import ssm_chunk_scan as pallas_ssm_chunk_scan
from repro.models import init_params, serve_decode, serve_prefill
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.configs import MAMBA, get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.models import (MambaState, Transformer, from_jax_params,
                                make_mamba_state, mamba_decode, mamba_mix,
                                moe_forward, moe_forward_decode, route)
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import causal_conv
from repro_torch.models import ssm as ssm_mod

ARCH = "jamba-v0.1-52b"
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)
LAYER_TOL = 1e-4
MODEL_TOL = 1e-3
BF16_REL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cmp(a, b, name, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


def _cmp_rel(a, b, name, rel=BF16_REL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, name
    err = np.abs(a - b).max()
    assert err <= rel * np.abs(b).max(), (name, err, np.abs(b).max())


def _np(tree):
    """numpy fp32 leaves (writable copies: torch.from_numpy shares them)."""
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _torch(tree, dtype):
    """Leaves as torch tensors: fp32 leaves stay fp32, the rest ``dtype``
    (the port's rule for the leaves the reference keeps in fp32)."""
    return {n: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if a.dtype == jnp.float32 else dtype)
        for n, a in tree.items()}


def _configs(reduced=True, dtype="float32", **changes):
    ref = dataclasses.replace(ref_get_config(ARCH, reduced=reduced),
                              dtype=dtype, **changes)
    port = dataclasses.replace(get_config(ARCH, reduced=reduced),
                               dtype=dtype, **changes)
    return ref, port


def _perturb_vectors(params, seed):
    """Noise on every norm scale, bias and per-channel vector (init makes
    them ones, zeros or constants), so the comparison exercises them."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------

def _scan_inputs(seed, b, l, d, st):
    rng = np.random.default_rng(seed)
    da = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, l, d, st))))
    dbx = rng.standard_normal((b, l, d, st)) * 0.1
    return da.astype(np.float32), dbx.astype(np.float32)


# tests/test_kernels.py's sweep (B 1..3, L 1..40, D 8/32/96, ST 4/16) and
# D 100, which the Pallas kernel pads to its channel block
@pytest.mark.parametrize("b,l,d,st", [
    (1, 1, 8, 4), (2, 7, 32, 16), (3, 40, 96, 4), (1, 40, 8, 16),
    (2, 16, 100, 8), (1, 33, 100, 16),
])
def test_plain_scan_matches_reference_kernels(b, l, d, st):
    da, dbx = _scan_inputs(l * 7 + d, b, l, d, st)
    out = ops.ssm_scan(torch.from_numpy(da), torch.from_numpy(dbx))
    assert out.dtype == torch.float32 and out.shape == (b, l, d, st)
    jda, jdbx = jnp.asarray(da), jnp.asarray(dbx)
    # D 100 also in channel blocks of 16: the last one padded
    block_d = 16 if d == 100 else 256
    refs = {"pallas": pallas_ssm_chunk_scan(jda, jdbx, block_d=block_d,
                                            interpret=True),
            "ref": ssm_chunk_scan_ref(jda, jdbx),
            "xla": ref_ops.ssm_scan(jda, jdbx, impl="xla")}
    for name, ref in refs.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   err_msg=name, **SCAN_TOL)


def test_ops_ssm_scan_dispatch():
    """A CPU tensor goes to the plain version (bit for bit); any device
    other than CPU or CUDA raises."""
    da, dbx = _scan_inputs(1, 2, 9, 12, 4)
    tda, tdbx = torch.from_numpy(da), torch.from_numpy(dbx)
    out = ops.ssm_scan(tda, tdbx)
    assert torch.equal(out, scan_mod.ssm_chunk_scan_plain(tda, tdbx))
    assert torch.equal(out, ops.ssm_scan_plain(tda, tdbx))
    with pytest.raises(ValueError, match="no ssm scan path"):
        ops.ssm_scan(tda.to("meta"), tdbx.to("meta"))


def test_scan_kernel_wrapper_refuses_what_it_cannot_take():
    da = torch.rand(2, 5, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.ssm_chunk_scan(da, da)
    with pytest.raises(ValueError, match="float32"):
        scan_mod.ssm_chunk_scan(da.bfloat16(), da.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        scan_mod.ssm_chunk_scan(da, da.double())
    with pytest.raises(ValueError, match=r"\(B, L, D, ST\)"):
        scan_mod.ssm_chunk_scan(da[0], da[0])
    with pytest.raises(ValueError, match="dbx has shape"):
        scan_mod.ssm_chunk_scan(da, da[:, :4])
    with pytest.raises(ValueError, match="empty"):
        scan_mod.ssm_chunk_scan(da[:, :0], da[:, :0])
    with pytest.raises(ValueError, match="dbx has shape"):
        scan_mod.ssm_chunk_scan_plain(da, da[..., :2])


# --------------------------------------------------------------------------
# the Mamba layer
# --------------------------------------------------------------------------

def _mamba_params(ref_cfg, seed, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    p = _perturb_vectors(ref_ssm.init_mamba_params(
        jax.random.PRNGKey(seed), ref_cfg, dtype=jdt), seed)
    return p, _torch(p, tdt)


def _state(rng, b, cfg, dtype="float32"):
    """A non-zero carried state on both sides."""
    jdt, tdt = DTYPES[dtype]
    inner = cfg.ssm_expand * cfg.d_model
    h = rng.standard_normal((b, inner, cfg.ssm_state_dim)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.ssm_conv_dim - 1, inner)) \
        .astype(np.float32)
    return (ref_ssm.MambaState(h=jnp.asarray(h),
                               conv=jnp.asarray(conv, jdt)),
            MambaState(h=torch.from_numpy(h.copy()),
                       conv=torch.from_numpy(conv).to(tdt)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x, tail = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 9, 24), (2, 3, 24)))
    w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 24),
                                                                 (24,)))
    out_r, tail_r = ref_ssm._causal_conv(*(jnp.asarray(a, jdt)
                                           for a in (x, tail, w, b)))
    out_t, tail_t = causal_conv(*(torch.from_numpy(a).to(tdt)
                                  for a in (x, tail, w, b)))
    assert out_t.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2e-2
    _cmp(out_t.float().numpy(), out_r, "conv out", tol)
    np.testing.assert_array_equal(tail_t.float().numpy(),
                                  np.asarray(tail_r, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 8), (5, 256)])
def test_mamba_mix_matches_reference(s, chunk, dtype):
    """Chunks of 8 over S = 20 pad the last chunk with 4 identity steps;
    the incoming state is non-zero, so the cumprod fold and the conv tail
    carry real values."""
    ref_cfg, port_cfg = _configs()
    p, pt = _mamba_params(ref_cfg, 1, dtype)
    rng = np.random.default_rng(s)
    st_r, st_t = _state(rng, 2, ref_cfg, dtype)
    x = rng.standard_normal((2, s, ref_cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    out_r, new_r = ref_ssm.mamba_mix(jnp.asarray(x, jdt), p, ref_cfg, st_r,
                                     chunk=chunk)
    calls = []

    def counting(da, dbx):
        calls.append(da.shape)
        return ops.ssm_scan(da, dbx)
    out_t, new_t = mamba_mix(torch.from_numpy(x).to(tdt), pt, port_cfg,
                             st_t, chunk=chunk, ssm=counting)
    assert len(calls) == -(-s // min(chunk, s))
    assert out_t.dtype == tdt and new_t.h.dtype == torch.float32
    for name, a, r in (("out", out_t, out_r), ("state h", new_t.h, new_r.h),
                       ("conv tail", new_t.conv, new_r.conv)):
        if dtype == "float32":
            _cmp(a.numpy(), r, name, LAYER_TOL)
        else:
            _cmp_rel(a.float().numpy(), r, name)


def test_mamba_layer_at_full_width():
    """One Mamba layer of the published jamba-v0.1-52b (d 4096, inner 8192,
    state 16, dt rank 256) in fp32, B 1, S 8, from the zero state."""
    ref_cfg, port_cfg = _configs(reduced=False)
    p, pt = _mamba_params(ref_cfg, 2)
    x = np.random.default_rng(2).standard_normal(
        (1, 8, ref_cfg.d_model)).astype(np.float32)
    out_r, st_r = ref_ssm.mamba_mix(
        jnp.asarray(x), p, ref_cfg, ref_ssm.make_mamba_state(1, ref_cfg,
                                                             jnp.float32))
    out_t, st_t = mamba_mix(torch.from_numpy(x), pt, port_cfg,
                            make_mamba_state(1, port_cfg, torch.float32,
                                             "cpu"))
    assert st_t.h.shape == (1, 8192, 16)
    _cmp(out_t.numpy(), out_r, "out", LAYER_TOL)
    _cmp(st_t.h.numpy(), st_r.h, "state h", LAYER_TOL)


def test_mamba_decode_matches_reference_from_a_prefilled_state():
    ref_cfg, port_cfg = _configs()
    p, pt = _mamba_params(ref_cfg, 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, ref_cfg.d_model)).astype(np.float32)
    _, st_r = ref_ssm.mamba_mix(jnp.asarray(x), p, ref_cfg,
                                ref_ssm.make_mamba_state(2, ref_cfg,
                                                         jnp.float32))
    _, st_t = mamba_mix(torch.from_numpy(x), pt, port_cfg,
                        make_mamba_state(2, port_cfg, torch.float32, "cpu"))
    for step in range(3):
        xd = rng.standard_normal((2, 1, ref_cfg.d_model)).astype(np.float32)
        out_r, st_r = ref_ssm.mamba_decode(jnp.asarray(xd), p, ref_cfg, st_r)
        h_in = st_t.h
        out_t, st_t = mamba_decode(torch.from_numpy(xd), pt, port_cfg, st_t)
        assert st_t.h is not h_in
        _cmp(out_t.numpy(), out_r, f"step {step} out", LAYER_TOL)
        _cmp(st_t.h.numpy(), st_r.h, f"step {step} state h", LAYER_TOL)
        _cmp(st_t.conv.numpy(), st_r.conv, f"step {step} conv", LAYER_TOL)


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def _moe_params(ref_cfg, seed, dtype="float32", skew=0.0):
    """The reference's MoE parameters; ``skew`` is added to expert 0's
    router column, so most tokens pick it first."""
    jdt, tdt = DTYPES[dtype]
    p = ref_moe.init_moe_params(jax.random.PRNGKey(seed), ref_cfg, dtype=jdt)
    if skew:
        p["router"] = p["router"].at[:, 0].add(skew)
    return p, _torch(p, tdt)


def _ref_keep(experts, num_experts, cap):
    """The reference's drop rule in numpy: a pair is kept while fewer than
    ``cap`` earlier pairs (token-major) went to its expert."""
    flat = np.asarray(experts).reshape(-1)
    seen = np.zeros(num_experts, np.int64)
    keep = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew", [0.0, 0.05])
def test_moe_forward_matches_reference(skew, dtype):
    """T = 2 x 16 tokens, 4 experts, capacity 24.  With the skewed router
    expert 0 is asked for more than 24 rows: the same pairs are dropped
    on both sides."""
    ref_cfg, port_cfg = _configs()
    jdt, tdt = DTYPES[dtype]
    p, pt = _moe_params(ref_cfg, 5, dtype, skew)
    # with a skew, inputs of mean 0.5 add ~0.05 * 0.5 * 256 = 6.4 to
    # expert 0's logit: every token asks for it
    x = (np.random.default_rng(5).standard_normal((2, 16, ref_cfg.d_model))
         + (0.5 if skew else 0.0)).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    out_r, aux_r = ref_moe.moe_forward(xj, p, ref_cfg)
    out_t, aux_t = moe_forward(xt, pt, port_cfg)
    e_r, g_r, _ = ref_moe.route(xj.reshape(32, -1), p["router"], ref_cfg)
    e_t, g_t, _ = route(xt.reshape(32, -1), pt["router"], port_cfg)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_r))
    cap = moe_mod._capacity(32, port_cfg)
    assert cap == ref_moe._capacity(32, ref_cfg) == 24
    keep_r = _ref_keep(e_r, 4, cap)
    _, keep_t = moe_mod.dispatch_slots(e_t.reshape(-1), 4, cap)
    np.testing.assert_array_equal(keep_t.numpy(), keep_r)
    if skew:
        assert (~keep_r).sum() > 0           # overflow really happened
    assert out_t.dtype == tdt
    _cmp(float(aux_t), float(aux_r), "aux", 1e-5)
    if dtype == "float32":
        _cmp(g_t.numpy(), g_r, "gates", 1e-5)
        _cmp(out_t.numpy(), out_r, "out", LAYER_TOL)
    else:
        _cmp_rel(out_t.float().numpy(), out_r, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_decode_matches_reference(dtype):
    """B 5 tokens (10 pairs over 4 experts, so experts repeat)."""
    ref_cfg, port_cfg = _configs()
    jdt, tdt = DTYPES[dtype]
    p, pt = _moe_params(ref_cfg, 6, dtype)
    x = np.random.default_rng(6).standard_normal(
        (5, 1, ref_cfg.d_model)).astype(np.float32)
    out_r = ref_moe.moe_forward_decode(jnp.asarray(x, jdt), p, ref_cfg)
    out_t = moe_forward_decode(torch.from_numpy(x).to(tdt), pt, port_cfg)
    assert out_t.dtype == tdt and out_t.shape == (5, 1, ref_cfg.d_model)
    if dtype == "float32":
        _cmp(out_t.numpy(), out_r, "out", LAYER_TOL)
    else:
        _cmp_rel(out_t.float().numpy(), out_r, "out")


@pytest.mark.parametrize("router", ["zero", "equal_columns"])
def test_moe_routing_ties_match_reference(router):
    """Tied probabilities go to the lower expert index, as
    ``lax.top_k`` orders them: a zero router (every probability 1/4, so
    experts [0, 1] for every token) and a router whose columns 1 and 3
    are equal (a tie at the k boundary picks 1 over 3)."""
    ref_cfg, port_cfg = _configs()
    p, _ = _moe_params(ref_cfg, 7)
    if router == "zero":
        p["router"] = jnp.zeros_like(p["router"])
    else:
        p["router"] = p["router"].at[:, 3].set(p["router"][:, 1])
    pt = _torch(p, torch.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 16, ref_cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    e_r, g_r, aux_r = ref_moe.route(xj.reshape(32, -1), p["router"], ref_cfg)
    e_t, g_t, aux_t = route(xt.reshape(32, -1), pt["router"], port_cfg)
    e_r = np.asarray(e_r)
    if router == "zero":
        assert (e_r == [0, 1]).all()
    else:
        assert ((e_r == 1).any(1) ^ (e_r == 3).any(1)).any()  # a boundary tie
    np.testing.assert_array_equal(e_t.numpy(), e_r)
    _cmp(g_t.numpy(), g_r, "gates", 1e-6)
    _cmp(float(aux_t), float(aux_r), "aux", 1e-6)
    out_r, _ = ref_moe.moe_forward(xj, p, ref_cfg)
    out_t, _ = moe_forward(xt, pt, port_cfg)
    _cmp(out_t.numpy(), out_r, "moe_forward", LAYER_TOL)
    xd = x[:, :1]
    out_r = ref_moe.moe_forward_decode(jnp.asarray(xd), p, ref_cfg)
    out_t = moe_forward_decode(torch.from_numpy(np.ascontiguousarray(xd)),
                               pt, port_cfg)
    _cmp(out_t.numpy(), out_r, "moe_forward_decode", LAYER_TOL)


# --------------------------------------------------------------------------
# the reduced model
# --------------------------------------------------------------------------

def _tokens(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _cmp_states(port_layers, ref_blocks, cfg, where):
    """Each layer's state: Mamba h and conv tail, attention k and v."""
    for li, st in enumerate(port_layers):
        ref = ref_blocks[li % len(cfg.block_pattern)]
        names = ("h", "conv") if cfg.block_pattern[li] == MAMBA \
            else ("k", "v")
        for name in names:
            a = getattr(st, name).float().numpy()
            b = np.asarray(getattr(ref, name), np.float32)[0]
            _cmp(a, b, f"{where} layer {li} {name}", MODEL_TOL)


def _against_reference(params, tokens, steps):
    """fp32: prefill, then ``steps`` greedy steps on both sides, each fed
    the reference's greedy token; logits compared after the prefill and at
    every step, the states after the prefill and at the end."""
    ref_cfg, port_cfg = _configs()
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
        lt = lt.numpy()
        _cmp(lt, lr, where, MODEL_TOL)
        np.testing.assert_array_equal(lt.argmax(-1), lr.argmax(-1),
                                      err_msg=where)
    check(lt, lr, "prefill")
    _cmp_states(ct.layers, cr.blocks, port_cfg, "prefill")
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        lr, cr = step(params, cr, jnp.asarray(nxt))
        with torch.inference_mode():
            lt, ct = model.serve_decode(torch.from_numpy(nxt), ct)
        assert ct.pos == tokens.shape[1] + i + 1
        check(lt, lr, f"decode step {i}")
    _cmp_states(ct.layers, cr.blocks, port_cfg, "decode")


def test_serve_prefill_and_decode_match_reference_fp32():
    """Reduced jamba-v0.1-52b (7 Mamba + 1 attention layer, 4 MoE MLPs of
    4 experts, no RoPE): S 12 in chunks of 256, then 3 decode steps at
    positions 12-14."""
    ref_cfg, _ = _configs()
    params = _perturb_vectors(init_params(jax.random.PRNGKey(0), ref_cfg), 0)
    _against_reference(params, _tokens(ref_cfg.vocab_size), 3)


def test_serve_prefill_and_decode_match_reference_bf16():
    """bf16 parameters, states and activations on both sides.

    Eight bf16 layers with a router amplify rounding: on these parameters
    the reference's own bf16 logits sit 3.1 % of max |logit| from its fp32
    logits after the prefill (3.1-3.6 % over seeds 0 and 2, 37 % over seed
    1, where a bf16 rounding flips a routing choice), so the 2e-2 of max
    |logit| that the dense models meet cannot hold for any bf16
    implementation here; each layer alone meets it
    (``test_mamba_mix_matches_reference``,
    ``test_moe_forward_matches_reference``).  After the prefill and at each
    decode step, the port's bf16 logits must sit no further from the
    reference's bf16 logits than those sit from fp32, and no further from
    fp32 than 1.5 times that (``test_torch_xlstm.py``'s rule)."""
    ref_cfg, port_cfg = _configs(dtype="bfloat16")
    ref32 = dataclasses.replace(ref_cfg, dtype="float32")
    params = init_params(jax.random.PRNGKey(2), ref_cfg)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    tokens = _tokens(ref_cfg.vocab_size, seed=2)
    steps = 3
    cache_len = tokens.shape[1] + steps
    lr, cr = serve_prefill(params, jnp.asarray(tokens), ref_cfg,
                           cache_len=cache_len)
    l32, c32 = serve_prefill(p32, jnp.asarray(tokens), ref32,
                             cache_len=cache_len)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg,
                            device="cpu", dtype=torch.bfloat16)
    with torch.inference_mode():
        lt, ct = model.serve_prefill(torch.from_numpy(tokens),
                                     cache_len=cache_len)
    step16 = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref_cfg))
    step32 = jax.jit(lambda p, c, t: serve_decode(p, c, t, ref32))

    def check(where):
        r16, r32 = np.asarray(lr, np.float32), np.asarray(l32, np.float32)
        port = lt.float().numpy()
        noise = np.abs(r16 - r32).max()
        assert np.abs(port - r16).max() <= noise, where
        assert np.abs(port - r32).max() <= 1.5 * noise, where
    check("prefill")
    for i in range(steps):
        nxt = jnp.asarray(np.asarray(jnp.argmax(lr, -1)).astype(np.int32))
        lr, cr = step16(params, cr, nxt)
        l32, c32 = step32(p32, c32, nxt)
        with torch.inference_mode():
            lt, ct = model.serve_decode(torch.from_numpy(np.array(nxt)),
                                        ct)
        check(f"decode step {i}")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, MODEL_TOL),
                                       (torch.bfloat16, 0.15)])
def test_prefill_matches_incremental_decode(dtype, tol):
    """Prefill of 16 tokens equals prefill of the first 8 and 8 decode
    steps (the Mamba state and conv tail carried, the attention cache
    filled slot by slot)."""
    cfg = get_config(ARCH, reduced=True)
    model = from_jax_params(
        _np(init_params(jax.random.PRNGKey(0), ref_get_config(
            ARCH, reduced=True))), cfg, device="cpu", dtype=dtype)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, b=1, s=16, seed=3))
    with torch.inference_mode():
        full, _ = model.serve_prefill(tokens, cache_len=16)
        logits, cache = model.serve_prefill(tokens[:, :8], cache_len=16)
        for i in range(8, 16):
            logits, cache = model.serve_decode(tokens[:, i], cache)
    assert cache.pos == 16
    _cmp(logits.float().numpy(), full.float().numpy(),
         "incremental decode vs prefill", tol)


def test_from_jax_params_keeps_the_fp32_leaves():
    """In a bf16 model Mamba's dt_bias, A_log and D and the MoE router
    stay float32 and hold the reference's values exactly."""
    ref_cfg, port_cfg = _configs(dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(1), ref_cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg,
                            device="cpu", dtype=torch.bfloat16)
    fp32 = {"dt_bias", "A_log", "D"}
    for li, p in enumerate(model.layers):
        j = li % len(port_cfg.block_pattern)
        blk = params["blocks"][j]
        for name, t in p.items():
            want = fp32 | ({"router"} if port_cfg.mlp_pattern[j] == "moe"
                           else set())
            assert t.dtype == (torch.float32 if name in want
                               else torch.bfloat16), (li, name)
            if name in want:
                leaf = blk["mix"][name] if name in blk["mix"] \
                    else blk["mlp"][name]
                assert np.asarray(leaf).dtype == np.float32
                np.testing.assert_array_equal(t.numpy(),
                                              np.asarray(leaf)[0])


def test_seed_init_gives_the_reference_special_values():
    """A = -(1..state) per channel, dt_bias -4.6, D 1, conv bias 0, as
    ``init_mamba_params`` makes them; the other weights are random."""
    cfg = get_config(ARCH, reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    ref = ref_ssm.init_mamba_params(jax.random.PRNGKey(0), ref_get_config(
        ARCH, reduced=True))
    p = model.layers[0]
    for name in ("A_log", "dt_bias", "D", "conv_b"):
        assert p[name].dtype == (torch.bfloat16 if name == "conv_b"
                                 else torch.float32)
        _cmp(p[name].float().numpy(), ref[name], name, 1e-6)
    assert p["in_proj"].float().std() > 0
    assert model.layers[1]["router"].dtype == torch.float32


def test_configs_match_reference():
    for reduced in (False, True):
        port = get_config(ARCH, reduced=reduced)
        ref = ref_get_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.vocab_size, full.rope) == \
        (32, 4096, 32, 8, 65536, False)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_expert) == \
        (16, 2, 14336)
    assert ssm_mod.dt_rank(full) == 256
