"""The port's training step against the reference's, on the CPU: the
attention op's gradients against ``jax.grad`` of the reference's
``flash_attn``, remat on against off, ``to_jax_params`` as the inverse of
``from_jax_params``, and three AdamW steps of reduced qwen3-0.6b,
starcoder2-3b and qwen3-moe-30b-a3b against the reference's jitted
``make_train_step``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import init_params
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import init_adamw as ref_init_adamw
from repro.training import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import Transformer, from_jax_params, to_jax_params
from repro_torch.training import (AdamWConfig, DataConfig, init_adamw,
                                  make_batch, make_train_step)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# (B, Sq, Skv, H, KVH, hd, causal, window): causal MHA, GQA, a window
# shorter than S, unmasked (an encoder), unmasked Sq != Skv (cross)
ATTN_CASES = [
    (2, 24, 24, 4, 4, 16, True, None),
    (2, 33, 33, 8, 2, 16, True, None),
    (1, 40, 40, 6, 2, 8, True, 7),
    (2, 20, 20, 4, 4, 32, False, None),
    (2, 12, 50, 4, 2, 16, False, None),
]


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", ATTN_CASES)
def test_attention_op_grads_match_reference(b, sq, skv, h, kvh, hd, causal,
                                            window):
    rng = np.random.default_rng(sq * 7 + h)
    q, dout = (rng.standard_normal((b, sq, h, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
            for _ in range(2))

    def ref_loss(q, k, v):
        out = ref_attn.flash_attn(q, k, v, causal=causal, window=window,
                                  q_block=16, kv_block=16)
        return jnp.sum(out * dout)
    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_has_empty_rows_matches_the_plain_mask(causal):
    """The shapes the card refuses under grad are exactly those whose plain
    mask leaves a query row with no key (window 1 and windows past S
    included)."""
    from repro_torch.kernels.flash_attention import has_empty_rows
    for sq in (1, 2, 5, 9):
        for skv in (1, 3, 5, 9):
            for window in (None, 1, 2, 4, 12):
                qpos = torch.arange(sq)[:, None]
                kpos = torch.arange(skv)[None, :]
                mask = torch.ones(sq, skv, dtype=torch.bool)
                if causal:
                    mask &= kpos <= qpos
                if window is not None:
                    mask &= kpos > qpos - window
                empty = bool((~mask.any(dim=1)).any())
                assert has_empty_rows(sq, skv, window) == empty, \
                    (sq, skv, window)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "jamba-v0.1-52b"])
def test_remat_on_equals_remat_off(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=6)
    model.requires_grad_(True)
    batch = make_batch(cfg, DataConfig(seq_len=12, global_batch=2), 1)
    frames = torch.from_numpy(batch["frames"]) if "frames" in batch \
        else None
    params = list(model.parameters())
    out = {}
    for remat in (True, False):
        loss = model.forward_train(torch.from_numpy(batch["tokens"]),
                                   torch.from_numpy(batch["labels"]),
                                   frames, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, params))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_jax_params_inverts_from_jax_params(arch, dtype):
    ref_cfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                                  dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    params = init_params(jax.random.PRNGKey(4), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(tree, cfg, device="cpu",
                            dtype=getattr(torch, dtype))
    back = to_jax_params(model)
    ours, ref = _flat(back), _flat(tree)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path, a), (_, r) in zip(ours, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(r, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-3b",
                                  "qwen3-moe-30b-a3b"])
def test_train_steps_match_reference(arch):
    """Three steps of a reduced model in fp32 at ``weight_decay=0`` (so the
    decay rule of ROADMAP Queue C 4 plays no part): losses, grad norms,
    learning rates and the parameters after each step.  qwen3-0.6b,
    starcoder2-3b (a sliding window, biases, LayerNorm) and
    qwen3-moe-30b-a3b (the capacity dispatch's backward)."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    kw = dict(lr=3e-3, weight_decay=0.0, warmup_steps=2, total_steps=10)
    params = init_params(jax.random.PRNGKey(5), ref_cfg)
    ref_opt = ref_init_adamw(params)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(**kw)))
    model = from_jax_params(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                         params), cfg, device="cpu",
                            dtype=torch.float32)
    opt = init_adamw(dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(**kw))
    dcfg = DataConfig(seq_len=16, global_batch=4)
    start = [np.asarray(r) for _, r in _flat(params)]
    for i in range(3):
        batch = make_batch(cfg, dcfg, i)
        params, ref_opt, rm = ref_step(params, ref_opt, batch)
        opt, m = step(opt, batch)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
        assert m["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
        bc2 = 1 - RefAdamWConfig().beta2 ** (i + 1)
        for (path, a), (_, r), r0, (_, nu) in zip(
                _flat(to_jax_params(model)), _flat(params), start,
                _flat(ref_opt.nu)):
            # Adam moves each entry by about lr a step whatever its
            # gradient's size, so an entry whose gradient is within fp32
            # summation noise of 0 may move by +lr in one package and -lr
            # in the other: no entry is off by more than 2 lr a step, and
            # the leaf's difference is a small part of what the steps
            # moved it (a wrong step is O(1) of it).  An entry whose
            # gradient has been exactly 0 in the reference (an unseen
            # embedding row, an expert no token reached) must not have
            # moved in either.  The norm check leaves out the entries
            # whose nonzero gradient's RMS is below AdamW's eps, where a
            # step is lr m / eps, the gradient's noise scaled up (reduced
            # qwen3-moe-30b-a3b's embedding has one in its first step:
            # -4.6e-9 in the reference and 6.8e-8 here, of a largest
            # 0.52); qwen3-0.6b's check passes without it, and covers
            # every entry
            r, nu = np.asarray(r), np.asarray(nu)
            where = jax.tree_util.keystr(path)
            still = nu == 0
            np.testing.assert_array_equal(a[still], r[still],
                                          err_msg=where)
            noise = ~still & (np.sqrt(nu / bc2) < RefAdamWConfig().eps)
            held = slice(None) if arch == "qwen3-0.6b" else ~noise
            assert np.abs(a - r).max() <= 2 * kw["lr"] * (i + 1), where
            assert np.linalg.norm((a - r)[held]) \
                <= 1e-3 * np.linalg.norm(r - r0), where
