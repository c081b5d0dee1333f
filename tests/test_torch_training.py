"""The port's training substrate against the reference's, on the CPU:
AdamW leaf by leaf, the schedule and the global norm, the data pipeline
bit for bit, checkpoints (``torch.save`` in place of msgpack), resume, and
the reference's own learnable-data contract.  Also the pin of ROADMAP
Queue C 4: the reference decays its stacked per-layer norm scales; the
port decays matrices only."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # degrade to deterministic example sweeps
    from _hypothesis_fallback import given, settings, st

from repro.configs import get_config as ref_get_config
from repro.models import init_params
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.models import Transformer, from_jax_params, to_jax_params
from repro_torch.training import (AdamWConfig, AdamWState, CheckpointManager,
                                  DataConfig, adamw_update, global_norm,
                                  init_adamw, load_pytree, make_batch,
                                  make_train_step, save_pytree, schedule)

# AdamW on the same leaves in fp32: the two packages differ in the order
# of the global norm's sum and in fp32 rounding of the schedule's scalars
# (~1e-7 relative); bf16 leaves may land one rounding step apart
ADAMW_TOL = {np.float32: 1e-6, ml_dtypes.bfloat16: 2 ** -7}


def _leaves(rng, dtype):
    """A matrix, a stacked matrix, a vector (a ``final_norm``-like leaf)
    and a scalar-per-head leaf, in ``dtype``; plus an fp32 leaf, as the
    fp32 parameters a bf16 model keeps."""
    def arr(*shape, dt=dtype):
        return (rng.standard_normal(shape) * 0.5).astype(dt)
    return {"w": arr(6, 5), "stack": arr(2, 4, 3), "norm": arr(5),
            "b_h": arr(3), "router": arr(5, 4, dt=np.float32)}


def _ref_tree(leaves):
    return {k: jnp.asarray(v) for k, v in leaves.items()}


def _port_tree(leaves):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == ml_dtypes.bfloat16 else torch.float32)
        for k, v in leaves.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("clip_norm", [1e3, 0.5], ids=["no_clip", "clip"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(dtype, clip_norm, weight_decay):
    rng = np.random.default_rng(0)
    params = _leaves(rng, dtype)
    cfg = dict(lr=1e-2, weight_decay=weight_decay, clip_norm=clip_norm,
               warmup_steps=2, total_steps=10)
    rp, ro = _ref_tree(params), ref_opt.init_adamw(_ref_tree(params))
    pp = _port_tree(params)
    po = init_adamw(pp)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        rp, ro, rs = ref_opt.adamw_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, ro, rp,
            ref_opt.AdamWConfig(**cfg))
        pp, po, ps = adamw_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, po, pp,
            AdamWConfig(**cfg))
        assert po.step == int(ro.step) == step + 1
        assert ps["lr"] == pytest.approx(float(rs["lr"]), rel=1e-6)
        assert float(ps["grad_norm"]) == pytest.approx(
            float(rs["grad_norm"]), rel=1e-6)
        for k in params:
            assert pp[k].dtype == (torch.float32 if k == "router" or
                                   dtype == np.float32 else torch.bfloat16)
            tol = ADAMW_TOL[np.float32 if k == "router" else dtype]
            np.testing.assert_allclose(_np(pp[k]), _np(rp[k]), rtol=tol,
                                       atol=tol)
            np.testing.assert_allclose(po.mu[k].numpy(), _np(ro.mu[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(po.nu[k].numpy(), _np(ro.nu[k]),
                                       rtol=1e-5, atol=1e-7)


def _functional_adamw(grads, state, params, cfg, scale):
    """The update as the port wrote it before it worked in place: new
    parameters and moments, the same elementary operations in the same
    order, given the clip ``scale``."""
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
    new_p, new_m, new_v = {}, {}, {}
    for n, g in grads.items():
        p = params[n]
        g = g.float() * scale
        m2 = b1 * state.mu[n] + (1 - b1) * g
        v2 = b2 * state.nu[n] + (1 - b2) * g.square()
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p[n] = (p.float() - lr * delta).to(p.dtype)
        new_m[n], new_v[n] = m2, v2
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("clip_norm", [1e3, 0.5], ids=["no_clip", "clip"])
def test_adamw_update_is_in_place(dtype, clip_norm):
    """Three updates write over the parameters and moments they are given
    (the same tensors, the same storage, returned again) and the values
    are bit for bit those of the functional form on the same inputs and
    clip scale."""
    rng = np.random.default_rng(1)
    params = {k: v.clone() for k, v in _port_tree(_leaves(rng, dtype)).items()}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm,
                      warmup_steps=2, total_steps=10)
    opt = init_adamw(params)
    ptrs = {k: (params[k].data_ptr(), opt.mu[k].data_ptr(),
                opt.nu[k].data_ptr()) for k in params}
    want_p = {k: v.clone() for k, v in params.items()}
    want = AdamWState(0, {k: v.clone() for k, v in opt.mu.items()},
                      {k: v.clone() for k, v in opt.nu.items()})
    for _ in range(3):
        grads = {k: torch.from_numpy((rng.standard_normal(v.shape) * 3)
                                     .astype(np.float32)).to(v.dtype)
                 for k, v in params.items()}
        scale = torch.clamp(cfg.clip_norm / torch.clamp(global_norm(grads),
                                                        min=1e-9), max=1.0)
        want_p, want = _functional_adamw(grads, want, want_p, cfg, scale)
        got_p, got, _ = adamw_update(dict(grads), opt, params, cfg)
        assert got.step == want.step
        for k in params:
            assert got_p[k] is params[k]
            assert got.mu[k] is opt.mu[k] and got.nu[k] is opt.nu[k]
            assert (params[k].data_ptr(), opt.mu[k].data_ptr(),
                    opt.nu[k].data_ptr()) == ptrs[k]
            assert params[k].dtype == want_p[k].dtype
            assert torch.equal(params[k], want_p[k]), k
            assert torch.equal(opt.mu[k], want.mu[k]), k
            assert torch.equal(opt.nu[k], want.nu[k]), k
        opt = got


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert schedule(step, AdamWConfig(**cfg)) == float(
        ref_opt.schedule(jnp.asarray(step), ref_opt.AdamWConfig(**cfg)))


@pytest.mark.parametrize("case,match", [
    ("cpu", "adamw_step_plain"), ("fp16", "dtypes"), ("grad_dtype", "dtypes"),
    ("shape", "shapes"), ("strided", "contiguous")])
def test_adamw_kernels_refuse_what_they_cannot_update(case, match):
    """The multi-tensor kernels' table takes bf16/fp32 leaves laid out as
    their gradients and of their dtype, contiguous, on one CUDA device:
    CPU leaves (which the leaf loop updates), another dtype, a gradient
    of another dtype or shape and a strided parameter are refused before
    anything is launched."""
    from repro_torch.kernels import adamw
    p = {"w": torch.ones(4, 6, dtype=torch.float16 if case == "fp16"
                         else torch.float32)}
    if case == "strided":
        p["w"] = p["w"].t()
    g = {"w": torch.ones(6, 4) if case == "shape" else torch.ones_like(
        p["w"], dtype=torch.bfloat16 if case == "grad_dtype" else None)}
    opt = init_adamw(p)
    with pytest.raises(ValueError, match=match):
        adamw.leaf_table(g, p, opt.mu, opt.nu)


def test_global_norm_and_clipping():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(3 + 16))
    p = {"w": torch.ones(4, 4)}
    g = {"w": torch.full((4, 4), 100.0)}
    cfg = AdamWConfig(clip_norm=1.0, lr=1.0, warmup_steps=0, total_steps=1)
    _, _, stats = adamw_update(g, init_adamw(p), p, cfg)
    assert float(stats["grad_norm"]) == pytest.approx(400.0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
@pytest.mark.parametrize("step,hosts,host", [(0, 1, 0), (7, 2, 1),
                                              (123, 4, 3)])
def test_make_batch_is_bit_equal_to_reference(arch, step, hosts, host):
    kw = dict(seq_len=24, global_batch=8, seed=3, host_id=host,
              num_hosts=hosts)
    ours = make_batch(get_config(arch, reduced=True), DataConfig(**kw), step)
    ref = ref_data.make_batch(ref_get_config(arch, reduced=True),
                              ref_data.DataConfig(**kw), step)
    assert set(ours) == set(ref) == ({"tokens", "labels", "frames"}
                                     if arch == "whisper-medium"
                                     else {"tokens", "labels"})
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_checkpoint_roundtrip_gc_and_latest(tmp_path):
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16, seed=1)
    params = model.state_dict()
    opt = init_adamw(params)
    opt = AdamWState(step=5, mu={k: v + 1.5 for k, v in opt.mu.items()},
                     nu=opt.nu)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    for s in (1, 2, 3):
        assert mgr.save(s, params, opt) == str(tmp_path / f"step_{s:08d}")
    assert mgr.steps() == [2, 3]            # gc keeps the last 2
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                             "step_00000003"]
    p2, o2 = mgr.restore(3, params, init_adamw(params))
    assert list(p2) == list(params)
    for k, v in params.items():
        assert p2[k].dtype == v.dtype == torch.bfloat16
        assert torch.equal(p2[k], v)
    assert isinstance(o2, AdamWState) and o2.step == 5
    for k in params:
        assert torch.equal(o2.mu[k], opt.mu[k])
        assert o2.mu[k].dtype == torch.float32
    _, none = mgr.restore(2, params)
    assert none is None


def test_load_pytree_refuses_a_mismatch(tmp_path):
    path = str(tmp_path / "t.pt")
    save_pytree({"a": torch.zeros(2, 3), "b": [torch.ones(4), 7]}, path)
    out = load_pytree(path, {"a": torch.empty(2, 3),
                             "b": [torch.empty(4), 0]})
    assert torch.equal(out["b"][0], torch.ones(4)) and out["b"][1] == 7
    with pytest.raises(ValueError, match="match"):
        load_pytree(path, {"a": torch.empty(3, 2), "b": [torch.empty(4), 0]})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": torch.empty(2, 3)})


def _run(model, opt, cfg, steps, start=0):
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2,
                                              total_steps=8))
    dcfg = DataConfig(seq_len=16, global_batch=2)
    losses = []
    for s in range(start, steps):
        opt, m = step(opt, make_batch(cfg, dcfg, s))
        losses.append(float(m["loss"]))
    return opt, losses


def test_resumed_run_equals_uninterrupted(tmp_path):
    cfg = get_config("qwen3-0.6b", reduced=True)
    full = Transformer(cfg, device="cpu", dtype=torch.float32, seed=2)
    _, losses = _run(full, init_adamw(dict(full.named_parameters())), cfg,
                     6)

    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=2)
    opt, first = _run(model, init_adamw(dict(model.named_parameters())),
                      cfg, 3)
    CheckpointManager(str(tmp_path)).save(3, model.state_dict(), opt)
    resumed = Transformer(cfg, device="cpu", dtype=torch.float32, seed=9)
    mgr = CheckpointManager(str(tmp_path))
    params, opt = mgr.restore(mgr.latest_step(), resumed.state_dict(),
                              init_adamw(dict(resumed.named_parameters())))
    resumed.load_state_dict(params)
    _, rest = _run(resumed, opt, cfg, 6, start=3)
    assert first + rest == losses
    for (n, a), (_, b) in zip(full.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), n


def test_loss_decreases_on_learnable_data():
    """The reference's contract: constant-token batches are perfectly
    learnable, so the loss must drop fast."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    opt = init_adamw(dict(model.named_parameters()))
    step = make_train_step(model, AdamWConfig(lr=5e-3, warmup_steps=1,
                                              total_steps=50))
    tokens = np.full((4, 16), 7, np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for _ in range(12):
        opt, m = step(opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses
    assert not any(p.requires_grad for p in model.parameters())


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 100), hosts=st.sampled_from([1, 2, 4]))
def test_data_determinism_and_host_disjointness(step, hosts):
    cfg = get_config("qwen3-0.6b", reduced=True)
    b1 = make_batch(cfg, DataConfig(seq_len=16, global_batch=8), step)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    parts = [make_batch(cfg, DataConfig(seq_len=16, global_batch=8,
                                        host_id=h, num_hosts=hosts), step)
             for h in range(hosts)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), b1["tokens"])


def test_decay_skips_per_layer_vectors():
    """ROADMAP Queue C 4.  Reduced qwen3-0.6b, one AdamW step with
    ``weight_decay=0.1`` and zero gradients: only decay moves a leaf.  The
    reference stacks each layer's leaves over superblocks, so its
    ``ndim >= 2`` rule decays ``norm1`` (1, 256), ``q_norm`` (1, 64) and
    the rest of the per-layer vectors, and spares only ``final_norm``; the
    port's per-layer leaves decay the matrices and nothing else."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen3-0.6b", reduced=True),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    params = init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    opt_kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=0, total_steps=10)
    zeros = jax.tree.map(jnp.zeros_like, params)
    ref_new, _, _ = ref_opt.adamw_update(zeros, ref_opt.init_adamw(params),
                                         params,
                                         ref_opt.AdamWConfig(**opt_kw))
    model = from_jax_params(tree, cfg, device="cpu", dtype=torch.float32)
    named = dict(model.named_parameters())
    new, _, _ = adamw_update({n: torch.zeros_like(p)
                              for n, p in named.items()},
                             init_adamw(named), named, AdamWConfig(**opt_kw))
    ours = to_jax_params(model, new)
    blk_ref, blk = ref_new["blocks"][0], ours["blocks"][0]
    before = tree["blocks"][0]
    # the reference decays the stacked per-layer vectors ...
    for name in ("norm1", "norm2"):
        assert blk_ref[name].shape == (1, 256)
        assert not np.array_equal(np.asarray(blk_ref[name]), before[name])
        np.testing.assert_array_equal(blk[name], before[name])
    for name in ("q_norm", "k_norm"):
        assert blk_ref["mix"][name].shape == (1, 64)
        assert not np.array_equal(np.asarray(blk_ref["mix"][name]),
                                  before["mix"][name])
        np.testing.assert_array_equal(blk["mix"][name], before["mix"][name])
    # ... and neither decays the top-level final_norm; both decay matrices
    np.testing.assert_array_equal(ours["final_norm"], tree["final_norm"])
    np.testing.assert_array_equal(np.asarray(ref_new["final_norm"]),
                                  tree["final_norm"])
    for name in ("wq", "wo"):
        assert not np.array_equal(blk["mix"][name], before["mix"][name])
        np.testing.assert_allclose(blk["mix"][name],
                                   np.asarray(blk_ref["mix"][name]),
                                   rtol=1e-6, atol=1e-8)
