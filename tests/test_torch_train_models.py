"""``Transformer.forward_train`` against the reference's ``forward_train``:
the loss and every parameter's gradient, for every architecture of the
zoo in reduced form, in fp32 on the CPU (the port's kernels then run their
plain versions, which autograd differentiates).  The reference's
parameters go into the port with ``from_jax_params``; the port's
gradients come back in the reference's tree with ``to_jax_params``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import forward_train, init_params
from repro.training import DataConfig as RefDataConfig
from repro.training import make_batch as ref_make_batch
from repro_torch.configs import get_config
from repro_torch.models import from_jax_params, to_jax_params

# fp32 on both sides; the two frameworks sum in other orders (~1e-7
# relative per op), which the reduced stacks carry into the gradients:
# measured at most 8.7e-5 of a leaf's largest entry (xlstm-1.3b's
# recurrences), 1.6e-5 (jamba) and <= 3.4e-6 for the attention models,
# on this CPU run; the loss within 4.5e-7.  A wrong or missing gradient
# path is O(1) of the leaf's largest entry.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3           # max |diff| over max |reference gradient|, a leaf


def _configs(arch):
    return (dataclasses.replace(ref_get_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32"))


def _perturb_vectors(params, seed):
    """Noise on every norm scale and bias (init makes them ones/zeros), so
    their gradients are exercised away from the init point."""
    rng = np.random.default_rng(seed)

    def f(x):
        if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 4):
            return x                       # a weight matrix (maybe stacked)
        return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1, x.dtype)
    return jax.tree.map(f, params)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _batch(ref_cfg):
    return ref_make_batch(ref_cfg, RefDataConfig(seq_len=16, global_batch=2,
                                                 seed=5), 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_loss_and_grads_match_reference(arch):
    ref_cfg, cfg = _configs(arch)
    params = _perturb_vectors(init_params(jax.random.PRNGKey(3), ref_cfg), 1)
    batch = _batch(ref_cfg)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: forward_train(p, batch, ref_cfg)))(params)

    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    model = from_jax_params(tree, cfg, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    frames = torch.from_numpy(batch["frames"]) if "frames" in batch \
        else None
    loss = model.forward_train(torch.from_numpy(batch["tokens"]),
                               torch.from_numpy(batch["labels"]), frames)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert loss.item() == pytest.approx(float(loss_ref), rel=LOSS_RTOL)
    ours, ref = _flat(to_jax_params(model, grads)), _flat(grads_ref)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(ours, ref):
        r = np.asarray(r, np.float32)
        assert g.shape == r.shape, path
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)
