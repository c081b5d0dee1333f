"""Shared layers: norms, RoPE, causal conv, SwiGLU MLP, the training loss,
seeded init, device resolution, sharding hooks."""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: the
    port's entry points never drop quietly to the CPU; pass
    ``device="cpu"`` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: repro_torch runs on the GPU "
                               "unless the caller passes device='cpu'")
        device = "cuda"
    return torch.device(device)


# --------------------------------------------------------------------------
# Sharding hooks (the reference's ``models/common.py:21-54``): the launcher
# installs activation rules (name -> an object with a ``.spec``, one entry
# per dim of the reference's layout: None, an axis name or a tuple of
# them); model code calls constrain(x, "name") at the reference's points.
# Without rules, or on a plain tensor, it returns x: a single device runs
# as before.  With rules and a DTensor it redistributes x to the rule's
# placements on x's own mesh.
# --------------------------------------------------------------------------

_rules = threading.local()


def set_sharding_rules(rules: Optional[dict]) -> None:
    _rules.value = rules


def get_sharding_rules() -> Optional[dict]:
    return getattr(_rules, "value", None)


def spec_placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: dim d's entry
    names the mesh dims that shard it, major to minor.  Several axes on
    one dim must follow the mesh's dim order (plain ``Shard`` placements
    split in that order; another needs strided sharding and raises)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    pl = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {d} sharded over {axes}: not in the mesh's dim order "
                f"{names}, which plain Shard placements cannot express")
        for i in idx:
            pl[i] = Shard(d)
    return tuple(pl)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded(x) -> bool:
    """Whether x takes the sharded paths: rules are installed and x is a
    DTensor (a single device never does)."""
    return bool(get_sharding_rules()) and _is_dtensor(x)


def constrain(x: torch.Tensor, name: str,
              perm: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x redistributed to the installed rule ``name``.  ``perm[i]`` names
    the rule's dim that x's dim i is, where x's layout differs from the
    reference's (e.g. (B, S, H, hd) against the rule's (B, H, S, hd))."""
    rules = get_sharding_rules()
    if not sharded(x) or rules.get(name) is None:
        return x
    spec = tuple(rules[name].spec)
    spec = spec + (None,) * (x.ndim - len(spec))
    if perm is not None:
        spec = tuple(spec[perm[i]] for i in range(x.ndim))
    return x.redistribute(x.device_mesh, spec_placements(x.device_mesh,
                                                         spec))


# shard-local dispatch context: layers whose dispatch must be LOCAL per data
# shard (MoE scatter, sLSTM time scan) read the mesh and data axes from
# here and run under ``local_map``.  None outside the launchers.
_shard_ctx = threading.local()


def set_shard_context(ctx: Optional[dict]) -> None:
    """ctx: {"mesh": DeviceMesh, "dp": data axis names, "tp": "model" or
    None, "tp_size": int} or None."""
    _shard_ctx.value = ctx


def get_shard_context() -> Optional[dict]:
    return getattr(_shard_ctx, "value", None)


def local_op(fn, *args, local_dims: Sequence[int] = (0,), n_out: int = 0,
             replicate: Sequence[int] = (), **kwargs):
    """``fn(*args, **kwargs)``; on DTensors (a sharded launch), ``fn`` runs
    on each shard's local tensors under ``local_map``.  The tensor
    arguments are laid out as the first one, sharded only on
    ``local_dims`` (dims where every such argument and output is
    independent, e.g. batch and heads): its shards on other dims are
    gathered first, a plain tensor counts as replicated.  The arguments
    at the indices ``replicate`` (weights) are gathered whole.  The
    output, a tensor (``n_out`` 0) or a flat tuple of ``n_out`` tensors
    each with those dims, comes back laid out as the first argument.  Ops
    with no DTensor sharding strategy (the kernels' plain versions, scans,
    scatters, lookups) run through here."""
    if not sharded(args[0]):
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in local_dims
               else Replicate() for p in args[0].placements)
    rep = (Replicate(),) * mesh.ndim
    # a whole argument's gradient from each shard is that shard's part: a
    # partial sum over the mesh dims that split the others
    rep_grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in pl)
    ins, in_pl, grad_pl = [], [], []
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, rep, run_check=False)
            want = rep if i in replicate else pl
            a = a.redistribute(mesh, want)
            in_pl.append(want)
            grad_pl.append(rep_grad if i in replicate else pl)
        else:
            in_pl.append(None)
            grad_pl.append(None)
        ins.append(a)
    # local_map: a list of placements per output, a tuple of them for a
    # tuple of outputs
    out_pl = tuple(list(pl) for _ in range(n_out)) if n_out else list(pl)
    return local_map(lambda *xs: fn(*xs, **kwargs), out_placements=out_pl,
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*ins)


# FSDP: the mesh axes a layer's parameters are gathered over before use
# (the training launch sets the data axes; None elsewhere)
_gather_axes = threading.local()


def set_param_gather(axes: Optional[Sequence[str]]) -> None:
    _gather_axes.value = tuple(axes) if axes else None


def gather_params(p):
    """A layer's parameters with their shards over the gather axes
    (``set_param_gather``) all-gathered, as FSDP does before a layer
    runs: its products then see only the "model" axis's TP shards (the
    reference's XLA partitioner inserts the same gathers).  ``p`` itself
    when no axes are set."""
    axes = getattr(_gather_axes, "value", None)
    if not axes:
        return p
    from torch.distributed.tensor import DTensor, Replicate

    def gather(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if names[i] in axes else q
                   for i, q in enumerate(t.placements))
        return t if pl == tuple(t.placements) \
            else t.redistribute(t.device_mesh, pl)
    return {n: gather(t) for n, t in p.items()}


def split_dim(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x ready to have ``dim`` split into (n, rest): a DTensor sharded on
    ``dim`` over mesh dims whose sizes do not divide n (e.g. 8 KV heads of
    a 16-way model axis) is gathered on ``dim`` first, the replication the
    reference's rules fall back to."""
    if not sharded(x):
        return x
    from torch.distributed.tensor import Shard
    shards = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            shards *= x.device_mesh.size(i)
    return x if n % shards == 0 else unshard_dims(x, (dim % x.ndim,))


def unshard_dims(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """x with its shards on ``dims`` gathered (a DTensor; else x): the
    sequence entering attention and the MLP under sequence parallelism,
    as XLA gathers it from the reference's "residual" constraint."""
    if not sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) \
        else x.redistribute(x.device_mesh, pl)


# --------------------------------------------------------------------------
# Initialisation (seeded through an explicit torch.Generator)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, in_axis: int = -2) -> torch.Tensor:
    """LeCun-normal-ish init, fan-in on ``in_axis``."""
    std = 1.0 / shape[in_axis] ** 0.5
    return (torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device) -> torch.Tensor:
    return (torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Norms (fp32 internals, cast back)
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: normalise over the head dim of (..., H, hd)."""
    return rms_norm(x, scale, eps)


# --------------------------------------------------------------------------
# RoPE (split-half convention)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    # a Python-scalar base: no host-to-device copy, which would make the
    # host wait for the stream at every layer
    return 1.0 / torch.pow(theta, exponents)                 # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Causal depthwise conv (the mLSTM and Mamba blocks)
# --------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor):
    """x: (B, S, inner); tail: (B, ck-1, inner) history; w: (ck, inner).
    Returns the depthwise causal conv output (B, S, inner) and the new
    tail."""
    ck = w.shape[0]
    s = x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(ck))
    new_tail = xp[:, -(ck - 1):] if ck > 1 else tail
    return out + b, new_tail


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Weights are (in, out): ``x @ W`` as in the reference."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    h = constrain(h, "ffn_hidden")
    return h @ w_down


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy in fp32 (twin of the reference's
    ``cross_entropy_loss``): logits (B, S, V) in any dtype, labels (B, S).
    The row max is detached (the reference's ``stop_gradient``) and
    subtracted in the logits' dtype, the rest runs in fp32; the gold logit
    is gathered, where the reference takes it by an iota match (the same
    value and gradient)."""
    if sharded(logits):
        return _vocab_parallel_ce(logits, labels)
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - lmax).float()
    sumexp = shifted.exp().sum(dim=-1)
    gold = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return (sumexp.log() - gold).mean()


def _vocab_parallel_ce(logits, labels):
    """``cross_entropy_loss`` of DTensor logits, shard-local: every shard
    keeps its slice of the vocab (no logits or gradient gathered across
    the vocab shards, as the reference's V-sharded loss); the row max,
    the exp-sum and the gold logit are all-reduced over the mesh dim that
    shards the vocab, one value a row each."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = list(logits.placements)
    vdims = [i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == last]
    row_pl = [Replicate() if i in vdims else p for i, p in enumerate(pl)]
    labels = labels.redistribute(mesh, row_pl)
    group = (mesh, vdims[0]) if vdims else None
    rows = local_map(
        lambda lg, lb: _ce_rows(lg, lb, group), out_placements=row_pl,
        in_placements=(pl, row_pl), device_mesh=mesh)(logits, labels)
    return rows.mean()


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) of a value every rank of ``group`` then holds
    alike; its gradient comes back replicated, so the backward passes it
    through."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ce_rows(logits, labels, group):
    """Per-row loss of one shard's logits (..., V_local) over the vocab
    slice at this rank's offset; ``group``: the vocab's mesh dim or None
    (an unsharded vocab)."""
    import torch.distributed._functional_collectives as funcol
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    v = logits.shape[-1]
    off = 0
    if group is not None:
        lmax = funcol.all_reduce(lmax, "max", group)
        off = group[0].get_local_rank(group[1]) * v
    shifted = (logits - lmax).float()
    sumexp = shifted.exp().sum(dim=-1)
    idx = labels.long() - off
    mine = (idx >= 0) & (idx < v)
    gold = torch.where(mine, shifted.gather(
        -1, idx.clamp(0, v - 1)[..., None])[..., 0], 0.0)
    if group is not None:
        sumexp = _SumAcross.apply(sumexp, group)
        gold = _SumAcross.apply(gold, group)
    return sumexp.log() - gold
