"""Mixture-of-Experts layer: top-k router + capacity-based scatter dispatch.

The port of ``repro/models/moe.py`` for one device.  Prefill
(``moe_forward``) is the reference's local dispatch
(``_moe_dispatch_local``): each (token, slot) pair takes the next free row
of its expert's (C, d) buffer in token-major order, pairs past the
capacity C are dropped, all experts run as one batched product over
(E, C, d) x (E, d, f), and the outputs are scatter-added back weighted by
their gates.  The reference's ``shard_map`` branch is multi-device and has
no counterpart here.

Decode (``moe_forward_decode``) computes the reference's gather-of-weights
function without its copy of the (T, k, d, f) selected expert weights
(0.94 GB per matrix per layer at Jamba's width and T = 4): the T·k pairs
are grouped by expert, and each selected expert's matrices are read in
place, once, for all its pairs.  That costs one host sync per call, to
learn which experts the router picked.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (constrain, get_shard_context,
                                       local_op, sharded)

# parameters kept in float32 whatever the model's dtype
FP32_PARAMS = frozenset({"router"})


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert, moe.num_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    moe = cfg.moe
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8, floor 8


def route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (top-k experts (T, k), gates (T, k) in x's dtype,
    aux loss scalar).  Slots are ordered by descending probability, ties
    to the lower expert index, as ``lax.top_k`` orders them (``torch.topk``
    leaves the order of ties undefined, so the top k come from a stable
    descending sort)."""
    moe = cfg.moe
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :moe.top_k], experts[..., :moe.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    e = moe.num_experts
    dispatch_frac = F.one_hot(experts, e).float().sum(1).mean(0)
    prob_frac = probs.mean(0)
    aux = e * (dispatch_frac * prob_frac).sum() * moe.load_balance_coef
    return experts, gates.to(x2d.dtype), aux


def dispatch_slots(flat_expert: torch.Tensor, num_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_expert: (T*k,) the expert of each (token, slot) pair, token-major.
    Returns each pair's row in its expert's buffer (its running count among
    the pairs of that expert, in that order) and whether it is kept (row <
    ``cap``; the rest overflow and are dropped)."""
    onehot = F.one_hot(flat_expert, num_experts)                 # (T*k, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_expert[:, None])[:, 0]
    return pos, pos < cap


def moe_forward(x: torch.Tensor, p, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss scalar).

    On DTensors (a sharded launch) the dispatch runs LOCALLY per shard of
    the batch, and of the sequence where the residual stream is
    sequence-sharded over "model" (the reference's shard_map, through
    ``local_map``): every shard routes its own tokens through all the
    experts, whose weights are gathered; the cumsum and scatter of the
    dispatch have no sharding strategy.  The aux loss is the mean over the
    shards (the reference's pmean over the data axes)."""
    if not sharded(x):
        return _moe_dispatch(x, p["router"], p["w_gate"], p["w_up"],
                             p["w_down"], cfg=cfg)
    local_dims = (0, 1) if get_shard_context() else (0,)
    out, aux = local_op(_moe_dispatch_shard, x, p["router"], p["w_gate"],
                        p["w_up"], p["w_down"], local_dims=local_dims,
                        replicate=(1, 2, 3, 4), n_out=2, cfg=cfg)
    return out, aux.mean()


def _moe_dispatch_shard(x, router, w_gate, w_up, w_down, *, cfg):
    """One shard's dispatch; the aux loss repeated over its (B, S)."""
    out, aux = _moe_dispatch(x, router, w_gate, w_up, w_down, cfg=cfg,
                             local=True)
    return out, aux.expand(x.shape[:2])


def _moe_dispatch(x, router, w_gate, w_up, w_down, *, cfg: ModelConfig,
                  local: bool = False):
    """The capacity dispatch of x (B, S, d) (``moe_forward``)."""
    p = {"router": router, "w_gate": w_gate, "w_up": w_up,
         "w_down": w_down}
    # the reference's "moe_buf"/"moe_hidden" constraints apply on its
    # auto-SPMD path only; a shard's dispatch is local
    c = (lambda t, name: t) if local else constrain
    moe = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, moe.top_k, moe.num_experts
    cap = _capacity(t, cfg)
    x2d = x.reshape(t, d)
    experts, gates, aux = route(x2d, p["router"], cfg)          # (T, k)

    flat_expert = experts.reshape(-1)                            # (T*k,)
    pos, keep = dispatch_slots(flat_expert, e, cap)

    # scatter tokens into (E, C, d); a dropped pair goes to a spare bin
    # (expert e), which no expert reads: no host sync on the mask
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    scatter_e = torch.where(keep, flat_expert, e)
    slot = torch.where(keep, pos, 0)
    buf = x.new_zeros(e + 1, cap, d)
    buf[scatter_e, slot] = x2d[tok_idx]
    buf = c(buf[:e], "moe_buf")

    # expert FFN (swiglu), batched over experts
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = c(F.silu(g.float()).to(x.dtype) * u, "moe_hidden")
    y = torch.bmm(h, p["w_down"])                                # (E, C, d)

    # gather back and combine with the gates, scatter-add in x's dtype
    gathered = y[scatter_e.clamp(max=e - 1), pos.clamp(0, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = gathered * gates.reshape(-1)[:, None]
    out = x.new_zeros(t, d).index_add_(0, tok_idx, weighted)
    return out.reshape(b, s, d), aux


def _decode_shard(x, router, w_gate, w_up, w_down, *, cfg):
    return moe_forward_decode(x, {"router": router, "w_gate": w_gate,
                                  "w_up": w_up, "w_down": w_down}, cfg)


def moe_forward_decode(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Decode path: x (B, 1, d); no capacity, no drops, exact.

    One host sync per call (the experts the router picked); the pairs are
    grouped by expert on the device, and each picked expert's three
    matrices are then used in place for all the pairs routed to it.  On
    DTensors (a sharded launch) each shard of the batch decodes its own
    rows over the gathered experts."""
    if sharded(x):
        return local_op(_decode_shard, x, p["router"], p["w_gate"],
                        p["w_up"], p["w_down"], replicate=(1, 2, 3, 4),
                        cfg=cfg)
    if x.device.type == "meta":
        # a shape-only trace (the dry run) cannot read the router's picks:
        # the capacity dispatch with room for every pair has the same
        # result and bounds the same products
        moe = cfg.moe
        cfg = replace(cfg, moe=replace(
            moe, capacity_factor=moe.num_experts / moe.top_k))
        return _moe_dispatch(x, p["router"], p["w_gate"], p["w_up"],
                             p["w_down"], cfg=cfg, local=True)[0]
    b, s, d = x.shape
    k = cfg.moe.top_k
    x2d = x.reshape(b * s, d)
    experts, gates, _ = route(x2d, p["router"], cfg)             # (T, k)
    t = x2d.shape[0]
    flat_dev = experts.reshape(-1)
    flat = flat_dev.tolist()
    order = torch.argsort(flat_dev, stable=True)     # pairs by expert
    y = x.new_empty(t * k, d)
    start = 0
    for ex in sorted(set(flat)):
        rows = order[start:start + flat.count(ex)]
        start += rows.shape[0]
        xe = x2d[rows // k]
        g = xe @ p["w_gate"][ex]
        u = xe @ p["w_up"][ex]
        h = F.silu(g.float()).to(x.dtype) * u
        y[rows] = h @ p["w_down"][ex]
    out = torch.einsum("tkd,tk->td", y.reshape(t, k, d), gates)
    return out.reshape(b, s, d)
