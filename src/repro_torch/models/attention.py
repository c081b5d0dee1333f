"""Attention sub-block: GQA/MHA projections, qk-norm, RoPE, KV cache, and
the encoder-decoder's cross-attention.

Prefill attention goes through ``kernels.ops.flash_attention`` and decode
attention through ``kernels.ops.decode_attention`` (the Hopper kernels on
the card, their plain versions on the CPU) unless the caller hands another
function of the same signature as ``attention`` or ``decode_attention``.

Unlike the reference, which is functional, a decode step writes the new
token's k/v into the cache it is handed, in place (``cache_write``): a
copy of every layer's cache at every step would cost more than the
attention itself.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, constrain,
                                       head_rms_norm, local_op, sharded,
                                       split_dim)

AttentionFn = Callable[..., torch.Tensor]
DecodeAttentionFn = Callable[..., torch.Tensor]


class KVCache(NamedTuple):
    """Per-layer KV cache.  ``k``/``v``: (B, S_cache, KVH, hd).

    S_cache is the full context for dense decode or the window size for the
    ring-buffer variant; token t sits in slot ``t % S_cache``.
    """
    k: torch.Tensor
    v: torch.Tensor


def make_kv_cache(batch: int, s_cache: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, s_cache, kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def project_qkv(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                cfg: ModelConfig, positions: Optional[torch.Tensor]):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KVH,hd); RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_dim(q, -1, cfg.num_heads).reshape(b, s, cfg.num_heads, hd)
    k = split_dim(k, -1, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads,
                                                   hd)
    v = split_dim(v, -1, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads,
                                                   hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "act_q")
    k = constrain(k, "act_kv")
    v = constrain(v, "act_kv")
    return q, k, v


# the rule "attn_heads" is in the reference's (B, H, S, hd); these tensors
# are (B, S, H, hd)
_BSHD = (0, 2, 1, 3)


def segment_attention(attention: AttentionFn, q, k, v, *, causal: bool,
                      window: Optional[int]) -> torch.Tensor:
    """``attention(q, k, v)`` (B, S, H|KVH, hd).  On DTensors (a sharded
    launch) K/V are repeated to the H query heads and all three laid out
    by the rule "attn_heads" (batch over data, heads over "model" where
    they divide), as the reference does, and the op runs on each shard's
    local batch and heads (``local_op``: its plain version has no DTensor
    sharding strategy)."""
    if not sharded(q):
        return attention(q, k, v, causal=causal, window=window)
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    q, k, v = (constrain(t, "attn_heads", _BSHD) for t in (q, k, v))
    return local_op(attention, q, k, v, local_dims=(0, 2), causal=causal,
                    window=window)


def prefill_cache(k: torch.Tensor, v: torch.Tensor,
                  cache: Optional[KVCache]) -> KVCache:
    """The decode cache after a prefill of k/v (B, S, KVH, hd): the last
    ``S_cache`` tokens, ring-aligned (token t in slot t % S_cache), or the
    prompt written at the front of a longer cache."""
    s = k.shape[1]
    s_cache = cache.k.shape[1] if cache is not None else s
    if s >= s_cache:
        # ring alignment: slot of token t is t % s_cache
        shift = (s - s_cache) % s_cache
        kc = torch.roll(k[:, s - s_cache:], shifts=shift, dims=1)
        vc = torch.roll(v[:, s - s_cache:], shifts=shift, dims=1)
        return KVCache(kc, vc)
    kfull = cache.k.clone()
    vfull = cache.v.clone()
    kfull[:, :s] = k
    vfull[:, :s] = v
    return KVCache(kfull, vfull)


def cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int) -> KVCache:
    """Write one token's k/v (B, 1, KVH, hd) at ring slot ``pos % Sc``, in
    place; returns ``cache`` itself."""
    slot = pos % cache.k.shape[1]
    if sharded(cache.k):
        _write_slot(cache, k_new, v_new, slot)
        return cache
    cache.k[:, slot:slot + 1] = k_new
    cache.v[:, slot:slot + 1] = v_new
    return cache


def _write_slot(cache: KVCache, k_new, v_new, slot: int) -> None:
    """``cache_write`` on DTensors: the shard that holds ``slot`` writes
    it into its local block, in place (an indexed write into a dim split
    over the mesh has no DTensor strategy)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.k.device_mesh
    pl = list(cache.k.placements)
    seq_dims = [i for i, p in enumerate(pl)
                if isinstance(p, Shard) and p.dim == 1]
    npl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
           for p in pl]
    k_new = k_new.redistribute(mesh, npl)
    v_new = v_new.redistribute(mesh, npl)

    def write(kc, vc, kn, vn):
        sc = kc.shape[1]
        local = slot - _slot_block(mesh, seq_dims) * sc
        if 0 <= local < sc:
            kc[:, local:local + 1] = kn
            vc[:, local:local + 1] = vn
        return kc
    local_map(write, out_placements=pl, in_placements=(pl, pl, npl, npl),
              device_mesh=mesh)(cache.k, cache.v, k_new, v_new)


def decode_attn(q: torch.Tensor, cache: KVCache, pos: int,
                decode_attention: DecodeAttentionFn = ops.decode_attention
                ) -> torch.Tensor:
    """q: (B, 1, H, hd) against ``cache`` (B, Sc, KVH, hd); ``pos`` is the
    number of tokens written so far, this step's included, so slots below
    ``min(pos, Sc)`` are valid (a ring slot i holds a token once i < pos)."""
    return decode_attend(decode_attention, q, cache.k, cache.v,
                         min(pos, cache.k.shape[1]))


def decode_attend(decode_attention: DecodeAttentionFn, q, k, v,
                  valid: int) -> torch.Tensor:
    """``decode_attention(q, k, v, valid)``.  On DTensors (a sharded
    launch) with the cache's slots sharded (the reference's
    sequence-parallel decode rule), each shard attends over its own slots
    and the shards' softmax partials are combined by all-reduces (the
    flash-decode XLA lowers the reference's rule to; the cache is never
    gathered); with the slots whole, the op runs on each shard's batch
    (``local_op``)."""
    if not sharded(k):
        return decode_attention(q, k, v, valid)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    seq_dims = [i for i, p in enumerate(k.placements)
                if isinstance(p, Shard) and p.dim == 1]
    if not seq_dims:
        return local_op(decode_attention, q, k, v, valid)
    kpl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
           for p in k.placements]
    qpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in k.placements]
    q = q.redistribute(mesh, qpl)
    k, v = k.redistribute(mesh, kpl), v.redistribute(mesh, kpl)
    return local_map(
        lambda q_, k_, v_: _decode_slots(q_, k_, v_, valid, mesh, seq_dims),
        out_placements=qpl, in_placements=(qpl, kpl, kpl),
        device_mesh=mesh)(q, k, v)


def _slot_block(mesh, seq_dims) -> int:
    """This rank's block of cache slots: its coordinates on the mesh dims
    that split the slots, major to minor."""
    idx = 0
    for i in seq_dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _decode_slots(q, k, v, valid: int, mesh, seq_dims) -> torch.Tensor:
    """One shard's part of the decode softmax over its cache slots (in
    fp32, as the plain version), combined across ``seq_dims``: zeros when
    no slot is valid."""
    import torch.distributed._functional_collectives as funcol
    b, sc, kvh, hd = k.shape
    h = q.shape[2]
    first = _slot_block(mesh, seq_dims) * sc
    mine = first + torch.arange(sc, device=k.device) < valid
    qf = q.float().reshape(b, kvh, h // kvh, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k.float())
    s = s.masked_fill(~mine, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    for i in seq_dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(dim=-1, keepdim=True)
    num = torch.einsum("bkgc,bckd->bkgd", p, v.float())
    for i in seq_dims:
        den = funcol.all_reduce(den, "sum", (mesh, i))
        num = funcol.all_reduce(num, "sum", (mesh, i))
    out = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attn_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cfg: ModelConfig, *, positions: torch.Tensor, mode: str,
                 cache: Optional[KVCache] = None, pos: Optional[int] = None,
                 attention: AttentionFn = ops.flash_attention,
                 decode_attention: DecodeAttentionFn = ops.decode_attention):
    """Self-attention sub-block for ``mode`` "prefill", "train" or
    "decode".

    Returns (out (B,S,d), new_cache or None).  Prefill builds the decode
    cache, sized to x's sequence unless ``cache`` gives its length.  Decode
    takes x (B, 1, d) at absolute position ``pos`` (a host int; RoPE reads
    ``positions``), writes its k/v into ``cache`` in place and attends over
    the cache; the returned cache is ``cache``.
    """
    b, s, _ = x.shape
    q, k, v = project_qkv(x, p, cfg, positions)
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs the cache and pos")
        new_cache = cache_write(cache, k, v, pos)
        out = decode_attn(q, new_cache, pos + 1, decode_attention)
    elif mode in ("prefill", "train"):
        out = segment_attention(attention, q, k, v, causal=cfg.causal,
                                window=cfg.sliding_window)
        new_cache = prefill_cache(k, v, cache) if mode == "prefill" else None
    else:
        raise ValueError(f"attention mode {mode!r}")
    out = constrain(out, "act_attn_out")
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p["wo"], new_cache


def encode_cross_kv(enc_out: torch.Tensor, p: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> KVCache:
    """The cross-attention K/V (B, S_enc, KVH, hd) of the encoder's output
    (B, S_enc, d), computed once per prefill (no RoPE, no k-norm, as the
    reference)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    kvh = cfg.num_kv_heads
    return KVCache(k=split_dim(k, -1, kvh).reshape(b, s, kvh, hd),
                   v=split_dim(v, -1, kvh).reshape(b, s, kvh, hd))


def cross_attn_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                       cfg: ModelConfig, enc_kv: KVCache, *,
                       mode: str = "prefill",
                       attention: AttentionFn = ops.flash_attention,
                       decode_attention: DecodeAttentionFn =
                       ops.decode_attention) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, d), K/V the encoder's
    (``encode_cross_kv``), every key visible.  Returns (B, S, d).

    Prefill (and train) goes through ``attention`` with ``causal=False``.
    Decode (x (B, 1, d)) goes through ``decode_attention`` with ``valid``
    the whole encoder length: for one query token that is the reference's
    non-causal ``flash_attn`` at Sq = 1, and it is the shape the decode
    kernel is built for (the prefill kernel would fill one of its 128
    query rows).  The port makes this choice; the reference runs
    ``flash_attn`` in both modes."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = split_dim(q, -1, cfg.num_heads).reshape(b, s, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
    if mode == "decode":
        out = decode_attend(decode_attention, q, enc_kv.k, enc_kv.v,
                            enc_kv.k.shape[1])
    elif mode in ("prefill", "train"):
        out = segment_attention(attention, q, enc_kv.k, enc_kv.v,
                                causal=False, window=None)
    else:
        raise ValueError(f"cross-attention mode {mode!r}")
    return out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
