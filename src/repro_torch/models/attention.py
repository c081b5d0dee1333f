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

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, head_rms_norm

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
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    cache.k[:, slot:slot + 1] = k_new
    cache.v[:, slot:slot + 1] = v_new
    return cache


def decode_attn(q: torch.Tensor, cache: KVCache, pos: int,
                decode_attention: DecodeAttentionFn = ops.decode_attention
                ) -> torch.Tensor:
    """q: (B, 1, H, hd) against ``cache`` (B, Sc, KVH, hd); ``pos`` is the
    number of tokens written so far, this step's included, so slots below
    ``min(pos, Sc)`` are valid (a ring slot i holds a token once i < pos)."""
    return decode_attention(q, cache.k, cache.v, min(pos, cache.k.shape[1]))


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
        out = attention(q, k, v, causal=cfg.causal,
                        window=cfg.sliding_window)
        new_cache = prefill_cache(k, v, cache) if mode == "prefill" else None
    else:
        raise ValueError(f"attention mode {mode!r}")
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
    return KVCache(k=k.reshape(b, s, cfg.num_kv_heads, hd),
                   v=v.reshape(b, s, cfg.num_kv_heads, hd))


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
    q = q.reshape(b, s, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
    if mode == "decode":
        out = decode_attention(q, enc_kv.k, enc_kv.v, enc_kv.k.shape[1])
    elif mode in ("prefill", "train"):
        out = attention(q, enc_kv.k, enc_kv.v, causal=False, window=None)
    else:
        raise ValueError(f"cross-attention mode {mode!r}")
    return out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
