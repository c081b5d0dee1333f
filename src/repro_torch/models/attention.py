"""Attention sub-block: GQA/MHA projections, qk-norm, RoPE, KV cache.

Attention itself goes through ``kernels.ops.flash_attention`` (the Hopper
kernel on the card, its plain version on the CPU) unless the caller hands
another function of the same signature as ``attention``.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, head_rms_norm

AttentionFn = Callable[..., torch.Tensor]


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


def attn_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cfg: ModelConfig, *, positions: torch.Tensor, mode: str,
                 cache: Optional[KVCache] = None,
                 attention: AttentionFn = ops.flash_attention):
    """Self-attention sub-block for ``mode`` "prefill" or "train".

    Returns (out (B,S,d), new_cache or None).  Prefill builds the decode
    cache, sized to x's sequence unless ``cache`` gives its length.
    """
    if mode not in ("prefill", "train"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    b, s, _ = x.shape
    q, k, v = project_qkv(x, p, cfg, positions)
    out = attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    new_cache = prefill_cache(k, v, cache) if mode == "prefill" else None
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p["wo"], new_cache
