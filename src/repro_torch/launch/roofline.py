"""Roofline accounting of the port: analytic FLOPs/bytes, FLOPs counted
over a traced step, and per-device collective bytes of a DTensor run.

Methodology (the port of ``repro/launch/roofline.py``):
  * FLOPs / HBM bytes come from the same closed-form model over the config
    as the reference's (``analytic_costs``, ``roofline_terms``: copied as
    they are), checked against the FLOPs that
    ``torch.utils.flop_counter.FlopCounterMode`` counts over a traced
    forward (``flop_count``) in ``tests/test_torch_launch.py``;
  * collective bytes are recorded, not parsed: the port runs its layers
    eagerly on DTensors, so every collective the partitioner inserts is one
    dispatch of a ``_c10d_functional`` op, and ``CollectiveCounter`` adds
    the bytes of its result's local shape, per device, by kind (the
    reference reads the same per-device result sizes from compiled HLO and
    multiplies loop bodies by their trip counts; there is no loop to undo
    here);
  * convention: collective bytes are per device, and the collective term
    is per_device_bytes / ici_bandwidth (on the H100: NVLink, one
    direction).
"""
from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ATTN, CROSS, MAMBA, MLSTM, SLSTM,
                                     HardwareSpec, InputShape, ModelConfig,
                                     active_param_count, param_count)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collectives -> the reference's HLO collective kinds
_FUNCOL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def in_sharding_propagation() -> bool:
    """Whether the current op runs inside DTensor's sharding propagation,
    which runs ops on global-shaped stand-ins for their metadata only (in
    a fake mode of its own on some torch versions, directly on ``meta``
    tensors on others): such ops are no device's work or memory."""
    f = sys._getframe(2)
    for _ in range(48):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class ShardCounter(TorchDispatchMode):
    """What one device runs of a DTensor program: the collectives (bytes
    of each ``_c10d_functional`` op's result, by kind, as the reference
    counts an HLO collective's result) and the FLOPs of its local products
    (``FlopCounterMode``'s formulas on the local shards' shapes).  Ops on
    DTensors are handed back (``NotImplemented``, as ``CommDebugMode``
    does) so the mode sees what DTensor lowers them to, the collectives
    of its redistributions included; ops that DTensor's sharding
    propagation runs on global-shaped stand-ins (metadata only) are not
    counted (``in_sharding_propagation``).
    ``summary()`` has the reference's
    ``parse_collectives`` keys, with ``while_trip_counts`` empty (the port
    runs no scanned loop)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import FlopCounterMode
        self._dtensor = DTensor
        self._flop_fns = FlopCounterMode().flop_registry
        self.bytes: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if in_sharding_propagation():
            return out
        ns = getattr(func, "namespace", "")
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _FUNCOL_KIND.get(func._opname)
            if kind is not None:
                self.bytes[kind] += _nbytes(out)
                self.counts[kind] += 1
        fn = self._flop_fns.get(getattr(func, "_overloadpacket", None))
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        return out

    def summary(self) -> dict:
        out = {k: float(self.bytes[k]) for k in KINDS}
        out["counts"] = dict(self.counts)
        out["total_bytes"] = float(sum(self.bytes.values()))
        out["while_trip_counts"] = {}
        return out


def flop_count(fn, *args, **kwargs) -> Tuple[float, object]:
    """FLOPs that ``FlopCounterMode`` counts while ``fn(*args, **kwargs)``
    runs (the counterpart of XLA's cost_analysis "flops"); returns
    (flops, fn's result)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return float(fc.get_total_flops()), out


# ==========================================================================
# Analytic FLOPs / HBM bytes (global, whole cluster)
# ==========================================================================

def _per_layer_matmul_params(cfg: ModelConfig) -> Tuple[float, float]:
    """(dense-active params per layer-pattern, moe-expert params active)."""
    total = 0.0
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    for kind, mlp in zip(cfg.block_pattern, cfg.mlp_pattern):
        if kind in (ATTN, CROSS):
            total += d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
                + cfg.num_heads * hd * d
            if kind == CROSS:
                total += d * cfg.num_heads * hd + cfg.num_heads * hd * d
        elif kind == MAMBA:
            inner = cfg.ssm_expand * d
            total += d * 2 * inner + inner * d \
                + inner * (max(1, d // 16) + 2 * cfg.ssm_state_dim) \
                + max(1, d // 16) * inner
        elif kind == MLSTM:
            inner = cfg.xlstm_expand * d
            total += d * 2 * inner + inner * d \
                + 3 * inner * (inner // cfg.xlstm_num_heads)
        elif kind == SLSTM:
            nh = cfg.xlstm_num_heads
            total += 4 * d * d + 4 * d * (d // nh) + 2 * d * int(d * 4 / 3)
        if mlp == "dense":
            total += 3 * d * cfg.d_ff
        elif mlp == "moe":
            total += 3 * d * cfg.moe.d_expert * cfg.moe.top_k \
                + d * cfg.moe.num_experts
    return total / len(cfg.block_pattern), 0.0


def _attn_quadratic_flops(cfg: ModelConfig, b: int, s: int,
                          s_kv: int) -> float:
    """Per ATTN/CROSS layer: masked-full-KV scores + PV (the implementation
    computes the full rectangle; causal skipping is a §Perf item)."""
    hd = cfg.resolved_head_dim
    return 2.0 * 2.0 * b * s * s_kv * cfg.num_heads * hd


def _mixer_extra_flops(cfg: ModelConfig, b: int, s: int, mode: str) -> float:
    """Non-projection flops of SSM/xLSTM mixers per superblock pass."""
    d = cfg.d_model
    extra = 0.0
    for kind in cfg.block_pattern:
        if kind == MAMBA:
            inner = cfg.ssm_expand * d
            st = cfg.ssm_state_dim
            extra += 8.0 * b * s * inner * st        # scan + y=C·h
        elif kind == MLSTM:
            inner = cfg.xlstm_expand * d
            h = cfg.xlstm_num_heads
            hd = inner // h
            if mode == "decode":
                extra += 4.0 * b * h * hd * hd
            else:
                l = min(256, s)
                extra += 6.0 * b * h * s * l * hd \
                    + 4.0 * b * h * s * hd * hd / max(l, 1) * l  # carry upd
        elif kind == SLSTM:
            extra += 30.0 * b * s * d
    return extra / len(cfg.block_pattern)


def analytic_costs(cfg: ModelConfig, shp: InputShape,
                   weight_replicas: int = 1,
                   weight_bytes: float = 2.0) -> dict:
    """Global FLOPs / HBM bytes for one (arch, shape) combo.

    weight_replicas: how many independent copies of the weights the mesh
    holds (inference shards weights over the model axis only, so every
    data-parallel replica re-reads them — decode is usually bound by this).
    weight_bytes: bytes per weight (2 = bf16; 1 = int8-quantized serving).
    """
    b, s = shp.global_batch, shp.seq_len
    mode = shp.kind
    n_layers = cfg.num_layers
    d, v = cfg.d_model, cfg.vocab_size
    p_total = param_count(cfg)
    p_active = active_param_count(cfg)
    per_layer_mm, _ = _per_layer_matmul_params(cfg)

    from repro_torch.models.transformer import decode_cache_len
    s_cache = decode_cache_len(cfg, s)

    if mode in ("train", "prefill"):
        toks = b * s
        linear = 2.0 * toks * (per_layer_mm * n_layers + d * v)
        attn_layers = sum(1 for k in cfg.block_pattern if k in (ATTN, CROSS))
        s_kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
        quad = _attn_quadratic_flops(cfg, b, s, s_kv) * attn_layers \
            * cfg.num_superblocks
        mixer = _mixer_extra_flops(cfg, b, s, mode) * n_layers
        enc = 0.0
        if cfg.encoder_decoder:
            se = cfg.encoder_seq_len
            enc_params = cfg.num_encoder_layers * (
                4 * d * cfg.num_heads * cfg.resolved_head_dim // 2 * 2
                + 3 * d * cfg.d_ff)
            enc = 2.0 * b * se * enc_params \
                + _attn_quadratic_flops(cfg, b, se, se) \
                * cfg.num_encoder_layers
            # cross-attention PV against encoder keys
            quad += 2.0 * 2.0 * b * s * se * cfg.num_heads \
                * cfg.resolved_head_dim * attn_layers * cfg.num_superblocks \
                * (1 if CROSS in cfg.block_pattern else 0)
        fwd = linear + quad + mixer + enc
        if mode == "train":
            flops = 4.0 * fwd          # fwd + 2×bwd + remat re-fwd
            model_flops = 6.0 * p_active * toks
            # HBM: 3 weight passes + grads + fp32 adam m/v/p read+write
            wbytes = p_total * (3 * 2 + 2 + 24)
            act = n_layers * toks * d * 2 * 4
            logits_b = toks * v * 2 * 3
            hbm = wbytes + act + logits_b
        else:
            flops = fwd
            model_flops = 2.0 * p_active * toks
            cache_b = (n_layers * b * s_cache * cfg.num_kv_heads
                       * cfg.resolved_head_dim * 2 * 2
                       if any(k in (ATTN, CROSS) for k in cfg.block_pattern)
                       else 0)
            hbm = p_total * weight_bytes * weight_replicas \
                + n_layers * toks * d * 2 * 2 + cache_b + toks * v * 2
    else:  # decode: one token
        toks = b
        linear = 2.0 * toks * (per_layer_mm * n_layers + d * v)
        attn_layers = sum(1 for k in cfg.block_pattern if k in (ATTN, CROSS)) \
            * cfg.num_superblocks
        quad = 2.0 * 2.0 * b * cfg.num_heads * cfg.resolved_head_dim \
            * s_cache * attn_layers
        if cfg.encoder_decoder:
            quad += 2.0 * 2.0 * b * cfg.num_heads * cfg.resolved_head_dim \
                * cfg.encoder_seq_len * attn_layers
        mixer = _mixer_extra_flops(cfg, b, 1, "decode") * n_layers
        flops = linear + quad + mixer
        model_flops = 2.0 * p_active * toks
        # weights touched once per replica group; MoE: expected unique
        # experts across the batch
        wbytes = p_total * weight_bytes
        if cfg.moe is not None:
            e, k = cfg.moe.num_experts, cfg.moe.top_k
            n_moe = sum(1 for m in cfg.mlp_pattern if m == "moe") \
                * cfg.num_superblocks
            expert_p = 3 * d * cfg.moe.d_expert
            frac = min(1.0, b * k / e)
            wbytes = (p_total - e * expert_p * n_moe) * weight_bytes \
                + e * expert_p * n_moe * weight_bytes * frac
        wbytes *= weight_replicas
        cache_b = n_layers * b * s_cache * cfg.num_kv_heads \
            * cfg.resolved_head_dim * 2 * 2 \
            if any(k_ in (ATTN, CROSS) for k_ in cfg.block_pattern) else 0
        state_b = 0
        if MAMBA in cfg.block_pattern or MLSTM in cfg.block_pattern:
            inner = max(cfg.ssm_expand, cfg.xlstm_expand) * d
            per = inner * cfg.ssm_state_dim * 4 if MAMBA in cfg.block_pattern \
                else (inner // cfg.xlstm_num_heads) * inner * 4
            state_b = n_layers * b * per * 2
        hbm = wbytes + cache_b + state_b + toks * v * 2

    return {
        "flops": float(flops),
        "model_flops": float(model_flops),
        "hbm_bytes": float(hbm),
        "useful_ratio": float(model_flops / max(flops, 1.0)),
        "tokens": int(toks),
    }


def roofline_terms(analytic: dict, coll_bytes_per_dev: float, chips: int,
                   hw: HardwareSpec) -> dict:
    t_compute = analytic["flops"] / (chips * hw.peak_flops)
    t_memory = analytic["hbm_bytes"] / (chips * hw.hbm_bandwidth)
    t_coll = coll_bytes_per_dev / hw.ici_bandwidth
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "mfu_upper_bound": t_compute / max(bound, 1e-30),
        "model_flops_ratio": analytic["useful_ratio"],
    }
