"""Operations and bytes that a model's shapes need, and the H100's peaks.

Counted from the configuration's published shapes, whatever implements
them: a matmul of (m, k) by (k, n) is 2·m·k·n operations; causal attention
is counted at half of its square; elementwise work is not counted.  A
kernel's bytes are its inputs read once and its outputs written once.
A whole model's operations (``prefill_flops``, ``train_flops``) are its
family's (``perfbench/families/<family>.py``), counted by these rules.
"""
from __future__ import annotations

from typing import Mapping

# NVIDIA's H100 data sheet, dense rates at the 700 W limit: (bf16 FLOP/s,
# HBM bytes/s) by form factor; the SXM part is the default
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12),
         "SXM": (989e12, 3.35e12)}


def peaks(device_name: str) -> tuple:
    """(bf16 FLOP/s, bytes/s) of the card named ``device_name``."""
    for part in ("PCIe", "NVL"):
        if part in device_name:
            return PEAKS[part]
    return PEAKS["SXM"]


def dims(cfg: Mapping) -> dict:
    """The shapes of one decoder (a stage's or a training config's)."""
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    return dict(d=cfg["hidden_size"], f=cfg["intermediate_size"],
                layers=cfg["num_hidden_layers"], h=h, kvh=kvh, hd=hd,
                v=cfg["vocab_size"])


def attention_fwd_flops(batch: int, seq: int, heads: int, hd: int,
                        causal: bool = True) -> float:
    """QK^T and PV of one attention over ``seq`` positions."""
    full = 2 * 2 * batch * heads * seq * seq * hd
    return full / 2 if causal else full


def attention_fwd_kernel(batch: int, seq: int, heads: int, kv_heads: int,
                         hd: int, itemsize: int = 2,
                         writes_lse: bool = True) -> tuple:
    """(operations, bytes) of one causal forward launch: q, k, v read, the
    output (and under grad the fp32 log-sum-exp of each row) written."""
    flops = attention_fwd_flops(batch, seq, heads, hd)
    q_o = 2 * batch * seq * heads * hd * itemsize
    k_v = 2 * batch * seq * kv_heads * hd * itemsize
    lse = batch * heads * seq * 4 if writes_lse else 0
    return flops, q_o + k_v + lse


def attention_bwd_kernel(batch: int, seq: int, heads: int, kv_heads: int,
                         hd: int, itemsize: int = 2) -> tuple:
    """(operations, bytes) of one causal backward launch: QK^T again, then
    dV, dP, dQ and dK (2.5x the forward's operations); q, k, v, o, dO and
    the log-sum-exp read, dQ, dK and dV written."""
    flops = 2.5 * attention_fwd_flops(batch, seq, heads, hd)
    q_sized = batch * seq * heads * hd * itemsize
    kv_sized = batch * seq * kv_heads * hd * itemsize
    reads = 3 * q_sized + 2 * kv_sized + batch * heads * seq * 4
    writes = q_sized + 2 * kv_sized
    return flops, reads + writes


def roofline_s(flops: float, nbytes: float, device_name: str) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory's, whichever is longer."""
    peak_flops, peak_bw = peaks(device_name)
    return max(flops / peak_flops, nbytes / peak_bw)
