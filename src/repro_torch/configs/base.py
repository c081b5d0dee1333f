"""Config system of the PyTorch port: architecture definitions.

Each architecture the port knows gets one module in this package that
builds a ``ModelConfig`` via :func:`register`.  ``get_config(name)``
returns the full published configuration; ``get_config(name, reduced=True)``
returns the small variant of the same family (one superblock, d_model <=
256) that the CPU tests use.  Any other name raises ``KeyError``.  A known
configuration whose blocks the port's models do not implement (whisper-
medium's encoder-decoder) is data for the predictor and the workloads;
building its model raises ``NotImplementedError``
(``models/transformer.py:_check_ported``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence


# Block kinds (the port's models implement ATTN with a dense MLP, MAMBA with
# a dense or MoE MLP, and MLSTM and SLSTM with none)
ATTN = "attn"          # (causal or bidirectional) self-attention block
CROSS = "cross"        # decoder block with self + cross attention (enc-dec)
MAMBA = "mamba"        # Mamba selective-SSM block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block

BLOCK_KINDS = (ATTN, CROSS, MAMBA, MLSTM, SLSTM)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation for the published config

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads

    # one superblock period; num_layers % len(block_pattern) == 0
    block_pattern: Sequence[str] = (ATTN,)
    # per-position MLP flavour within the superblock: "dense"|"moe"|"none"
    mlp_pattern: Sequence[str] = ("dense",)

    moe: Optional[MoEConfig] = None

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    long_context_window: int = 4096
    causal: bool = True

    # encoder-decoder
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0
    max_position_embeddings: int = 32768
    learned_pos_emb: bool = False

    # SSM (mamba) options
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2

    # xLSTM options
    xlstm_num_heads: int = 4
    xlstm_expand: int = 2
    xlstm_conv_dim: int = 4

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def num_superblocks(self) -> int:
        if self.num_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"block pattern period {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    def validate(self) -> None:
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm",
                                  "audio"):
            raise ValueError(f"{self.name}: arch_type {self.arch_type!r}")
        if len(self.block_pattern) != len(self.mlp_pattern):
            raise ValueError(f"{self.name}: block/mlp pattern lengths differ")
        for k in self.block_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"{self.name}: block kind {k!r}")
        for m in self.mlp_pattern:
            if m not in ("dense", "moe", "none"):
                raise ValueError(f"{self.name}: mlp kind {m!r}")
        if "moe" in self.mlp_pattern and self.moe is None:
            raise ValueError(f"{self.name}: moe pattern without MoEConfig")
        _ = self.num_superblocks


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}
_REDUCERS: dict[str, Callable[[ModelConfig], ModelConfig]] = {}

# the configurations the port knows (every one but whisper-medium also
# has its model ported)
_MODULES = {
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "qwen3-0.6b": "qwen3_0p6b",
    "starcoder2-3b": "starcoder2_3b",
    "whisper-medium": "whisper_medium",
    "xlstm-1.3b": "xlstm_1p3b",
}
ARCH_IDS = tuple(_MODULES)


def register(cfg: ModelConfig, reducer=None) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    if reducer is not None:
        _REDUCERS[cfg.name] = reducer
    return cfg


def _default_reduce(cfg: ModelConfig) -> ModelConfig:
    """Generic reduction: same family, laptop scale."""
    period = len(cfg.block_pattern)
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, n_heads))
    if n_heads % kv:
        kv = 1
    moe = cfg.moe
    if moe is not None:
        moe = replace(moe, num_experts=min(moe.num_experts, 4),
                      top_k=min(moe.top_k, 2), d_expert=min(moe.d_expert, 256))
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=period,          # a single superblock keeps every kind
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        moe=moe,
        num_encoder_layers=min(cfg.num_encoder_layers, 2) if cfg.encoder_decoder else 0,
        encoder_seq_len=min(cfg.encoder_seq_len, 64) if cfg.encoder_decoder else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        long_context_window=64,
        max_position_embeddings=512,
    )


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        if name not in _MODULES:
            raise KeyError(
                f"architecture {name!r} is not ported to repro_torch yet; "
                f"known: {sorted(_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = _REGISTRY[name]
    if reduced:
        red = _REDUCERS.get(name, _default_reduce)(cfg)
        red.validate()
        return red
    return cfg


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (the workloads size a stage's per-query
    FLOPs and weights from it)."""
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d                      # embedding
    if not cfg.tie_embeddings:
        total += v * d                 # lm head
    hd = cfg.resolved_head_dim
    for kind, mlp in zip(cfg.block_pattern, cfg.mlp_pattern):
        p = 0
        if kind in (ATTN, CROSS):
            q = cfg.num_heads * hd
            kvd = cfg.num_kv_heads * hd
            p += d * q + 2 * d * kvd + q * d          # qkv + out
            if kind == CROSS:
                p += d * q + 2 * d * kvd + q * d      # cross-attn
            p += 2 * d                                 # norms
        elif kind == MAMBA:
            inner = cfg.ssm_expand * d
            p += d * 2 * inner                        # in_proj (x, z)
            p += inner * cfg.ssm_conv_dim             # conv
            p += inner * (cfg.ssm_state_dim * 2 + 1)  # B,C,dt proj (approx)
            p += inner * cfg.ssm_state_dim            # A
            p += inner * d                            # out proj
            p += d
        elif kind == MLSTM:
            inner = cfg.xlstm_expand * d
            p += d * 2 * inner                        # up (x, z)
            p += inner * cfg.xlstm_conv_dim
            p += 3 * inner * inner // cfg.xlstm_num_heads  # q,k,v head-block
            p += 3 * inner                            # gates
            p += inner * d
            p += d
        elif kind == SLSTM:
            nh = cfg.xlstm_num_heads
            p += 4 * d * d + 4 * d * (d // nh)        # input + recurrent (block-diag)
            p += 8 * d                                # gates/norm
            p += int(2 * d * (4 / 3) * d)             # ffn up/down (GEGLU 4/3)
            p += d
        if mlp == "dense":
            p += 3 * d * cfg.d_ff                     # swiglu
            p += d
        elif mlp == "moe":
            p += 3 * d * cfg.moe.d_expert * cfg.moe.num_experts
            p += d * cfg.moe.num_experts              # router
            p += d
        total += p * cfg.num_superblocks
    total += d                                        # final norm
    if cfg.encoder_decoder:
        # encoder layers: self-attn + dense mlp
        q = cfg.num_heads * hd
        kvd = cfg.num_kv_heads * hd
        enc = (d * q + 2 * d * kvd + q * d + 2 * d + 3 * d * cfg.d_ff + d)
        total += enc * cfg.num_encoder_layers
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only top_k experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    full = param_count(cfg)
    d = cfg.d_model
    n_moe_layers = sum(1 for m in cfg.mlp_pattern if m == "moe") * cfg.num_superblocks
    all_experts = 3 * d * cfg.moe.d_expert * cfg.moe.num_experts * n_moe_layers
    active = 3 * d * cfg.moe.d_expert * cfg.moe.top_k * n_moe_layers
    return int(full - all_experts + active)
