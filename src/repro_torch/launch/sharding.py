"""Sharding rules of the port: parameters, optimizer state, batches,
caches, activations (the counterpart of ``repro/launch/sharding.py``).

The same decisions as the reference:
  * train: FSDP×TP; weight matrices sharded over (data…) on their large
    input dim and over "model" on their output dim; optimizer state
    follows parameters.  Activations: batch over the data axes, the
    residual stream sequence-sharded over "model" between layers.
    Attention-free stacks (xlstm) train pure-DP;
  * prefill/decode: weights TP-sharded over "model" only, batch over the
    data axes; KV caches shard their sequence dim when the batch is too
    small for the data axes.
Every rule checks divisibility and falls back to replication.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names (major to minor, as a JAX ``PartitionSpec``'s;
one-name tuples are written as the name, as ``PartitionSpec`` normalises
them).  ``NamedSpec`` pairs it with the mesh, like a ``NamedSharding``,
and turns it into DTensor placements (``models.common.spec_placements``):
one ``Shard(d)`` per mesh dim named in dim d's entry.  Several axes on one
dim shard it major to minor only when they follow the mesh's own dim
order, which every rule here keeps (the data axes, then "model"); another
order would need DTensor's strided sharding and raises.

The reference stacks each pattern position's layers on a leading
superblock axis; the port's parameters are per-layer modules
(``models/transformer.py``).  A port leaf gets the spec of its reference
leaf without the superblock entry, found through the names
``from_jax_params``/``to_jax_params`` map: ``layers.<i>.<name>`` is
``blocks[i % period]``'s leaf ``<name>`` (``cross_<name>``: the ``cross``
subtree's ``<name>``), ``enc_layers.<i>.<name>`` is ``enc_blocks``'s.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

from repro_torch.configs.base import ATTN, CROSS, MLSTM, ModelConfig
from repro_torch.launch.mesh import (axis_names, axis_size, data_axes,
                                     tp_size)
from repro_torch.models.common import spec_placements
from repro_torch.models.transformer import CROSS_PREFIX, ModelCache

TP = "model"


def _div(size: int, n: int) -> bool:
    return n > 0 and size % n == 0 and size >= n


def _entry(e):
    """One spec entry as a ``PartitionSpec`` holds it."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def normalize(spec: Sequence) -> tuple:
    return tuple(_entry(e) for e in spec)


class NamedSpec:
    """A spec on a mesh (the counterpart of ``NamedSharding``)."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = normalize(spec)

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSpec) and other.spec == self.spec \
            and other.mesh is self.mesh

    def __repr__(self) -> str:
        return f"NamedSpec{self.spec}"


def reference_path(name: str) -> list:
    """The reference's parameter path of a port parameter name (only its
    first and last entries decide a spec)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        leaf = parts[2]
        group = "mix"
        if leaf.startswith(CROSS_PREFIX):
            leaf, group = leaf[len(CROSS_PREFIX):], "cross"
        return ["blocks" if parts[0] == "layers" else "enc_blocks", group,
                leaf]
    return parts


class ShardingRules:
    """Factory for every sharding used by one (cfg, mesh, mode) combo."""

    def __init__(self, cfg: ModelConfig, mesh, mode: str,
                 global_batch: int, seq_len: int):
        assert mode in ("train", "prefill", "decode")
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.batch = global_batch
        self.seq = seq_len
        # attention-free stacks (xlstm) train pure-DP: "model" folds into
        # data parallelism
        self.pure_dp = (mode == "train"
                        and not any(k in (ATTN, CROSS)
                                    for k in cfg.block_pattern))
        if self.pure_dp:
            dp = axis_names(mesh)
            # largest suffix of axes whose product divides the batch
            while dp and not _div(global_batch, self._n(dp)):
                dp = dp[1:]
            self.dp = dp or data_axes(mesh)
            self.tp_enabled = False
        else:
            self.dp = data_axes(mesh)
            self.tp_enabled = True
        self.dp_n = self._n(self.dp)
        self.tp_n = tp_size(mesh)
        self.batch_shardable = _div(global_batch, self.dp_n)

    def _n(self, axes) -> int:
        return math.prod(axis_size(self.mesh, a) for a in axes)

    def ns(self, *spec) -> NamedSpec:
        return NamedSpec(self.mesh, spec)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _leaf_spec(self, path_names, shape) -> tuple:
        """The reference's ``_leaf_spec``: a leaf under ``blocks`` or
        ``enc_blocks`` has the superblock axis first."""
        name = path_names[-1]
        in_blocks = path_names[0] in ("blocks", "enc_blocks")
        body = tuple(shape[1:]) if in_blocks else tuple(shape)
        lead = (None,) if in_blocks else ()
        train = self.mode == "train"

        def dpa(size):      # data-axes shard if divisible (train only)
            return self.dp if (train and _div(size, self.dp_n)) else None

        def tpa(size):
            if not self.tp_enabled:
                return None
            return TP if _div(size, self.tp_n) else None

        def spec(*entries):
            return normalize(lead + entries)

        if name == "embed":
            v, d = body
            # vocab over the model axis in both modes (the V-sharded
            # logits), d over data = the FSDP dim in training
            return normalize((tpa(v), dpa(d)))
        if name == "lm_head":
            d, v = body
            return normalize((dpa(d), tpa(v)))
        if len(body) == 1:
            return spec(None)
        if name in ("wq", "wk", "wv") and len(body) == 2:
            d, x = body
            return spec(dpa(d), tpa(x))
        if name == "wo":
            x, d = body
            return spec(tpa(x), dpa(d))
        if len(body) == 2 and name in ("w_gate", "w_up", "ff_gate", "ff_up",
                                       "in_proj", "w_in"):
            d, f = body
            return spec(dpa(d), tpa(f))
        if len(body) == 2 and name in ("w_down", "ff_down", "out_proj",
                                       "dt_proj"):
            f, d = body
            return spec(tpa(f), dpa(d))
        if name == "router":
            return spec(None, None)
        if len(body) == 3:
            # MoE experts: expert-parallel over the data axes in train and
            # prefill; decode keeps experts replicated over data
            def edp(e):
                return self.dp if (self.mode in ("train", "prefill")
                                   and _div(e, self.dp_n)) else None
            if name in ("w_gate", "w_up"):          # MoE (E, d, f)
                e, d, f = body
                return spec(edp(e), None, tpa(f))
            if name == "w_down":                    # MoE (E, f, d)
                e, f, d = body
                return spec(edp(e), tpa(f), None)
            if name == "r":                         # sLSTM recurrent
                return spec(None, None, None)
            if name == "wv":                        # mLSTM v-head blocks
                h, hd_in, hd_out = body
                return spec(None, None, tpa(hd_out))
            return spec(None, None, None)
        if name == "conv_w":
            ck, inner = body
            return spec(None, tpa(inner))
        if name == "x_proj":
            inner, r = body
            return spec(tpa(inner), None)
        if name == "A_log":
            inner, st = body
            return spec(tpa(inner), None)
        if name in ("w_i", "w_f"):
            inner, h = body
            return spec(tpa(inner), None)
        if len(body) == 2:
            d0, d1 = body
            return spec(dpa(d0), tpa(d1))
        return spec(*([None] * len(body)))

    def param_spec(self, name: str, shape) -> tuple:
        """A port parameter's spec: its reference leaf's, without the
        superblock entry for a per-layer leaf."""
        path = reference_path(name)
        if path[0] in ("blocks", "enc_blocks"):
            return self._leaf_spec(path, (1,) + tuple(shape))[1:]
        return self._leaf_spec(path, tuple(shape))

    def params_shardings(self, named: Mapping[str, Any]) -> dict:
        """{parameter name: NamedSpec} for ``dict(model.named_parameters())``
        (or any mapping of names to shaped leaves)."""
        return {n: NamedSpec(self.mesh, self.param_spec(n, t.shape))
                for n, t in named.items()}

    def opt_shardings(self, opt_state, named: Mapping[str, Any]):
        """The AdamW state's: moments follow their parameters."""
        from repro_torch.training.optimizer import AdamWState
        params_sh = self.params_shardings(named)
        return AdamWState(step=self.ns(), mu=params_sh, nu=dict(params_sh))

    # ------------------------------------------------------------------
    # Batch / tokens
    # ------------------------------------------------------------------

    def batch_shardings(self, batch: Mapping[str, Any]) -> dict:
        dpb = self.dp if self.batch_shardable else None

        def spec(leaf):
            if len(leaf.shape) == 0:
                return self.ns()
            return self.ns(dpb, *([None] * (len(leaf.shape) - 1)))
        return {k: spec(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # Cache (decode / prefill)
    # ------------------------------------------------------------------

    def _cache_leaf_spec(self, shp) -> tuple:
        """The reference's cache rule on a leaf with its superblock dim
        first (``shp`` = (n_sb, B, ...))."""
        cfg = self.cfg
        dpb = self.dp if self.batch_shardable else None
        kvh_tp = TP if _div(cfg.num_kv_heads, self.tp_n) else None
        seq_shard_kv = not self.batch_shardable
        ndim = len(shp)
        if ndim == 0:
            return ()
        # 5D leaves: KV cache for attention archs, matrix memory C for
        # xLSTM (no model mixes both)
        is_kv = MLSTM not in cfg.block_pattern
        if ndim == 5 and is_kv:        # KV cache (n_sb, B, Sc, KVH, hd)
            sc = shp[2]
            seq_axes = []
            if seq_shard_kv and _div(sc, self.dp_n * self.tp_n):
                seq_axes = list(self.dp) + [TP]
            elif _div(sc, self.tp_n):
                seq_axes = [TP]
            if seq_axes:
                return normalize((None, dpb, tuple(seq_axes), None, None))
            return normalize((None, dpb, None, kvh_tp, None))
        if ndim == 5:                  # mLSTM C (n_sb, B, H, hdk, hdv)
            hdv_tp = TP if _div(shp[-1], self.tp_n) else None
            return normalize((None, dpb, None, None, hdv_tp))
        if ndim == 4:
            # mamba h (n_sb, B, inner, st) | mlstm n (n_sb, B, H, hd)
            if shp[-1] == cfg.ssm_state_dim and _div(shp[2], self.tp_n):
                return normalize((None, dpb, TP, None))
            return normalize((None, dpb, None, None))
        if ndim == 3:                  # conv tails / slstm (n_sb, B, d)
            return normalize((None, dpb, None))
        if ndim == 2:
            return normalize((None, dpb))
        return (None,) * ndim

    def cache_spec(self, shape) -> tuple:
        """A per-layer cache leaf's spec (the reference's without the
        superblock entry)."""
        return self._cache_leaf_spec((1,) + tuple(shape))[1:]

    def cache_shardings(self, cache: ModelCache) -> ModelCache:
        """The cache's NamedSpecs, leaf for leaf (``pos``: replicated)."""
        def state(st):
            if st is None:
                return None
            return type(st)(*(NamedSpec(self.mesh, self.cache_spec(t.shape))
                              for t in st))
        return ModelCache(
            layers=[state(st) for st in cache.layers], pos=self.ns(),
            cross=None if cache.cross is None
            else [state(kv) for kv in cache.cross])

    # ------------------------------------------------------------------
    # Activation constraint rules (installed via set_sharding_rules)
    # ------------------------------------------------------------------

    def activation_rules(self) -> dict:
        cfg = self.cfg
        dpb = self.dp if self.batch_shardable else None
        h_tp = TP if _div(cfg.num_heads, self.tp_n) else None
        ff_tp = TP if _div(cfg.d_ff or 0, self.tp_n) else None
        v_tp = TP if _div(cfg.vocab_size, self.tp_n) else None
        inner_ssm = cfg.ssm_expand * cfg.d_model
        inner_x = cfg.xlstm_expand * cfg.d_model
        e_dp = None
        if cfg.moe is not None and self.mode in ("train", "prefill") and \
                _div(cfg.moe.num_experts, self.dp_n):
            e_dp = self.dp
        moe_ff_tp = TP if (cfg.moe and _div(cfg.moe.d_expert, self.tp_n)) \
            else None
        seq_tp = TP if (self.mode in ("train", "prefill")
                        and _div(self.seq, self.tp_n)) else None

        if not self.tp_enabled:          # pure-DP (attention-free train)
            flat3 = self.ns(dpb, None, None)
            return {
                "residual": flat3, "logits": flat3, "ffn_hidden": flat3,
                "ssm_inner": flat3, "xlstm_inner": flat3, "slstm_seq": flat3,
                "attn_heads": self.ns(dpb, None, None, None),
                "act_q": None, "act_kv": None, "act_attn_out": None,
                "moe_buf": None, "moe_hidden": None,
            }

        rules = {
            # sequence parallelism: the residual stream is sequence-sharded
            # over the model axis between layers
            "residual": self.ns(dpb, seq_tp, None),
            # sLSTM per-timestep scan: replicated on the model axis
            "slstm_seq": self.ns(dpb, None, None),
            "logits": self.ns(dpb, None, v_tp),
            # attention in the reference's (B, H, S, hd), KV repeated to H
            "attn_heads": self.ns(dpb, h_tp, None, None),
            "act_q": None,
            "act_kv": None,
            "act_attn_out": None,
            "ffn_hidden": self.ns(dpb, None, ff_tp),
            "ssm_inner": self.ns(
                dpb, None, TP if _div(inner_ssm, self.tp_n) else None),
            "xlstm_inner": self.ns(
                dpb, None, TP if _div(inner_x, self.tp_n) else None),
            "moe_buf": self.ns(e_dp, None, None),
            "moe_hidden": self.ns(e_dp, None, moe_ff_tp),
        }
        if self.mode == "decode":
            rules["residual"] = self.ns(dpb, None, None)
        return rules

    def shard_context(self) -> Optional[dict]:
        """The shard-local dispatch context (``set_shard_context``) the
        reference's launchers install: segment modes with a shardable
        batch only."""
        if self.mode in ("train", "prefill") and self.batch_shardable:
            return {"mesh": self.mesh, "dp": self.dp,
                    "tp": TP if self.tp_enabled else None,
                    "tp_size": self.tp_n if self.tp_enabled else 0}
        return None
