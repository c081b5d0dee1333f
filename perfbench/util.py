"""Small helpers shared by the harness: paths, seeds, logging, the process's
start time, cache directories and the check that no JAX module is loaded."""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Mapping

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names the harness's process may not hold once the window
# has closed: JAX, its libraries and the JAX package this repo ports
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return load_json(PKG / "configs" / f"{name}.json")


def cell(name: str) -> dict:
    return load_json(PKG / "workloads" / f"{name}.json")


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def derive_seed(seed: int, *tags) -> int:
    """A seed in [0, 2**63) for one use of the run's ``--seed`` (weights of
    a stage, traffic, data), the same on every machine."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def log(*parts) -> None:
    print("[perfbench]", *parts, file=sys.stderr, flush=True)


def process_start_s() -> float:
    """The epoch second at which this process started (Linux ``/proc``);
    falls back to now where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])            # starttime, field 22
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache the program or torch may use, at fixed
    paths inside the checkout (``build/`` is git-ignored): the port builds
    its kernels into ``build/repro_torch/`` by itself."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        d = base / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)


def forbidden_loaded() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def check_port_config(port, cfg: Mapping) -> None:
    """Raise unless the port's ``ModelConfig`` ``port`` runs the widths,
    depth and options that the benchmark's config ``cfg`` states."""
    pairs = {
        "hidden_size": port.d_model, "intermediate_size": port.d_ff,
        "num_hidden_layers": port.num_layers,
        "num_attention_heads": port.num_heads,
        "num_key_value_heads": port.num_kv_heads,
        "head_dim": port.resolved_head_dim, "vocab_size": port.vocab_size,
        "rope_theta": port.rope_theta, "rms_norm_eps": port.norm_eps,
        "tie_word_embeddings": port.tie_embeddings,
        "attention_bias": port.qkv_bias, "qk_norm": port.qk_norm}
    bad = {k: (cfg[k], v) for k, v in pairs.items() if cfg[k] != v}
    if tuple(port.block_pattern) != ("attn",) or \
            tuple(port.mlp_pattern) != ("dense",) or not port.rope or \
            port.sliding_window is not None or not port.causal:
        bad["layers"] = "not a causal RoPE attention + dense MLP decoder"
    if bad:
        raise ValueError(f"{port.name}: the port runs another model than "
                         f"the config states (config, port): {bad}")
