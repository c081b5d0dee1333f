"""Small helpers shared by the harness: paths, the loaders of configurations
and model families, seeds, logging, the process's start time, cache
directories and the check that no JAX module is loaded."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Mapping

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names the harness's process may not hold once the window
# has closed: JAX, its libraries and the JAX package this repo ports
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# what every model family's file defines (``perfbench/families/qwen.py``)
FAMILY_API = ("weight_groups", "check_port", "last_logits", "loss_and_grads",
              "prefill_flops", "train_flops", "reduced")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(path: Path) -> dict:
    """A configuration file; raises, naming the file, unless each model it
    describes (each of its ``stages``, or the file itself) names its
    ``family``."""
    cfg = load_json(path)
    for m in cfg.get("stages", [cfg]):
        if not isinstance(m.get("family"), str):
            raise ValueError(f"{path}: the model {m.get('arch')!r} names no "
                             f"\"family\"")
    return cfg


def config(name: str) -> dict:
    return load_config(PKG / "configs" / f"{name}.json")


def load_family(path: Path) -> ModuleType:
    """The model family's module at ``path`` (imported once a process);
    raises, naming the file and the functions, unless it defines every
    function of ``FAMILY_API``."""
    key = f"perfbench.families.{path.stem.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and mod.__file__ == str(path):
        return mod
    if not path.is_file():
        raise ValueError(f"no model family file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in FAMILY_API if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"{path}: a model family lacks {missing}")
    sys.modules[key] = mod
    return mod


def family(cfg: Mapping) -> ModuleType:
    """The family module that a model's config (a stage's entry or a
    training config) names: ``perfbench/families/<family>.py``.  The
    benchmark's config chooses it, never the program."""
    return load_family(PKG / "families" / f"{cfg['family']}.py")


def reduced(cfg: Mapping) -> dict:
    """``cfg`` (a stage's entry or a training config) at the port's reduced
    sizes of its ``arch``, every option kept: the CPU tests' model."""
    from repro_torch.configs import get_config
    return family(cfg).reduced(cfg, get_config(cfg["arch"], reduced=True))


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
