"""Checkpointing with the reference's layout and semantics
(``repro/training/checkpoint.py``), written with ``torch.save``.

A step is a directory ``step_%08d`` holding ``params.pt`` and, where
given, ``opt_state.pt``; it is written as ``step_%08d.tmp`` and renamed
into place (atomic), and only the last ``keep`` steps are kept.  A tree
(nested dicts, lists, tuples and NamedTuples of tensors and Python
numbers) is saved as its flat list of leaves, tensors moved to the CPU in
their own dtype (bf16 included); it is read back with
``torch.load(weights_only=True)`` into the structure of a ``like`` tree,
each tensor's shape checked and placed on the device of its ``like``
leaf.  The reference serialises with msgpack, which this package does
not need.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in a fixed order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves taken, in order, from
    ``leaves`` (consumed from the front)."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return leaves.pop(0)


def save_pytree(tree: Any, path: str) -> None:
    """Write the tree's leaves to ``path`` (atomic rename)."""
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
              for x in _leaves(tree)]
    tmp = path + ".tmp"
    torch.save({"leaves": leaves}, tmp)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape-checked)."""
    payload = torch.load(path, weights_only=True, map_location="cpu")
    entries = payload["leaves"]
    leaves_like = _leaves(like)
    if len(entries) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(entries)} leaves, expected "
                         f"{len(leaves_like)}")
    out = []
    for e, ref in zip(entries, leaves_like):
        if isinstance(ref, torch.Tensor):
            if not isinstance(e, torch.Tensor) or e.shape != ref.shape:
                raise ValueError(f"leaf {getattr(e, 'shape', e)} does not "
                                 f"match {tuple(ref.shape)}")
            e = e.to(ref.device)
        out.append(e)
    return _rebuild(like, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, params: Any, opt_state: Any = None) -> str:
        d = self._step_dir(step) + ".tmp"
        os.makedirs(d, exist_ok=True)
        save_pytree(params, os.path.join(d, "params.pt"))
        if opt_state is not None:
            save_pytree(opt_state, os.path.join(d, "opt_state.pt"))
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(d, final)
        self._gc()
        return final

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, params_like: Any,
                opt_like: Any = None) -> Tuple[Any, Any]:
        d = self._step_dir(step)
        params = load_pytree(os.path.join(d, "params.pt"), params_like)
        opt = None
        opt_path = os.path.join(d, "opt_state.pt")
        if opt_like is not None and os.path.exists(opt_path):
            opt = load_pytree(opt_path, opt_like)
        return params, opt

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
