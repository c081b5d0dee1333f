"""Weights of a model made from a seed, the same for the program and the
plain reference.

The names, shapes and kinds of the leaves are the model family's
(``weight_groups`` of ``perfbench/families/<family>.py``): matrices as
(in, out), or (..., in, out) for a stack, as the reference applies
``x @ W``, keyed as ``repro_torch``'s ``Transformer`` names its parameters
(``embed``, ``final_norm``, ``layers.<i>.<leaf>``) so that the program's
model can be filled in place.  Values are drawn on the given device by one
``torch.Generator`` in one call a group (for a decoder: one for the
embedding and final norm, then one a layer), by kind:

- "matrix" N(0, 1/fan_in), fan_in being the next-to-last size;
- "embed" N(0, 0.02^2);
- "norm" scales 1 + N(0, 0.1^2), "bias" N(0, 0.02^2), so that a scale or
  a bias the program ignored would show.

Each value is drawn in fp32 and rounded once to ``dtype``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from perfbench.util import family


KINDS = ("matrix", "embed", "bias", "norm")


def names_and_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    return {n: s for g in family(cfg).weight_groups(cfg) for n, s, _ in g}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(cfg: Mapping, seed: int, device, dtype: torch.dtype,
                 out: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The seeded weights of ``cfg``, as new tensors of ``dtype`` on
    ``device``, or written into ``out`` (a name -> tensor mapping with
    exactly these names and shapes, e.g. a model's parameters)."""
    groups = family(cfg).weight_groups(cfg)
    bad_kinds = {n: k for g in groups for n, _, k in g if k not in KINDS}
    if bad_kinds:
        raise ValueError(f"leaves of no kind in {KINDS}: {bad_kinds}")
    want = {n: s for g in groups for n, s, _ in g}
    if out is not None:
        got = {n: tuple(t.shape) for n, t in out.items()}
        if got != want:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            bad = sorted(n for n in set(want) & set(got)
                         if want[n] != got[n])
            raise ValueError(f"parameters differ from the config: missing "
                             f"{missing[:4]}, extra {extra[:4]}, shapes "
                             f"{bad[:4]}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    result: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for group in groups:
            total = sum(_numel(s) for _, s, _ in group)
            draw = torch.randn(total, generator=gen, device=device,
                               dtype=torch.float32)
            off = 0
            for name, shape, kind in group:
                n = _numel(shape)
                x = draw[off:off + n].view(shape)
                off += n
                if kind == "matrix":
                    x = x * (1.0 / shape[-2] ** 0.5)
                elif kind == "embed" or kind == "bias":
                    x = x * 0.02
                else:                                    # norm scale
                    x = x * 0.1 + 1.0
                if out is not None:
                    out[name].copy_(x.to(dtype))
                    result[name] = out[name]
                else:
                    result[name] = x.to(dtype)
            del draw
    return result
