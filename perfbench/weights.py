"""Weights of a decoder made from a seed, the same for the program and the
plain reference.

The names and shapes are the decoder's own ((in, out) matrices, as the
reference applies ``x @ W``), keyed as ``repro_torch``'s ``Transformer``
names its parameters (``embed``, ``final_norm``, ``layers.<i>.<leaf>``) so
that the program's model can be filled in place.  Values are drawn on the
given device by one ``torch.Generator`` in one call a layer (and one for
the embedding and final norm):

- matrices N(0, 1/fan_in), the embedding N(0, 0.02^2);
- norm scales 1 + N(0, 0.1^2), qkv biases N(0, 0.02^2), so that a scale or
  a bias the program ignored would show.

Each value is drawn in fp32 and rounded once to ``dtype``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from perfbench.counts import dims

Spec = Tuple[str, Tuple[int, ...], str]      # name, shape, kind


def layer_specs(cfg: Mapping) -> List[Spec]:
    """One layer's leaves: (name, shape, kind) with kind "matrix", "norm"
    or "bias"."""
    m = dims(cfg)
    d, qd, kvd = m["d"], m["h"] * m["hd"], m["kvh"] * m["hd"]
    out = [("norm1", (d,), "norm"), ("wq", (d, qd), "matrix"),
           ("wk", (d, kvd), "matrix"), ("wv", (d, kvd), "matrix"),
           ("wo", (qd, d), "matrix")]
    if cfg["attention_bias"]:
        out += [("bq", (qd,), "bias"), ("bk", (kvd,), "bias"),
                ("bv", (kvd,), "bias")]
    if cfg["qk_norm"]:
        out += [("q_norm", (m["hd"],), "norm"),
                ("k_norm", (m["hd"],), "norm")]
    out += [("norm2", (d,), "norm"), ("w_gate", (d, m["f"]), "matrix"),
            ("w_up", (d, m["f"]), "matrix"), ("w_down", (m["f"], d), "matrix")]
    return out


def groups(cfg: Mapping) -> List[List[Tuple[str, Tuple[int, ...], str]]]:
    """The leaves in draw order, one group a call: the embedding and final
    norm, then each layer."""
    if not cfg["tie_word_embeddings"]:
        raise ValueError("only tied embeddings are described here")
    m = dims(cfg)
    top = [("embed", (m["v"], m["d"]), "embed"),
           ("final_norm", (m["d"],), "norm")]
    return [top] + [[(f"layers.{i}.{n}", s, k) for n, s, k in layer_specs(cfg)]
                    for i in range(m["layers"])]


def names_and_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    return {n: s for g in groups(cfg) for n, s, _ in g}


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
    want = names_and_shapes(cfg)
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
        for group in groups(cfg):
            total = sum(_numel(s) for _, s, _ in group)
            draw = torch.randn(total, generator=gen, device=device,
                               dtype=torch.float32)
            off = 0
            for name, shape, kind in group:
                n = _numel(shape)
                x = draw[off:off + n].view(shape)
                off += n
                if kind == "matrix":
                    x = x * (1.0 / shape[0] ** 0.5)
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
