"""The Qwen family's yardstick: a dense decoder written from the published
layer equations, in fp32 PyTorch with no kernel, cache or batching of the
program, and imports of neither ``jax`` nor anything of ``repro_torch``.

Per layer: RMSNorm -> q, k, v projections (+ bias where the config has
``attention_bias``) -> per-head RMSNorm of q and k (``qk_norm``) -> RoPE
(split-half, theta from the config) -> causal softmax attention, each
query head reading KV head ``head // (H / KVH)`` -> output projection ->
residual; RMSNorm -> SwiGLU MLP -> residual.  Then the final RMSNorm and
the tied head.  The loss is the mean token cross entropy.

``precision`` selects the arithmetic of every matmul (the projections,
QK^T, PV and the head): see ``perfbench.reference.matmul``.

The functions that every family file defines (``perfbench.util.FAMILY_API``):
``weight_groups``, ``check_port``, ``last_logits``, ``loss_and_grads``,
``prefill_flops``, ``train_flops`` and ``reduced``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.counts import attention_fwd_flops, dims
from perfbench.reference import matmul, rms_norm, rope

Spec = Tuple[str, Tuple[int, ...], str]      # name, shape, kind


# --------------------------------------------------------------------------
# Weights: names and shapes as the port's ``Transformer`` names its
# parameters, drawn by ``perfbench.weights.make_weights``
# --------------------------------------------------------------------------

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


def weight_groups(cfg: Mapping) -> List[List[Spec]]:
    """The leaves in draw order, one group a call: the embedding and final
    norm, then each layer."""
    if not cfg["tie_word_embeddings"]:
        raise ValueError("only tied embeddings are described here")
    m = dims(cfg)
    top = [("embed", (m["v"], m["d"]), "embed"),
           ("final_norm", (m["d"],), "norm")]
    return [top] + [[(f"layers.{i}.{n}", s, k) for n, s, k in layer_specs(cfg)]
                    for i in range(m["layers"])]


# --------------------------------------------------------------------------
# The port's model against the config
# --------------------------------------------------------------------------

def check_port(port, cfg: Mapping) -> None:
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


def reduced(cfg: Mapping, port) -> dict:
    """``cfg`` at the sizes of ``port``, the port's reduced ``ModelConfig``
    of its ``arch`` (the CPU tests' model), every option kept."""
    return {**cfg, "hidden_size": port.d_model,
            "intermediate_size": port.d_ff,
            "num_hidden_layers": port.num_layers,
            "num_attention_heads": port.num_heads,
            "num_key_value_heads": port.num_kv_heads,
            "head_dim": port.resolved_head_dim, "vocab_size": port.vocab_size}


# --------------------------------------------------------------------------
# The reference
# --------------------------------------------------------------------------

def layer(h: torch.Tensor, w: Mapping[str, torch.Tensor], i: int,
          cfg: Mapping, precision: str) -> torch.Tensor:
    """One decoder layer over h (N, S, d)."""
    m = dims(cfg)
    eps, n, s = cfg["rms_norm_eps"], h.shape[0], h.shape[1]
    p = {k.split(".", 2)[2]: t for k, t in w.items()
         if k.startswith(f"layers.{i}.")}
    x = rms_norm(h, p["norm1"], eps)
    q, k, v = (matmul(x, p[f"w{c}"], precision) for c in "qkv")
    if cfg["attention_bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(n, s, m["h"], m["hd"])
    k = k.view(n, s, m["kvh"], m["hd"])
    v = v.view(n, s, m["kvh"], m["hd"])
    if cfg["qk_norm"]:
        q, k = rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = m["h"] // m["kvh"]
    q = q.transpose(1, 2)                                   # N, H, S, hd
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(m["hd"])
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    att = matmul(probs, v, precision).transpose(1, 2).reshape(n, s, -1)
    h = h + matmul(att, p["wo"], precision)
    x = rms_norm(h, p["norm2"], eps)
    gate = matmul(x, p["w_gate"], precision)
    up = matmul(x, p["w_up"], precision)
    return h + matmul(F.silu(gate) * up, p["w_down"], precision)


def hidden(w: Mapping[str, torch.Tensor], cfg: Mapping, tokens: torch.Tensor,
           precision: str, remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (N, S, d) of ``tokens`` (N, S)."""
    h = w["embed"][tokens.long()]
    for i in range(dims(cfg)["layers"]):
        if remat:
            h = checkpoint(layer, h, w, i, cfg, precision, use_reentrant=False)
        else:
            h = layer(h, w, i, cfg, precision)
    return rms_norm(h, w["final_norm"], cfg["rms_norm_eps"])


@torch.no_grad()
def last_logits(w: Mapping[str, torch.Tensor], cfg: Mapping,
                tokens: torch.Tensor, precision: str = "fp32",
                block: int = 8) -> torch.Tensor:
    """fp32 logits (N, V) at the last position of each prompt in
    ``tokens`` (N, S), computed ``block`` prompts at a time."""
    out = []
    for i in range(0, tokens.shape[0], block):
        h = hidden(w, cfg, tokens[i:i + block], precision)[:, -1]
        out.append(matmul(h, w["embed"].T, precision))
    return torch.cat(out)


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: Mapping,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "fp32", rows: Optional[Sequence[int]] = None
                   ) -> tuple:
    """The mean token cross entropy of a batch and its gradient by leaf.

    Runs one sequence at a time, each layer rematerialised, and sums the
    sequences' gradients of (their loss / the number of sequences).
    ``rows`` takes the mean over those sequences only (a fault that leaves
    part of the batch out)."""
    rows = list(range(tokens.shape[0])) if rows is None else list(rows)
    names = list(w)
    leaves = [w[n].requires_grad_(True) for n in names]
    grads = [torch.zeros_like(t) for t in leaves]
    total = 0.0
    for r in rows:
        h = hidden(w, cfg, tokens[r:r + 1], precision, remat=True)[0]
        logits = matmul(h, w["embed"].T, precision)
        loss = F.cross_entropy(logits, labels[r].long()) / len(rows)
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc += g
        total += float(loss.detach())
        del h, logits, loss
    for t in leaves:
        t.requires_grad_(False)
    return total, dict(zip(names, grads))


# --------------------------------------------------------------------------
# Operations (counted as ``perfbench.counts`` says)
# --------------------------------------------------------------------------

def layer_matmul_params(cfg: Mapping) -> int:
    """Weights one layer multiplies each token by: q, k, v, o and the
    SwiGLU's gate, up and down."""
    m = dims(cfg)
    attn = m["d"] * m["h"] * m["hd"] * 2 + m["d"] * m["kvh"] * m["hd"] * 2
    return attn + 3 * m["d"] * m["f"]


def prefill_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One ``serve_prefill`` of (batch, seq) tokens: every layer over every
    position, the head over the last position only."""
    m = dims(cfg)
    linear = 2 * batch * seq * layer_matmul_params(cfg) * m["layers"]
    attn = attention_fwd_flops(batch, seq, m["h"], m["hd"]) * m["layers"]
    head = 2 * batch * m["d"] * m["v"]
    return linear + attn + head


def train_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """Model operations of one training step: forward and backward of every
    matmul, the head over every position included (3x the forward: the
    backward takes the gradients of both operands), attention's QK^T and
    PV at the causal half, also 3x; remat's recomputation left out."""
    m = dims(cfg)
    tokens = batch * seq
    linear = 2 * tokens * (layer_matmul_params(cfg) * m["layers"]
                           + m["d"] * m["v"])
    attn = attention_fwd_flops(batch, seq, m["h"], m["hd"]) * m["layers"]
    return 3 * (linear + attn)
