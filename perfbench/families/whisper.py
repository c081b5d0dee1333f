"""The Whisper family's yardstick: an encoder-decoder written from the
layer equations of the port's whisper (arXiv:2212.04356 with the
departures below), in fp32 PyTorch with no kernel, cache or batching of
the program, and imports of neither ``jax`` nor anything of
``repro_torch``.

The encoder: the frames (B, S_enc, d) plus the sinusoidal table at
0..S_enc-1 (sin then cos at the frequencies exp(-log(1e4) i / (d/2 - 1)),
the paper's table); per layer RMSNorm -> q, k, v -> softmax attention with
no mask -> output projection -> residual, RMSNorm -> SwiGLU MLP ->
residual; then the encoder's final RMSNorm.  The decoder: the token
embedding plus the same sinusoidal table at the tokens' positions; per
layer RMSNorm -> causal self-attention -> residual, RMSNorm -> cross
attention (q from the decoder, k and v projected from the encoder's
output, every frame visible) -> residual, RMSNorm -> SwiGLU MLP ->
residual; then the final RMSNorm and the untied head.  Heads are
``d_model / heads`` wide, every one with its own k and v; scores are
scaled by 1/sqrt(head size).  The loss is the mean token cross entropy.

Departures from the published whisper-medium (each stated in the config's
``reduced``), all the port's:

- pre-norm RMSNorm (a scale, eps ``norm_eps``) in place of LayerNorm with
  a bias;
- a SwiGLU MLP (gate, up and down at the ffn width) in place of GELU
  fc1/fc2 with biases;
- no q, v or output-projection biases;
- the decoder's positions from the sinusoidal table, not a learned
  448 x d table (``max_target_positions`` still bounds a prompt);
- an untied ``lm_head`` in place of the output projection tied to the
  embedding;
- the log-mel and conv front end stubbed: the encoder reads zero frames
  of (B, ``max_source_positions``, d), as the served stage feeds it.

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

from perfbench.counts import attention_fwd_flops
from perfbench.reference import matmul, rms_norm

Spec = Tuple[str, Tuple[int, ...], str]      # name, shape, kind


def dims(cfg: Mapping) -> dict:
    """The shapes of one encoder-decoder, from its published keys."""
    h = cfg["decoder_attention_heads"]
    if cfg["encoder_attention_heads"] != h or \
            cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]:
        raise ValueError("the encoder and the decoder differ in heads or "
                         "ffn width, which the port's model does not")
    return dict(d=cfg["d_model"], f=cfg["decoder_ffn_dim"], h=h,
                hd=cfg["d_model"] // h, v=cfg["vocab_size"],
                enc=cfg["encoder_layers"], dec=cfg["decoder_layers"],
                s_enc=cfg["max_source_positions"],
                s_dec=cfg["max_target_positions"])


# --------------------------------------------------------------------------
# Weights: names and shapes as the port's ``Transformer`` names its
# parameters, drawn by ``perfbench.weights.make_weights``
# --------------------------------------------------------------------------

def _attn_specs(d: int, prefix: str = "") -> List[Spec]:
    return [(f"{prefix}w{c}", (d, d), "matrix") for c in "qkvo"]


def _mlp_specs(d: int, f: int) -> List[Spec]:
    return [("norm2", (d,), "norm"), ("w_gate", (d, f), "matrix"),
            ("w_up", (d, f), "matrix"), ("w_down", (f, d), "matrix")]


def encoder_layer_specs(cfg: Mapping) -> List[Spec]:
    m = dims(cfg)
    return [("norm1", (m["d"],), "norm")] + _attn_specs(m["d"]) + \
        _mlp_specs(m["d"], m["f"])


def decoder_layer_specs(cfg: Mapping) -> List[Spec]:
    m = dims(cfg)
    return [("norm1", (m["d"],), "norm")] + _attn_specs(m["d"]) + \
        [("norm_cross", (m["d"],), "norm")] + \
        _attn_specs(m["d"], "cross_") + _mlp_specs(m["d"], m["f"])


def weight_groups(cfg: Mapping) -> List[List[Spec]]:
    """The leaves in draw order, one group a call: the embedding, the
    head and the two final norms, then each encoder layer, then each
    decoder layer."""
    m = dims(cfg)
    top = [("embed", (m["v"], m["d"]), "embed"),
           ("final_norm", (m["d"],), "norm"),
           ("lm_head", (m["d"], m["v"]), "matrix"),
           ("enc_final_norm", (m["d"],), "norm")]
    enc = [[(f"enc_layers.{i}.{n}", s, k) for n, s, k in
            encoder_layer_specs(cfg)] for i in range(m["enc"])]
    dec = [[(f"layers.{i}.{n}", s, k) for n, s, k in
            decoder_layer_specs(cfg)] for i in range(m["dec"])]
    return [top] + enc + dec


# --------------------------------------------------------------------------
# The port's model against the config
# --------------------------------------------------------------------------

def check_port(port, cfg: Mapping) -> None:
    """Raise unless the port's ``ModelConfig`` ``port`` runs the widths,
    depths and options that the benchmark's config ``cfg`` states.  The
    port's decoder takes a prompt of ``max_target_positions`` where its
    ``max_position_embeddings`` is at least that."""
    pairs = {
        "d_model": port.d_model, "encoder_layers": port.num_encoder_layers,
        "decoder_layers": port.num_layers,
        "encoder_attention_heads": port.num_heads,
        "decoder_attention_heads": port.num_heads,
        "encoder_ffn_dim": port.d_ff, "decoder_ffn_dim": port.d_ff,
        "vocab_size": port.vocab_size,
        "max_source_positions": port.encoder_seq_len,
        "norm_eps": port.norm_eps}
    bad = {k: (cfg[k], v) for k, v in pairs.items() if cfg[k] != v}
    if cfg["max_target_positions"] > port.max_position_embeddings:
        bad["max_target_positions"] = (cfg["max_target_positions"],
                                       port.max_position_embeddings)
    if port.num_kv_heads != port.num_heads or \
            port.resolved_head_dim * port.num_heads != port.d_model:
        bad["heads"] = "not multi-head attention at d_model / heads"
    if not port.encoder_decoder or \
            tuple(port.block_pattern) != ("cross",) or \
            tuple(port.mlp_pattern) != ("dense",) or port.rope or \
            not port.learned_pos_emb or port.tie_embeddings or \
            port.qkv_bias or port.qk_norm or not port.causal or \
            port.sliding_window is not None:
        bad["layers"] = ("not an encoder under cross-attending causal "
                         "decoder layers with sinusoidal positions, a dense "
                         "MLP and an untied head")
    if bad:
        raise ValueError(f"{port.name}: the port runs another model than "
                         f"the config states (config, port): {bad}")


def reduced(cfg: Mapping, port) -> dict:
    """``cfg`` at the sizes of ``port``, the port's reduced ``ModelConfig``
    of its ``arch`` (the CPU tests' model), every option kept."""
    return {**cfg, "d_model": port.d_model,
            "encoder_layers": port.num_encoder_layers,
            "decoder_layers": port.num_layers,
            "encoder_attention_heads": port.num_heads,
            "decoder_attention_heads": port.num_heads,
            "encoder_ffn_dim": port.d_ff, "decoder_ffn_dim": port.d_ff,
            "vocab_size": port.vocab_size,
            "max_source_positions": port.encoder_seq_len,
            "max_target_positions": min(cfg["max_target_positions"],
                                        port.max_position_embeddings)}


# --------------------------------------------------------------------------
# The reference
# --------------------------------------------------------------------------

def sinusoids(length: int, d: int, device) -> torch.Tensor:
    """(length, d): sin then cos of the positions 0..length-1 at the
    frequencies exp(-log(1e4) i / (d/2 - 1)), i < d/2."""
    half = d // 2
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=device) / max(half - 1, 1))
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] \
        * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def _layer(w: Mapping[str, torch.Tensor], prefix: str) -> dict:
    return {k[len(prefix):]: t for k, t in w.items() if k.startswith(prefix)}


def attend(x: torch.Tensor, kv: torch.Tensor, p: Mapping[str, torch.Tensor],
           cfg: Mapping, causal: bool, precision: str,
           prefix: str = "") -> torch.Tensor:
    """Multi-head attention of queries from x (N, Sq, d) over keys and
    values projected from kv (N, Skv, d), through the output projection;
    ``causal`` masks key j > query i."""
    m = dims(cfg)
    n, sq, skv = x.shape[0], x.shape[1], kv.shape[1]
    q = matmul(x, p[f"{prefix}wq"], precision).view(n, sq, m["h"], m["hd"])
    k = matmul(kv, p[f"{prefix}wk"], precision).view(n, skv, m["h"], m["hd"])
    v = matmul(kv, p[f"{prefix}wv"], precision).view(n, skv, m["h"], m["hd"])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # N, H, S, hd
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(m["hd"])
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, -1)
    att = matmul(probs, v, precision).transpose(1, 2).reshape(n, sq, -1)
    return matmul(att, p[f"{prefix}wo"], precision)


def mlp(h: torch.Tensor, p: Mapping[str, torch.Tensor], eps: float,
        precision: str) -> torch.Tensor:
    x = rms_norm(h, p["norm2"], eps)
    gate = matmul(x, p["w_gate"], precision)
    up = matmul(x, p["w_up"], precision)
    return matmul(F.silu(gate) * up, p["w_down"], precision)


def encoder_layer(h: torch.Tensor, w: Mapping[str, torch.Tensor], i: int,
                  cfg: Mapping, precision: str) -> torch.Tensor:
    eps, p = cfg["norm_eps"], _layer(w, f"enc_layers.{i}.")
    x = rms_norm(h, p["norm1"], eps)
    h = h + attend(x, x, p, cfg, False, precision)
    return h + mlp(h, p, eps, precision)


def decoder_layer(h: torch.Tensor, enc: torch.Tensor,
                  w: Mapping[str, torch.Tensor], i: int, cfg: Mapping,
                  precision: str) -> torch.Tensor:
    eps, p = cfg["norm_eps"], _layer(w, f"layers.{i}.")
    x = rms_norm(h, p["norm1"], eps)
    h = h + attend(x, x, p, cfg, True, precision)
    xc = rms_norm(h, p["norm_cross"], eps)
    h = h + attend(xc, enc, p, cfg, False, precision, prefix="cross_")
    return h + mlp(h, p, eps, precision)


def _run(fn, remat: bool, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def encode(w: Mapping[str, torch.Tensor], cfg: Mapping, n: int,
           precision: str, remat: bool = False) -> torch.Tensor:
    """The encoder's output (n, S_enc, d) over zero frames."""
    m = dims(cfg)
    dev = w["embed"].device
    frames = torch.zeros(n, m["s_enc"], m["d"], device=dev)
    h = frames + sinusoids(m["s_enc"], m["d"], dev)
    for i in range(m["enc"]):
        h = _run(encoder_layer, remat, h, w, i, cfg, precision)
    return rms_norm(h, w["enc_final_norm"], cfg["norm_eps"])


def hidden(w: Mapping[str, torch.Tensor], cfg: Mapping, tokens: torch.Tensor,
           precision: str, remat: bool = False) -> torch.Tensor:
    """The final-normed decoder states (N, S, d) of ``tokens`` (N, S) over
    the encoder's output of zero frames."""
    m = dims(cfg)
    n, s = tokens.shape
    if s > m["s_dec"]:
        raise ValueError(f"a prompt of {s} tokens; the decoder takes at "
                         f"most {m['s_dec']}")
    enc = encode(w, cfg, n, precision, remat)
    h = w["embed"][tokens.long()] + sinusoids(s, m["d"], tokens.device)
    for i in range(m["dec"]):
        h = _run(decoder_layer, remat, h, enc, w, i, cfg, precision)
    return rms_norm(h, w["final_norm"], cfg["norm_eps"])


@torch.no_grad()
def last_logits(w: Mapping[str, torch.Tensor], cfg: Mapping,
                tokens: torch.Tensor, precision: str = "fp32",
                block: int = 8) -> torch.Tensor:
    """fp32 logits (N, V) at the last position of each prompt in
    ``tokens`` (N, S), the encoder and decoder computed ``block`` prompts
    at a time."""
    out = []
    for i in range(0, tokens.shape[0], block):
        h = hidden(w, cfg, tokens[i:i + block], precision)[:, -1]
        out.append(matmul(h, w["lm_head"], precision))
    return torch.cat(out)


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: Mapping,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "fp32", rows: Optional[Sequence[int]] = None
                   ) -> tuple:
    """The mean token cross entropy of a batch (over zero frames) and its
    gradient by leaf.

    Runs one sequence at a time, each encoder and decoder layer
    rematerialised, and sums the sequences' gradients of (their loss /
    the number of sequences).  ``rows`` takes the mean over those
    sequences only (a fault that leaves part of the batch out)."""
    rows = list(range(tokens.shape[0])) if rows is None else list(rows)
    names = list(w)
    leaves = [w[n].requires_grad_(True) for n in names]
    grads = [torch.zeros_like(t) for t in leaves]
    total = 0.0
    for r in rows:
        h = hidden(w, cfg, tokens[r:r + 1], precision, remat=True)[0]
        logits = matmul(h, w["lm_head"], precision)
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

def encoder_layer_params(cfg: Mapping) -> int:
    """Weights an encoder layer multiplies each frame by: q, k, v, o and
    the SwiGLU's gate, up and down."""
    m = dims(cfg)
    return 4 * m["d"] * m["d"] + 3 * m["d"] * m["f"]


def decoder_layer_params(cfg: Mapping) -> int:
    """Weights a decoder layer multiplies each token by: the
    self-attention's q, k, v, o, the cross-attention's q and o, and the
    SwiGLU's gate, up and down (the cross k and v multiply the frames)."""
    m = dims(cfg)
    return 6 * m["d"] * m["d"] + 3 * m["d"] * m["f"]


def _forward(cfg: Mapping, batch: int, seq: int, head_rows: int) -> float:
    """One forward over ``batch`` prompts of ``seq`` tokens and their
    ``max_source_positions`` frames, the head over ``head_rows`` rows."""
    m = dims(cfg)
    frames = batch * m["s_enc"]
    enc = 2 * frames * encoder_layer_params(cfg) * m["enc"] \
        + attention_fwd_flops(batch, m["s_enc"], m["h"], m["hd"],
                              causal=False) * m["enc"]
    cross = 2 * 2 * batch * seq * m["s_enc"] * m["h"] * m["hd"]
    dec = (2 * batch * seq * decoder_layer_params(cfg)
           + 2 * frames * 2 * m["d"] * m["d"]
           + attention_fwd_flops(batch, seq, m["h"], m["hd"]) + cross) \
        * m["dec"]
    return enc + dec + 2 * head_rows * m["d"] * m["v"]


def prefill_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One ``serve_prefill`` of (batch, seq) tokens over the frames: every
    encoder layer over every frame (attention unmasked), every decoder
    layer over every position (self-attention at the causal half,
    cross-attention over every frame, the cross k and v over every frame),
    the head over the last position only."""
    return _forward(cfg, batch, seq, batch)


def train_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """Model operations of one training step: 3x the forward of every
    matmul (the backward takes the gradients of both operands), the head
    over every position; remat's recomputation left out."""
    return 3 * _forward(cfg, batch, seq, batch * seq)
