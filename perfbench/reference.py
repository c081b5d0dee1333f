"""The plain reference: a Qwen-family decoder in fp32 PyTorch, written from
the published layer equations, with no kernel, cache or batching of the
program, and imports of neither ``jax`` nor anything of ``repro_torch``.

Per layer: RMSNorm -> q, k, v projections (+ bias where the config has
``attention_bias``) -> per-head RMSNorm of q and k (``qk_norm``) -> RoPE
(split-half, theta from the config) -> causal softmax attention, each
query head reading KV head ``head // (H / KVH)`` -> output projection ->
residual; RMSNorm -> SwiGLU MLP -> residual.  Then the final RMSNorm and
the tied head.  The loss is the mean token cross entropy.

``precision`` selects the arithmetic of every matmul (the projections,
QK^T, PV and the head): "fp32" with TF32 off, or "fp8", each operand
rounded to float8 e4m3 with a per-tensor scale (amax / 448) before an
fp32 product: the control that has to fail the benchmark's comparison.
Everything else runs in fp32 in both.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.counts import dims

FP8_MAX = 448.0


def no_tf32() -> None:
    """fp32 matmuls in fp32 on the card (not TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in fp32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (N, S, H, hd); rotate halves by position·theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


def schedule(step: int, opt: Mapping) -> float:
    """Linear warm-up, then a cosine to ``min_lr_frac`` of ``lr``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def adamw_steps(w: Dict[str, torch.Tensor], cfg: Mapping, batches: List[dict],
                opt: Mapping, store_dtype: torch.dtype,
                precision: str = "fp32", rows=None) -> dict:
    """AdamW over ``batches`` from the weights ``w`` (fp32 tensors, updated
    in place): global-norm clipping, bias correction, decoupled decay of
    the matrices, the new value rounded to ``store_dtype`` as the
    configuration keeps its parameters.  Returns each step's loss, the
    first step's global gradient norm before clipping, each leaf's norm of
    the first clipped gradient and each leaf's change after the last
    step."""
    start = {n: t.clone() for n, t in w.items()}
    mu = {n: torch.zeros_like(t) for n, t in w.items()}
    nu = {n: torch.zeros_like(t) for n, t in w.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, first = [], {}
    gnorm1 = None
    for k, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(w, cfg, batch["tokens"], batch["labels"],
                                     precision, rows)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = schedule(k, opt)
        with torch.no_grad():
            for n, g in grads.items():
                g = g * scale
                if k == 1:
                    first[n] = float(g.norm())
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (mu[n] / (1 - b1 ** k)) / (
                    (nu[n] / (1 - b2 ** k)).sqrt() + opt["eps"])
                if w[n].dim() >= 2:
                    upd = upd + opt["weight_decay"] * w[n]
                w[n].copy_((w[n] - lr * upd).to(store_dtype).float())
        if k == 1:
            gnorm1 = gnorm
        del grads
    change = {n: float((w[n] - start[n]).norm()) for n in w}
    return {"losses": losses, "grad_norm": gnorm1, "first_grad": first,
            "change": change}
