"""Training cells: ``repro_torch.training.make_train_step`` (remat, AdamW in
place) on one model, a synchronous step loop.  The config's family
(``perfbench/families/<family>.py``) checks the port's model, lays out the
seeded weights, counts a step's operations and is the plain reference.

Set-up builds the one training step with its model (the benchmark's seeded
weights written into the port's ``Transformer``) and its optimizer state,
and drives it through its first three steps with the window's own call and
feed; the numbers that the check needs are read from that state before
step 4 overwrites it: each step's loss, the first step's gradient norm,
each leaf's first clipped gradient (from the first moment after step 1)
and each leaf's change after step 3.  The window runs steps 4, 5, ... of
the same object until ``seconds`` have passed, reading each step's loss.
With ``trace`` two more steps run under ``torch.profiler`` after the
window.  Then the program's state is freed and the plain reference follows
the first three steps from the same weights and batches.
"""
from __future__ import annotations

import bisect
import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from perfbench import reference
from perfbench.trace import LEAD_IN_KERNEL, busy_union, gaps, top_by_name
from perfbench.util import derive_seed, family, log
from perfbench.weights import make_weights

CHECK_STEPS = 3
TRACE_STEPS = 2
LEAD_IN = 256                          # spin kernels before the profile


def _hash_tokens(indices: np.ndarray, vocab: int, seed: int) -> np.ndarray:
    """SplitMix64-style position hash -> token ids (a copy of the port's
    ``training/data.py``, whose batches it reproduces bit for bit)."""
    z = (indices.astype(np.uint64) + np.uint64(seed)
         + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


def make_batch(vocab: int, seq: int, batch: int, seed: int,
               step: int) -> dict:
    """Batch ``step`` of the token stream: sample i covers positions
    [i (S + 1), (i + 1)(S + 1)); labels are the tokens shifted by one."""
    ids = np.arange(batch) + step * batch
    offsets = ids[:, None] * (seq + 1) + np.arange(seq + 1)[None]
    stream = _hash_tokens(offsets, vocab, seed)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def opt_config(cfg: dict) -> dict:
    keys = ("lr", "beta1", "beta2", "eps", "weight_decay", "clip_norm",
            "warmup_steps", "total_steps", "min_lr_frac")
    return {k: cfg["optimizer"][k] for k in keys}


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                        for n in names]) * scale
    return dict(zip(names, vals.tolist()))


def run(ctx) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.training import AdamWConfig, init_adamw, make_train_step

    cfg, cell, seed, dev = ctx.config, ctx.cell, ctx.seed, ctx.device
    traffic = cell["traffic"]
    b, s = traffic["batch"], traffic["seq_len"]
    vocab = cfg["vocab_size"]
    data_seed = derive_seed(seed, "data") % 2 ** 32
    wseed = derive_seed(seed, "weights", 0)
    fam = family(cfg)
    port = get_config(cfg["arch"], reduced=ctx.reduced)
    fam.check_port(port, cfg)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_model = time.time()
    model = Transformer(port, device=dev, dtype=torch.bfloat16, init=False)
    named = dict(model.named_parameters())
    make_weights(cfg, wseed, dev, torch.bfloat16, out=named)
    opt = opt_config(cfg)
    step = make_train_step(model, AdamWConfig(**opt), remat=True)
    state = init_adamw(named)

    def batch(i: int) -> dict:
        return make_batch(vocab, s, b, data_seed, i)

    losses, first, gnorm1 = [], {}, None
    t_steps = time.time()
    for k in range(CHECK_STEPS):
        state, m = step(state, batch(k))
        losses.append(float(m["loss"]))
        if k == 0:
            gnorm1 = float(m["grad_norm"])
            first = _norms(state.mu, 1.0 / (1.0 - opt["beta1"]))
    start = make_weights(cfg, wseed, dev, torch.bfloat16)
    change = _norms({n: named[n].float() - start[n].float() for n in named})
    del start
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - ctx.process_start
    phases = {"to_model": t_model - ctx.process_start,
              "model_and_weights": t_steps - t_model,
              "first_steps": time.time() - t_steps}
    log(f"set-up {setup_s:.1f} s; losses {losses}")
    # the window
    enqueue, i = [], CHECK_STEPS
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        state, m = step(state, batch(i))
        enqueue.append(time.perf_counter() - ts)
        loss = float(m["loss"])              # waits for the step
        i += 1
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss {loss} at step {i}")
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    steps = i - CHECK_STEPS
    obs = {"kind": "train", "setup_s": setup_s, "steps": steps,
           "window_s": window_s, "tokens": steps * b * s,
           "enqueue_s": enqueue, "step_flops": fam.train_flops(cfg, b, s),
           "batch": b, "seq_len": s, "config": cfg}
    if ctx.trace:
        obs.update(_profile(lambda j: step(state, batch(j))[1]["loss"],
                            i, dev))
    obs["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) \
        if dev == "cuda" else 0
    info = {"steps": steps, "window_s": window_s,
            "lead_in_recorded": obs.get("lead_in_recorded"),
            "step_ms_mean": window_s / steps * 1e3,
            "losses_setup": losses, "last_loss": loss,
            "setup_phases_s": phases}
    # free the program's state before the reference runs on the card
    del model, named, step, state, m
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grad_norm": gnorm1, "first_grad": first,
            "change": change}
    ref = reference_steps(cfg, wseed, [batch(k) for k in range(CHECK_STEPS)],
                          dev)
    obs["checks"] = compare(prog, ref, cell["limits"])
    info["reference_losses"] = ref["losses"]
    obs["info"] = info
    return obs


def reference_steps(cfg: dict, wseed: int, batches, dev,
                    precision: str = "fp32", rows=None) -> dict:
    """The plain reference's first steps from the seeded weights."""
    reference.no_tf32()
    w = {k: t.float() for k, t in make_weights(
        cfg, wseed, dev, torch.bfloat16).items()}
    tb = [{k: torch.from_numpy(v).to(dev) for k, v in bt.items()}
          for bt in batches]
    return reference.adamw_steps(family(cfg).loss_and_grads, w, cfg, tb,
                                 opt_config(cfg), torch.bfloat16, precision,
                                 rows)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves) -> float:
    """The worst leaf's |program norm - reference norm|, over the larger of
    that leaf's reference norm and the median leaf's."""
    med = float(np.median([ref[n] for n in leaves]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in leaves)


def compare(prog: dict, ref: dict, limits: dict) -> Dict:
    """The numbers that decide ``correct``, each with its limit:

    - ``loss_gap``: the largest |program - reference| of the first three
      steps' losses (nats);
    - ``grad_norm_gap``: the first step's global gradient norm before
      clipping, |program - reference| / reference;
    - ``first_grad_gap``: the first clipped gradient, by the worst leaf;
    - ``change_gap``: the parameters' change after three steps, by the
      worst leaf, over the leaves whose first reference gradient is at
      least a thousandth of the median leaf's (a leaf below that moves by
      round-off alone)."""
    leaves = list(ref["first_grad"])
    med = float(np.median([ref["first_grad"][n] for n in leaves]))
    moving = [n for n in leaves if ref["first_grad"][n] >= 1e-3 * med]
    loss_gap = max(abs(a - r) for a, r in zip(prog["losses"],
                                              ref["losses"]))
    out = {
        "loss_gap": (loss_gap, limits["loss_gap"]),
        "grad_norm_gap": (abs(prog["grad_norm"] - ref["grad_norm"])
                          / ref["grad_norm"], limits["grad_norm_gap"]),
        "first_grad_gap": (leaf_gap(prog["first_grad"], ref["first_grad"],
                                    leaves), limits["first_grad_gap"]),
        "change_gap": (leaf_gap(prog["change"], ref["change"], moving),
                       limits["change_gap"]),
        "leaves_left_out": (len(leaves) - len(moving), None),
    }
    return out


def _host_op_at(host, starts, t: int, look_back: int = 4096) -> str:
    """The name of the latest-starting host op that covers time ``t``
    (the innermost of nested ops), looking back over at most
    ``look_back`` ops from the last one started by ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "no host op"


def _profile(one_step, first_index: int, dev: str) -> dict:
    """``TRACE_STEPS`` steps under the profiler after the lead-in: each
    device operation's time, the attention kernels' launches and time, the
    busy time and the traced window, and the idle gaps by the host op that
    was running in each."""
    if dev != "cuda":
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        lo = time.time_ns()
        for j in range(TRACE_STEPS):
            float(one_step(first_index + j))
        torch.cuda.synchronize()
        hi = time.time_ns()
    res = prof.profiler.kineto_results
    kernels, host, lead_in = [], [], 0
    for e in res.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            if LEAD_IN_KERNEL in e.name():
                lead_in += 1
            else:
                kernels.append((e.name(), e.start_ns(),
                                e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(),
                         e.start_ns() + e.duration_ns()))
    merged, busy = busy_union([(a, z) for _, a, z in kernels], lo, hi)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    labels: Dict[str, float] = {}
    for a, z in gaps(merged, lo, hi):
        label = _host_op_at(host, starts, (a + z) // 2)
        labels[label] = labels.get(label, 0.0) + (z - a) / 1e9
    by_kernel: Dict[str, list] = {}
    for name, a, z in kernels:
        if lo <= a < hi:
            row = by_kernel.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (z - a) / 1e9
    return {"busy_s": busy / 1e9, "trace_window_s": (hi - lo) / 1e9,
            "traced_steps": TRACE_STEPS, "kernels": by_kernel,
            "device_ops": top_by_name(kernels, lo, hi),
            "idle_gaps": sorted(([k, v] for k, v in labels.items()),
                                key=lambda kv: kv[1], reverse=True)[:10],
            "lead_in_recorded": lead_in}
