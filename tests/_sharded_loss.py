"""One rank of a real sharded run on the CPU: ``tests/test_torch_launch.py``
starts WORLD of these (gloo, a 2×2 (data, model) mesh) and compares what
rank 0 prints.

  python tests/_sharded_loss.py ARCH RANK WORLD PORT

Every rank builds the same reduced ARCH in fp32 from a seed, computes
the training loss and its gradients on one device (no rules), then lays the
parameters and the batch out by ``ShardingRules`` as DTensors, installs the
model's hooks (the training rules with their FSDP gather) and computes the
loss and gradients again, sharded; and the same for a prefill's logits
under the prefill rules and a decode step's (batch 4 and 1) on a cache
laid out by the decode rules, its slots sharded.  Rank 0 prints the largest relative differences
as JSON."""
import json
import os
import socket
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models import Transformer
from repro_torch.models.transformer import ModelCache
from repro_torch.models.common import (set_param_gather, set_shard_context,
                                       set_sharding_rules)


def rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def install(rules):
    set_sharding_rules(rules and rules.activation_rules())
    set_shard_context(rules and rules.shard_context())
    set_param_gather(rules.dp if rules and rules.mode == "train" else None)


def distribute(model, rules):
    """A copy of the model's parameters as DTensors laid out by rules."""
    specs = rules.params_shardings(dict(model.named_parameters()))
    out = {}
    for n, p in model.named_parameters():
        out[n] = distribute_tensor(p.detach(), rules.mesh,
                                   specs[n].placements)
    return out


def swap(model, tensors):
    """Sets the model's parameters to ``tensors`` (requires grad)."""
    for n, t in tensors.items():
        mod_name, _, leaf = n.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        param = torch.nn.Parameter(t, requires_grad=True)
        if isinstance(mod, torch.nn.ParameterDict):
            mod[leaf] = param
        else:
            setattr(mod, leaf, param)


def main(arch: str, rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)            # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        # a shard routes its own tokens (the reference's shard_map): with
        # room for every pair and no load-balance term (a mean over the
        # shards of a product, not the global product) that is the global
        # dispatch, pair for pair
        cfg = replace(cfg, moe=replace(
            cfg.moe, load_balance_coef=0.0,
            capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    b, s = 4, 16
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32)
    frames = torch.as_tensor(rng.standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model)), dtype=torch.float32) \
        if cfg.encoder_decoder else None
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    names = [n for n, _ in model.named_parameters()]
    plain = dict(model.named_parameters())
    for p in plain.values():
        p.requires_grad_(True)
    loss1 = model.forward_train(tokens, labels, frames, remat=True)
    grads1 = torch.autograd.grad(loss1, list(plain.values()))
    with torch.no_grad():
        logits1, _ = model.serve_prefill(tokens, frames=frames)
    # decode steps against caches of 2s slots (their slots split over the
    # model axis, and for one sequence over data too): batch b and 1
    decodes = []
    for nb in (b, 1):
        fr = None if frames is None else frames[:nb]
        with torch.no_grad():
            _, cache = model.serve_prefill(tokens[:nb], cache_len=2 * s,
                                           frames=fr)
            ref, _ = model.serve_decode(tokens[:nb, -1], cache)
            _, cache = model.serve_prefill(tokens[:nb], cache_len=2 * s,
                                           frames=fr)
        decodes.append((nb, cache, ref))

    out = {}
    rules = ShardingRules(cfg, mesh, "train", b, s)
    swap(model, distribute(model, rules))
    install(rules)
    try:
        batch = {"tokens": tokens, "labels": labels}
        if frames is not None:
            batch["frames"] = frames
        bsh = rules.batch_shardings(batch)
        tok, lab, frm = (None if t is None else distribute_tensor(
            t, mesh, bsh[k].placements) for k, t in (
                ("tokens", tokens), ("labels", labels), ("frames", frames)))
        params = [dict(model.named_parameters())[n] for n in names]
        # plain constants (RoPE tables, iotas) count as replicated
        with implicit_replication():
            loss2 = model.forward_train(tok, lab, frm, remat=True)
            grads2 = torch.autograd.grad(loss2, params)
        out["loss"] = rel(loss2.full_tensor(), loss1)
        out["grads"] = max(rel(g2.full_tensor(), g1)
                           for g1, g2 in zip(grads1, grads2))
        out["sharded_params"] = sum(
            any(not p.is_replicate() for p in t.placements)
            for t in params)
    finally:
        install(None)
    swap(model, plain)
    rules = ShardingRules(cfg, mesh, "prefill", b, s)
    swap(model, distribute(model, rules))
    install(rules)
    try:
        bsh = rules.batch_shardings({"tokens": tokens, "frames": tokens})
        tok, frm = (None if t is None else distribute_tensor(
            t, mesh, bsh[k].placements) for k, t in (
                ("tokens", tokens), ("frames", frames)))
        with torch.no_grad(), implicit_replication():
            logits2, _ = model.serve_prefill(tok, frames=frm)
        assert isinstance(logits2, DTensor)
        out["prefill_logits"] = rel(logits2.full_tensor(), logits1)
    finally:
        install(None)
    # one decode step on caches laid out by the decode rules
    out["decode_logits"] = 0.0
    for nb, cache, ref in decodes:
        swap(model, plain)
        rules = ShardingRules(cfg, mesh, "decode", nb, 2 * s)
        swap(model, distribute(model, rules))
        csh = rules.cache_shardings(cache)

        def lay(st, sh):
            return type(st)(*(distribute_tensor(t, mesh, spec.placements)
                              for t, spec in zip(st, sh)))
        cache = ModelCache(
            [lay(st, sh) for st, sh in zip(cache.layers, csh.layers)],
            cache.pos, None if cache.cross is None else
            [None if st is None else lay(st, sh)
             for st, sh in zip(cache.cross, csh.cross)])
        install(rules)
        try:
            tok = distribute_tensor(
                tokens[:nb, -1], mesh,
                rules.batch_shardings({"t": tokens[:nb, -1]})["t"]
                .placements)
            with torch.no_grad(), implicit_replication():
                got, _ = model.serve_decode(tok, cache)
            out["decode_logits"] = max(out["decode_logits"],
                                       rel(got.full_tensor(), ref))
        finally:
            install(None)
        out.setdefault("decode_cache_placements", []).append(
            str(cache.layers[0][0].placements))
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()


TRAIN_ARGS = ["--steps", "3", "--seq", "16", "--global-batch", "4",
              "--device", "cpu"]
LAUNCH = ("import json, sys\n"
          "from repro_torch.launch import train\n"
          "hist = train.main(sys.argv[1:])\n"
          "print(json.dumps(hist))\n")


def run_launcher(world: int = 4, timeout: float = 240) -> tuple:
    """``python -m repro_torch.launch.train`` on ``world`` gloo ranks
    started as ``torchrun`` would (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), and on one process: the two
    histories (rank 0's)."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", LAUNCH, *TRAIN_ARGS], cwd=root,
        env={**env, "WORLD_SIZE": str(world), "RANK": str(r),
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    one = subprocess.run([sys.executable, "-c", LAUNCH, *TRAIN_ARGS],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout)
    outs = [p.communicate(timeout=timeout) for p in procs]
    for rc, err in [(p.returncode, e) for p, (_, e) in zip(procs, outs)] \
            + [(one.returncode, one.stderr)]:
        assert rc == 0, err[-3000:]
    return (json.loads(outs[0][0].strip().splitlines()[-1]),
            json.loads(one.stdout.strip().splitlines()[-1]))


def run(arch: str, world: int = 4, timeout: float = 240) -> dict:
    """Starts ``world`` ranks of this script for ``arch`` (one thread
    each) and returns rank 0's record."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), arch, str(r), str(world),
         str(port)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
