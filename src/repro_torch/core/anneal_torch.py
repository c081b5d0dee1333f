"""The annealing walk of the Camelot joint solver as torch ops on the card
(``SAConfig(mode="torch")``; the port of ``repro/core/anneal_jax.py``).

The vectorized annealer's hot loop is flat array math over
``_PolicyTables`` lookups; this module runs that loop (mutate → gather →
constraint reduction → masked argmax → Metropolis accept) as torch ops on
one device, the whole walk's state and history kept there and read back
once at the end.

Division of labour with the numpy paths, as in the reference:

  * the **walk** (float32) scores candidates with Constraints 2–4, the
    aggregate form of Constraint 1, and the exact group-sparse Constraint 5
    (per-QoS-group critical paths over the padded membership tensors that
    ``IncrementalEvaluator`` builds).  Per-device packability (integer FFD)
    is data-dependent recursion and stays on the host: the walk is
    deliberately *optimistic* about it;
  * the **exact numpy evaluator** then re-scores the walk's incumbent pool
    (per-walker bests + final walker states) with the full ``_eval_many``
    (real FFD, float64), picks the best truly feasible state and hands it
    to the deterministic greedy ``_polish``.

So the returned allocation is always exact-feasible.  ``run_anneal``
returns ``None`` only for the reference's algorithmic reasons (non-linear
utility curves, a graph past the group-path cap, no exact-feasible pool
survivor, a packing failure) and ``_anneal`` then runs the vectorized numpy
walk.  A failure of the walk itself on the device raises: it is not hidden
behind the numpy walk.

The random draws of a step are a function of their own (``draw``): the
step body (``step``) takes them as tensors, so the same body runs on any
stream of draws.  ``draw`` reproduces the reference's ``jax.random`` stream
(threefry2x32 from ``PRNGKey(sa.seed & 0x7FFFFFFF)``) for every step at
once, so the port's walk is the reference's on the CPU and on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.deployment import pack_instances
from repro_torch.core.incremental import IncrementalEvaluator
from repro_torch.core.types import QUOTA_STEP, Allocation, StageAlloc

# per-move instance/quota-index deltas (moves 4/5 rescale the quota)
_MOVE_DN = (1, -1, 0, 0, 1, -1)
_MOVE_DQ = (0, 0, 1, -1, 0, 0)


def resolve_device(device) -> torch.device:
    """The walk's device: ``"cuda"`` unless the caller asks for the CPU.
    With no CUDA device it raises (no quiet numpy walk)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SAConfig(mode='torch') runs its walk on the card "
            f"(device={str(device)!r}) but no CUDA device is available; "
            "pass device='cpu' to run it on the CPU")
    return dev


@dataclass
class Problem:
    """One walk's static shape and its float32/integer tensors on the walk's
    device.  ``n``: stages; ``W`` walkers × ``C`` candidates each;
    ``n_mut`` stacked moves at most per candidate; ``g`` quota-grid
    points; ``E`` graph edges (0: the edge term is skipped)."""
    n: int
    W: int
    C: int
    n_mut: int
    g: int
    E: int
    bw_on: bool
    maxload: bool
    dur: torch.Tensor           # (n, g)
    bwt: torch.Tensor           # (n, g)
    tht: torch.Tensor           # (n, g)
    foots: torch.Tensor         # (n,)
    gridv: torch.Tensor         # (g,)
    norm: torch.Tensor          # (n,)
    A: torch.Tensor             # (Gq, P, mn) path × node membership
    B: torch.Tensor             # (Gq, P, me) path × edge membership
    g_nodes: torch.Tensor       # (Gq, mn) int64
    ge_src: torch.Tensor        # (Gq, me) int64
    ge_dst: torch.Tensor        # (Gq, me) int64
    ge_tc: torch.Tensor         # (Gq, me) transfer time if co-located
    ge_th: torch.Tensor         # (Gq, me) transfer time via host
    targets: torch.Tensor       # (Gq,)
    max_inst: int
    cap_quota: torch.Tensor     # float32 scalars
    cap_inst: int
    cap_bw: torch.Tensor
    cap_mem: torch.Tensor
    req: torch.Tensor
    move_dn: torch.Tensor       # (6,) per-move instance / quota deltas
    move_dq: torch.Tensor

    @property
    def K(self) -> int:
        return self.W * self.C


class Draws(NamedTuple):
    """The random numbers of one step (or, with a leading steps dim, of a
    whole walk): ``muts`` (K,) moves per candidate in 1..n_mut, ``ik``
    (n_mut, K) stages, ``mk`` (n_mut, K) move kinds in 0..5, ``jr`` (W,)
    explored candidates, ``u_explore`` and ``u_accept`` (W,) uniforms."""
    muts: torch.Tensor
    ik: torch.Tensor
    mk: torch.Tensor
    jr: torch.Tensor
    u_explore: torch.Tensor
    u_accept: torch.Tensor


# ---- the reference's random stream (jax.random's threefry2x32) -----------
# A torch.Generator's stream (mt19937 on the CPU, Philox on the card)
# walks elsewhere than the reference: at the reference test's seed it left
# two-chains at 0.9455 of the vectorized objective, a local optimum the
# reference's own walk reaches at other seeds.  The walk's draws therefore
# follow the reference's counter-based stream exactly, so mode "torch"
# reproduces mode "jax"'s walk on every device.  They are integer hashes
# computed in numpy (uint32 arithmetic wraps natively) on the host, for all
# steps at once, and copied to the walk's device in one transfer each.

_ROT = (tuple(np.uint32(r) for r in (13, 15, 26, 6)),
        tuple(np.uint32(r) for r in (17, 29, 16, 24)))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counters (x1, x2) under key (k1, k2), as
    jax's ``threefry2x32_p`` (20 rounds, 5 key injections)."""
    u32 = np.uint32
    ks = (u32(k1), u32(k2), u32(k1) ^ u32(k2) ^ u32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = np.asarray(x1, u32) + ks[0], np.asarray(x2, u32) + ks[1]
        for r in range(5):
            for rot in _ROT[r % 2]:
                x0 = x0 + x1
                x1 = (x1 << rot) | (x1 >> (u32(32) - rot))
                x1 = x0 ^ x1
            x0 = x0 + ks[(r + 1) % 3]
            x1 = x1 + ks[(r + 2) % 3] + u32(r + 1)
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a seed below 2^32."""
    return (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))


def split(key, num: int) -> list:
    """``jax.random.split`` (the partitionable, fold-like form)."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element (``jax.random.bits``)."""
    size = int(np.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(size, np.uint32),
                          np.arange(size, dtype=np.uint32))
    return (b1 ^ b2).reshape(shape)


def randint(key, shape, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(key, shape, lo, hi)`` (int32, hi > lo)."""
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(hi - lo)
    mult = np.uint32((2 ** 16 % int(span)) ** 2 % int(span))
    with np.errstate(over="ignore"):
        off = ((higher % span) * mult + lower % span) % span
    return lo + off.astype(np.int64)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def draw(seed: int, steps: int, pb: Problem, device) -> Draws:
    """Every step's draws at once (leading dim steps) on ``device``: the
    key sequence of the reference's walk, ``key, k1..k6 = split(key, 7)``
    a step (``repro/core/anneal_jax.py:102-108, :125-126, :136``)."""
    K, W, n_mut = pb.K, pb.W, pb.n_mut
    key = prng_key(seed & 0x7FFFFFFF)
    out = [[] for _ in range(6)]
    for _ in range(steps):
        key, k1, k2, k3, k4, k5, k6 = split(key, 7)
        for o, x in zip(out, (randint(k1, (K,), 1, n_mut + 1),
                              randint(k2, (n_mut, K), 0, pb.n),
                              randint(k3, (n_mut, K), 0, 6),
                              randint(k4, (W,), 0, pb.C),
                              uniform(k5, (W,)), uniform(k6, (W,)))):
            o.append(x)
    return Draws(*(torch.as_tensor(np.stack(o)).to(device) for o in out))


def score_rows(pb: Problem, NS: torch.Tensor, QI: torch.Tensor
               ) -> torch.Tensor:
    """float32 score of each row (-inf: infeasible) under Constraints 1–5
    (1 in aggregate, packability left to the exact re-evaluation)."""
    ari = torch.arange(pb.n, device=NS.device)[None, :]
    NSf = NS.to(torch.float32)
    PS = pb.gridv[QI]                                       # (K, n)
    dur_r = pb.dur[ari, QI]
    thpt_min = (NSf * pb.tht[ari, QI] / pb.norm[None, :]).amin(dim=1)
    quota = (NSf * PS).sum(dim=1)
    feas = quota <= pb.cap_quota
    feas &= NS.sum(dim=1) <= pb.cap_inst
    if pb.bw_on:
        feas &= (NSf * pb.bwt[ari, QI]).sum(dim=1) <= pb.cap_bw
    feas &= (NSf * pb.foots[None, :]).sum(dim=1) <= pb.cap_mem
    # Constraint 5: per-group critical paths through the padded membership
    # tensors (padded slots carry zero membership)
    durg = dur_r[:, pb.g_nodes]                             # (K, Gq, mn)
    lat_p = torch.einsum("gpj,kgj->kgp", pb.A, durg)
    if pb.E:
        colo = PS[:, pb.ge_src] + PS[:, pb.ge_dst] <= 1.0 + 1e-6
        ec = torch.where(colo, pb.ge_tc[None], pb.ge_th[None])
        lat_p = lat_p + torch.einsum("gpj,kgj->kgp", pb.B, ec)
    feas &= (lat_p.amax(dim=2) <= pb.targets[None, :]).all(dim=1)
    ninf = torch.full((), -torch.inf, device=NS.device)
    if pb.maxload:
        return torch.where(feas, thpt_min, ninf)
    s = torch.where(feas, -quota, ninf)
    return torch.where(thpt_min >= pb.req, s, ninf)


class State(NamedTuple):
    """Walkers (NS, QI), their scores ``cur`` and per-walker incumbents."""
    NS: torch.Tensor            # (W, n) int64 instance counts
    QI: torch.Tensor            # (W, n) int64 quota-grid indices
    cur: torch.Tensor           # (W,) float32
    bNS: torch.Tensor
    bQI: torch.Tensor
    bS: torch.Tensor


def init_state(pb: Problem, NS0: torch.Tensor, QI0: torch.Tensor) -> State:
    cur0 = score_rows(pb, NS0, QI0)
    return State(NS0, QI0, cur0, NS0, QI0, cur0)


def mutate(pb: Problem, NS: torch.Tensor, QI: torch.Tensor, d: Draws):
    """Each walker's C candidates, each 1..n_mut stacked single moves."""
    C = pb.C
    NS_c = NS.repeat_interleave(C, dim=0)                   # walker-major
    QI_c = QI.repeat_interleave(C, dim=0)
    ar_k = torch.arange(pb.K, device=NS.device)
    for t in range(pb.n_mut):                               # static unroll
        active = d.muts > t
        i, mv = d.ik[t], d.mk[t]
        cn = NS_c[ar_k, i]
        cq = QI_c[ar_k, i]
        tn = (cn + pb.move_dn[mv]).clamp(1, pb.max_inst)
        tq = cq + pb.move_dq[mv]
        # the reference's int32 product (exact here: < 2^24) divided in
        # float32 and rounded half to even, as jnp.rint
        resc = torch.round((cq + 1).mul(cn).to(torch.float32)
                           / tn.to(torch.float32)).to(torch.int64) - 1
        tq = torch.where(mv >= 4, resc, tq).clamp(0, pb.g - 1)
        NS_c[ar_k, i] = torch.where(active, tn, cn)
        QI_c[ar_k, i] = torch.where(active, tq, cq)
    return NS_c, QI_c


def step(pb: Problem, st: State, d: Draws, temp: torch.Tensor):
    """One step of the walk given its draws: returns the next state and
    the best candidate score of the step (the history's entry)."""
    W, C = pb.W, pb.C
    dev = st.NS.device
    NS_c, QI_c = mutate(pb, st.NS, st.QI, d)
    sw = score_rows(pb, NS_c, QI_c).reshape(W, C)
    # annealed explore-vs-argmax pick (argmax takes the first maximum, as
    # jnp.argmax), then per-walker Metropolis accept
    jmax = sw.argmax(dim=1)
    explore = d.u_explore < torch.clamp(temp, max=1.0)
    sr = sw.gather(1, d.jr[:, None])[:, 0]
    jc = torch.where(explore & torch.isfinite(sr), d.jr, jmax)
    sj = sw.gather(1, jc[:, None])[:, 0]
    cur_ok = torch.isfinite(st.cur)
    cur_safe = torch.where(cur_ok, st.cur, 0.0)
    gap = torch.where(cur_ok, sj - cur_safe, torch.full_like(sj, torch.inf))
    prob = torch.exp(torch.clamp(
        gap / torch.clamp(temp * cur_safe.abs() + 1e-12, min=1e-12),
        max=0.0))
    accept = torch.isfinite(sj) & ((gap >= 0) | (d.u_accept < prob))
    base = torch.arange(W, device=dev) * C
    rows = base + jc
    NS = torch.where(accept[:, None], NS_c[rows], st.NS)
    QI = torch.where(accept[:, None], QI_c[rows], st.QI)
    cur = torch.where(accept, sj, st.cur)
    # per-walker incumbents over the whole evaluated fan: the pool the
    # exact numpy evaluator re-scores afterwards
    sb = sw.gather(1, jmax[:, None])[:, 0]
    rb = base + jmax
    upd = sb > st.bS
    bNS = torch.where(upd[:, None], NS_c[rb], st.bNS)
    bQI = torch.where(upd[:, None], QI_c[rb], st.bQI)
    bS = torch.where(upd, sb, st.bS)
    return State(NS, QI, cur, bNS, bQI, bS), sb.max()


def walk(pb: Problem, st: State, draws: Draws, temps: torch.Tensor):
    """``len(temps)`` steps; the history stays on the device."""
    hist = []
    for t in range(temps.shape[0]):
        st, h = step(pb, st, Draws(*(x[t] for x in draws)), temps[t])
        hist.append(h)
    return st, torch.stack(hist)


def prepare(alloc, batch: int, n_devices: int, objective: str,
            required_load: Optional[float], warm: Optional[Allocation],
            device: torch.device):
    """The walk's problem and start, built from ``alloc`` as the
    reference's ``run_anneal`` builds its kernel arguments; ``None`` when
    the group-sparse Constraint-5 tensors are unusable (path cap)."""
    sa = alloc.sa
    n = alloc.pipeline.n_stages
    tab = alloc._policy_tables(batch)
    g = len(tab.grid)
    max_inst = n_devices * alloc.device.max_instances
    engine = IncrementalEvaluator(alloc, tab, n_devices)
    if not engine.usable:
        return None
    k = max(1, int(sa.population))
    w = int(np.clip(sa.walkers, 1, k))
    c = max(1, k // w)
    n_mut = max(1, int(sa.max_mutations))
    NS0, QI0 = alloc._seed_walkers(tab, n_devices, w, g, max_inst)
    n_warm = 0
    if warm is not None and len(warm.stages) == n:
        wns = np.clip(np.array([s.n_instances for s in warm.stages],
                               np.int64), 1, max_inst)
        wqi = np.clip(np.rint(np.array(
            [s.quota for s in warm.stages]) / QUOTA_STEP).astype(
                np.int64) - 1, 0, g - 1)
        NS0 = np.vstack([NS0, wns[None]])
        QI0 = np.vstack([QI0, wqi[None]])
        n_warm = 1
    W = w + n_warm
    steps = max(1, -(-sa.iterations * n_mut // (w * c)))
    temps = sa.t0 * (sa.t_end / sa.t0) ** (
        np.arange(steps) / max(steps - 1, 1))
    norm = alloc._node_norm
    norm = np.ones(n) if norm is None else np.asarray(norm, np.float64)
    E = engine.E
    ge = engine._g_edges

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)
    pb = Problem(
        n=n, W=W, C=c, n_mut=n_mut, g=g, E=E,
        bw_on=bool(sa.bandwidth_constraint), maxload=objective == "max_load",
        dur=f32(tab.dur), bwt=f32(tab.bw), tht=f32(tab.thpt),
        foots=f32(tab.foots), gridv=f32(tab.grid), norm=f32(norm),
        A=f32(engine._A), B=f32(engine._B), g_nodes=i64(engine._g_nodes),
        ge_src=i64(tab.edge_src[ge] if E else ge),
        ge_dst=i64(tab.edge_dst[ge] if E else ge),
        ge_tc=f32(tab.edge_t_colo[ge] if E else ge),
        ge_th=f32(tab.edge_t_host[ge] if E else ge),
        targets=f32(engine._targets), max_inst=int(max_inst),
        # float32 aggregate sums drift ~1e-4 at thousand-node scale: admit
        # borderline rows here, let the exact re-eval decide
        cap_quota=f32(n_devices * 1.0 + 1e-3), cap_inst=int(max_inst),
        cap_bw=f32(n_devices * alloc.device.mem_bandwidth * (1 + 1e-6)),
        cap_mem=f32(n_devices * alloc.device.mem_capacity * (1 + 1e-6)),
        req=f32(required_load if required_load is not None else 0.0),
        move_dn=i64(_MOVE_DN), move_dq=i64(_MOVE_DQ))
    return (pb, i64(NS0), i64(QI0), f32(temps), tab, engine, max_inst, g,
            n_warm)


#: the last walk's counts: ``steps`` and ``walk_s`` (the walk's wall time,
#: the one sync included), for the chip's report
LAST_WALK: dict = {}


def run_anneal(alloc, batch: int, n_devices: int, objective: str,
               required_load: Optional[float] = None,
               warm: Optional[Allocation] = None):
    """Run one annealing walk for ``alloc`` (a CamelotAllocator or
    subclass) on ``alloc.sa.device``.  Returns a SolveResult with
    ``mode="torch"``, or ``None`` for the reference's algorithmic
    fallbacks (the caller then runs the vectorized numpy walk)."""
    if getattr(alloc, "_util_codes", None) is not None:
        # non-linear utility curves reshape the max-load objective; the
        # float32 walk would rank incumbents by the untransformed min and
        # keep the wrong pool: the numpy path applies them exactly.
        # (Isolation floor/cap bounds differ: the walk searches
        # optimistically without them and the exact `_eval_many` below
        # enforces them on every surviving incumbent.)
        return None
    from repro_torch.core.allocator import SolveResult      # avoid cycle

    t_start = time.perf_counter()
    sa = alloc.sa
    dev = resolve_device(getattr(sa, "device", "cuda"))
    prep = prepare(alloc, batch, n_devices, objective, required_load, warm,
                   dev)
    if prep is None:
        return None
    pb, NS0, QI0, temps, tab, engine, max_inst, g, n_warm = prep
    n = pb.n
    t_walk = time.perf_counter()
    # the einsums over A and B in full fp32 (no TF32 on the card)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        st, hist = walk(pb, init_state(pb, NS0, QI0),
                        draw(sa.seed, temps.shape[0], pb, dev), temps)
        # the one sync of the walk
        NS_f, bNS, bQI = (x.cpu().numpy() for x in (st.NS, st.bNS, st.bQI))
        QI_f, hist = st.QI.cpu().numpy(), hist.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    LAST_WALK.clear()
    LAST_WALK.update(steps=int(temps.shape[0]),
                     walk_s=time.perf_counter() - t_walk)

    # exact numpy re-evaluation of the incumbent pool (real FFD, float64)
    pool_ns = np.concatenate([bNS, NS_f]).astype(np.int64)
    pool_qi = np.concatenate([bQI, QI_f]).astype(np.int64)
    ev = alloc._eval_many(pool_ns, pool_qi, tab, n_devices)

    def scores(ev):
        thpt, quota, lat, feas = ev
        if objective == "max_load":
            return np.where(feas, thpt, -np.inf)
        s = np.where(feas, -quota, -np.inf)
        if required_load is not None:
            s = np.where(thpt >= required_load, s, -np.inf)
        return s

    s = scores(ev)
    j = int(np.argmax(s))
    if not np.isfinite(s[j]):
        return None                  # no exact-feasible survivor: fallback
    best_ns, best_qi, best_score = pool_ns[j].copy(), pool_qi[j].copy(), \
        float(s[j])
    history = [float(x) for x in hist]
    best_ns, best_qi, best_score = alloc._polish(
        best_ns, best_qi, best_score, scores, tab, n_devices, max_inst, g,
        history, engine=engine)

    ps = tab.grid[best_qi]
    thpt, quota, lat, feas = alloc._eval_many(
        best_ns[None], best_qi[None], tab, n_devices)
    feasible = bool(feas[0])
    result = Allocation(
        stages=[StageAlloc(int(best_ns[i]), float(ps[i]), batch)
                for i in range(n)],
        predicted_min_throughput=float(thpt[0]) if feasible else 0.0,
        predicted_latency=float(lat[0]) if feasible else float("inf"))
    if feasible:
        result.placement = pack_instances(
            result, alloc.pipeline, alloc.predictor, alloc.device,
            n_devices)
        feasible = result.placement is not None
    if not feasible:
        return None
    return SolveResult(allocation=result, objective=best_score,
                       feasible=True,
                       solve_time=time.perf_counter() - t_start,
                       iterations=sa.iterations, history=history,
                       mode="torch", warm_started=bool(n_warm))
