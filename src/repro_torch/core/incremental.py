"""Amortized incremental constraint evaluation for the annealing hot path.

``CamelotAllocator._eval_many`` re-derives Constraints 1–5 from scratch for
every candidate row: O(n) table gathers and reductions per row plus a
Python-level topological recurrence over the whole (union) graph for the
critical path.  But the annealer's move kernel only ever perturbs
``max_mutations`` (default 4) stages per candidate — at datacenter scale
(hundreds of tenants, ~1k union-graph nodes) >99% of that work re-computes
unchanged state.

``IncrementalEvaluator`` keeps per-walker caches of everything a candidate
can share with its base state and re-scores only what a mutation touched:

  * **aggregate sums** (total quota, instance count, bandwidth, memory —
    Constraints 1–4) update by the touched stages' deltas;
  * **min-throughput objective**: the smallest ``max_mutations + 1``
    normalized node throughputs are cached per walker, so the min over
    untouched nodes is always available without a full scan (at most
    ``max_mutations`` of the cached set can be invalidated);
  * **Constraint-5 latency** is sparse over *QoS groups* (per-tenant exit
    groups of the union graph; the whole graph for single-service solves).
    A mutation perturbs only the groups containing a touched node — every
    edge of a disjoint-union graph is intra-tenant, so co-location flips
    stay inside the touched group too.  Each touched (row, group) pair is
    re-scored *fresh* as a max over the group's enumerated entry→exit
    paths with small padded per-group membership tensors (one einsum, no
    Python loop over tenants and no topological recurrence); untouched
    groups come from cached per-walker group latencies, violation counts
    and a top-k largest-latency cache;
  * **per-quota-level instance histograms** (the FFD packability key)
    update by scatter deltas, so Constraint-1's refinement costs
    O(touched) before the memoized integer-FFD check.

Per evaluated candidate the cost is O(touched · group-size) instead of
O(n + topo-pass) — the superlinear term the dense evaluator pays at every
step.  Graphs whose per-group path count exceeds the cap (wide fan-out
DAGs) report ``usable=False`` and callers fall back to the dense path.
Float drift from delta accumulation only affects the aggregate sums
(latencies are re-derived fresh) and is bounded by re-deriving committed
walker caches from the full decision vectors every ``REFRESH_EVERY``
commits — deltas are then one hop from a fresh base, so error stays
~1e-13 against constraint tolerances of 1e-9.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.types import apply_utility

#: per-group entry→exit path ceiling: beyond this the padded membership
#: tensors stop being small and the dense topo pass is the better trade
GROUP_PATH_CAP = 64


class IncrementalEvaluator:
    """Stateful drop-in for ``_eval_many`` over a fixed (tab, n_devices)
    solve: ``rebase`` installs the walker base states, ``eval`` scores
    candidate rows against them by delta, ``commit`` folds accepted
    candidates back into the walker caches."""

    REFRESH_EVERY = 64

    def __init__(self, alloc, tab, n_devices: int,
                 path_cap: int = GROUP_PATH_CAP):
        self._alloc = alloc
        self._tab = tab
        self.n_devices = int(n_devices)
        graph = alloc.pipeline
        n = graph.n_nodes
        self.n = n
        sa = alloc.sa
        self._bw_on = bool(sa.bandwidth_constraint)
        dev = alloc.device
        self._cap_inst = self.n_devices * dev.max_instances
        self._cap_bw = self.n_devices * dev.mem_bandwidth
        self._cap_mem = self.n_devices * dev.mem_capacity
        self._cap_quota = self.n_devices * 1.0 + 1e-9
        norm = alloc._node_norm
        self._norm = np.ones(n) if norm is None else np.asarray(norm,
                                                                np.float64)
        # lifecycle hooks, mirrored from the allocator so the incremental
        # verdicts stay identical to ``_eval_many``'s: per-tenant quota
        # [floor, cap] bounds (delta-updated per walker) and per-node
        # utility codes (folded into the tracked normalized throughputs —
        # the curves are monotone, so min-tracking over transformed values
        # is exactly the dense transformed min)
        self._iso = alloc._iso_bounds
        if self._iso is not None:
            starts = self._iso[0]
            self._tenant_of = np.searchsorted(
                starts, np.arange(n), side="right") - 1
        self._codes = alloc._util_codes
        # cache depth for the two "extremum over untouched" tricks: deep
        # enough that at least one cached entry survives any compound
        # mutation (or the whole set, which makes the cached value exact)
        n_mut = max(1, int(sa.max_mutations))
        self.S = min(n, n_mut + 1)
        groups = alloc._qos_exit_groups
        if groups is None:
            groups = [(np.asarray(graph.exits, np.int64), graph.qos_target)]
        self.usable = self._build_groups(graph, groups, sa.qos_slack,
                                         path_cap)
        if not self.usable:
            return
        self.S2 = min(self.Gq, n_mut + 1)
        self._esrc = tab.edge_src
        self._edst = tab.edge_dst
        self._ar = np.arange(n)
        self._commits = 0
        self._pending = None

    # ------------------------------------------------------------------

    def _build_groups(self, graph, groups, qos_slack, path_cap) -> bool:
        """Padded per-group path tensors: for QoS group g, ``g_nodes[g]``/
        ``g_edges[g]`` are the node/edge ids on its paths and ``A[g]``/
        ``B[g]`` are (path × member) 0/1 membership, so a group's critical
        path is one masked gather + einsum + max."""
        paths = graph.enumerate_paths(cap=path_cap * max(1, len(groups)))
        if not paths:
            return False
        exit_group = {}
        for gi, (exits, _t) in enumerate(groups):
            for x in np.asarray(exits).ravel().tolist():
                exit_group[int(x)] = gi
        by_group: list = [[] for _ in groups]
        for nodes, edges in paths:
            gi = exit_group.get(int(nodes[-1]))
            if gi is None:          # an exit outside every QoS group
                return False
            by_group[gi].append((nodes, edges))
        if any(not g or len(g) > path_cap for g in by_group):
            return False
        gq = len(groups)
        node_group = np.full(graph.n_nodes, -1, np.int64)
        g_nodes, g_edges, g_paths = [], [], []
        for gi, plist in enumerate(by_group):
            nset = np.unique(np.concatenate([p[0] for p in plist]))
            eset = np.unique(np.concatenate(
                [p[1] for p in plist] + [np.empty(0, np.int64)]))
            # a node on two groups' paths breaks the sparse-update model
            if (node_group[nset] >= 0).any():
                return False
            node_group[nset] = gi
            g_nodes.append(nset)
            g_edges.append(eset)
            g_paths.append(plist)
        mn = max(len(x) for x in g_nodes)
        me = max((len(x) for x in g_edges), default=0)
        mp = max(len(x) for x in g_paths)
        self.Gq = gq
        self._node_group = node_group
        self._g_nodes = np.zeros((gq, mn), np.int64)
        self._g_edges = np.zeros((gq, max(me, 1)), np.int64)
        self._A = np.zeros((gq, mp, mn))
        self._B = np.zeros((gq, mp, max(me, 1)))
        for gi in range(gq):
            nset, eset = g_nodes[gi], g_edges[gi]
            self._g_nodes[gi, :len(nset)] = nset
            self._g_edges[gi, :len(eset)] = eset
            for pi, (nodes, edges) in enumerate(g_paths[gi]):
                self._A[gi, pi, np.searchsorted(nset, nodes)] = 1.0
                if len(edges):
                    self._B[gi, pi, np.searchsorted(eset, edges)] = 1.0
        self._targets = np.array([t * (1.0 - qos_slack)
                                  for _x, t in groups])
        self.E = len(graph.edges)
        return True

    def _group_lats(self, QI: np.ndarray, PS: np.ndarray, rows: np.ndarray,
                    gs: np.ndarray) -> np.ndarray:
        """Fresh critical-path latency of group ``gs[k]`` under candidate
        row ``rows[k]`` — max over the group's paths of node durations
        plus co-location-priced edge transfers.  Padded slots carry zero
        membership, so their gathered values never contribute."""
        tab = self._tab
        gn = self._g_nodes[gs]                              # (a, mn)
        dur = tab.dur[gn, QI[rows[:, None], gn]]
        lat_p = np.einsum("apj,aj->ap", self._A[gs], dur)
        if self.E:
            ge = self._g_edges[gs]                          # (a, me)
            colo = PS[rows[:, None], self._esrc[ge]] \
                + PS[rows[:, None], self._edst[ge]] <= 1.0 + 1e-9
            ec = np.where(colo, tab.edge_t_colo[ge], tab.edge_t_host[ge])
            lat_p += np.einsum("apj,aj->ap", self._B[gs], ec)
        return lat_p.max(axis=1)

    # ------------------------------------------------------------------

    def rebase(self, NS: np.ndarray, QI: np.ndarray) -> None:
        """Install (copies of) the walker base states and derive every
        cache from scratch — the once-per-solve (and drift-refresh) pass
        that all later ``eval`` calls delta against."""
        tab = self._tab
        self._NS = NS.copy()
        self._QI = QI.copy()
        B, n = NS.shape
        ar = self._ar
        PS = tab.grid[QI]
        self._sq = (NS * PS).sum(axis=1)
        self._si = NS.sum(axis=1)
        self._sb = (NS * tab.bw[ar, QI]).sum(axis=1)
        self._sm = (NS * tab.foots).sum(axis=1)
        if self._iso is not None:
            self._tq = np.add.reduceat(NS * PS, self._iso[0], axis=1)
        self._tn = NS * tab.thpt[ar, QI] / self._norm
        if self._codes is not None:
            self._tn = apply_utility(self._tn, self._codes)
        S = self.S
        if S < n:
            idx = np.argpartition(self._tn, S - 1, axis=1)[:, :S]
        else:
            idx = np.tile(ar, (B, 1))
        vals = np.take_along_axis(self._tn, idx, axis=1)
        order = np.argsort(vals, axis=1)
        self._sm_idx = np.take_along_axis(idx, order, axis=1)
        self._sm_val = np.take_along_axis(vals, order, axis=1)
        # per-group latencies for every walker (fresh), the violation
        # census and the top-S2 LARGEST group latencies (max over
        # untouched groups for candidate rows)
        rows = np.repeat(np.arange(B), self.Gq)
        gs = np.tile(np.arange(self.Gq), B)
        self._lat_g = self._group_lats(QI, PS, rows, gs).reshape(B, self.Gq)
        self._viol = (self._lat_g > self._targets).sum(axis=1)
        S2 = self.S2
        if S2 < self.Gq:
            gidx = np.argpartition(-self._lat_g, S2 - 1, axis=1)[:, :S2]
        else:
            gidx = np.tile(np.arange(self.Gq), (B, 1))
        gvals = np.take_along_axis(self._lat_g, gidx, axis=1)
        gorder = np.argsort(-gvals, axis=1)
        self._lt_idx = np.take_along_axis(gidx, gorder, axis=1)
        self._lt_val = np.take_along_axis(gvals, gorder, axis=1)
        self._hist = np.zeros((B, len(tab.grid)), np.int64)
        np.add.at(self._hist, (np.arange(B)[:, None], QI), NS)

    # ------------------------------------------------------------------

    def eval(self, NS: np.ndarray, QI: np.ndarray, base: np.ndarray,
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Score candidate rows by delta against their base walkers
        (``base[r]`` indexes the states installed by ``rebase``).  Returns
        the ``_eval_many`` tuple (min_throughput, total_quota, latency,
        feasible) under the identical constraint thresholds."""
        tab = self._tab
        K, n = NS.shape
        PS = tab.grid[QI]
        NSb = self._NS[base]
        QIb = self._QI[base]
        changed = (NS != NSb) | (QI != QIb)
        rows, cols = np.nonzero(changed)          # row-major sorted
        nnz = len(rows)
        qin, nsn = QI[rows, cols], NS[rows, cols]
        qio, nso = QIb[rows, cols], NSb[rows, cols]
        psn, pso = tab.grid[qin], tab.grid[qio]

        dq = nsn * psn - nso * pso
        di = nsn - nso
        dbw = nsn * tab.bw[cols, qin] - nso * tab.bw[cols, qio]
        quota = self._sq[base] + np.bincount(rows, dq, minlength=K)
        inst = self._si[base] + np.bincount(rows, di, minlength=K)
        bwsum = self._sb[base] + np.bincount(rows, dbw, minlength=K)
        mem = self._sm[base] + np.bincount(rows, di * tab.foots[cols],
                                           minlength=K)

        if self._iso is not None:
            starts, floors, caps = self._iso
            T = len(floors)
            dtq = np.bincount(rows * T + self._tenant_of[cols], dq,
                              minlength=K * T).reshape(K, T)
            tq = self._tq[base] + dtq
        else:
            tq = None

        # objective: min normalized throughput = min(cached min over
        # untouched nodes, fresh values at the touched nodes)
        tn_new = nsn * tab.thpt[cols, qin] / self._norm[cols]
        if self._codes is not None:
            tn_new = apply_utility(tn_new, self._codes[cols])
        sm_i = self._sm_idx[base]
        sm_v = self._sm_val[base]
        if nnz:
            cnt = np.bincount(rows, minlength=K)
            starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
            pos = np.arange(nnz) - np.repeat(starts, cnt)
            tc = np.full((K, int(cnt.max())), -1, np.int64)
            tc[rows, pos] = cols
            touched = (sm_i[:, :, None] == tc[:, None, :]).any(axis=-1)
            unt_min = np.where(touched, np.inf, sm_v).min(axis=1)
            t_new_min = np.full(K, np.inf)
            np.minimum.at(t_new_min, rows, tn_new)
            thpt_min = np.minimum(unt_min, t_new_min)
        else:
            thpt_min = sm_v[:, 0].copy()

        # Constraint-5: re-score only the touched (row, group) pairs;
        # untouched groups read from the walker caches
        g_of = self._node_group[cols]
        ok = g_of >= 0
        key = np.unique(rows[ok] * self.Gq + g_of[ok]) if nnz else \
            np.empty(0, np.int64)
        rows_a, gs_a = key // self.Gq, key % self.Gq
        lt_v = self._lt_val[base]
        if key.size:
            newlat = self._group_lats(QI, PS, rows_a, gs_a)
            cnt_a = np.bincount(rows_a, minlength=K)
            starts = np.concatenate(([0], np.cumsum(cnt_a)[:-1]))
            pos = np.arange(len(rows_a)) - np.repeat(starts, cnt_a)
            tg = np.full((K, int(cnt_a.max())), -1, np.int64)
            tg[rows_a, pos] = gs_a
            gtouched = (self._lt_idx[base][:, :, None]
                        == tg[:, None, :]).any(axis=-1)
            unt_max = np.where(gtouched, -np.inf, lt_v).max(axis=1)
            t_new_max = np.full(K, -np.inf)
            np.maximum.at(t_new_max, rows_a, newlat)
            lat = np.maximum(unt_max, t_new_max)
            dviol = (newlat > self._targets[gs_a]).astype(np.int64) \
                - (self._lat_g[base[rows_a], gs_a]
                   > self._targets[gs_a]).astype(np.int64)
            viol = self._viol[base] + np.bincount(rows_a, dviol,
                                                  minlength=K)
        else:
            newlat = np.empty(0)
            lat = lt_v[:, 0].copy()
            viol = self._viol[base].copy()

        feas = quota <= self._cap_quota
        if tq is not None:
            feas &= (tq >= floors - 1e-9).all(axis=1)
            feas &= (tq <= caps + 1e-9).all(axis=1)
        feas &= inst <= self._cap_inst
        if self._bw_on:
            feas &= bwsum <= self._cap_bw
        feas &= mem <= self._cap_mem
        feas &= viol == 0

        # Constraint-1 refined: delta histograms + memoized integer FFD for
        # rows past the sufficient condition (same filter as the dense path)
        dh = np.zeros((K, len(tab.grid)), np.int64)
        if nnz:
            np.add.at(dh, (rows, qin), nsn)
            np.add.at(dh, (rows, qio), -nso)
        need = np.flatnonzero(feas & (quota > (1.0 - PS.max(axis=1))
                                      * self.n_devices))
        if need.size:
            hn = self._hist[base[need]] + dh[need]
            for j, counts in zip(need, hn.tolist()):
                feas[j] = self._alloc._ffd_cached(counts, self.n_devices)

        self._pending = (NS, QI, quota, inst, bwsum, mem, rows, cols,
                         tn_new, rows_a, gs_a, newlat, viol, dh, tq)
        return thpt_min, quota, lat, feas

    # ------------------------------------------------------------------

    def commit(self, walkers: np.ndarray, picked: np.ndarray) -> None:
        """Fold accepted candidate rows (from the last ``eval``) into the
        walker caches: ``walkers[i]`` takes candidate row ``picked[i]``."""
        (NS, QI, quota, inst, bwsum, mem, rows, cols, tn_new,
         rows_a, gs_a, newlat, viol, dh, tq) = self._pending
        n = self.n
        for wi, r in zip(np.asarray(walkers).tolist(),
                         np.asarray(picked).tolist()):
            self._NS[wi] = NS[r]
            self._QI[wi] = QI[r]
            self._sq[wi] = quota[r]
            self._si[wi] = inst[r]
            self._sb[wi] = bwsum[r]
            self._sm[wi] = mem[r]
            if tq is not None:
                self._tq[wi] = tq[r]
            m = rows == r
            if m.any():
                self._tn[wi, cols[m]] = tn_new[m]
                row = self._tn[wi]
                if self.S < n:
                    idx = np.argpartition(row, self.S - 1)[:self.S]
                else:
                    idx = self._ar
                idx = idx[np.argsort(row[idx])]
                self._sm_idx[wi] = idx
                self._sm_val[wi] = row[idx]
            ma = rows_a == r
            if ma.any():
                self._lat_g[wi, gs_a[ma]] = newlat[ma]
                self._viol[wi] = viol[r]
                lrow = self._lat_g[wi]
                if self.S2 < self.Gq:
                    gidx = np.argpartition(-lrow, self.S2 - 1)[:self.S2]
                else:
                    gidx = np.arange(self.Gq)
                gidx = gidx[np.argsort(-lrow[gidx])]
                self._lt_idx[wi] = gidx
                self._lt_val[wi] = lrow[gidx]
            self._hist[wi] += dh[r]
        self._commits += 1
        if self._commits % self.REFRESH_EVERY == 0:
            self.rebase(self._NS, self._QI)
