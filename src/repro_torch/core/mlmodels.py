"""Prediction models used by the Camelot performance predictor (paper §VII-A):
Linear Regression, CART Decision Tree, and Random Forest — written from
scratch on numpy (no sklearn in this environment).

The paper evaluates all three (Fig. 12) and picks the Decision Tree for
duration/bandwidth/throughput (accuracy of RF at ~1/5 the inference cost) and
LR for FLOPs / memory footprint (exactly linear in batch size).

Inference is the allocator's hot path (~4·n predictor calls per SA
candidate), so trees are *flattened* after fit into parallel node arrays
(``feature_``/``threshold_``/``value_``/``left_``/``right_``) and
``predict`` walks all rows level-by-level with masked numpy indexing —
no Python recursion per row.  A forest stacks every tree's node arrays
into one arena so all trees advance together in a single (T, N) index
update per level.  The array walk takes the same ``<=`` branches as the
node-by-node reference walk, so predictions are bit-identical
(``_predict_recursive`` is kept for exactly that assertion).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# --------------------------------------------------------------------------
# Linear regression (normal equations, ridge-stabilised)
# --------------------------------------------------------------------------

class LinearRegression:
    def __init__(self, ridge: float = 1e-8):
        self.ridge = ridge
        self.coef_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LinearRegression":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        a = xb.T @ xb + self.ridge * np.eye(xb.shape[1])
        self.coef_ = np.linalg.solve(a, xb.T @ y)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        return xb @ self.coef_


# --------------------------------------------------------------------------
# CART regression tree
# --------------------------------------------------------------------------

@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    value: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None


class DecisionTreeRegressor:
    """CART with variance-reduction splits."""

    def __init__(self, max_depth: int = 12, min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, seed: int = 0):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = np.random.default_rng(seed)
        self.root: Optional[_Node] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self.root = self._build(x, y, 0)
        self._flatten()
        return self

    def _flatten(self) -> None:
        """Lower the node tree into parallel arrays (preorder indexing);
        leaves carry ``left_ == right_ == -1``."""
        feats, thrs, vals, lefts, rights = [], [], [], [], []

        def emit(node: _Node) -> int:
            idx = len(feats)
            feats.append(node.feature)
            thrs.append(node.threshold)
            vals.append(node.value)
            lefts.append(-1)
            rights.append(-1)
            if not node.is_leaf:
                lefts[idx] = emit(node.left)
                rights[idx] = emit(node.right)
            return idx

        emit(self.root)
        self.feature_ = np.array(feats, np.int64)
        self.threshold_ = np.array(thrs, np.float64)
        self.value_ = np.array(vals, np.float64)
        self.left_ = np.array(lefts, np.int64)
        self.right_ = np.array(rights, np.int64)

    def _best_split(self, x, y):
        n, d = x.shape
        feats = np.arange(d)
        if self.max_features is not None and self.max_features < d:
            feats = self.rng.choice(d, self.max_features, replace=False)
        best = (None, None, np.inf)
        for f in feats:
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum = np.cumsum(ys)
            csq = np.cumsum(ys ** 2)
            total, total_sq = csum[-1], csq[-1]
            ks = np.arange(self.min_samples_leaf,
                           n - self.min_samples_leaf + 1)
            if len(ks) == 0:
                continue
            # skip splits between equal feature values (ks <= n-1 here)
            ks = ks[xs[ks - 1] < xs[ks]]
            if len(ks) == 0:
                continue
            left_sum, left_sq = csum[ks - 1], csq[ks - 1]
            right_sum, right_sq = total - left_sum, total_sq - left_sq
            sse = ((left_sq - left_sum ** 2 / ks)
                   + (right_sq - right_sum ** 2 / (n - ks)))
            i = int(np.argmin(sse))
            if sse[i] < best[2]:
                k = int(ks[i])
                thr = 0.5 * (xs[k - 1] + xs[min(k, n - 1)])
                best = (int(f), float(thr), float(sse[i]))
        return best

    def _build(self, x, y, depth) -> _Node:
        node = _Node(value=float(np.mean(y)))
        if (depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf
                or np.ptp(y) == 0.0):
            return node
        f, thr, sse = self._best_split(x, y)
        if f is None:
            return node
        mask = x[:, f] <= thr
        if mask.all() or (~mask).all():
            return node
        node.feature, node.threshold = f, thr
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched array-walk prediction: every row descends one level per
        masked update (≤ max_depth iterations total, no per-row recursion)."""
        x = np.asarray(x, np.float64)
        idx = np.zeros(len(x), np.int64)
        rows = np.arange(len(x))
        while True:
            left = self.left_[idx]
            live = left >= 0
            if not live.any():
                break
            at = idx[live]
            go_left = x[rows[live], self.feature_[at]] <= self.threshold_[at]
            idx[live] = np.where(go_left, left[live], self.right_[at])
        return self.value_[idx]

    def _predict_recursive(self, x: np.ndarray) -> np.ndarray:
        """Reference node-by-node walk (tests pin ``predict`` against it)."""
        x = np.asarray(x, np.float64)
        out = np.empty(len(x))
        for i, row in enumerate(x):
            node = self.root
            while not node.is_leaf:
                node = node.left if row[node.feature] <= node.threshold \
                    else node.right
            out[i] = node.value
        return out


# --------------------------------------------------------------------------
# Random forest (bagging)
# --------------------------------------------------------------------------

class RandomForestRegressor:
    def __init__(self, n_trees: int = 20, max_depth: int = 12,
                 min_samples_leaf: int = 2, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees: list[DecisionTreeRegressor] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        n, d = x.shape
        max_feats = max(1, int(np.ceil(d / 2)))
        self.trees = []
        for t in range(self.n_trees):
            idx = rng.integers(0, n, n)
            tree = DecisionTreeRegressor(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                max_features=max_feats, seed=self.seed + t + 1)
            tree.fit(x[idx], y[idx])
            self.trees.append(tree)
        self._stack()
        return self

    def _stack(self) -> None:
        """Concatenate every tree's flattened node arrays into one arena
        (child indices rebased) so predict advances all trees at once."""
        offsets = np.cumsum([0] + [len(t.value_) for t in self.trees])
        self._roots = offsets[:-1]
        self._feature = np.concatenate([t.feature_ for t in self.trees])
        self._threshold = np.concatenate([t.threshold_ for t in self.trees])
        self._value = np.concatenate([t.value_ for t in self.trees])
        self._left = np.concatenate(
            [np.where(t.left_ >= 0, t.left_ + off, -1)
             for t, off in zip(self.trees, offsets)])
        self._right = np.concatenate(
            [np.where(t.right_ >= 0, t.right_ + off, -1)
             for t, off in zip(self.trees, offsets)])

    def predict(self, x: np.ndarray) -> np.ndarray:
        """One (T, N) masked index update per tree level — the whole forest
        descends together, then tree outputs reduce in a single mean."""
        x = np.asarray(x, np.float64)
        n = len(x)
        idx = np.repeat(self._roots[:, None], n, axis=1)        # (T, N)
        cols = np.broadcast_to(np.arange(n), idx.shape)
        while True:
            left = self._left[idx]
            live = left >= 0
            if not live.any():
                break
            at = idx[live]
            go_left = x[cols[live], self._feature[at]] <= self._threshold[at]
            idx[live] = np.where(go_left, left[live], self._right[at])
        return self._value[idx].mean(axis=0)


def mean_absolute_percentage_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    denom = np.maximum(np.abs(y_true), 1e-12)
    return float(np.mean(np.abs(y_true - y_pred) / denom))
