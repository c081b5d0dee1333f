"""Camelot performance predictor (paper §VII-A).

Per microservice, three models over features (batch size, compute quota):
duration, global-memory bandwidth usage, throughput — Decision Trees (the
paper's pick: DT error close to RF at <1 ms inference).  FLOPs and memory
footprint are linear in batch size and use Linear Regression.

Training samples come from solo-run profiling (paper: nvprof/Nsight offline;
here: the ground-truth curves sampled with measurement noise, or real step
timings from the live serving engine at reduced scale — see
``profile_from_engine``).

The tabulation contract (policy hot path)
-----------------------------------------
The allocator only ever queries quotas on the ``QUOTA_STEP`` grid and batch
sizes from the profiling lattice, so ``TabulatedStagePredictor`` precomputes
duration/bandwidth/throughput over the full (batch-lattice × quota-grid)
product once per ``fit`` — a handful of batched model calls — and serves
**on-grid lookups exactly** (the tables store the model's own outputs, and
the DT is piecewise constant, so a lookup is bit-identical to a fresh model
call at that point).  Off-grid queries fall back to the underlying model
transparently.  ``quota_row`` hands the allocator a whole per-quota table
row so its candidate evaluation is pure numpy indexing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.mlmodels import (DecisionTreeRegressor, LinearRegression,
                                       RandomForestRegressor,
                                       mean_absolute_percentage_error)
from repro_torch.core.types import QUOTA_GRID, DeviceSpec, MicroserviceProfile

DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
# profiling quota axis == the allocator's decision lattice (types.QUOTA_GRID)
# so tabulated predictors serve every allocator query from the table
DEFAULT_QUOTAS = tuple(QUOTA_GRID.tolist())


@dataclass
class ProfileSample:
    batch: int
    quota: float
    duration: float
    bandwidth: float
    throughput: float


def collect_samples(profile: MicroserviceProfile, device: DeviceSpec,
                    batches: Sequence[int] = DEFAULT_BATCHES,
                    quotas: Sequence[float] = DEFAULT_QUOTAS,
                    noise: float = 0.03, seed: int = 0,
                    repeats: int = 3) -> list[ProfileSample]:
    """Solo-run profiling of the ground truth with measurement noise."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        mem = profile.mem_bytes(b)
        for q in quotas:
            # deterministic ground truth: one curve evaluation per (b, q);
            # only the measurement-noise draw varies across repeats
            d = profile.duration(b, q, device)
            for _ in range(repeats):
                d_obs = d * float(1 + rng.normal(0, noise))
                out.append(ProfileSample(
                    batch=b, quota=q, duration=d_obs,
                    bandwidth=mem / d_obs,
                    throughput=b / d_obs))
    return out


class StagePredictor:
    """Trained predictor for one microservice stage."""

    def __init__(self, name: str, model_kind: str = "dt", seed: int = 0):
        assert model_kind in ("lr", "dt", "rf")
        self.name = name
        self.model_kind = model_kind
        self.seed = seed
        self._models: Dict[str, object] = {}
        self._flops_lr = LinearRegression()
        self._footprint_lr = LinearRegression()
        self.fit_errors: Dict[str, float] = {}
        self.predict_time: float = 0.0
        self.predict_calls: int = 0

    def reset_counters(self) -> None:
        """Zero the accumulated inference-time/call counters."""
        self.predict_time = 0.0
        self.predict_calls = 0

    def _new_model(self):
        if self.model_kind == "lr":
            return LinearRegression()
        if self.model_kind == "dt":
            return DecisionTreeRegressor(max_depth=12, seed=self.seed)
        return RandomForestRegressor(n_trees=20, seed=self.seed)

    def fit(self, samples: Sequence[ProfileSample],
            profile: Optional[MicroserviceProfile] = None,
            holdout: float = 0.3) -> "StagePredictor":
        x = np.array([[s.batch, s.quota] for s in samples], np.float64)
        ys = {
            "duration": np.array([s.duration for s in samples]),
            "bandwidth": np.array([s.bandwidth for s in samples]),
            "throughput": np.array([s.throughput for s in samples]),
        }
        rng = np.random.default_rng(self.seed)
        idx = rng.permutation(len(x))
        n_tr = max(1, int(len(x) * (1 - holdout)))
        tr, te = idx[:n_tr], idx[n_tr:]
        for key, y in ys.items():
            m = self._new_model()
            m.fit(x[tr], y[tr])
            self._models[key] = m
            if len(te):
                self.fit_errors[key] = mean_absolute_percentage_error(
                    y[te], m.predict(x[te]))
        # LR for FLOPs / footprint (linear in batch, §VII-A)
        if profile is not None:
            bs = np.array(sorted({s.batch for s in samples}), np.float64)
            self._flops_lr.fit(bs[:, None],
                               np.array([profile.flops(int(b)) for b in bs]))
            self._footprint_lr.fit(
                bs[:, None], np.array([profile.footprint(int(b)) for b in bs]))
        return self

    # --- prediction API used by the allocator -------------------------
    def _predict(self, key: str, batch: float, quota: float) -> float:
        t0 = time.perf_counter()
        v = float(self._models[key].predict(
            np.array([[batch, quota]], np.float64))[0])
        self.predict_time += time.perf_counter() - t0
        self.predict_calls += 1
        return max(v, 1e-9)

    def predict_many(self, key: str, x: np.ndarray) -> np.ndarray:
        """Batched model inference over N (batch, quota) rows — one array
        walk instead of N scalar calls."""
        t0 = time.perf_counter()
        v = np.maximum(self._models[key].predict(
            np.asarray(x, np.float64)), 1e-9)
        self.predict_time += time.perf_counter() - t0
        self.predict_calls += len(v)
        return v

    def quota_row(self, key: str, batch: int,
                  quotas: Sequence[float]) -> np.ndarray:
        """Model predictions for one batch size across a quota vector (the
        allocator's per-solve table row)."""
        q = np.asarray(quotas, np.float64)
        x = np.column_stack([np.full(len(q), batch, np.float64), q])
        return self.predict_many(key, x)

    def duration(self, batch: int, quota: float) -> float:
        return self._predict("duration", batch, quota)

    def bandwidth(self, batch: int, quota: float) -> float:
        return self._predict("bandwidth", batch, quota)

    def throughput(self, batch: int, quota: float) -> float:
        return self._predict("throughput", batch, quota)

    def flops(self, batch: int) -> float:
        return float(self._flops_lr.predict(
            np.array([[batch]], np.float64))[0])

    def footprint(self, batch: int) -> float:
        return float(self._footprint_lr.predict(
            np.array([[batch]], np.float64))[0])


class TabulatedStagePredictor(StagePredictor):
    """StagePredictor with O(1) on-grid inference.

    ``fit`` additionally tabulates every metric over the (batch-lattice ×
    quota-grid) product in a few batched model calls.  Scalar queries that
    land on the grid (the allocator's only access pattern — quotas are
    multiples of ``QUOTA_STEP``, batches come from the profiling lattice)
    are answered by pure numpy indexing and are **exact**: the tables hold
    the model's own outputs and the DT is piecewise constant.  Anything
    off-grid silently falls back to the model, so this is a drop-in
    replacement for StagePredictor everywhere.
    """

    #: quota grid — must stay aligned with the allocator's QUOTA_STEP grid
    GRID_DECIMALS = 2

    def __init__(self, name: str, model_kind: str = "dt", seed: int = 0,
                 quotas: Sequence[float] = DEFAULT_QUOTAS):
        super().__init__(name, model_kind, seed=seed)
        self.grid_quotas = np.round(np.asarray(quotas, np.float64),
                                    self.GRID_DECIMALS)
        self._quota_step = float(self.grid_quotas[0])
        self.grid_batches: Dict[int, int] = {}
        self._tables: Dict[str, np.ndarray] = {}

    def fit(self, samples: Sequence[ProfileSample],
            profile: Optional[MicroserviceProfile] = None,
            holdout: float = 0.3) -> "TabulatedStagePredictor":
        super().fit(samples, profile=profile, holdout=holdout)
        batches = sorted({s.batch for s in samples})
        self.grid_batches = {int(b): i for i, b in enumerate(batches)}
        bb, qq = np.meshgrid(np.asarray(batches, np.float64),
                             self.grid_quotas, indexing="ij")
        x = np.column_stack([bb.ravel(), qq.ravel()])
        shape = (len(batches), len(self.grid_quotas))
        for key in ("duration", "bandwidth", "throughput"):
            self._tables[key] = self.predict_many(key, x).reshape(shape)
        self.reset_counters()             # table build is fit cost, not
        return self                       # inference cost

    def _grid_index(self, batch: float, quota: float) -> Optional[tuple]:
        bi = self.grid_batches.get(int(batch)) \
            if float(batch) == int(batch) else None
        if bi is None:
            return None
        qi = int(round(quota / self._quota_step)) - 1
        if 0 <= qi < len(self.grid_quotas) and \
                abs(self.grid_quotas[qi] - quota) < 1e-6:
            return bi, qi
        return None

    def _predict(self, key: str, batch: float, quota: float) -> float:
        hit = self._grid_index(batch, quota)
        if hit is None:                       # off-grid: model fallback
            return super()._predict(key, batch, quota)
        self.predict_calls += 1
        return float(self._tables[key][hit])

    def quota_row(self, key: str, batch: int,
                  quotas: Sequence[float]) -> np.ndarray:
        """Whole-grid lookup when ``quotas`` IS the table's quota grid (the
        allocator's per-solve request); otherwise defer to the model."""
        q = np.round(np.asarray(quotas, np.float64), self.GRID_DECIMALS)
        bi = self.grid_batches.get(int(batch)) \
            if float(batch) == int(batch) else None
        if bi is not None and len(q) == len(self.grid_quotas) and \
                np.array_equal(q, self.grid_quotas):
            self.predict_calls += len(q)
            return self._tables[key][bi].copy()
        return super().quota_row(key, batch, quotas)


def tabulate_physics(profile: MicroserviceProfile, device: DeviceSpec,
                     max_batch: int, quotas: Sequence[float],
                     ) -> Dict[float, tuple]:
    """Tabulate one node's ground-truth sim physics.

    Returns ``{quota: (dur, bw)}`` where ``dur[b]``/``bw[b]`` hold the node's
    ``MicroserviceProfile.duration``/``bandwidth`` for batch ``b`` (index 0
    unused) on ``device``, for every distinct placed ``quota``.  The table
    stores the curves' own outputs at exactly the (batch, quota) points the
    simulator's hot loop would evaluate — in-flight batches are always
    1..max_batch — so an on-table lookup is bit-identical to a fresh call;
    the same contract (exact on-grid, caller falls back off-grid) as
    ``TabulatedStagePredictor``."""
    out: Dict[float, tuple] = {}
    for q in quotas:
        if q in out:
            continue
        dur = [0.0] * (max_batch + 1)
        bw = [0.0] * (max_batch + 1)
        for b in range(1, max_batch + 1):
            dur[b] = profile.duration(b, q, device)
            bw[b] = profile.bandwidth(b, q, device)
        out[q] = (dur, bw)
    return out


class PipelinePredictor:
    """Per-node predictors for one service, built from offline profiling.

    ``stages[i]`` is the predictor for node i of the ``ServiceGraph`` (the
    allocator indexes by node id); a chain's stage order is the node order,
    so chain-era callers are unchanged."""

    def __init__(self, stage_predictors: Sequence[StagePredictor]):
        self.stages = list(stage_predictors)

    def total_predict_time(self) -> float:
        """Accumulated model-inference seconds across every stage (the
        allocator reports the delta per solve in ``SolveResult``)."""
        return sum(s.predict_time for s in self.stages)

    def total_predict_calls(self) -> int:
        return sum(s.predict_calls for s in self.stages)

    def reset_counters(self) -> None:
        for s in self.stages:
            s.reset_counters()

    @classmethod
    def from_profiles(cls, profiles: Sequence[MicroserviceProfile],
                      device: DeviceSpec, model_kind: str = "dt",
                      noise: float = 0.03, seed: int = 0,
                      batches: Sequence[int] = DEFAULT_BATCHES,
                      tabulate: bool = True) -> "PipelinePredictor":
        """``tabulate=True`` (default) builds ``TabulatedStagePredictor``s —
        identical predictions (on-grid lookups are exact), O(1) hot path.
        Pass False for the scalar baseline (e.g. benchmarking)."""
        mk = TabulatedStagePredictor if tabulate else StagePredictor
        preds = []
        for i, p in enumerate(profiles):
            samples = collect_samples(p, device, noise=noise, seed=seed + i,
                                      batches=batches)
            preds.append(mk(p.name, model_kind, seed=seed + i)
                         .fit(samples, profile=p))
        return cls(preds)

    @classmethod
    def from_graph(cls, graph, device: DeviceSpec, model_kind: str = "dt",
                   noise: float = 0.03, seed: int = 0,
                   batches: Sequence[int] = DEFAULT_BATCHES,
                   tabulate: bool = True) -> "PipelinePredictor":
        """Profile every node of a ``ServiceGraph`` (topology-agnostic —
        solo-run profiling is per node)."""
        return cls.from_profiles(graph.nodes, device, model_kind=model_kind,
                                 noise=noise, seed=seed, batches=batches,
                                 tabulate=tabulate)


def profile_from_engine(name: str, timings: Sequence[tuple], weights_bytes: float,
                        act_bytes_per_query: float, device: DeviceSpec,
                        host_bytes_per_query: float = 0.0,
                        ) -> MicroserviceProfile:
    """Build a MicroserviceProfile from REAL measured (batch, seconds) step
    timings (live engine at reduced scale) by fitting the linear FLOPs model
    against the device's effective rate — the calibrated-hybrid path:
    measured stage timings, the simulator's physics fitted to them."""
    arr = np.array(timings, np.float64)
    lr = LinearRegression().fit(arr[:, :1], arr[:, 1])
    per_query_t = max(lr.coef_[0], 1e-9)
    overhead = max(lr.coef_[1], 1e-6)
    return MicroserviceProfile(
        name=name,
        flops_per_query=per_query_t * device.peak_flops,
        mem_bytes_per_query=per_query_t * device.mem_bandwidth * 0.3,
        host_bytes_per_query=host_bytes_per_query,
        weights_bytes=weights_bytes,
        act_bytes_per_query=act_bytes_per_query,
        overhead=overhead)
