"""Fault scripts for the twin execution planes.

A :class:`FaultSpec` is a seeded, dict-round-trippable script of bad
events injected into a simulation (or mirrored onto the live engine):

* :class:`DeviceFailure` — a device dies at ``time`` and never returns.
  Instances placed on it stop accepting work; in-flight batches on the
  device fail (and may be retried on surviving instances).
* :class:`Straggle` — a device slows down by ``factor`` from ``time``
  until ``until`` (forever if ``None``).  Models thermal throttling,
  noisy neighbours, ECC retirement.
* :class:`TransientErrors` — each stage execution inside the active
  window independently fails with probability ``rate`` (seeded draw).
  Models CUDA ECC blips, OOM races, flaky kernels.

The spec is deliberately tiny and declarative so that benchmarks and
chaos tests can generate, persist, and replay identical fault scripts:
``FaultSpec.from_dict(spec.to_dict())`` round-trips exactly, and all
randomness (transient-error draws) comes from ``numpy`` generators
seeded with ``spec.seed`` — *separate* from the workload RNG, so a
no-fault run is bit-identical to a run with no ``FaultSpec`` at all.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = ["DeviceFailure", "Straggle", "TransientErrors", "FaultSpec"]


@dataclass(frozen=True)
class DeviceFailure:
    """Device ``device`` dies permanently at simulation time ``time``."""

    time: float
    device: int

    def to_dict(self) -> Dict:
        return {"time": self.time, "device": self.device}

    @classmethod
    def from_dict(cls, d: Dict) -> "DeviceFailure":
        return cls(time=float(d["time"]), device=int(d["device"]))


@dataclass(frozen=True)
class Straggle:
    """Device ``device`` runs ``factor``x slower on [``time``, ``until``)."""

    time: float
    device: int
    factor: float = 3.0
    until: float = math.inf

    def to_dict(self) -> Dict:
        return {"time": self.time, "device": self.device,
                "factor": self.factor,
                "until": None if math.isinf(self.until) else self.until}

    @classmethod
    def from_dict(cls, d: Dict) -> "Straggle":
        until = d.get("until")
        return cls(time=float(d["time"]), device=int(d["device"]),
                   factor=float(d.get("factor", 3.0)),
                   until=math.inf if until is None else float(until))


@dataclass(frozen=True)
class TransientErrors:
    """Stage executions fail i.i.d. with ``rate`` on [``start``, ``until``)."""

    rate: float
    start: float = 0.0
    until: float = math.inf

    def to_dict(self) -> Dict:
        return {"rate": self.rate, "start": self.start,
                "until": None if math.isinf(self.until) else self.until}

    @classmethod
    def from_dict(cls, d: Dict) -> "TransientErrors":
        until = d.get("until")
        return cls(rate=float(d["rate"]), start=float(d.get("start", 0.0)),
                   until=math.inf if until is None else float(until))


@dataclass(frozen=True)
class FaultSpec:
    """A complete seeded fault script for one run.

    ``max_retries`` bounds how many times a failed stage execution is
    re-dispatched before its whole batch is abandoned (counted as
    failed queries).  ``seed`` drives the transient-error draws only —
    workload randomness is untouched, which is what keeps no-fault runs
    bit-identical to fault-free simulation.
    """

    device_failures: Tuple[DeviceFailure, ...] = ()
    straggles: Tuple[Straggle, ...] = ()
    transient: TransientErrors = None
    seed: int = 0
    max_retries: int = 2

    def active(self) -> bool:
        """True if this spec injects anything at all."""
        return bool(self.device_failures or self.straggles
                    or (self.transient is not None
                        and self.transient.rate > 0.0))

    def to_dict(self) -> Dict:
        return {
            "device_failures": [f.to_dict() for f in self.device_failures],
            "straggles": [s.to_dict() for s in self.straggles],
            "transient": (None if self.transient is None
                          else self.transient.to_dict()),
            "seed": self.seed,
            "max_retries": self.max_retries,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSpec":
        trans = d.get("transient")
        return cls(
            device_failures=tuple(DeviceFailure.from_dict(f)
                                  for f in d.get("device_failures", [])),
            straggles=tuple(Straggle.from_dict(s)
                            for s in d.get("straggles", [])),
            transient=None if trans is None
            else TransientErrors.from_dict(trans),
            seed=int(d.get("seed", 0)),
            max_retries=int(d.get("max_retries", 2)),
        )
