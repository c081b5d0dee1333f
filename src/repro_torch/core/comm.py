"""Inter-microservice communication (paper §VI).

Two mechanisms:
  * host-staged (the default on GPUs): device -> host -> device over PCIe,
    with bandwidth-sharing contention;
  * global-memory (Camelot): the producer passes a handle and the consumer
    reads the buffer in place — no PCIe traffic, a small fixed overhead, so
    tiny transfers (< ~0.02 MB, paper Fig. 11) are better off host-staged.

``CommModel``/``select_mechanism`` price and pick a mechanism per edge
payload (the rule the execution core shares with the simulator);
``DeviceHandoff``/``HostStagedChannel`` are the live mechanisms on torch
tensors and ``EdgeChannel`` routes each real payload between them.  Within
one process on one card the global-memory hand-off is the CUDA tensor
itself, passed by reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.types import DeviceSpec


@dataclass
class CommModel:
    device: DeviceSpec
    global_memory_enabled: bool = True
    ici_bandwidth: float = 50e9        # cross-device interconnect B/s
    ici_latency: float = 2e-6
    # a measured Fig. 11 crossover; None keeps the modelled constant
    crossover_override: Optional[float] = None

    def host_staged_time(self, nbytes: float, concurrent: int = 1) -> float:
        """Two PCIe copies (D2H + H2D) with ``concurrent`` streams sharing
        the link."""
        dev = self.device
        per_stream = min(dev.host_link_stream,
                         dev.host_link_total / max(concurrent, 1))
        return 2 * (dev.host_link_latency + nbytes / per_stream)

    def global_memory_time(self, nbytes: float) -> float:
        """Handle pass + map; data never moves."""
        return self.device.ipc_latency

    def ici_time(self, nbytes: float) -> float:
        return self.ici_latency + nbytes / self.ici_bandwidth

    def transfer_time(self, nbytes: float, same_device: bool,
                      concurrent: int = 1, cross_pod: bool = False) -> float:
        if same_device and self.global_memory_enabled:
            return min(self.global_memory_time(nbytes),
                       self.host_staged_time(nbytes, concurrent))
        if cross_pod or not self.global_memory_enabled:
            return self.host_staged_time(nbytes, concurrent)
        return min(self.ici_time(nbytes),
                   self.host_staged_time(nbytes, concurrent))

    def crossover_bytes(self) -> float:
        """Data size above which global-memory wins (paper: ~0.02 MB)."""
        if self.crossover_override is not None:
            return float(self.crossover_override)
        dev = self.device
        return max(0.0, (dev.ipc_latency - 2 * dev.host_link_latency)
                   * dev.host_link_stream / 2)


GLOBAL_MEMORY = "global-memory"
HOST_STAGED = "host-staged"
ICI = "ici"


def select_mechanism(comm: Optional[CommModel], nbytes: float,
                     same_device: bool, cross_pod: bool = False) -> str:
    """Pick the communication mechanism for one edge payload: global
    memory only when producer and consumer share a device AND the payload
    is above the Fig. 11 crossover."""
    if comm is None or not comm.global_memory_enabled or cross_pod:
        return HOST_STAGED
    if same_device:
        return (HOST_STAGED if nbytes < comm.crossover_bytes()
                else GLOBAL_MEMORY)
    return (ICI if comm.ici_time(nbytes) < comm.host_staged_time(nbytes)
            else HOST_STAGED)


def mechanism_time(comm: CommModel, mechanism: str, nbytes: float,
                   concurrent: int = 1) -> float:
    """Modelled cost of moving ``nbytes`` via the chosen mechanism."""
    if mechanism == GLOBAL_MEMORY:
        return comm.global_memory_time(nbytes)
    if mechanism == ICI:
        return comm.ici_time(nbytes)
    return comm.host_staged_time(nbytes, concurrent)


# --------------------------------------------------------------------------
# Live mechanisms on torch tensors
# --------------------------------------------------------------------------

class DeviceHandoff:
    """Global-memory communication, live path: the producer's output
    tensor is handed to the consumer by reference — no copy, no host round
    trip.  Setup (the IPC-channel analogue) happens once."""

    def __init__(self):
        self._setup_done = False
        self.setup_time = 0.0
        self.transfers = 0

    def setup(self):
        t0 = time.perf_counter()
        self._setup_done = True
        self.setup_time = time.perf_counter() - t0

    def send(self, tensor: torch.Tensor) -> torch.Tensor:
        if not self._setup_done:
            self.setup()
        self.transfers += 1
        return tensor          # handle pass: zero copy


class HostStagedChannel:
    """The default mechanism, live path: copy to host memory and back to
    the tensor's device — the D2H + H2D round trip of paper Fig. 8(a)."""

    def __init__(self):
        self.transfers = 0
        self.bytes_moved = 0

    def send(self, tensor: torch.Tensor) -> torch.Tensor:
        host = tensor.to("cpu", copy=True)            # D2H
        self.transfers += 1
        self.bytes_moved += host.numel() * host.element_size() * 2
        return host.to(tensor.device, copy=True)      # H2D


class EdgeChannel:
    """Live per-edge channel owning BOTH mechanisms; each payload is routed
    by ``select_mechanism`` (crossover + co-location), or pinned to one
    mechanism with ``force`` ("device" / "host") for A/B runs."""

    def __init__(self, comm: Optional[CommModel] = None,
                 force: Optional[str] = None):
        if force not in (None, "device", "host"):
            raise ValueError(f"force must be None, 'device' or 'host', "
                             f"got {force!r}")
        self.comm = comm
        self.force = force
        self.device_handoff = DeviceHandoff()
        self.host_staged = HostStagedChannel()
        self.picks = {GLOBAL_MEMORY: 0, HOST_STAGED: 0}

    def select(self, nbytes: float, same_device: bool = True) -> str:
        if self.force == "device":
            return GLOBAL_MEMORY
        if self.force == "host":
            return HOST_STAGED
        mech = select_mechanism(self.comm, nbytes, same_device)
        # one host: the interconnect collapses to the in-memory hand-off
        return GLOBAL_MEMORY if mech == ICI else mech

    def send(self, tensor: torch.Tensor, same_device: bool = True):
        nbytes = tensor.numel() * tensor.element_size()
        mech = self.select(nbytes, same_device)
        self.picks[mech] += 1
        if mech == GLOBAL_MEMORY:
            return self.device_handoff.send(tensor)
        return self.host_staged.send(tensor)

    @property
    def transfers(self) -> int:
        return self.device_handoff.transfers + self.host_staged.transfers

    @property
    def bytes_moved(self) -> int:
        return self.host_staged.bytes_moved
