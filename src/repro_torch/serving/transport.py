"""Zero-copy inter-process payload transport (paper §VI, executed live).

The port of ``repro/serving/transport.py``.  The process-parallel serving
backend moves stage outputs between worker processes with the SAME two
mechanisms the paper prices for GPUs:

  * **arena hand-off** (the global-memory mechanism, §VI-B): the producer
    worker writes the payload ONCE into a slot of its arena and ships only
    a tiny ``PayloadRef`` descriptor through the control queue; the
    consumer maps the slot as a zero-copy view.  On the host the arena is
    a ``ShmArena`` — a ``multiprocessing.shared_memory`` ring buffer of
    numpy payloads, the reference's realisation, kept bit-equal; on the
    card it is a ``DeviceArena`` — the same slot ring with its payload
    slots in device memory, mapped into every worker by CUDA IPC
    (``CUDA_IPC``).
  * **pickle-over-queue** (the host-staged mechanism, §VI-A): the payload
    itself (numpy; a device output is first copied to the host) is pickled
    into the completion message, copied into the driver ("host"), and
    copied again into the consumer's task message — the two-copy round
    trip of Fig. 8(a).

``select_transport`` routes each payload exactly like the simulator's
per-edge rule (``repro_torch.core.comm.select_mechanism``): queue below the
``CommModel.crossover_bytes()`` crossover, an arena above it — so the
mechanism the ``CommModel`` prices is the mechanism that actually runs.
``measure_transport``/``measure_device_transport``/``measured_crossover``
time the two live mechanisms across payload sizes (on the host, and on the
card) and return an observed crossover that
``ClusterSpec(crossover_bytes=...)`` can ingest (Fig. 11 from measurement,
not modelling).

Slot lifecycle (single-writer / single-freer, message-passing ordered):
the OWNING worker is the only allocator of its arena's slots (state byte
0 -> 1 before the ref is published); the DRIVER is the only freer
(1 -> 0, after every consumer of the ref has completed).  Ring allocation
scans from a moving cursor, so a drained ring wraps around indefinitely;
a full ring (consumer lagging) makes ``try_put`` return None and the
producer falls back to the queue mechanism — backpressure degrades to
host-staging instead of blocking the worker.
"""
from __future__ import annotations

import math
import pickle
import time
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import (GLOBAL_MEMORY, HOST_STAGED, CommModel,
                                   select_mechanism)

__all__ = ["PayloadRef", "ShmArena", "DeviceArena", "ArenaMap",
           "select_transport", "measure_transport",
           "measure_device_transport", "measured_crossover",
           "SHM", "CUDA_IPC", "QUEUE"]

#: live transport names — SHM (host arena) and CUDA_IPC (device arena)
#: realise GLOBAL_MEMORY, QUEUE realises HOST_STAGED (the driver is the
#: "host" the payload stages through)
SHM = "shm"
CUDA_IPC = "cuda-ipc"
QUEUE = "queue"

_FREE = 0
_USED = 1


@dataclass(frozen=True)
class PayloadRef:
    """Picklable descriptor of a payload parked in an arena slot
    (``ShmArena`` on the host, ``DeviceArena`` on the card).

    This is the 8-byte-handle analogue of the paper's global-memory
    mechanism: the control plane moves the ref; the data stays put."""
    arena: str                  # shared-memory segment name
    slot: int
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int

    def key(self) -> Tuple[str, int]:
        """Pin-table identity.  A slot is never reallocated while any ref
        to it is outstanding (the driver frees last), so (arena, slot)
        uniquely names a live payload."""
        return (self.arena, self.slot)


class ShmArena:
    """A slot ring over ONE ``multiprocessing.shared_memory`` segment.

    Layout: ``slots`` state bytes, then ``slots`` fixed-size payload slots.
    Create once in the driver (``create=True``); the owning worker and the
    driver both attach by name.  Only the owner calls ``try_put``; only
    the driver calls ``free`` — cross-process ordering is provided by the
    task/completion queues the refs travel through, so the one-byte state
    flags need no locks.
    """

    def __init__(self, name: Optional[str] = None, slots: int = 16,
                 slot_bytes: int = 1 << 20, create: bool = False):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        size = self.slots + self.slots * self.slot_bytes
        if create:
            self._shm = shared_memory.SharedMemory(create=True, size=size,
                                                   name=name)
        else:
            assert name is not None, "attaching needs the segment name"
            self._shm = shared_memory.SharedMemory(name=name)
        self._owns = create
        self.name = self._shm.name
        self._state = np.ndarray((self.slots,), np.uint8,
                                 buffer=self._shm.buf)
        if create:
            self._state[:] = _FREE
        self._cursor = 0

    # ---- producer side (owning worker) --------------------------------

    def try_put(self, arr: np.ndarray) -> Optional[PayloadRef]:
        """Write ``arr`` into a free slot; None when the payload exceeds
        the slot size or every slot is in use (backpressure — the caller
        falls back to the queue mechanism)."""
        arr = np.ascontiguousarray(arr)
        if arr.nbytes > self.slot_bytes:
            return None
        n = self.slots
        for probe in range(n):
            slot = (self._cursor + probe) % n
            if self._state[slot] == _FREE:
                off = n + slot * self.slot_bytes
                if arr.nbytes:
                    dst = np.ndarray(arr.shape, arr.dtype,
                                     buffer=self._shm.buf, offset=off)
                    dst[...] = arr
                self._state[slot] = _USED
                self._cursor = (slot + 1) % n
                return PayloadRef(self.name, slot, str(arr.dtype),
                                  tuple(arr.shape), arr.nbytes)
        return None

    # ---- consumer side ------------------------------------------------

    def get(self, ref: PayloadRef) -> np.ndarray:
        """Zero-copy numpy view over the slot.  Valid until the driver
        frees the slot — consumers read synchronously inside the task
        whose completion triggers the free, so the window is safe."""
        off = self.slots + ref.slot * self.slot_bytes
        return np.ndarray(ref.shape, np.dtype(ref.dtype),
                          buffer=self._shm.buf, offset=off)

    # ---- freer side (driver) ------------------------------------------

    def free(self, ref: PayloadRef) -> None:
        self._state[ref.slot] = _FREE

    def in_use(self) -> int:
        return int((self._state == _USED).sum())

    # ---- lifecycle ----------------------------------------------------

    def close(self) -> None:
        # drop the numpy view before closing the mmap (BufferError guard)
        self._state = None
        try:
            self._shm.close()
        except (BufferError, OSError):  # pragma: no cover - teardown race
            pass

    def unlink(self) -> None:
        if self._owns:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass


#: a ``DeviceArena``'s slot size is a multiple of this, so every slot
#: starts aligned for any dtype's view
SLOT_ALIGN = 16


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class DeviceArena:
    """``ShmArena``'s slot ring with its payload slots in device memory.

    The one-byte slot states stay in a host ``shared_memory`` segment (so
    the driver frees a slot by flipping its byte, without touching the
    card); the payloads live in ONE ``torch.empty(slots * slot_bytes,
    uint8)`` buffer on the card.  The DRIVER creates both and hands the
    arena to workers by pickling it with ``torch.multiprocessing``'s
    reductions (a spawn-context ``Process`` argument or ``Queue`` message),
    which share the buffer's CUDA storage by IPC handle; a plain
    ``pickle.dumps`` would copy the bytes instead, which is not the
    mechanism.  Because the driver owns every buffer:

      * every worker maps every arena, its own included — a process
        cannot open an IPC handle it exported itself, and a producer is
        often its own consumer;
      * outputs a dead worker published stay readable after its crash;
      * the driver never maps a payload: it only flips state bytes.

    ``try_put`` copies a tensor into a free slot on the current stream and
    waits for the copy (an event synchronize) before returning the ref;
    ``get`` returns a view of the slot, shaped and typed from the ref,
    which the consumer must finish reading before it reports completion,
    since the driver frees the slot on that completion.
    """

    def __init__(self, slots: int = 16, slot_bytes: int = 1 << 20,
                 device="cuda", *, name: Optional[str] = None,
                 buffer: Optional[torch.Tensor] = None):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        if self.slot_bytes % SLOT_ALIGN:
            raise ValueError(f"slot_bytes {slot_bytes} is not a multiple "
                             f"of {SLOT_ALIGN}")
        create = buffer is None
        if create:
            self.buffer = torch.empty(self.slots * self.slot_bytes,
                                      dtype=torch.uint8, device=device)
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=self.slots)
        else:
            if name is None:
                raise ValueError("attaching needs the state segment's name")
            if buffer.dtype != torch.uint8 or \
                    buffer.numel() != self.slots * self.slot_bytes:
                raise ValueError("buffer does not match the slot geometry")
            self.buffer = buffer
            self._shm = shared_memory.SharedMemory(name=name)
        self._owns = create
        self.name = self._shm.name
        self._state = np.ndarray((self.slots,), np.uint8,
                                 buffer=self._shm.buf)
        if create:
            self._state[:] = _FREE
        self._cursor = 0

    def __reduce__(self):
        """Attach by name in the receiving process; the buffer travels as
        a tensor, shared by IPC under ``torch.multiprocessing``."""
        return (_attach_device_arena,
                (self.name, self.slots, self.slot_bytes, self.buffer))

    def _slot(self, slot: int, dtype: torch.dtype,
              shape: Tuple[int, ...]) -> torch.Tensor:
        nbytes = math.prod(shape) * dtype.itemsize
        return self.buffer.narrow(0, slot * self.slot_bytes,
                                  nbytes).view(dtype).view(shape)

    # ---- producer side (owning worker) --------------------------------

    def try_put(self, tensor: torch.Tensor) -> Optional[PayloadRef]:
        """Copy ``tensor`` into a free slot and wait for the copy; None
        when it exceeds the slot size or every slot is in use
        (backpressure — the caller falls back to the queue mechanism)."""
        nbytes = tensor.numel() * tensor.element_size()
        if nbytes > self.slot_bytes:
            return None
        n = self.slots
        for probe in range(n):
            slot = (self._cursor + probe) % n
            if self._state[slot] == _FREE:
                if nbytes:
                    self._slot(slot, tensor.dtype,
                               tuple(tensor.shape)).copy_(tensor)
                    if self.buffer.is_cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(
                            self.buffer.device))
                        done.synchronize()
                self._state[slot] = _USED
                self._cursor = (slot + 1) % n
                return PayloadRef(self.name, slot, _dtype_name(tensor.dtype),
                                  tuple(tensor.shape), nbytes)
        return None

    # ---- consumer side ------------------------------------------------

    def get(self, ref: PayloadRef) -> torch.Tensor:
        """Zero-copy view of the slot, valid until the driver frees it."""
        return self._slot(ref.slot, getattr(torch, ref.dtype), ref.shape)

    # ---- freer side (driver) ------------------------------------------

    def free(self, ref: PayloadRef) -> None:
        self._state[ref.slot] = _FREE

    def in_use(self) -> int:
        return int((self._state == _USED).sum())

    # ---- lifecycle ----------------------------------------------------

    def close(self) -> None:
        self._state = None
        self.buffer = None
        try:
            self._shm.close()
        except (BufferError, OSError):  # pragma: no cover - teardown race
            pass

    def unlink(self) -> None:
        if self._owns:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass


def _attach_device_arena(name: str, slots: int, slot_bytes: int,
                         buffer: torch.Tensor) -> DeviceArena:
    return DeviceArena(slots, slot_bytes, name=name, buffer=buffer)


class ArenaMap:
    """Consumer-side cache of attached arenas, keyed by segment name —
    each worker (and the driver) opens a producer's arena once and maps
    every later ref through the cached attachment.  A ``DeviceArena``
    received from the driver is ``register``-ed and then resolves like a
    host one."""

    def __init__(self):
        self._arenas: Dict[str, ShmArena] = {}

    def register(self, arena: ShmArena) -> None:
        self._arenas[arena.name] = arena

    def _attach(self, ref: PayloadRef) -> ShmArena:
        a = self._arenas.get(ref.arena)
        if a is None:
            # slots/slot_bytes are encoded in the segment itself only via
            # size; the ref carries everything needed to locate the slot,
            # so attach with slot geometry recovered from the name owner.
            raise KeyError(f"arena {ref.arena!r} not registered")
        return a

    def attach(self, name: str, slots: int, slot_bytes: int) -> ShmArena:
        a = self._arenas.get(name)
        if a is None:
            a = ShmArena(name=name, slots=slots, slot_bytes=slot_bytes,
                         create=False)
            self._arenas[name] = a
        return a

    def get(self, ref: PayloadRef) -> np.ndarray:
        return self._attach(ref).get(ref)

    def free(self, ref: PayloadRef) -> None:
        self._attach(ref).free(ref)

    def close(self) -> None:
        for a in self._arenas.values():
            a.close()
        self._arenas.clear()


# --------------------------------------------------------------------------
# Mechanism selection — the Fig. 11 rule, executed
# --------------------------------------------------------------------------

def select_transport(comm: Optional[CommModel], nbytes: float,
                     shm_ok: bool = True,
                     force: Optional[str] = None) -> str:
    """Route one inter-process payload: SHM realises the global-memory
    mechanism, QUEUE the host-staged one.  ``force`` pins the mechanism
    ("device" -> shm, "host" -> queue) for A/B runs; otherwise the
    decision is ``select_mechanism``'s crossover rule — worker processes
    share one host, so the co-location precondition always holds."""
    if force == "device":
        return SHM if shm_ok else QUEUE
    if force == "host" or not shm_ok:
        return QUEUE
    mech = select_mechanism(comm, nbytes, same_device=True)
    return SHM if mech == GLOBAL_MEMORY else QUEUE


# --------------------------------------------------------------------------
# Live calibration: measured shm vs pickle-queue hand-off (satellite)
# --------------------------------------------------------------------------

def _pickle_roundtrip(arr: np.ndarray) -> np.ndarray:
    return pickle.loads(pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL))


def measure_transport(sizes_bytes: Optional[List[int]] = None,
                      repeats: int = 9) -> Dict:
    """Time one producer->consumer hand-off per mechanism per payload size.

    shm  = arena write + zero-copy map + free (what the worker and its
           consumer actually execute);
    queue = pickle dumps + loads (the serialize/deserialize copies of the
           queue mechanism — a lower bound on its true cost, which makes
           the measured crossover conservative in shm's favour being
           claimed too early).

    Returns ``{"sizes": [...], "shm_s": [...], "queue_s": [...],
    "crossover_bytes": float}`` with median-of-``repeats`` seconds."""
    if sizes_bytes is None:
        sizes_bytes = [1 << s for s in range(6, 25, 2)]   # 64 B .. 16 MB
    sizes_bytes = [int(s) for s in sizes_bytes]
    slot_bytes = max(sizes_bytes)
    arena = ShmArena(slots=2, slot_bytes=slot_bytes, create=True)
    shm_s: List[float] = []
    queue_s: List[float] = []
    try:
        for nbytes in sizes_bytes:
            arr = np.arange(max(nbytes // 8, 1), dtype=np.int64)
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                ref = arena.try_put(arr)
                view = arena.get(ref)
                _ = view[-1]                     # touch: the map is real
                arena.free(ref)
                ts.append(time.perf_counter() - t0)
            shm_s.append(float(np.median(ts)))
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = _pickle_roundtrip(arr)
                _ = out[-1]
                ts.append(time.perf_counter() - t0)
            queue_s.append(float(np.median(ts)))
    finally:
        arena.close()
        arena.unlink()
    return {"sizes": sizes_bytes, "shm_s": shm_s, "queue_s": queue_s,
            "crossover_bytes": measured_crossover(sizes_bytes, shm_s,
                                                  queue_s)}


def measure_device_transport(sizes_bytes: Optional[List[int]] = None,
                             repeats: int = 9) -> Dict:
    """``measure_transport`` on the card: one producer->consumer hand-off
    of a device tensor per mechanism per payload size.

    shm  = ``DeviceArena`` slot write (a device-to-device copy and its
           event synchronize) + the consumer's view + free — what the
           producing worker, its consumer and the driver execute;
    queue = the host-staged round trip: D2H copy, pickle dumps + loads,
           H2D copy and its synchronize (again without the queue's own
           pipe, so a lower bound on that mechanism).

    Same return shape as ``measure_transport`` ("shm_s" is the device
    arena's), on the current CUDA device.  Raises without one: there is
    no CPU stand-in for a device measurement."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_device_transport needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    if sizes_bytes is None:
        sizes_bytes = [1 << s for s in range(6, 25, 2)]   # 64 B .. 16 MB
    sizes_bytes = [int(s) for s in sizes_bytes]
    slot_bytes = -(-max(sizes_bytes) // SLOT_ALIGN) * SLOT_ALIGN
    arena = DeviceArena(slots=2, slot_bytes=slot_bytes, device=device)
    stream = torch.cuda.current_stream(device)
    shm_s: List[float] = []
    queue_s: List[float] = []
    try:
        for nbytes in sizes_bytes:
            t = torch.arange(max(nbytes // 8, 1), dtype=torch.int64,
                             device=device)
            torch.cuda.synchronize(device)
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                ref = arena.try_put(t)
                arena.get(ref)
                arena.free(ref)
                ts.append(time.perf_counter() - t0)
            shm_s.append(float(np.median(ts)))
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                host = _pickle_roundtrip(t.cpu().numpy())
                torch.from_numpy(host).to(device)
                stream.synchronize()
                ts.append(time.perf_counter() - t0)
            queue_s.append(float(np.median(ts)))
    finally:
        arena.close()
        arena.unlink()
    return {"sizes": sizes_bytes, "shm_s": shm_s, "queue_s": queue_s,
            "crossover_bytes": measured_crossover(sizes_bytes, shm_s,
                                                  queue_s)}


def measured_crossover(sizes: List[int], shm_s: List[float],
                       queue_s: List[float]) -> float:
    """The observed Fig. 11 crossover: the smallest measured size from
    which shm stays at-or-below queue for every larger size (log-linear
    interpolation against the preceding point when one exists).  Falls
    back to the largest size + 1 when queue never loses — "never pick
    shm", which ``select_mechanism`` honours."""
    win = [s <= q for s, q in zip(shm_s, queue_s)]
    start = None
    for i in range(len(sizes)):
        if all(win[i:]):
            start = i
            break
    if start is None:
        return float(max(sizes)) + 1.0
    if start == 0:
        return float(sizes[0])
    # interpolate where the two latency curves cross in log-size space
    s0, s1 = sizes[start - 1], sizes[start]
    d0 = queue_s[start - 1] - shm_s[start - 1]      # <= 0: queue winning
    d1 = queue_s[start] - shm_s[start]              # >= 0: shm winning
    if d1 == d0:
        return float(s1)
    frac = -d0 / (d1 - d0)
    frac = min(max(frac, 0.0), 1.0)
    return float(np.exp(np.log(s0) + frac * (np.log(s1) - np.log(s0))))
