"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

All ``kernels/csrc/*.cu`` sources compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  One
``nvcc`` per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c <src>.cu -o <src>.o     (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libreprotorch_<hash>.so *.o

The library lands in ``<repo>/build/repro_torch/`` (git-ignored), keyed by
a hash of the sources, their headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds and an unchanged one is built once
per checkout.  It is loaded with ``ctypes``;
callers declare ``argtypes`` for every entry point they use.  Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's output (with ptxas's register and spill lines) of the last build
# in this process; empty when the library was already on disk
build_log = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built with nvcc on a machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; their output, or ``RuntimeError``
    with it if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the library unless it is already on disk; returns its path.
    Raises ``RuntimeError`` with nvcc's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(_sources(), objs)])
    tmp = out.with_name(f"{tag}.tmp.so")
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    os.replace(tmp, out)          # atomic: concurrent builds agree
    for obj in objs:
        obj.unlink()
    global build_log
    build_log = log
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
