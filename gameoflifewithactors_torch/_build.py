"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain ``extern "C"`` interface and loaded with
:mod:`ctypes`; :func:`build_all` compiles several at once, one ``nvcc``
each. Libraries go to ``_build/`` beside this file, named by a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Importing this module needs no ``nvcc``; a build that
fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, kept in the log
)


@dataclasses.dataclass(frozen=True)
class Built:
    """A loaded library with what its build said."""

    lib: ctypes.CDLL
    path: str
    log: str             # nvcc's output (ptxas register/spill report)
    build_seconds: float  # 0.0 when an earlier build was loaded


_lock = threading.Lock()
_loaded: Dict[str, Built] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels of "
        "gameoflifewithactors_torch are built from source at first use")


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` for the current source (and
    the current ``csrc/*.cuh`` headers it may include) lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, so: str):
    """Start ``nvcc`` on ``csrc/<name>.cu``; returns what :func:`_finish`
    needs."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return src, so, tmp, proc, time.perf_counter()


def _finish(job) -> float:
    """Wait for a build started by :func:`_start`; returns its seconds."""
    src, so, tmp, proc, t0 = job
    out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {src}:\n{out}{err}")
    with open(so + ".log", "w") as f:
        f.write(out + err)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return seconds


def build_all(names) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    for each, all started together; returns each build's seconds (0.0 for
    a library that was already there). :func:`load` then loads them."""
    with _lock:
        jobs = {name: _start(name, library_path(name)) for name in names
                if not os.path.exists(library_path(name))}
        return {name: _finish(jobs[name]) if name in jobs else 0.0
                for name in names}


def load(name: str) -> Built:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        so = library_path(name)
        seconds = 0.0 if os.path.exists(so) else _finish(_start(name, so))
        log = ""
        if os.path.exists(so + ".log"):
            with open(so + ".log") as f:
                log = f.read()
        built = Built(ctypes.CDLL(so), so, log, seconds)
        _loaded[name] = built
        return built
