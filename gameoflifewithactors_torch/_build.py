"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain ``extern "C"`` interface and loaded with
:mod:`ctypes`; :func:`build_all` compiles several at once, one ``nvcc``
each. A source named in :data:`UNITS` is compiled as several translation
units at once, the same file under different ``-D`` flags, one ``nvcc -c``
each, and the objects are linked into its one library. Libraries go to
:data:`BUILD_DIR`, named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. :data:`BUILD_DIR` is read at each call:
:func:`.aot.cache.ensure_persistent_cache` points it at the kernel build
cache root in effect (by default ``_build/cuda/`` beside this file;
``--cache-dir`` or ``GOLTPU_CACHE_DIR`` move it). Importing this module
needs no ``nvcc``; a build that fails raises with the compiler's output.

Every build and every first load in a process lands in
:data:`.obs.compile.COMPILE_LOG`: a library that ``nvcc`` built as a
``"cache_miss"`` event (its seconds are compile seconds, which
``GridCoordinator.tick`` takes out of its wall time), one loaded from an
existing file as ``"cache_hit"``. :func:`build_variant` builds a source
under extra ``-D`` flags into a library of its own and loads nothing.
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
from typing import Dict, Sequence

from .obs import compile as obs_compile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
# the default root's library directory; .aot.cache re-points it
BUILD_DIR = os.path.join(_HERE, "_build", "cuda")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, kept in the log
)

# Sources built from several translation units: the -D flags of each unit.
# life_ltl.cu instantiates its kernels for one radius per unit (the unit of
# LTL_RADIUS=r), life_generations.cu for one plane count per unit (the unit
# of GEN_PLANES=b), and the unit without it holds the C entry points.
UNITS = {
    "life_generations": [()] + [(f"-DGEN_PLANES={b}",) for b in range(2, 9)],
    "life_ltl": [()] + [(f"-DLTL_RADIUS={r}",) for r in range(1, 8)],
}


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


def library_path(name: str, defines: Sequence[str] = ()) -> str:
    """Where the build of ``csrc/<name>.cu`` for the current source (and
    the current ``csrc/*.cuh`` headers it may include) lives; ``defines``
    are extra ``-D`` flags of a variant build."""
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    digest.update(repr(UNITS.get(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, so: str, defines: Sequence[str] = ()):
    """Start ``nvcc`` on ``csrc/<name>.cu``, one process per translation
    unit (each with ``defines``); returns what :func:`_finish` needs."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    units = UNITS.get(name)
    if units is None:
        cmds, objs = [[nvcc, *NVCC_FLAGS, *defines, "-o", tmp, src]], None
    else:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [f"{tmp}.{i}.o" for i in range(len(units))]
        cmds = [[nvcc, *compile_flags, *defines, *defs, "-c", "-o", obj, src]
                for defs, obj in zip(units, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    return src, so, tmp, procs, objs, time.perf_counter()


def _finish(job) -> float:
    """Wait for a build started by :func:`_start` (and link the objects of
    a source of several units); returns its seconds."""
    src, so, tmp, procs, objs, t0 = job
    log = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {src} "
                f"({' '.join(proc.args[-5:])}):\n{out}{err}")
        log.append(out + err)
    if objs is not None:
        link_flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        link = subprocess.run([procs[0].args[0], *link_flags, "-o", tmp, *objs],
                              capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if link.returncode != 0:
            raise RuntimeError(f"linking {src} failed:\n{link.stdout}{link.stderr}")
    seconds = time.perf_counter() - t0
    with open(so + ".log", "w") as f:
        f.write("".join(log))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    obs_compile.note_kernel_build("miss")
    return seconds


def build_all(names) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    for each (one per translation unit for a source in :data:`UNITS`), all
    started together; returns each build's seconds (0.0 for a library that
    was already there). :func:`load` then loads them."""
    with _lock:
        jobs = {name: _start(name, library_path(name)) for name in names
                if not os.path.exists(library_path(name))}
        seconds = {}
        for name in names:
            seconds[name] = 0.0
            if name in jobs:
                seconds[name] = _finish(jobs[name])
                t0 = jobs[name][-1]
                obs_compile.record_build(
                    f"build:{name}", os.path.basename(library_path(name)),
                    t0, t0 + seconds[name], miss=True)
        return seconds


def build_variant(name: str, defines: Sequence[str]) -> str:
    """Build ``csrc/<name>.cu`` under the extra ``-D`` flags ``defines``
    into a library of its own (once: an existing one is kept) and return
    its path; nothing is loaded. Counted as a build (a load when the
    library was there): a caller inside :func:`.obs.compile.tracked_call`
    gets its event."""
    so = library_path(name, defines)
    with _lock:
        if os.path.exists(so):
            obs_compile.note_kernel_build("hit")
        else:
            _finish(_start(name, so, defines))
    return so


def load(name: str) -> Built:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process)."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        built = obs_compile.tracked_call(_load_new, f"build:{name}", (name,), {})
        _loaded[name] = built
        return built


def _load_new(name: str) -> Built:
    so = library_path(name)
    if os.path.exists(so):
        seconds = 0.0
        obs_compile.note_kernel_build("hit")
    else:
        seconds = _finish(_start(name, so))
    log = ""
    if os.path.exists(so + ".log"):
        with open(so + ".log") as f:
            log = f.read()
    return Built(ctypes.CDLL(so), so, log, seconds)
