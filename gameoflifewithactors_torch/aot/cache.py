"""The kernel build cache root (warm-start layer 1).

Counterpart of ``gameoflifewithactors_tpu.aot.cache``. What a cold process
pays here is ``nvcc``: every CUDA source of the package is built into a
shared library at first use (:mod:`.._build`), seconds each. The library is
keyed by a hash of its source, headers and flags, so a second process
that finds it loads it instead of building. This module decides where the
libraries live, so that two installations, or a warm-up run and the
servers after it, can share one cache.

Resolution order for the cache root (the JAX package's):

1. an explicit path (``SimulationConfig.cache_dir`` / ``--cache-dir``;
   ``""`` disables);
2. the ``GOLTPU_CACHE_DIR`` environment variable: a path, or one of
   ``""``/``0``/``off``/``none``/``disabled`` to disable caching;
3. the default, ``gameoflifewithactors_torch/_build/`` beside this
   package (gitignored), so that a checkout builds every kernel at first
   use without any setup. (The JAX package's default is
   ``~/.cache/gameoflifewithactors_tpu``.)

Under a root the libraries live in ``<root>/cuda`` and the registry of
:mod:`.registry` (layer 2) in ``<root>/torch_aot``: never the JAX
package's ``<root>/xla`` and ``<root>/aot``, so that the two packages can
share one root without reading each other's records. With caching
disabled the libraries are built into a temporary directory of the
process, removed at exit: every process pays ``nvcc``, as every JAX
process compiles when its cache is off.

:func:`ensure_persistent_cache` points :data:`.._build.BUILD_DIR` at the
root in effect. It is idempotent and thread-safe: the first call wins,
and an explicit path given later re-points (the CLI parses its flags
after an engine may exist). The engine, the CLI, ``serve`` and the
``warmup`` pipeline call it before anything builds.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
import warnings
from typing import Optional

ENV_CACHE_DIR = "GOLTPU_CACHE_DIR"
_DISABLED_VALUES = ("", "0", "off", "none", "disabled")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_lock = threading.Lock()
_state = {
    "root": None,        # the cache root in effect, or None when disabled
    "build_dir": None,   # where _build puts libraries (a temp dir if disabled)
    "attempted": False,  # ensure_persistent_cache ran at least once
    "tmp": None,         # the process's temporary build dir, once made
}


def default_cache_root() -> str:
    return os.path.join(_PACKAGE, "_build")


def resolve_cache_root(explicit: Optional[str] = None) -> Optional[str]:
    """The cache root directory, or None when caching is disabled."""
    if explicit is not None:
        return explicit or None
    env = os.environ.get(ENV_CACHE_DIR)
    if env is not None:
        if env.strip().lower() in _DISABLED_VALUES:
            return None
        return env
    return default_cache_root()


def kernel_cache_dir(root: str) -> str:
    """Where the kernel libraries of a cache root live."""
    return os.path.join(root, "cuda")


def aot_registry_dir(root: Optional[str] = None) -> Optional[str]:
    """The registry directory of ``root``; without one, of the root in
    effect (resolved, if :func:`ensure_persistent_cache` has not run).
    None when caching is disabled."""
    if root is None:
        with _lock:
            root = _state["root"] if _state["attempted"] \
                else resolve_cache_root()
    return None if root is None else os.path.join(root, "torch_aot")


def _temporary_build_dir() -> str:
    if _state["tmp"] is None:
        _state["tmp"] = tempfile.mkdtemp(prefix="goltpu_torch_build_")
        atexit.register(shutil.rmtree, _state["tmp"], True)
    return _state["tmp"]


def ensure_persistent_cache(explicit: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at the cache root; returns the library
    directory in effect, or None when caching is disabled (libraries then
    go to a temporary directory of the process).

    The first call wins; an explicit path on a later call re-points.
    Failures are a warning, not an error: a read-only root must not take
    an engine down (the builds then go to the temporary directory)."""
    from .. import _build

    with _lock:
        if _state["attempted"] and explicit is None:
            return None if _state["root"] is None else _state["build_dir"]
        root = resolve_cache_root(explicit)
        _state["attempted"] = True
        if root is not None:
            target = kernel_cache_dir(root)
            try:
                os.makedirs(target, exist_ok=True)
            except OSError as exc:
                warnings.warn(
                    f"kernel build cache unavailable at {target} "
                    f"({type(exc).__name__}: {exc}); kernels will not be "
                    "cached across processes", RuntimeWarning, stacklevel=2)
                root = None
        if root is None:
            target = _temporary_build_dir()
        _state["root"] = root
        _state["build_dir"] = target
        _build.BUILD_DIR = target
        return None if root is None else target


def current_cache_dir() -> Optional[str]:
    """The kernel library directory this process configured (None when
    caching is disabled or not yet enabled)."""
    with _lock:
        return None if _state["root"] is None else _state["build_dir"]
