"""Warm start: make the second process pay no build time.

Counterpart of ``gameoflifewithactors_tpu.aot``, in three layers:

- :mod:`.cache` -- the **kernel build cache root**: where ``nvcc``'s
  libraries live (``<root>/cuda``), in-repo by default
  (``gameoflifewithactors_torch/_build/``), moved or disabled by
  ``GOLTPU_CACHE_DIR`` / ``--cache-dir``; the counterpart of the XLA
  persistent cache;
- :mod:`.spec` + :mod:`.registry` -- **EngineSpec** canonically hashes a
  runner configuration with the torch/CUDA/card fingerprint, and the
  **registry** keeps a record per spec (``<root>/torch_aot``) from which a
  fresh process serves the plain multi-step loop as CUDA graphs, keeping
  its normal runner (with a warning) on any mismatch;
- :mod:`.warmup` -- the pipeline behind the ``warmup`` CLI subcommand:
  walk a manifest of specs and fill both ahead of serving.

Attribution lands in :mod:`..obs.compile`: every event carries ``kind`` in
{``cache_miss``, ``cache_hit``, ``aot_loaded``}, and only real builds
count as compile seconds -- a warm RunReport shows ``compile_seconds`` 0.
"""

from .cache import (  # noqa: F401
    ENV_CACHE_DIR,
    current_cache_dir,
    default_cache_root,
    ensure_persistent_cache,
    resolve_cache_root,
)
from .spec import EngineSpec, environment_fingerprint  # noqa: F401
from .registry import (  # noqa: F401
    AotUnsupported,
    ENV_AOT,
    aot_enabled,
    load_runner,
    maybe_load_for_engine,
    serialize_engine,
)
from .warmup import load_manifest, warmup_spec, warmup_specs  # noqa: F401

__all__ = [
    "ENV_CACHE_DIR", "ENV_AOT",
    "current_cache_dir", "default_cache_root", "ensure_persistent_cache",
    "resolve_cache_root",
    "EngineSpec", "environment_fingerprint",
    "AotUnsupported", "aot_enabled", "load_runner", "maybe_load_for_engine",
    "serialize_engine",
    "load_manifest", "warmup_spec", "warmup_specs",
]
