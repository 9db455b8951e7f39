"""The runner registry (warm-start layer 2): records of plain runners,
served as CUDA graphs.

Counterpart of ``gameoflifewithactors_tpu.aot.registry``. The JAX registry
stores a serialized executable of a spec's multi-step runner, so a fresh
process loads it instead of tracing. PyTorch has no trace to skip and no
executable to store; what a fresh process pays on the plain paths is the
launch of tens of small eager ops per generation. So the record here
names the runner, and :func:`load_runner` builds its executable form in
the process: on the card, CUDA graphs of the plain loop (one graph of
:data:`GRAPH_CHUNK` generations and one of a single generation for each
of two static buffers, replayed ping-pong, one dispatch per graph), on
the CPU the plain runner itself.

Registry layout (``<cache_root>/torch_aot/``, never the JAX package's
``<cache_root>/aot``)::

    <key>.torchaot   the record (written first: the blob)
    <key>.json       the same record, the commit (written last)

A record holds the canonical spec, the environment fingerprint, the
runner's name, the state's shape and dtype, the kernel libraries the
runner loads (none: the plain runners launch no library), the format
version and ``created_at``. The key hashes spec + environment, so a
record from another environment is simply not found; when one exists for
the same spec under a *different* environment, the loader names it in a
warning and the engine keeps its normal runner. Any load failure (a
corrupt record, another format, a capture that fails) is a warning and
the normal runner, never an error: the registry is an optimization, not
a correctness layer.

Scope (the JAX registry's): single-device engines on the plain paths
(``packed``, ``dense``, the plane stack, bit-sliced LtL; every family).
Sharded engines, the sparse and paged backends and the ``cuda`` backend
keep their runners; the ``cuda`` backend's kernels warm-start through
the kernel build cache (layer 1), as the JAX package's Mosaic kernels
warm-start through the XLA cache. ``GOLTPU_AOT=0`` opts out.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable, Optional, Tuple

from . import cache as cache_lib
from .spec import EngineSpec, environment_fingerprint

ENV_AOT = "GOLTPU_AOT"
_FORMAT_VERSION = 1
# generations in one captured graph of the plain loop; a remainder replays
# the one-generation graph
GRAPH_CHUNK = 16


def aot_enabled() -> bool:
    return os.environ.get(ENV_AOT, "1").strip().lower() \
        not in cache_lib._DISABLED_VALUES


class AotUnsupported(ValueError):
    """This engine configuration has no registrable runner."""


def _plain_runners() -> dict:
    """The plain ``(state, n, *, rule, topology)`` runners by name."""
    from ..ops.generations import multi_step_generations
    from ..ops.ltl import multi_step_ltl
    from ..ops.packed import multi_step_packed
    from ..ops.packed_generations import multi_step_packed_generations
    from ..ops.packed_ltl import multi_step_ltl_packed, multi_step_ltl_planes
    from ..ops.stencil import multi_step

    return {fn.__name__: fn for fn in (
        multi_step, multi_step_packed, multi_step_generations,
        multi_step_packed_generations, multi_step_ltl,
        multi_step_ltl_packed, multi_step_ltl_planes)}


def _exportable_runner(engine) -> Tuple[Callable, str]:
    """The plain runner behind the engine's step and its name. Raises
    AotUnsupported for configurations whose runner is not one plain
    ``(state, n)`` loop."""
    from ..models.generations import GenRule
    from ..models.ltl import LtLRule

    if engine.mesh is not None:
        raise AotUnsupported(
            "sharded engines keep their runners (the kernel build cache "
            "still warm-starts their kernels)")
    if engine.backend in ("sparse", "paged"):
        raise AotUnsupported(
            f"the {engine.backend} backend's stepper is stateful (activity "
            "map + overflow handling), not one exportable (state, n) runner")
    if engine.backend == "cuda":
        raise AotUnsupported(
            "cuda runners are hand-written kernels built by nvcc; they "
            "warm-start through the kernel build cache")
    dense = engine._layout == "dense"
    if isinstance(engine.rule, LtLRule):
        name = "multi_step_ltl" if dense else (
            "multi_step_ltl_planes" if engine._layout == "planes"
            else "multi_step_ltl_packed")
    elif isinstance(engine.rule, GenRule):
        name = "multi_step_generations" if dense \
            else "multi_step_packed_generations"
    else:
        name = "multi_step" if dense else "multi_step_packed"
    return _plain_runners()[name], name


def _paths(key: str, registry_dir: str) -> Tuple[str, str]:
    return (os.path.join(registry_dir, key + ".torchaot"),
            os.path.join(registry_dir, key + ".json"))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def serialize_engine(engine, registry_dir: Optional[str] = None) -> str:
    """Write the record of the engine's runner under the spec's cache key;
    returns the blob path. The engine's own state gives the shape and
    dtype the runner steps (packed words, plane stacks or bytes)."""
    registry_dir = registry_dir if registry_dir is not None \
        else cache_lib.aot_registry_dir()
    if registry_dir is None:
        raise ValueError("AOT registry disabled (GOLTPU_CACHE_DIR off)")
    _, runner_name = _exportable_runner(engine)
    spec = EngineSpec.from_engine(engine)
    env = environment_fingerprint()
    key = spec.cache_key(env)
    state = engine.state
    meta = {
        "format_version": _FORMAT_VERSION,
        "spec": spec.canonical(),
        "env": env,
        "runner": runner_name,
        "state_shape": list(state.shape),
        "state_dtype": _dtype_name(state.dtype),
        "kernels": [],   # libraries the runner loads: none on a plain path
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    text = json.dumps(meta, indent=1) + "\n"
    os.makedirs(registry_dir, exist_ok=True)
    blob_path, meta_path = _paths(key, registry_dir)
    # blob first, meta last: a meta file is the commit record -- a crash
    # between the writes leaves an orphan blob, never a dangling meta
    for path in (blob_path, meta_path):
        with open(path + ".tmp", "w") as f:
            f.write(text)
        os.replace(path + ".tmp", path)
    return blob_path


def _mismatch_candidates(spec: EngineSpec, registry_dir: str) -> list:
    """Records in the registry for this spec under OTHER environments
    (the mismatch warning's evidence)."""
    want = spec.canonical()
    out = []
    try:
        names = os.listdir(registry_dir)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(registry_dir, name)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(meta, dict) and meta.get("spec") == want:
            out.append(meta)
    return out


class GraphRunner:
    """``(state, n) -> state`` replaying CUDA graphs of a plain loop.

    Two static buffers; for each, one graph of :data:`GRAPH_CHUNK`
    generations and one of a single generation, each writing its result
    into the other buffer. A call copies the state in, replays the chunk
    graph ``n // GRAPH_CHUNK`` times and the single one for the rest,
    alternating buffers, and returns a copy of the last: a later replay
    never overwrites a state it handed out. Replays run on the current
    stream; the graphs' intermediates live in one private pool."""

    def __init__(self, step: Callable, like):
        import torch

        self._bufs = (torch.zeros_like(like), torch.zeros_like(like))
        side = torch.cuda.Stream(device=like.device)
        side.wait_stream(torch.cuda.current_stream(like.device))
        with torch.cuda.stream(side):   # warm the allocator off capture
            step(self._bufs[0], 1)
        torch.cuda.current_stream(like.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self._graphs = {}
        for gens in (GRAPH_CHUNK, 1):
            for src in (0, 1):
                graph = torch.cuda.CUDAGraph()
                # thread_local: a sampler thread's CUDA calls must not
                # invalidate the capture
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self._bufs[1 - src].copy_(step(self._bufs[src], gens))
                self._graphs[(gens, src)] = graph

    def __call__(self, state, n):
        n = int(n)
        if n == 0:
            return state
        if state.shape != self._bufs[0].shape or state.dtype != self._bufs[0].dtype:
            raise ValueError(
                f"graph runner captured for {self._bufs[0].dtype}"
                f"{tuple(self._bufs[0].shape)}, got {state.dtype}"
                f"{tuple(state.shape)}")
        cur = 0
        self._bufs[0].copy_(state)
        chunks, rem = divmod(n, GRAPH_CHUNK)
        for gens, count in ((GRAPH_CHUNK, chunks), (1, rem)):
            for _ in range(count):
                self._graphs[(gens, cur)].replay()
                cur = 1 - cur
        return self._bufs[cur].clone()


def _runner_for(meta: dict, spec: EngineSpec, device) -> Callable:
    """The runner a record names, on ``device``: CUDA graphs of the plain
    loop on the card, the plain runner on the CPU."""
    import torch

    from ..models.generations import parse_any
    from ..ops.stencil import Topology

    fn = _plain_runners()[meta["runner"]]
    rule, topology = parse_any(spec.rule), Topology(spec.topology)

    def plain(state, n):
        return fn(state, n, rule=rule, topology=topology)

    if device.type != "cuda":
        return plain
    like = torch.zeros(tuple(meta["state_shape"]),
                       dtype=getattr(torch, meta["state_dtype"]), device=device)
    return GraphRunner(plain, like)


def load_runner(spec_or_engine, registry_dir: Optional[str] = None,
                device=None) -> Optional[Callable]:
    """Load the runner a record serves for a spec or engine; None (after
    at most one warning) when no loadable record exists. The runner is
    ``(state, n) -> state`` on the engine's device (for a spec,
    ``device``: ``"cuda"`` unless the caller asks for the CPU)."""
    from ..engine import resolve_device
    from ..obs import compile as obs_compile

    registry_dir = registry_dir if registry_dir is not None \
        else cache_lib.aot_registry_dir()
    if registry_dir is None or not os.path.isdir(registry_dir):
        return None
    engine = None
    if isinstance(spec_or_engine, EngineSpec):
        spec, dev = spec_or_engine, resolve_device(device)
    else:
        engine = spec_or_engine
        spec, dev = EngineSpec.from_engine(engine), engine.device
    if spec.backend == "auto":
        # records are filed under the RESOLVED backend (serialize_engine
        # works from a live engine)
        spec = spec.resolve(dev)
    env = environment_fingerprint()
    key = spec.cache_key(env)
    blob_path, meta_path = _paths(key, registry_dir)
    if not os.path.exists(meta_path) or not os.path.exists(blob_path):
        for meta in _mismatch_candidates(spec, registry_dir):
            got = meta.get("env", {})
            if got != env:
                diff = ", ".join(
                    f"{k}: {got.get(k)!r} != {env.get(k)!r}"
                    for k in sorted(set(got) | set(env))
                    if got.get(k) != env.get(k))
                warnings.warn(
                    f"AOT record for {spec.describe()} exists but was made "
                    f"for a different environment ({diff}); keeping the "
                    "normal runner (re-run warmup to refresh)",
                    RuntimeWarning, stacklevel=3)
                break
        return None
    t0 = time.perf_counter()
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"registry format {meta.get('format_version')} != "
                f"{_FORMAT_VERSION}")
        with open(blob_path) as f:
            if json.load(f) != meta:
                raise ValueError("the record's blob and its .json differ")
        if engine is not None and (
                meta["state_shape"] != list(engine.state.shape)
                or meta["state_dtype"] != _dtype_name(engine.state.dtype)):
            raise ValueError(
                f"the record steps {meta['state_dtype']}"
                f"{meta['state_shape']}, the engine holds "
                f"{_dtype_name(engine.state.dtype)}{list(engine.state.shape)}")
        run = _runner_for(meta, spec, dev)
    except Exception as exc:
        warnings.warn(
            f"AOT record for {spec.describe()} failed to load "
            f"({type(exc).__name__}: {exc}); keeping the normal runner",
            RuntimeWarning, stacklevel=3)
        return None
    obs_compile.record_aot_load(
        meta["runner"],
        f"{meta['state_dtype']}[{','.join(map(str, meta['state_shape']))}]",
        time.perf_counter() - t0)
    run.aot_key = key  # introspection: which record serves this engine
    return run


def maybe_load_for_engine(engine) -> Optional[Callable]:
    """Engine-constructor hook: the registry's runner when a record exists
    for this exact configuration + environment, else None -- one hash and
    one stat on the miss path, silent unless a record exists but cannot
    serve."""
    if not aot_enabled():
        return None
    try:
        _exportable_runner(engine)  # the scope gate
    except AotUnsupported:
        return None
    return load_runner(engine)
