"""Warmup pipeline (layer 3): fill the caches before serving.

Counterpart of ``gameoflifewithactors_tpu.aot.warmup``.
``python -m gameoflifewithactors_torch warmup --manifest specs.json`` (or
``--from-config`` + the normal CLI flags) builds each spec's engine and
steps it through both runner signatures a serving process uses (one
generation and a bulk chunk), so the kernel build cache holds every
library those runners load (on the card: B1, B3 or B4 for ``auto``); with
``aot`` (the default) it also writes the runner's record into the
registry where its scope allows. A rollout runs this once per (torch
version × card) before taking traffic.

The manifest is a JSON list of EngineSpec dicts, the JAX package's
format::

    [{"rule": "B3/S23", "shape": [4096, 4096], "backend": "packed"},
     {"rule": "brain", "shape": [1024, 1024]},
     {"rule": "R2,C0,M1,S2..6,B3..5,NM", "shape": [512, 512],
      "backend": "packed", "topology": "dead"}]

An entry may also carry a **lane ladder**, the batch capacities the
session service (:mod:`..serve.lanes`) dispatches the family at::

    [{"rule": "B3/S23", "shape": [256, 256], "lanes": [1, 8, 64, 256]}]

A lane entry builds the kernel its lanes launch (B2's lane form on the
card, :func:`..serve.lanes.warm_family`). PyTorch traces nothing, so no
capacity needs warming: placement, growth and compaction across the
ladder then cause no ``cache_miss``. Extras such as ``lanes`` are
manifest-level vocabulary, peeled off before ``EngineSpec.from_dict``
(which rejects unknown fields).
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence, Tuple

from . import cache as cache_lib
from . import registry as registry_lib
from .spec import EngineSpec

# manifest keys that configure warmup itself rather than the engine;
# EngineSpec.from_dict stays strict about everything else
MANIFEST_EXTRAS = ("lanes",)


def load_manifest_entries(path: str) -> List[Tuple[EngineSpec, dict]]:
    """Parse a manifest into (spec, extras) pairs, where ``extras`` holds
    the warmup-level keys (:data:`MANIFEST_EXTRAS`) the entry carried."""
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(
            f"manifest {path} must be a JSON list of spec objects")
    out: List[Tuple[EngineSpec, dict]] = []
    for e in entries:
        e = dict(e)
        extras = {k: e.pop(k) for k in MANIFEST_EXTRAS if k in e}
        if "lanes" in extras:
            lanes = extras["lanes"]
            if (not isinstance(lanes, list) or not lanes
                    or not all(isinstance(c, int) and c > 0 for c in lanes)):
                raise ValueError(
                    f"manifest {path}: 'lanes' must be a non-empty list "
                    f"of positive batch capacities, got {lanes!r}")
        out.append((EngineSpec.from_dict(e), extras))
    return out


def load_manifest(path: str) -> List[EngineSpec]:
    return [spec for spec, _extras in load_manifest_entries(path)]


def _warm_lanes(spec: EngineSpec, lanes: Sequence[int], device) -> str:
    """Build the kernel the spec's lanes launch on ``device``. Imported
    lazily: manifest readers need not pull the serve layer in."""
    from ..serve import lanes as lanes_lib

    d = spec.canonical()
    d["mesh"] = None  # lanes are single-device by contract (serve/lanes.py)
    family = lanes_lib.SpecFamily.from_spec(d, device)
    lanes_lib.warm_family(family, device)
    return (f"warmed the lane kernel for {family.key} ({len(lanes)} "
            "capacities need no warming)")


def warmup_spec(spec: EngineSpec, *, aot: bool = True,
                lanes: Optional[Sequence[int]] = None, device=None) -> dict:
    """Warm one spec on ``device``: build its engine, step both runner
    signatures, optionally write the registry record and warm the lane
    ladder's kernel. Returns a report row (wall seconds, ``nvcc`` seconds,
    event kinds, aot and lane status)."""
    from ..obs import compile as obs_compile

    log = obs_compile.COMPILE_LOG
    n_before = len(log.events())
    t0 = time.perf_counter()
    engine = spec.build_engine(device=device)
    # both signatures the serving process uses: one generation (the
    # remainder path) and a bulk chunk (> gens_per_exchange, so chunked
    # runners launch their chunk too)
    engine.step(1)
    engine.step(max(2, engine.gens_per_exchange + 1))
    engine.block_until_ready()
    aot_status: Optional[str] = None
    if aot:
        try:
            registry_lib.serialize_engine(engine)
            aot_status = "serialized"
        except registry_lib.AotUnsupported as exc:
            aot_status = f"unsupported: {exc}"
        except Exception as exc:  # pragma: no cover - environment-dependent
            aot_status = f"failed: {type(exc).__name__}: {exc}"
    lanes_status: Optional[str] = None
    if lanes:
        try:
            lanes_status = _warm_lanes(spec, lanes, engine.device)
        except ValueError as exc:
            # a family the lane layer refuses (multi-state rule, sharded
            # mesh, unpackable width) is a manifest authoring error the
            # report must surface, not a warmup crash
            lanes_status = f"unsupported: {exc}"
    wall = time.perf_counter() - t0
    events = log.events()[n_before:]
    kinds: dict = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    row = {
        "spec": spec.canonical(),
        "resolved_backend": engine.backend,
        "wall_seconds": wall,
        "compile_seconds": sum(e.wall_seconds for e in events
                               if e.kind == "cache_miss"),
        "events": kinds,
        "aot": aot_status,
    }
    if lanes:
        row["lanes"] = {"capacities": list(lanes), "status": lanes_status}
    return row


def warmup_specs(specs, *, aot: bool = True, cache_dir: Optional[str] = None,
                 verbose=None, device=None) -> List[dict]:
    """The pipeline: point the kernel builds at the cache root, then warm
    every spec on ``device``. ``specs`` is a list of EngineSpec or
    (EngineSpec, extras) pairs (the :func:`load_manifest_entries` shape --
    extras may carry ``lanes``). ``verbose`` is a print-like callable for
    progress lines (or None)."""
    enabled = cache_lib.ensure_persistent_cache(cache_dir)
    if verbose:
        verbose(f"kernel build cache: {enabled or 'DISABLED'}")
    rows = []
    for item in specs:
        spec, extras = item if isinstance(item, tuple) else (item, {})
        if verbose:
            verbose(f"warming {spec.describe()} ...")
        row = warmup_spec(spec, aot=aot, lanes=extras.get("lanes"),
                          device=device)
        rows.append(row)
        if verbose:
            verbose(
                f"  {row['wall_seconds']:.2f}s wall, "
                f"{row['compile_seconds']:.2f}s compiling, "
                f"events {row['events'] or '{}'}"
                + (f", aot: {row['aot']}" if row["aot"] else "")
                + (f", lanes: {row['lanes']['status']}"
                   if row.get("lanes") else ""))
    return rows
