"""BASELINE.json config #5 at its stated scale: a Gosper gun in a 65536²
field on the activity-tiled engines.

Counterpart of the repository's ``scripts/config5_sparse.py``: a Gosper
gun centred in a ``--size``² field (default 65536²), on
``Engine(backend="sparse")`` and ``Engine(backend="paged")`` (and, with
``--backends ...,cuda``, on kernel B1 for the whole field). Each backend
reports gens/s, nominal cell-updates/s (whole-grid cells x gens / time:
what a dense step would have had to pay), active tiles, capacity, host
syncs and dispatches per generation, and peak card memory.

The 65536² packed grid is 512 MiB; the dense seed would be 4.3 GB, so the
gun is packed small and placed word-aligned into the packed field
(``models.seeds.seeded_packed``): seeding costs O(pattern).

Prints one JSON line per phase and one summary line per backend; ``--out``
also writes the summaries with the provenance stamp as one record::

    python -m gameoflifewithactors_torch.bench.config5 --device cuda
    python -m gameoflifewithactors_torch.bench.config5 --device cpu --size 1024 --gens 64

The field's edge is DEAD, as the repository's script runs it.
:func:`build_and_step` times one build and one ``n``-generation step of
a config #5 engine of any edge (:func:`.timing.timed_run`, the protocol
``chip_smoke.py`` times the activity-tiled engines by); it returns
:func:`summary`'s record, as :func:`measure` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from . import timing
from .run import PACKAGE

BACKENDS = ("sparse", "paged", "cuda")


def seed_words(side: int):
    """The gun's packed field: ``(side, side/32)`` uint32 words, the gun
    at row ``side/2``, word column ``side/64``."""
    from ..models import seeds
    from ..ops import bitpack

    if side % bitpack.WORD:
        raise ValueError(f"--size must be a multiple of {bitpack.WORD}")
    return seeds.seeded_packed((side, side), "gosper_gun", top=side // 2,
                               left_word=side // bitpack.WORD // 2)


def _opts(backend: str, capacity: Optional[int],
          chunk_gens: Optional[int]) -> Optional[dict]:
    if backend == "cuda":
        return None
    opts = {}
    if capacity is not None:
        opts["capacity"] = capacity
    if chunk_gens is not None:
        opts["chunk_gens"] = chunk_gens
    return opts or None


def make_engine(words, backend: str, *, topology: str = "dead",
                capacity: Optional[int] = None,
                chunk_gens: Optional[int] = None, device="cuda"):
    """The config #5 engine of ``backend`` over the packed ``words``."""
    from ..engine import Engine
    from ..ops.stencil import Topology

    return Engine.from_packed(words, "B3/S23", topology=Topology(topology),
                              backend=backend, device=device,
                              sparse_opts=_opts(backend, capacity,
                                                chunk_gens))


def counters(engine) -> dict:
    """The activity-tiled state's ``dispatches`` and ``syncs`` (the paged
    engine counts them on its pool), its capacity; zeros and None for a
    kernel engine."""
    state = engine._sparse
    if state is None:
        return {"dispatches": 0, "syncs": 0, "capacity": None}
    counter = state.pool if engine.backend == "paged" else state
    return {"dispatches": counter.dispatches, "syncs": counter.syncs,
            "capacity": counter.capacity}


def _tiles(engine) -> int:
    """Every tile of the field, in the tile shape the engine uses."""
    state = engine._sparse
    tr, tw = ((state.pool.tile_rows, state.pool.tile_words)
              if engine.backend == "paged" else
              (state.tile_rows, state.tile_words))
    h, wq = engine.shape[0], engine.shape[1] // 32
    return (h // tr) * (wq // tw)


def _chunk_gens(engine) -> Optional[int]:
    state = engine._sparse
    return None if state is None else getattr(state, "chunk_gens", None)


def summary(engine, backend: str, gens: int, walls: List[float], c0: dict,
            c1: dict, peak: Optional[int], generations_run: int,
            device) -> dict:
    """Config #5's record of ``engine`` after timed steps of ``gens``
    generations that took ``walls`` seconds, its counters ``c0`` before
    and ``c1`` after them; the best step is the value."""
    from ..ops import bitpack

    side = engine.shape[0]
    best = max(gens / w for w in walls)
    timed = gens * len(walls)
    return {
        "metric": f"gens/sec, {side}x{side} Gosper gun ({backend}, "
                  f"{device.type})",
        "value": best,
        "unit": "gens/sec",
        "nominal_cell_updates_per_sec": best * side * side,
        "active_tiles": engine.active_tiles(),
        "total_tiles": None if engine._sparse is None else _tiles(engine),
        "capacity": c1["capacity"],
        "chunk_gens": _chunk_gens(engine),
        "population": bitpack.population(engine.state),
        "generations_run": generations_run,
        "grid_bytes": side * (side // 32) * 4,
        "platform": device.type,
        "backend": backend,
        "topology": engine.topology.value,
        "repetition_seconds": walls,
        "host_syncs_per_gen": (c1["syncs"] - c0["syncs"]) / timed,
        "dispatches_per_gen": (c1["dispatches"] - c0["dispatches"]) / timed,
        "peak_card_mib": None if peak is None else peak / 2 ** 20,
        "device": timing.card(device),
    }


def build_and_step(words, backend: str, n: int, **kw):
    """``(engine, record)``: the config #5 engine of ``backend``
    (:func:`make_engine`'s keywords) built and stepped ``n`` generations
    in one step by :func:`.timing.timed_run`; the record is
    :func:`summary`'s, its counters taken from the build on, plus the
    build's seconds ``build_s``."""
    from ..engine import resolve_device

    device = resolve_device(kw.get("device", "cuda"))
    engine, build_s, wall, peak = timing.timed_run(
        lambda: make_engine(words, backend, **kw), n, device)
    zero = {"dispatches": 0, "syncs": 0}
    rec = summary(engine, backend, n, [wall], zero, counters(engine), peak,
                  n, device)
    rec["build_s"] = build_s
    return engine, rec


def measure(words, backend: str, *, gens: int, repeats: int,
            capacity: Optional[int] = None,
            chunk_gens: Optional[int] = None, device="cuda",
            emit=print) -> dict:
    """``scripts/config5_sparse.py``'s protocol on one backend, on a DEAD
    field: build, warm past one full chunk (``max(4, 2 * chunk_gens)``
    generations, outside the timing), then ``repeats`` repetitions of
    ``gens`` generations, each closed by a device sync. Returns
    :func:`summary`'s record."""
    from ..engine import resolve_device

    device = resolve_device(device)
    side = words.shape[0]
    base = timing.peak_start(device)
    t0 = time.perf_counter()
    engine = make_engine(words, backend, capacity=capacity,
                         chunk_gens=chunk_gens, device=device)
    engine.block_until_ready()
    emit(json.dumps({"phase": "seeded", "backend": backend,
                     "grid": [side, side],
                     "packed_mb": round(side * (side // 32) * 4 / 2 ** 20, 1),
                     "seed_s": round(time.perf_counter() - t0, 2),
                     "platform": device.type}))
    warm = max(4, 2 * (_chunk_gens(engine) or 1))
    t0 = time.perf_counter()
    engine.step(warm)
    engine.block_until_ready()
    emit(json.dumps({"phase": "warm", "backend": backend,
                     "compile_s": round(time.perf_counter() - t0, 2),
                     "active_tiles": engine.active_tiles()}))
    c0 = counters(engine)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine.step(gens)
        engine.block_until_ready()
        walls.append(time.perf_counter() - t0)
    return summary(engine, backend, gens, walls, c0, counters(engine),
                   timing.peak_since(device, base), warm + repeats * gens,
                   device)


def run(*, size: int = 65536, gens: int = 512, repeats: int = 2,
        capacity: Optional[int] = None, chunk_gens: Optional[int] = None,
        chunk_ab: bool = False, backends=("sparse", "paged"),
        device="cuda", emit=print) -> List[dict]:
    """Config #5 on each of ``backends``; one summary per backend (the
    sparse one with ``chunked_gens_per_sec`` when ``chunk_ab``)."""
    from ..models.rules import CONWAY
    from ..ops.sparse import max_chunk_gens

    words = seed_words(size)
    out = []
    for backend in backends:
        if backend not in BACKENDS:
            raise ValueError(f"config #5 backends are {BACKENDS}, got "
                             f"{backend!r}")
        rec = measure(words, backend, gens=gens, repeats=repeats,
                      capacity=capacity, chunk_gens=chunk_gens,
                      device=device, emit=emit)
        if chunk_ab and backend == "sparse":
            g = max_chunk_gens(CONWAY)
            ab = measure(words, backend, gens=gens, repeats=repeats,
                         capacity=capacity, chunk_gens=g, device=device,
                         emit=emit)
            rec["chunked_gens_per_sec"] = ab["value"]
            rec["chunked_chunk_gens"] = g
            emit(json.dumps({"phase": "chunk_ab", "chunk_gens": g,
                             "gens_per_sec": ab["value"]}))
        emit(json.dumps(rec))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=65536)
    ap.add_argument("--gens", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=None,
                    help="active-tile capacity (default: the engine's)")
    ap.add_argument("--chunk-gens", type=int, default=None, metavar="G",
                    help="temporal chunking depth of the activity-tiled "
                         "engines (default: theirs, 1)")
    ap.add_argument("--chunk-ab", action="store_true",
                    help="after the sparse run, run it again at the rule's "
                         "largest chunk depth and report both rates")
    ap.add_argument("--backends", default="sparse,paged",
                    help="comma-separated, of sparse, paged and cuda "
                         "(kernel B1 over the whole field)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    from ..engine import resolve_device
    from ..utils import provenance

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"config5: {exc}", file=sys.stderr)
        return 2
    summaries = run(size=args.size, gens=args.gens, repeats=args.repeats,
                    capacity=args.capacity, chunk_gens=args.chunk_gens,
                    chunk_ab=args.chunk_ab,
                    backends=[b for b in args.backends.split(",") if b],
                    device=args.device,
                    emit=lambda line: print(line, flush=True))
    if args.out:
        paths = sorted({p for s in summaries
                        for p in provenance.BACKEND_PATHS[s["backend"]]}
                       | {"gameoflifewithactors_torch/bench/config5.py"})
        record = {**summaries[0], "runs": summaries, "package": PACKAGE,
                  **provenance.head_stamp(paths=paths),
                  "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
