"""The bench: cell-updates/s of the port's main path, one JSON line.

Counterpart of the repository's ``bench.py``, run as::

    python -m gameoflifewithactors_torch.bench [--device cuda|cpu]
        [--size N] [--gens N] [--repeats 3] [--backend auto] [--rule R]
        [--store PATH] [--telemetry-out PATH] [--profile-sample S]
    python -m gameoflifewithactors_torch.bench --report [--store PATH]

The timed region is one ``GridCoordinator.run`` tick of ``n``
generations over an ``Engine`` with the resolved backend, on the host
clock, closed by ``torch.cuda.synchronize()`` (:func:`.timing.tick_seconds`).
The protocol is ``bench.py``'s (``BASELINE.md``, "Canonical measurement
protocol"): the same numpy seeds, a 10-generation warm-up, a
64-generation probe that sizes repetitions to about 4 s (10..16384
generations), re-sized once after the first repetition; ``value`` is the
best repetition. The record also carries every repetition's seconds,
generations and kernel launches, their median rate and spread, the card's
name and power limit, the resolved backend and kernel, and the provenance
stamp of the measured tree.

``vs_baseline`` is ``value / 1e9``, the north-star target of
``BASELINE.json``, not a measurement of another device.

No fallback: without CUDA and without ``--device cpu`` it exits non-zero
and prints no record; a failed or refused run exits non-zero; a stored
number never stands in for a fresh one. Each record is kept in the store
(``results/cuda_best.json``, ``--store``) when it beats the stored one for
its configuration, or when the stored one is stale.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Optional, Tuple

import numpy as np

from ..utils import provenance
from . import timing

NORTH_STAR_TARGET = 1e9     # cell-updates/s on 16384^2 (BASELINE.json)
WARMUP_GENERATIONS = 10     # >= every kernel's depth: the build lands here
PROBE_GENERATIONS = 64
REP_SECONDS = 4.0           # the autotuned length of a repetition
MIN_GENS, MAX_GENS = 10, 16384
DEFAULT_SIDE = {"cuda": 16384, "cpu": 4096}   # bench.py's, by platform
PACKAGE = "gameoflifewithactors_torch"
REQUESTS = ("auto", "packed", "dense", "cuda", "sparse", "paged", "pallas")
STORE_PATH = os.path.join(provenance.repo_root(), "results", "cuda_best.json")
# the kernel each family's "cuda" backend launches (its name in
# ops/cuda_stencil.launch_counts())
KERNELS = {"bs": "life_packed", "generations": "life_generations",
           "ltl": "life_ltl"}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=None,
                    help="grid side length (default: 16384 on cuda, 4096 "
                         "on cpu)")
    ap.add_argument("--gens", type=int, default=None,
                    help="generations per timed repetition (default: "
                         "autotuned to about 4 s)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--backend", choices=REQUESTS, default="auto",
                    help="auto = what Engine(backend='auto') picks on the "
                         "device (on the card the rule's kernel where it "
                         "takes the shape); 'pallas' is refused: the "
                         "port's kernels are backend 'cuda'")
    ap.add_argument("--rule", default="B3/S23")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the bench runs: the card (default; exits "
                         "non-zero without one) or the plain PyTorch path "
                         "on the CPU")
    ap.add_argument("--store", default=STORE_PATH, metavar="PATH",
                    help="the store of best records (default "
                         "results/cuda_best.json)")
    ap.add_argument("--report", action="store_true",
                    help="print the provenance scoreboard of the store and "
                         "of the port's records beside it, and exit")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="write the port's RunReport of the measured run "
                         "(spans, kernel builds, a StepMetrics record per "
                         "repetition, the roofline); read it with `python "
                         "-m gameoflifewithactors_torch report PATH`")
    ap.add_argument("--profile-sample", type=float, default=None,
                    metavar="S",
                    help="arm the sampling profiler (one torch.profiler "
                         "window every S seconds): its attribution lands in "
                         "the RunReport and a sibling .attribution.json. "
                         "Also read from $GOLTPU_PROFILE_SAMPLE_S")
    return ap.parse_args(argv)


def config_key(args, platform: str) -> str:
    """The store key of the *requested* configuration (a size left to its
    default stays 'default'), prefixed by the platform so that a CPU
    record never stands for a card's."""
    return f"{platform}:{args.backend}:{args.size or 'default'}:{args.rule}"


def _family(rule) -> str:
    from ..models.generations import GenRule
    from ..models.ltl import LtLRule

    if isinstance(rule, GenRule):
        return "generations"
    return "ltl" if isinstance(rule, LtLRule) else "bs"


def route(requested: str, rule, side: int) -> str:
    """The backend an explicit request runs on: ``bench.py``'s routing of
    the rule families (:344-409), with a note on stderr wherever it
    differs from the request. ``auto`` is left to the Engine; ``cuda`` is
    never rerouted (the Engine raises where the kernel cannot take the
    shape or the rule)."""
    if requested == "pallas":
        raise ValueError(
            "backend 'pallas' is the JAX package's TPU kernel; this "
            "package's kernel backend is 'cuda'")
    family = _family(rule)
    if requested in ("auto", "cuda") or family == "bs":
        return requested
    if family == "generations" and requested in ("dense", "paged"):
        return requested
    if family == "ltl" and requested in ("dense", "sparse", "paged"):
        return requested
    target = "packed" if side % 32 == 0 else "dense"
    if target != requested:
        label = ("bit-plane packed" if family == "generations"
                 or getattr(rule, "states", 2) > 2 else "bit-sliced packed")
        sys.stderr.write(
            f"note: rule {rule.notation} runs on the "
            f"{label if target == 'packed' else 'dense'} path; --backend "
            f"{requested} -> {target}\n")
    return target


def seed_grid(backend: str, rule, side: int) -> np.ndarray:
    """``bench.py``'s seeds (:410-424): the centred Gosper gun for the
    activity-tiled backends, a uniform 0..C-1 soup for multi-state rules,
    a 50% soup otherwise, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    if backend in ("sparse", "paged"):
        from ..models import seeds

        return seeds.seeded((side, side), "gosper_gun", side // 2, side // 2)
    states = getattr(rule, "states", 2)
    if states > 2:
        return rng.integers(0, states, size=(side, side), dtype=np.uint8)
    return rng.integers(0, 2, size=(side, side), dtype=np.uint8)


def _launches(kernel: Optional[str]) -> Optional[int]:
    if kernel is None:
        return None
    from ..ops import cuda_stencil

    return cuda_stencil.launch_counts()[kernel]


def run_bench(args) -> Tuple[dict, object]:
    """Measure ``args`` (:func:`parse`); returns ``(record, coordinator)``
    (the coordinator holds the final state). Raises ``RuntimeError``
    without CUDA on ``--device cuda`` and ``ValueError`` for a refused
    request."""
    from ..coordinator import GridCoordinator
    from ..engine import Engine, resolve_device
    from ..models.elementary import ElementaryRule
    from ..models.generations import parse_any
    from ..obs import spans
    from ..ops.stencil import Topology
    from ..utils.metrics import StepMetrics

    dev = resolve_device(args.device)
    platform = dev.type
    side = args.size or DEFAULT_SIDE[platform]
    rule = parse_any(args.rule)
    if isinstance(rule, ElementaryRule):
        raise ValueError(
            f"{rule.notation} is a 1D (elementary) rule; this bench times 2D "
            "grids. Drive ops.elementary directly (see examples/wolfram.py)")
    backend = route(args.backend, rule, side)
    grid = seed_grid(backend, rule, side)

    def phase(name, **attrs):
        if telem is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(spans.span(name, **attrs))
        if telem.watchdog is not None:
            stack.enter_context(telem.watchdog.watch(name))
        return stack

    engine = Engine(grid, rule, topology=Topology.TORUS, backend=backend,
                    device=dev)
    del grid
    if args.backend == "auto":
        sys.stderr.write(f"auto backend -> {engine.backend}\n")
    coord = GridCoordinator.from_engine(engine)
    kernel = KERNELS[_family(rule)] if engine.backend == "cuda" else None
    telem = sample = None
    if args.telemetry_out:
        from ..obs.report import begin_run_telemetry

        # the session starts after the build, as the CLI's does (the
        # warm-up's kernel build lands in it)
        sample = args.profile_sample
        if sample is None and os.environ.get("GOLTPU_PROFILE_SAMPLE_S"):
            sample = float(os.environ["GOLTPU_PROFILE_SAMPLE_S"])
        telem = begin_run_telemetry(
            stall_deadline=float(os.environ.get("BENCH_STALL_DEADLINE_S",
                                                "60")))

    with phase("bench.warmup", backend=engine.backend):
        timing.tick_seconds(coord, WARMUP_GENERATIONS)
    gens, probe = args.gens, None
    if gens is None:
        with phase("bench.autotune"):
            dt = timing.tick_seconds(coord, PROBE_GENERATIONS)
        probe = PROBE_GENERATIONS
        gens = max(MIN_GENS, min(MAX_GENS, int(
            REP_SECONDS / max(dt / PROBE_GENERATIONS, 1e-7))))
    if sample:
        from ..obs import profiler as profiler_lib

        # the sampler opens its first window over the timed repetitions
        # alone: its device span is then theirs, not the warm-up's
        telem.profiler = profiler_lib.arm(profiler_lib.ProfileSampler(sample))
        telem.profiler.wait_open()

    cells = side * side
    reps = []
    for rep in range(args.repeats):
        before = _launches(kernel)
        with phase("bench.rep", rep=rep, gens=gens):
            dt = timing.tick_seconds(coord, gens)
        launched = None if before is None else _launches(kernel) - before
        reps.append({"generations": gens, "seconds": dt,
                     "cell_updates_per_sec": cells * gens / dt,
                     "launches": launched})
        if telem is not None:
            telem.step_buffer(StepMetrics(
                generation=coord.generation, generations_stepped=gens,
                wall_seconds=dt, cell_updates_per_sec=cells * gens / dt))
        if rep == 0 and args.gens is None and dt < REP_SECONDS / 2:
            # the probe's per-generation time carries a tick's fixed cost;
            # the first full repetition measures it closely
            gens = max(MIN_GENS, min(MAX_GENS, int(REP_SECONDS * gens / dt)))

    if telem is not None and telem.profiler is not None:
        # close the window here: the report's closing snapshot must not
        # land in the repetitions' device span
        profiler_lib.disarm()
    rates = [r["cell_updates_per_sec"] for r in reps]
    best = max(rates)
    median = statistics.median(rates)
    seed_note = ("gosper-gun" if engine.backend in ("sparse", "paged")
                 else "uniform state soup" if getattr(rule, "states", 2) > 2
                 else "50% soup")
    record = {
        "metric": f"cell-updates/sec/chip, {side}x{side} {rule.notation} "
                  f"({engine.backend}, {seed_note}, {platform})",
        "value": best,
        "unit": "cell-updates/sec",
        "vs_baseline": best / NORTH_STAR_TARGET,
        "median": median,
        "spread": (max(rates) - min(rates)) / median,
        "repetitions": reps,
        "protocol": {
            "warmup_generations": WARMUP_GENERATIONS,
            "probe_generations": probe,
            "repeats": args.repeats,
            "timed_region": "GridCoordinator.run tick, host clock, closed "
                            "by torch.cuda.synchronize()"},
        "side": side,
        "rule": rule.notation,
        "topology": "torus",
        "requested_backend": args.backend,
        "backend": engine.backend,
        "kernel": kernel,
        "platform": platform,
        "device": timing.card(dev),
        "package": PACKAGE,
    }
    record.update(provenance.head_stamp(
        paths=provenance.explicit_record_paths(record)))
    record["recorded_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    if telem is not None:
        _write_telemetry(telem, coord, args.telemetry_out, {
            "bench": True, "side": side, "rule": rule.notation,
            "backend": engine.backend, "platform": platform,
            "gens_per_rep": gens, "repeats": args.repeats,
            "best_cell_updates_per_sec": best,
            "median_cell_updates_per_sec": median})
    return record, coord


def _write_telemetry(telem, coord, path: str, config: dict) -> None:
    from ..obs.profiler import attribution_path_for

    report = telem.finish(engine=coord.engine, config=config)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    report.save(path)
    sys.stderr.write(f"telemetry report written: {path}\n")
    if report.profile is not None:
        apath = attribution_path_for(path)
        with open(apath, "w") as f:
            json.dump(report.profile, f, indent=1)
            f.write("\n")
        sys.stderr.write(f"profile attribution written: {apath}\n")


# -- the store -----------------------------------------------------------------


def load_store(path: str) -> dict:
    try:
        with open(path) as f:
            store = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    return store if isinstance(store, dict) else {}


def persist_if_best(path: str, key: str, record: dict,
                    report_path: Optional[str] = None) -> bool:
    """Keep ``record`` under ``key`` when none is stored, when it beats the
    stored value, or when the stored record is stale and this one's
    provenance is clean (``bench.py``'s ``_persist_if_best``). Returns
    whether it was written."""
    store = load_store(path)
    prev = store.get(key)
    uncertifiable = record.get("commit_dirty") or not record.get("commit")
    prev_stale = prev is not None and provenance.staleness(prev)["stale"]
    if not (prev is None or (prev_stale and not uncertifiable)
            or record["value"] > prev["value"]):
        return False
    entry = {**record, "ok": True}
    if report_path and os.path.exists(report_path):
        base = os.path.dirname(os.path.dirname(os.path.abspath(path)))
        entry["telemetry_report"] = os.path.relpath(report_path, base)
        from ..obs.profiler import attribution_path_for

        apath = attribution_path_for(report_path)
        if os.path.exists(apath):
            entry["profile_attribution"] = os.path.relpath(apath, base)
    store[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(store, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return True


def marked_records(folder: str, skip=()):
    """``(path, record)`` of each JSON record in ``folder`` that names this
    package (the bench tools' ``--out`` records), in name order; ``skip``
    holds paths to leave out."""
    skip = {os.path.abspath(p) for p in skip}
    out = []
    for name in sorted(os.listdir(folder) if os.path.isdir(folder) else []):
        path = os.path.join(folder, name)
        if not name.endswith(".json") or os.path.abspath(path) in skip:
            continue
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rec, dict) and rec.get("package") == PACKAGE:
            out.append((path, rec))
    return out


def port_records(store_path: str):
    """``(source, key, record)`` of every record the port wrote beside the
    store: the store's entries, then the marked records of its directory."""
    out = [("store", key, rec) for key, rec in sorted(load_store(
        store_path).items()) if isinstance(rec, dict)]
    out += [("artifact", os.path.basename(path)[:-5], rec) for path, rec in
            marked_records(os.path.dirname(os.path.abspath(store_path)),
                           skip=[store_path]) if "metric" in rec]
    return out


def report(store_path: str) -> None:
    """The provenance scoreboard of the port's records: each with its
    commit stamp and its staleness at HEAD."""
    rows = []
    for source, key, rec in port_records(store_path):
        st = provenance.staleness(rec)
        rows.append({"source": source, "key": key, "ok": rec.get("ok", True),
                     "value": rec.get("value"), "unit": rec.get("unit"),
                     "commit": rec.get("commit"),
                     "recorded_at": rec.get("recorded_at"),
                     "device": timing.card_label(rec.get("device")),
                     "stale": st["stale"], "reason": st["reason"]})
    fresh = sum(1 for r in rows if r["ok"] and not r["stale"])
    for r in rows:
        flag = ("FRESH" if r["ok"] and not r["stale"]
                else "stale" if r["ok"] else "FAILED")
        val = (f"{r['value']:.4g} {r['unit'] or ''}".strip()
               if isinstance(r["value"], (int, float)) else "-")
        why = f"  [{r['reason']}]" if r["stale"] else ""
        print(f"{flag:6} {r['source']:8} {r['key']:34} {val:26} "
              f"@{r['commit'] or '?'} {r['recorded_at'] or '?'} "
              f"[{r['device']}]{why}")
    print(json.dumps({"report": True, "head": provenance.git_head(),
                      "store": store_path, "records": len(rows),
                      "fresh_ok": fresh}))


def main(argv=None) -> int:
    args = parse(argv)
    if args.report:
        report(args.store)
        return 0
    try:
        record, _ = run_bench(args)
    except RuntimeError as exc:
        if "no CUDA device" not in str(exc):
            raise
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    except ValueError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    if persist_if_best(args.store, config_key(args, record["platform"]),
                       record, args.telemetry_out):
        sys.stderr.write(f"stored as the best record of its configuration "
                         f"in {args.store}\n")
    print(json.dumps(record))
    return 0
