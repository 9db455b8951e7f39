"""Weak scaling: a fixed tile per mesh position, a growing position count.

Counterpart of the repository's ``scripts/weak_scaling.py``. For each
position count n a mesh of n positions is built (``make_mesh(None,
devices[:n])``: the most-square (nx, ny)), the global grid is sized
``nx*TH x ny*TW`` so that every position steps the same ``TH x TW`` tile,
and the sharded runner steps it. Efficiency is ``rate(n) / (n *
rate(first))``: 1.0 means the halo exchange is free.

The positions are ``--device``'s devices (every card, or the one CPU);
``--positions N`` puts N positions on that one device, as the examples
do (on one card the positions share it, so the efficiency then measures
the runner's exchange and launches, not an interconnect).

Runners: ``packed`` (2D tiles, one plain-torch generation per exchange;
``--gens-per-exchange G > 1`` takes the ghost-zone pipeline where the
tile fits it, else the deep runner), ``band`` (full-width row bands over
the flattened mesh, one launch of kernel B2's slab form per position and
chunk: the band runner ``Engine(mesh=..., backend="cuda")`` drives; on
CPU positions its plain version), ``sparse-tiled`` (per-tile activity
skipping, one soup blob per tile).

Each point is warmed, then timed over ``--repeats`` repetitions; the best
is its rate. Without ``--gens`` a 64-generation probe sizes a repetition
to about ``REP_SECONDS`` (10..16384 generations, a multiple of the
exchange depth), re-sized once after the first one, as the bench sizes
its own: windows of a few milliseconds would time launches, not the
runner.

Every point records ``single_chip_equivalent_updates_per_sec`` (the
fleet rate over n) and ``cost_vs_single_chip``: its ratio to the newest
single-device bench record of the dense main path in the port's store
(``results/cuda_best.json``, ``--store``; :func:`single_chip_reference`).
A missing or stale reference marks the ``--out`` record ``stale``, so
the gate skips it.

    python -m gameoflifewithactors_torch.bench.weak_scaling --device cuda --positions 4 --runner band
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..parallel.mesh import add_positions_flag, mesh_devices
from . import timing
from .run import (DEFAULT_SIDE, MAX_GENS, MIN_GENS, PACKAGE,
                  PROBE_GENERATIONS, STORE_PATH, load_store)

RUNNERS = ("packed", "band", "sparse-tiled")
REP_SECONDS = 0.5     # the autotuned length of a repetition


def single_chip_reference(platform: str, rule: str, tile=None,
                          store: str = STORE_PATH) -> Optional[dict]:
    """The COST normalizer: the newest bench record in the store of the
    dense main path of ``platform`` and ``rule``, one device stepping a
    50% soup on the ``auto`` or ``cuda`` request, at the bench's default
    side for the platform or at the square ``tile``'s side (store key
    ``<platform>:<auto|cuda>:<size>:<rule>``). Gun records (``sparse``,
    ``paged``: a nominal rate over a mostly empty field) and other sizes
    never stand in. Its staleness is re-derived from its commit stamp;
    None when the store has no such record."""
    from ..utils import provenance

    sizes = {"default", str(DEFAULT_SIDE[platform])}
    if tile is not None and tile[0] == tile[1]:
        sizes.add(str(tile[0]))
    best = None
    for key, rec in load_store(store).items():
        parts = key.split(":", 3)
        if (not isinstance(rec, dict) or len(parts) != 4
                or parts[0] != platform or parts[1] not in ("auto", "cuda")
                or parts[2] not in sizes or rec.get("rule") != rule
                or "50% soup" not in str(rec.get("metric", ""))
                or not isinstance(rec.get("value"), (int, float))):
            continue
        if best is None or (rec.get("recorded_at") or "") >= \
                (best[1].get("recorded_at") or ""):
            best = (key, rec)
    if best is None:
        return None
    key, rec = best
    ref = {"file": f"{store}#{key}", "metric": rec["metric"],
           "value": float(rec["value"])}
    for k in ("commit", "commit_dirty", "commit_approx", "recorded_at",
              "measured_paths", "device"):
        if k in rec:
            ref[k] = rec[k]
    st = provenance.staleness(ref)
    ref["stale"] = bool(st.get("stale"))
    if ref["stale"]:
        ref["stale_reason"] = st.get("reason", "")
    return ref


def _sync(mesh) -> None:
    import torch

    for device, _ in mesh.groups:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _timed(run_n, p, k: int, mesh):
    """``(state, seconds)`` of ``run_n(p, k)`` on the host clock, closed
    by a sync of the mesh's cards."""
    t0 = time.perf_counter()
    p = run_n(p, k)
    _sync(mesh)
    return p, time.perf_counter() - t0


def _sized(gens: int, seconds: float, g: int) -> int:
    """Generations for a repetition of about ``REP_SECONDS`` at the rate
    ``gens`` generations in ``seconds`` showed, clamped to
    ``MIN_GENS..MAX_GENS`` and rounded up to a multiple of ``g``."""
    n = max(MIN_GENS, min(MAX_GENS, int(REP_SECONDS * gens
                                        / max(seconds, 1e-9))))
    return -(-n // g) * g


def _counts(spec: Optional[str], available: int) -> List[int]:
    if spec:
        counts = [int(c) for c in spec.split(",")]
    else:
        counts, c = [], 1
        while c <= available:
            counts.append(c)
            c *= 2
        if counts[-1] != available:
            counts.append(available)
    return [c for c in counts if c <= available]


def run(args) -> dict:
    """Every point of the sweep: ``{"series", "summary", "finals",
    "reference"}``; ``finals`` holds per point the packed start words,
    the gathered final words (both on the mesh's first device) and the
    generations stepped, for checks against a single-device run, and each
    timed repetition's generations and seconds."""
    import torch

    from ..engine import resolve_device
    from ..models.rules import parse_rule
    from ..ops import bitpack
    from ..ops.stencil import Topology
    from ..parallel import mesh as mesh_lib
    from ..parallel import sharded

    dev = resolve_device(args.device)
    devices = mesh_devices(args.device, args.positions)
    platform = dev.type
    if args.tile:
        th, tw = (int(v) for v in args.tile.split("x"))
    else:
        th, tw = (4096, 4096) if platform == "cuda" else (512, 512)
    if tw % bitpack.WORD:
        raise ValueError(f"tile width must be a multiple of {bitpack.WORD}")
    rule = parse_rule(args.rule)
    ref = single_chip_reference(platform, rule.notation, (th, tw),
                                args.store)
    counts = _counts(args.counts, len(devices))

    rng = np.random.default_rng(0)
    base = None
    results, finals = [], []
    for n in counts:
        mesh = mesh_lib.make_mesh(None, devices[:n])
        nx, ny = mesh.shape[mesh_lib.ROW_AXIS], mesh.shape[mesh_lib.COL_AXIS]
        H, W = nx * th, ny * tw
        g = args.gens_per_exchange
        exchange = None
        if args.runner == "sparse-tiled":
            # one soup blob per tile (1/64 of its area): per-position
            # activity stays constant across the sweep
            grid = np.zeros((H, W), dtype=np.uint8)
            bh, bw = max(1, th // 8), max(1, tw // 8)
            for iy in range(nx):
                for ix in range(ny):
                    r0, c0 = iy * th + th // 4, ix * tw + tw // 4
                    grid[r0:r0 + bh, c0:c0 + bw] = rng.integers(
                        0, 2, size=(bh, bw), dtype=np.uint8)
        else:
            grid = rng.integers(0, 2, size=(H, W), dtype=np.uint8)
        packed = bitpack.pack(torch.from_numpy(grid).to(devices[0]))
        del grid
        p = mesh_lib.device_put_sharded_grid(
            packed, mesh, banded=args.runner == "band")
        act = None
        if args.runner == "band":
            gb = g if g > 1 else 8
            if args.gens is not None and args.gens % gb:
                raise ValueError(f"--gens must be a multiple of G={gb}")
            band = sharded.make_multi_step_kernel(
                mesh, rule, Topology.TORUS, gens_per_exchange=gb)
            run_n = band
            g = gb
        elif args.runner == "sparse-tiled":
            from ..ops.sparse import auto_tile

            if g > 1:
                raise ValueError(
                    "--gens-per-exchange applies to the packed and band "
                    "runners, not sparse-tiled")
            tr, twords = auto_tile(th, tw // bitpack.WORD)
            truns = sharded.make_multi_step_packed_sparse_tiled(
                mesh, rule, Topology.TORUS, tile_rows=tr, tile_words=twords)
            act = [sharded.initial_tile_activity(p, mesh, tr, twords)]

            def run_n(s_, k):
                s_, act[0] = truns(s_, act[0], k)
                return s_
        elif g > 1:
            if mesh_lib.ghost_fits(th, tw // bitpack.WORD, g):
                bulk = sharded.make_multi_step_packed_ghost(
                    mesh, rule, Topology.TORUS, gens_per_exchange=g)
                exchange = "ghost"
            else:
                bulk = sharded.make_multi_step_packed_deep(
                    mesh, rule, Topology.TORUS, gens_per_exchange=g)
                exchange = "deep"
            if args.gens is not None and args.gens % g:
                raise ValueError(f"--gens must be a multiple of G={g}")

            def run_n(s_, k, bulk=bulk, g=g):   # the runner counts chunks
                return bulk(s_, k // g)
        else:
            run_n = sharded.make_multi_step_packed(mesh, rule,
                                                   Topology.TORUS)
        p, _ = _timed(run_n, p, 8 * g, mesh)      # warm
        stepped, gens = 8 * g, args.gens
        if gens is None:
            probe = -(-PROBE_GENERATIONS // g) * g
            p, dt = _timed(run_n, p, probe, mesh)
            stepped += probe
            gens = _sized(probe, dt, g)
        best, reps = 0.0, []
        for rep in range(args.repeats):
            p, dt = _timed(run_n, p, gens, mesh)
            stepped += gens
            reps.append({"generations": gens, "seconds": dt})
            best = max(best, H * W * gens / dt)
            if rep == 0 and args.gens is None and dt < REP_SECONDS / 2:
                # the probe's rate carries a call's fixed cost; the first
                # repetition measures it closely
                gens = _sized(gens, dt, g)
        if base is None:
            base = (n, best)
        eff = (best / n) / (base[1] / base[0])
        rec = {
            "devices": n, "mesh": [nx, ny], "grid": [H, W],
            "runner": args.runner,
            "cell_updates_per_sec": best,
            "per_device": best / n,
            "single_chip_equivalent_updates_per_sec": best / n,
            "weak_scaling_efficiency": eff,
            "platform": platform,
        }
        if exchange is not None:
            rec["exchange"] = exchange
        if ref is not None and ref["value"] > 0:
            rec["cost_vs_single_chip"] = (best / n) / ref["value"]
        if act is not None:
            rec["active_tiles"] = int(sum(int(a.sum())
                                          for a in act[0].parts))
            rec["total_tiles"] = int(sum(a.numel() for a in act[0].parts))
        results.append(rec)
        finals.append({"devices": n, "start": packed,
                       "final": p.gather(), "generations": stepped,
                       "repetitions": reps})
        print(json.dumps(rec), flush=True)

    summary = {
        "metric": f"weak-scaling efficiency, {th}x{tw}/device, "
                  f"{rule.notation} ({platform}, runner={args.runner}, "
                  f"G={args.gens_per_exchange})",
        "value": results[-1]["weak_scaling_efficiency"],
        "unit": "fraction",
        "devices": results[-1]["devices"],
        "single_chip_equivalent_updates_per_sec":
            results[-1]["single_chip_equivalent_updates_per_sec"],
    }
    if ref is not None and ref["value"] > 0:
        summary["cost_vs_single_chip"] = (
            summary["single_chip_equivalent_updates_per_sec"] / ref["value"])
    print(json.dumps(summary), flush=True)
    return {"series": results, "summary": summary, "finals": finals,
            "reference": ref, "device": timing.card(dev)}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tile", default=None, metavar="HxW",
                    help="per-position tile in cells (default 4096x4096 on "
                         "cuda, 512x512 on cpu)")
    ap.add_argument("--gens", type=int, default=None,
                    help="generations per timed repetition (default: "
                         "autotuned to about REP_SECONDS)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rule", default="B3/S23")
    ap.add_argument("--counts", default=None,
                    help="comma-separated position counts (default: 1, 2, "
                         "4, ... up to all)")
    ap.add_argument("--gens-per-exchange", type=int, default=1, metavar="G",
                    help="G > 1: the ghost-zone pipeline (the deep runner "
                         "where the tile is too small for it); the band "
                         "runner's chunk (default 8)")
    ap.add_argument("--runner", default="packed", choices=RUNNERS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    add_positions_flag(ap)
    ap.add_argument("--store", default=STORE_PATH, metavar="PATH",
                    help="the bench store the COST reference is read from")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write {summary, series, provenance stamp} as "
                         "one JSON record")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..engine import resolve_device
    from ..utils import provenance

    args = parse(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"weak_scaling: {exc}", file=sys.stderr)
        return 2
    out = run(args)
    if args.out:
        pkg = PACKAGE
        paths = [f"{pkg}/parallel/{f}" for f in
                 ("sharded.py", "halo.py", "mesh.py")]
        paths += [f"{pkg}/ops/{f}" for f in
                  ("packed.py", "sparse.py", "cuda_stencil.py", "stencil.py",
                   "bitpack.py")]
        paths += [f"{pkg}/csrc", f"{pkg}/models/rules.py",
                  f"{pkg}/bench/weak_scaling.py"]
        ref = out["reference"]
        record = {**out["summary"], "series": out["series"],
                  "repetitions": [{"devices": f["devices"],
                                   "repetitions": f["repetitions"]}
                                  for f in out["finals"]],
                  "single_chip_reference": ref, "device": out["device"],
                  "package": PACKAGE, **provenance.head_stamp(paths=paths),
                  "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}
        platform = out["series"][-1]["platform"]
        if ref is None:
            record["stale"] = True
            record["needs_recapture"] = True
            record["stale_reason"] = (
                f"no single-device bench record for platform {platform!r} "
                "in the store; cost_vs_single_chip is unanchored")
        elif ref.get("stale"):
            record["stale"] = True
            record["needs_recapture"] = True
            record["stale_reason"] = (
                f"single-device reference {ref['file']} is stale: "
                f"{ref.get('stale_reason', '')}")
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
