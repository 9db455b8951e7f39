"""A glider flying forever across an unbounded paged universe.

No grid was ever allocated for this universe: the paged subsystem
(gameoflifewithactors_torch/memory/) binds physical tiles from a fixed
pool only where live structure is, allocates new pages at the glider's
advancing wake front, and retires the dead pages behind it -- so the
glider's footprint stays a constant handful of tiles however far it
flies. Run it for a million generations and the pool gauges read the
same as at generation 100.

Mid-flight the universe checkpoints (utils/checkpoint.save_paged -- the
sparse page list, never a dense rectangle), restores into a fresh pool,
and the copy must be bit-identical to the original for the rest of the
run: that equivalence is asserted, and the whole flight after warm
holds ``retrace_budget(0)`` (no kernel build).

    python -m gameoflifewithactors_torch.examples.unbounded_glider --gens 1024
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from . import add_device_flag

GLIDER = ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2))  # flies down-right


def run(argv=None) -> dict:
    """Fly, print, check; return ``{"rc": exit code, "universe",
    "twin"}`` (the original and its restored twin)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gens", type=int, default=1024,
                    help="generations to fly (glider advances 1 cell "
                         "diagonally per 4)")
    ap.add_argument("--tile-rows", type=int, default=16)
    ap.add_argument("--tile-words", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=64,
                    help="pool tiles — constant however far the glider "
                         "flies")
    ap.add_argument("--report-every", type=int, default=256)
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="where the mid-flight checkpoint lands "
                         "(default: a temp file, removed after)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from ..analysis import sanitizers
    from ..engine import resolve_device
    from ..memory import PagedUniverse, TilePool
    from ..models.generations import parse_any
    from ..serve.lanes import paged_lane_runner
    from ..utils import checkpoint as ckpt

    device = resolve_device(args.device)
    # one runner for this (rule, slab geometry): the restored twin's
    # fresh pool below reuses it
    rule = parse_any("B3/S23")
    runner = paged_lane_runner(rule, args.tile_rows, args.tile_words)

    def make_pool(name: str) -> TilePool:
        return TilePool(rule, args.capacity, tile_rows=args.tile_rows,
                        tile_words=args.tile_words, name=name,
                        runner=runner, device=device)

    cells = np.zeros((8, 8), np.uint8)
    for y, x in GLIDER:
        cells[y, x] = 1
    u = PagedUniverse(rule, pool=make_pool("glider"))
    u.seed_cells(cells, origin=(1, 1))
    seed_bbox = u.live_bbox_cells()
    u.pool.warm()

    # after warm, the whole flight — page allocation at the front, page
    # retirement behind, every step chunk — must build no kernel; a
    # single build here is a bug
    budget = sanitizers.retrace_budget(0)
    budget.__enter__()

    t0 = time.perf_counter()
    done = 0
    mid = args.gens // 2
    ckpt_path = args.checkpoint
    tmp_dir = None
    if ckpt_path is None:
        tmp_dir = tempfile.mkdtemp(prefix="goltorch_glider_")
        ckpt_path = os.path.join(tmp_dir, "glider.npz")
    twin = None
    try:
        while done < args.gens:
            n = min(args.report_every, args.gens - done)
            if twin is None and done + n >= mid:
                n = mid - done or n
            u.step(n)
            if twin is not None:
                twin.step(n)
            done += n
            stats = u.pool.stats()
            print(f"gen {u.generation:7d}  pop {u.population():3d}  "
                  f"pool {stats['in_use']}/{stats['capacity']} tiles  "
                  f"({done / (time.perf_counter() - t0):8.1f} gens/s)")
            if twin is None and done >= mid:
                # mid-flight: checkpoint, restore into a FRESH pool, and
                # fly both for the rest of the run
                ckpt.save_paged(u, ckpt_path)
                grid2, _meta = ckpt.load_paged(
                    ckpt_path, pool=make_pool("glider-restore"))
                grid2.pool.warm()
                twin = PagedUniverse(rule, pool=grid2.pool)
                twin.grid = grid2
                print(f"checkpointed at gen {u.generation} -> {ckpt_path} "
                      f"({os.path.getsize(ckpt_path)} bytes, "
                      f"{len(grid2.pages)} pages)")
    finally:
        budget.__exit__(None, None, None)
        if tmp_dir is not None:
            import shutil

            shutil.rmtree(tmp_dir, ignore_errors=True)

    out = {"rc": 1, "universe": u, "twin": twin}
    origin, snap = u.snapshot_cells()
    t_origin, t_snap = twin.snapshot_cells()
    if origin != t_origin or not np.array_equal(snap, t_snap):
        print("FAIL: restored universe diverged from the original",
              file=sys.stderr)
        return out
    if u.population() != 5:
        print(f"FAIL: glider lost cells (pop {u.population()})",
              file=sys.stderr)
        return out
    bbox = u.live_bbox_cells()
    flown = bbox[0] - seed_bbox[0]
    print(f"glider flew {flown} cells diagonally over {u.generation} gens "
          f"(bbox {seed_bbox} -> {bbox}); restored twin bit-identical; "
          f"pool constant at {u.pool.stats()['in_use']} tiles")
    if flown < args.gens // 4 - 2:
        print("FAIL: glider did not advance (expected ~gens/4 cells)",
              file=sys.stderr)
        return out
    out["rc"] = 0
    return out


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
