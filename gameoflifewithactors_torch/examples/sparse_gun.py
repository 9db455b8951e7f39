"""A Gosper gun firing into a huge, mostly-empty universe (config #5 shape).

The sparse backend's activity tiling makes compute scale with the
CHANGED area, not the grid area: a 65536² universe with one gun steps a
handful of active tiles per generation. This example runs a scaled-down
version and prints the live-cell count every few hundred generations
(the gun emits a glider every 30).

    python -m gameoflifewithactors_torch.examples.sparse_gun --side 4096 --gens 900
"""

from __future__ import annotations

import argparse
import sys
import time

from . import add_device_flag


def run(argv=None) -> dict:
    """Print a line per report; return ``{"pops": [(gen, pop), ...],
    "engine": the sparse engine}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=4096)
    ap.add_argument("--gens", type=int, default=900)
    ap.add_argument("--report-every", type=int, default=300)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from .. import Engine
    from ..engine import resolve_device
    from ..models import seeds
    from ..ops.stencil import Topology

    device = resolve_device(args.device)
    grid = seeds.seeded((args.side, args.side), "gosper_gun",
                        args.side // 2, args.side // 2)
    # DEAD boundary: escaped gliders die at the edge instead of wrapping
    # around to destroy the gun
    eng = Engine(grid, "B3/S23", topology=Topology.DEAD, backend="sparse",
                 device=device)
    t0 = time.perf_counter()
    done = 0
    pops = []
    while done < args.gens:
        n = min(args.report_every, args.gens - done)
        eng.step(n)
        done += n
        pops.append((done, eng.population()))
        print(f"gen {done:6d}  pop {pops[-1][1]:6d}  "
              f"({done / (time.perf_counter() - t0):8.1f} gens/s)")
    return {"pops": pops, "engine": eng}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
