"""Ensemble statistics: a batch of random universes stepped in parallel.

The batched layer turns the framework into an ensemble machine. This
example steps B random soups together as one ``(B, H, W/32)`` tensor and
reports the population trajectory's mean/spread, the classic "soup
settles to ~3% density" experiment. On the card the batch takes B2's
lane form, one launch per chunk for the whole ensemble (a shape the form
cannot take raises); on the CPU the lane form's plain version.

    python -m gameoflifewithactors_torch.examples.ensemble --batch 8 --side 256 --gens 200
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import add_device_flag


def run(argv=None) -> dict:
    """Print a line per report; return ``{"grids": final (B, side, side)
    uint8}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--gens", type=int, default=200)
    ap.add_argument("--rule", default="B3/S23")
    ap.add_argument("--report-every", type=int, default=50)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    import torch

    from ..engine import resolve_device
    from ..models.rules import parse_rule
    from ..ops import bitpack
    from ..ops.stencil import Topology
    from ..parallel import batched

    device = resolve_device(args.device)
    # this example batches the life-like SWAR path; parse_rule rejects
    # other families with a clear error instead of parse_any's pass-through
    rule = parse_rule(args.rule)
    rng = np.random.default_rng(0)
    grids = rng.integers(0, 2, size=(args.batch, args.side, args.side),
                         dtype=np.uint8)
    packed = torch.stack([bitpack.pack(torch.from_numpy(u))
                          for u in grids]).to(device)

    cells = args.side * args.side
    done = 0
    while done < args.gens:
        n = min(args.report_every, args.gens - done)
        # one program for the whole ensemble: B2's lane form steps every
        # universe in one launch per chunk
        packed = batched.multi_step_kernel_batched(
            packed, n, rule=rule, topology=Topology.TORUS)
        done += n
        pops = np.array([bitpack.population(packed[i])
                         for i in range(args.batch)]) / cells
        print(f"gen {done:5d}  density mean {pops.mean():.4f}  "
              f"min {pops.min():.4f}  max {pops.max():.4f}")
    final = torch.stack([bitpack.unpack(p) for p in packed]).cpu().numpy()
    return {"grids": final}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
