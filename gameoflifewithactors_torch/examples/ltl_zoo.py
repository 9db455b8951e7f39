"""Larger-than-Life zoo: box, diamond, and multi-state rules side by side.

Runs the same random soup under three LtL rules -- Bosco (the classic
radius-5 box rule), a von Neumann diamond variant, and a Golly C>=3
multi-state rule whose failed survivors decay through dying states --
and prints a population/backends summary. Every rule resolves its own
backend through the Engine's auto routing: on the card the two binary
rules take kernel B4 (box and diamond) and the decay rule the plain
bit-plane stack (no kernel serves multi-state LtL); on the CPU each
takes what the JAX engine picks off its TPU (the byte path for binary
LtL, the plane stack for the decay rule).

    python -m gameoflifewithactors_torch.examples.ltl_zoo --side 128 --gens 20
"""

from __future__ import annotations

import argparse
import sys

from . import add_device_flag

RULES = [
    ("bosco", "Bosco / Bugs (R5 box, binary)"),
    ("R5,C0,M1,S34..58,B34..45,NN", "same intervals, diamond"),
    ("R2,C4,M1,S3..8,B5..9", "radius-2 box, 4 states (decay)"),
]


def run(argv=None) -> dict:
    """Print one line per rule; return ``{spec: final (side, side) grid}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--gens", type=int, default=20)
    ap.add_argument("--fill", type=float, default=0.35)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from .. import Engine
    from ..engine import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    soup = (rng.random((args.side, args.side)) < args.fill).astype(np.uint8)

    finals = {}
    for spec, label in RULES:
        e = Engine(soup, spec, device=device)
        e.step(args.gens)
        print(f"{label:38s} backend={e.backend:6s} "
              f"gen {e.generation:4d}  pop {e.population()}")
        finals[spec] = e.snapshot()
    return finals


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
