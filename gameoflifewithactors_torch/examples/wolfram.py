"""Elementary (Wolfram) 1D CA: print a spacetime diagram to the console.

Rule 90 from a single seed cell draws the Sierpinski triangle; rule 110
(Turing-complete) and rule 30 (chaos) are one flag away. The whole
evolution is computed on the device into one preallocated spacetime
tensor over the packed row, then shipped once for rendering.

    python -m gameoflifewithactors_torch.examples.wolfram --rule W90 --width 128 --steps 48
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import add_device_flag


def run(argv=None) -> dict:
    """Print the diagram; return ``{"image": (steps+1, width) uint8}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rule", default="W90", help="W0..W255 (or rule<N>)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--seed", default="center",
                    choices=["center", "random"])
    add_device_flag(ap)
    args = ap.parse_args(argv)

    import torch

    from .. import evolve_spacetime, pack, parse_elementary, unpack
    from ..engine import resolve_device

    device = resolve_device(args.device)
    rule = parse_elementary(args.rule)
    row = np.zeros(args.width, dtype=np.uint8)
    if args.seed == "center":
        row[args.width // 2] = 1
    else:
        row[:] = np.random.default_rng(0).integers(0, 2, args.width)

    st = evolve_spacetime(pack(torch.from_numpy(row[None]).to(device)),
                          args.steps, rule=rule)
    image = unpack(st[:, 0, :]).cpu().numpy()   # (steps+1, width), row = time
    for t, line in enumerate(image):
        print("".join(" #"[v] for v in line))
    print(f"{rule.notation}: {args.steps} generations of {args.width} cells")
    return {"image": image}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
