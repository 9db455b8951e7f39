"""A million-cell 1D "long context" sharded over every mesh position.

The elementary family's context-parallel runner splits one huge Wolfram
row over the mesh's column axis; each chunk moves ONE 32-cell halo word
per side and advances up to 32 generations locally (the corruption
light-cone creeps 1 cell/generation and the cropped halo word absorbs it
exactly). Rows on the mesh's row axis are independent universes -- here
we run a small ensemble of rules over the same giant row.

``--positions N`` builds the ``(1, N)`` mesh from N positions on
``--device`` (default: every device of its type), the counterpart of the
JAX rig's ``--xla_force_host_platform_device_count``.

    python -m gameoflifewithactors_torch.examples.long_row --cells 1048576 --gens 256
"""

from __future__ import annotations

import argparse
import sys

from ..parallel.mesh import add_positions_flag, mesh_devices
from . import add_device_flag


def run(argv=None) -> dict:
    """Print a line per rule; return ``{rule notation: final (1, cells)
    uint8 row}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=1 << 20)
    ap.add_argument("--gens", type=int, default=256)
    ap.add_argument("--rules", default="W30,W110,W184")
    add_device_flag(ap)
    add_positions_flag(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.elementary import parse_elementary
    from ..ops import bitpack
    from ..parallel import mesh as mesh_lib
    from ..parallel import sharded

    devices = mesh_devices(args.device, args.positions)
    n = len(devices)
    mesh = mesh_lib.make_mesh((1, n), devices)
    g = 32
    chunks, rem = divmod(args.gens, g)
    if rem:
        chunks += 1  # round up: exact gen counts matter less than scale here

    rng = np.random.default_rng(1)
    row = rng.integers(0, 2, size=(1, args.cells), dtype=np.uint8)
    p = bitpack.pack(torch.from_numpy(row))

    finals = {}
    for name in args.rules.split(","):
        rule = parse_elementary(name)
        run_rule = sharded.make_multi_step_elementary_sharded(
            mesh, rule, gens_per_exchange=g)
        out = run_rule(mesh_lib.device_put_sharded_grid(p, mesh),
                       chunks).gather()
        pop = bitpack.population(out)   # exact Python int at any size
        print(f"{rule.notation:5s} {args.cells:>9d} cells x "
              f"{chunks * g:4d} gens over {n} devices  pop {pop}")
        finals[rule.notation] = bitpack.unpack(out).cpu().numpy()
    return finals


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
