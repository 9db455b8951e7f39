"""Distributed stepping over every mesh position, with throughput.

Demonstrates the sharded fast paths on a mesh of the positions given:
the 2D-tiled SWAR runner, the (N, 1) row-band kernel runner (kernel B2's
slab form, one launch per device and chunk), and the SAME kernel on the
2D mesh via flattened full-width bands. On the CPU the two band layouts
run the same band runner with the slab kernel's plain version (the
kernels' CPU form, as the JAX rig runs its kernel in interpret mode).

``--positions N`` builds each mesh from N positions on ``--device``
(default: every device of its type), the counterpart of the JAX rig's
``--xla_force_host_platform_device_count``:

    python -m gameoflifewithactors_torch.examples.distributed_bands --device cpu --positions 8 --side 512 --gens 64
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..parallel.mesh import add_positions_flag, mesh_devices
from . import add_device_flag

LAYOUTS = (  # (mesh shape: "2d" or "bands", backend, label)
    ("2d", "packed", "2D tiles / SWAR"),
    ("bands", "cuda", "row bands / native kernel"),
    ("2d", "cuda", "2D mesh / flattened bands"),
)


def run(argv=None) -> dict:
    """Print a line per layout; return ``{label: (backend, final grid)}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--gens", type=int, default=64)
    ap.add_argument("--rule", default="B3/S23")
    add_device_flag(ap)
    add_positions_flag(ap)
    args = ap.parse_args(argv)

    from .. import Engine
    from ..parallel import mesh as mesh_lib

    devices = mesh_devices(args.device, args.positions)
    n = len(devices)
    grid = (np.random.default_rng(1)
            .integers(0, 2, size=(args.side, args.side), dtype=np.uint8))

    finals = {}
    for layout, backend, label in LAYOUTS:
        shape = mesh_lib.factor2d(n) if layout == "2d" else (n, 1)
        m = mesh_lib.make_mesh(shape, devices)
        eng = Engine(grid, args.rule, mesh=m, backend=backend,
                     gens_per_exchange=8 if backend == "cuda" else 1)
        eng.step(8)                      # build + warm
        eng.block_until_ready()
        t0 = time.perf_counter()
        eng.step(args.gens)
        eng.block_until_ready()
        dt = time.perf_counter() - t0
        rate = args.side * args.side * args.gens / dt
        print(f"{label:28s} mesh {shape}: {rate:.3e} cell-updates/s  "
              f"(halo {eng.halo_bytes_per_gen()} B/gen, pop {eng.population()})")
        finals[label] = (eng.backend, eng.snapshot())
    return finals


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
