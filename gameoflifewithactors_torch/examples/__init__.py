"""The ten demos of the JAX package's ``examples/``, on PyTorch and CUDA.

Each keeps its JAX file's name, its ``main(argv)`` and its flags, and
prints the JAX demo's lines with the same labels and numbers (rates,
timings and paths aside). Each adds ``--device {cuda,cpu}``, default
``cuda``: without a card it raises, and it runs the plain PyTorch path
on the CPU only when asked. ``run(argv)`` does what ``main`` does and
returns the demo's final state, for tests and the smoke script::

    python -m gameoflifewithactors_torch.examples.sparse_gun --device cuda

The mesh demos (``distributed_bands``, ``fault_recovery``, ``long_row``)
take ``--positions N`` (``parallel/mesh.add_positions_flag`` and
``mesh_devices``): a mesh of N positions, all on ``--device``
(``parallel/mesh.make_mesh(shape, [device] * N)``, a device may hold
several positions), by default every device of ``--device``'s type. It
is the counterpart of the JAX rig's
``--xla_force_host_platform_device_count``, not a new feature.
"""

from __future__ import annotations

import argparse


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the demo runs: the card (default; raises "
                         "without one) or the plain PyTorch path on the CPU")
