"""The ten demos of the JAX package's ``examples/``, on PyTorch and CUDA.

Each keeps its JAX file's name, its ``main(argv)`` and its flags, and
prints the JAX demo's lines with the same labels and numbers (rates,
timings and paths aside). Each adds ``--device {cuda,cpu}``, default
``cuda``: without a card it raises, and it runs the plain PyTorch path
on the CPU only when asked. ``run(argv)`` does what ``main`` does and
returns the demo's final state, for tests and the smoke script::

    python -m gameoflifewithactors_torch.examples.sparse_gun --device cuda

The mesh demos (``distributed_bands``, ``fault_recovery``, ``long_row``)
take ``--positions N``: a mesh of N positions, all on ``--device``
(``parallel/mesh.make_mesh(shape, [device] * N)``, a device may hold
several positions), by default every device of ``--device``'s type. It
is the counterpart of the JAX rig's
``--xla_force_host_platform_device_count``, not a new feature.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the demo runs: the card (default; raises "
                         "without one) or the plain PyTorch path on the CPU")


def add_positions_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--positions", type=int, default=None, metavar="N",
                    help="mesh positions, every one on --device (default: "
                         "every device of --device's type); the counterpart "
                         "of the JAX rig's "
                         "--xla_force_host_platform_device_count")


def mesh_devices(device: str, positions: Optional[int]) -> List:
    """The devices a mesh demo spreads over: ``positions`` times
    ``device``, or every device of its type (every CUDA device, or the
    one CPU), as ``config.build_mesh`` takes them. Raises without a card
    when ``device`` is ``"cuda"``."""
    import torch

    from ..engine import resolve_device

    dev = resolve_device(device)
    if positions is not None:
        if positions < 1:
            raise ValueError(f"--positions must be >= 1, got {positions}")
        return [dev] * positions
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
