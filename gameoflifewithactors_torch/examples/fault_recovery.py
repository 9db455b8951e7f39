"""Losing a mesh shard mid-run and recovering bit-exactly.

The reference's fault story is Akka supervision restarting a crashed
CellActor -- which silently loses that cell's state. The mesh equivalent
of a crashed actor is a lost shard; the honest recovery story is
checkpoint-based replay. This example runs a soup on a sharded engine
under GuardedRun, zeroes one position's shard *in place* mid-run
(``fault.drop_shard`` -- O(shard) host work, every other block
untouched), shows the failure detector catching it at the next
checkpoint boundary, and verifies the replayed trajectory is
bit-identical to an unfaulted run. On the card the ``(n, 1)`` mesh's
``auto`` backend is the band runner on kernel B2's slab form.

``--positions N`` builds the ``(N, 1)`` mesh from N positions on
``--device`` (default: every device of its type), the counterpart of the
JAX rig's ``--xla_force_host_platform_device_count``.

    python -m gameoflifewithactors_torch.examples.fault_recovery --side 128 --gens 48
"""

from __future__ import annotations

import argparse

import numpy as np

from ..parallel.mesh import add_positions_flag, mesh_devices
from . import add_device_flag


def run(argv=None) -> dict:
    """Print the fault and the recovery; return ``{"unfaulted",
    "replayed"}`` final grids and ``"backend"``. Raises
    ``AssertionError`` if they differ."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--gens", type=int, default=48)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    add_device_flag(ap)
    add_positions_flag(ap)
    args = ap.parse_args(argv)

    from .. import Engine
    from ..parallel import mesh as mesh_lib
    from ..utils import fault

    devices = mesh_devices(args.device, args.positions)
    n = len(devices)
    mesh = mesh_lib.make_mesh((n, 1), devices)
    rng = np.random.default_rng(2026)
    grid = rng.integers(0, 2, size=(args.side, 2 * args.side),
                        dtype=np.uint8)

    # clean trajectory: the expected population at every checkpoint
    # boundary doubles as the failure detector (a deterministic replay
    # makes the redundant computation exact), and the final state is the
    # oracle
    ref = Engine(grid, "B3/S23", mesh=mesh)
    expected = {0: ref.population()}
    for gen in range(args.checkpoint_every, args.gens + 1,
                     args.checkpoint_every):
        ref.step(args.checkpoint_every)
        expected[gen] = ref.population()

    eng = Engine(grid, "B3/S23", mesh=mesh)
    recoveries = []
    guard = fault.GuardedRun(
        eng, checkpoint_every=args.checkpoint_every,
        validator=lambda e: e.population() == expected.get(e.generation),
        on_recover=recoveries.append)

    half = args.gens // 2
    guard.run(half)
    victim = n // 2
    fault.drop_shard(eng, victim)
    print(f"gen {eng.generation}: dropped device shard {victim} of {n} "
          f"in flight (population now {eng.population()}, "
          f"expected {expected.get(eng.generation)})")

    guard.run(args.gens - half)
    print(f"gen {eng.generation}: recovered {guard.recoveries}x "
          f"(rolled back to gen {recoveries[0] if recoveries else '-'}), "
          f"population {eng.population()}")

    want = ref.snapshot()
    got = eng.snapshot()
    assert np.array_equal(got, want), "replayed trajectory diverged!"
    print("final state bit-identical to the unfaulted run")
    return {"unfaulted": want, "replayed": got, "backend": eng.backend}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
