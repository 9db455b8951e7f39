"""Checkpoint/resume round-trip: run, save, crash, resume, verify.

A universe is one array and resume is bit-exact. This example drives the
Engine + checkpoint API the way a long-running experiment would:
advance, snapshot to disk, "crash", reload into a FRESH engine, advance
both, and prove the resumed trajectory identical to the uninterrupted
one. On the card every engine takes kernel B1.

    python -m gameoflifewithactors_torch.examples.checkpoint_resume --side 512 --gens 300
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from . import add_device_flag


def run(argv=None) -> dict:
    """Print the round trip; return ``{"uninterrupted", "resumed"}``
    final grids. Raises ``SystemExit`` if they differ."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--gens", type=int, default=300)
    ap.add_argument("--rule", default="B3/S23")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from .. import Engine
    from ..engine import resolve_device
    from ..models import seeds
    from ..utils import checkpoint

    device = resolve_device(args.device)
    grid = seeds.seeded((args.side, args.side), "gosper_gun", 8, 8)
    half = args.gens // 2

    # the uninterrupted run
    ref = Engine(grid, args.rule, device=device)
    ref.step(args.gens)

    # the interrupted one: save at the halfway point...
    eng = Engine(grid, args.rule, device=device)
    eng.step(half)
    with tempfile.TemporaryDirectory() as tmpdir:
        path = f"{tmpdir}/halfway.npz"
        checkpoint.save(eng, path)
        print(f"checkpointed at gen {eng.generation} -> {path}")
        del eng  # ...crash...

        # ...and resume into a fresh engine
        eng2 = checkpoint.load_engine(path, device=device)
    print(f"resumed at gen {eng2.generation}")
    eng2.step(args.gens - half)

    want, got = ref.snapshot(), eng2.snapshot()
    same = bool((want == got).all())
    print(f"gen {eng2.generation}: resumed == uninterrupted: {same}, "
          f"population {eng2.population()}")
    if not same:
        raise SystemExit("resume diverged!")
    return {"uninterrupted": want, "resumed": got}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
