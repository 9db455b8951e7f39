"""The control of each cell: the reference put in the program's place,
with one guarantee of the configuration broken, must come out not correct.

    python3 -m benchmark.chip.control --workload NAME --seeds 1 2 3
        [--seconds S]

The configurations state no precision, so the control breaks the torus:
the plain reference that the configuration names steps with dead cells
beyond the edges, in the configuration's layout, where the program's
kernel would (``Engine._run`` of the batch cells, the lane runner of the
sessions cell). On a mesh it steps each card's band alone, without the
row exchange, with dead cells beyond the band. Each seed drives the
cell's whole run through its driver, at the cell's own size on the card,
and prints the checks; the smallest reading over the seeds is the upper
reading of each limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import check, manifest, run


def control_stepper(config: dict):
    """The configuration's reference on its layout, with dead edges."""
    reference = check.Reference(config)
    return lambda words, n: reference.run(words, n, torus=False)


def install(traffic: dict, config: dict, patch) -> None:
    """Put the control in the program's place for a cell of ``traffic``
    and ``config``, with ``patch(obj, name, value)``
    (``monkeypatch.setattr`` or ``setattr``)."""
    step = control_stepper(config)
    if traffic["driver"] == "sessions":
        from gameoflifewithactors_torch.serve import lanes

        def runner(family):
            def run_lane(state, n, mask):
                live = torch.as_tensor(np.asarray(mask) > 0,
                                       device=state.device)
                out = state.clone()
                out[live] = step(state[live], n)
                return out
            return run_lane

        patch(lanes, "lane_runner", runner)
    elif traffic.get("mesh") is not None:
        from gameoflifewithactors_torch.engine import Engine

        patch(Engine, "_run", lambda self, state, n: state.with_parts(
            step(part, n) for part in state.parts))
    else:
        from gameoflifewithactors_torch.engine import Engine

        patch(Engine, "_run", lambda self, state, n: step(state, n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    run.pin_cache()
    install(traffic, config, setattr)
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    for seed in args.seeds:
        spec = run.RunSpec(cell=args.workload, config=config, traffic=traffic,
                           seed=seed, seconds=args.seconds, trace=False,
                           devices=devices)
        out = run.drive(spec)
        checks = {k: v for k, (v, _) in out["checks"].items()}
        print(json.dumps({"control": args.workload, "seed": seed,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
