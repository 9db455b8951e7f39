"""Command-line entry point — the reference's ``Program`` role.

``python -m gameoflifewithactors_torch --grid 1024x1024 --seed random
--steps 1000 --population`` runs the stack: config → coordinator → tick
scheduler → renderer/metrics, on the GPU unless ``--device cpu``.
``python -m gameoflifewithactors_torch serve ...`` starts the session
service (:mod:`.serve.frontend`). Counterpart of
``gameoflifewithactors_tpu.cli`` for the ported flags and subcommands.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .config import from_args
from .utils.render import ConsoleRenderer


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] == "serve":
        # multi-tenant session service: live grid sessions on batched
        # lanes behind an HTTP/JSON API
        from .serve.frontend import main as serve_main

        return serve_main(argv[1:])
    cfg, args = from_args(argv)
    coordinator, scheduler = cfg.build()

    if args.render == "live":
        coordinator.subscribe(ConsoleRenderer())
    # Pacing (rate limit / periodic metrics / live frames) needs the tick
    # loop; otherwise the whole run is one call into the engine.
    if args.render == "live" or cfg.rate_hz or cfg.metrics:
        scheduler.run(max_generations=cfg.steps)
    else:
        coordinator.run(cfg.steps)

    if args.render == "final":
        ConsoleRenderer(ansi=False)(coordinator.current_frame())
    elif args.render == "off" and cfg.track_population:
        # --population with --render off still reports the number (live and
        # final rendering already show it in the status line)
        frame = coordinator.current_frame()
        print(f"gen {frame.generation}  pop {frame.population}")

    coordinator.engine.block_until_ready()
    return 0


if __name__ == "__main__":
    sys.exit(main())
