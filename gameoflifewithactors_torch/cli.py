"""Command-line entry point — the reference's ``Program`` role.

``python -m gameoflifewithactors_torch --grid 1024x1024 --seed random
--steps 1000 --population`` runs the stack: config → coordinator → tick
scheduler → renderer/metrics → optional PPM, RLE and checkpoint outputs,
on the GPU unless ``--device cpu``. ``--resume PATH`` continues a
checkpoint (either package's), ``--list`` prints what ``--seed`` and
``--rule`` accept, and a 1D W-rule takes the spacetime route.
``python -m gameoflifewithactors_torch serve ...`` starts the session
service (:mod:`.serve.frontend`). Counterpart of
``gameoflifewithactors_tpu.cli`` for the ported flags and subcommands.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .config import from_args
from .utils.render import ConsoleRenderer


def _run_elementary(cfg, args, rule) -> int:
    """The 1D (Wolfram W0..255) route: evolve the full spacetime diagram on
    the device (ops/elementary.evolve_spacetime), then render rows-as-time:
    ``--grid HxW`` contributes the row width W (H is ignored — time is the
    vertical axis), ``--steps`` the generation count, ``--seed`` center
    (default) / random / empty, ``--render final`` an ASCII diagram,
    ``--ppm`` the image."""
    import numpy as np
    import torch

    from .engine import resolve_device
    from .ops import bitpack
    from .ops.elementary import evolve_spacetime
    from .ops.stencil import Topology

    # flags this route cannot honor must fail loudly, not exit 0 without
    # the requested side effect (a later --resume on the missing file
    # would fail far from the cause)
    for flag, value in (("--checkpoint", cfg.checkpoint),
                        ("--metrics", cfg.metrics), ("--mesh", cfg.mesh),
                        ("--ppm-every", cfg.ppm_every or None),
                        ("--save-rle", cfg.save_rle)):
        if value is not None:
            raise SystemExit(
                f"{flag} is not supported for 1D W-rules (the spacetime "
                "route has no engine state to checkpoint/shard; use --ppm "
                "for the artifact)")

    width = cfg.width
    if width % bitpack.WORD:
        raise SystemExit(
            f"elementary rules run bit-packed: width {width} must be a "
            f"multiple of {bitpack.WORD} (use --grid 1x{width + bitpack.WORD - width % bitpack.WORD})")
    row = np.zeros(width, dtype=np.uint8)
    if cfg.random_fill is not None:                 # --seed random
        # numpy, not a torch.Generator: the same flags give the same bytes
        # as the JAX package's CLI
        row[:] = np.random.default_rng(cfg.rng_seed).random(width) < cfg.random_fill
    elif args.seed in ("glider", "center"):
        # 'glider' is only the 2D default the parser injects; 1D's
        # canonical single-cell seed takes its place (rule 90 from one
        # cell -> the Sierpinski triangle)
        row[width // 2] = 1
    elif args.seed != "empty":
        raise SystemExit(
            f"--seed {args.seed!r} is a 2D seed; 1D W-rules accept "
            "'center' (default), 'random', or 'empty'")

    device = resolve_device(cfg.device)
    start = bitpack.pack(torch.from_numpy(row[None]).to(device))
    st = evolve_spacetime(start, cfg.steps, rule=rule,
                          topology=Topology(cfg.topology))
    image = bitpack.unpack(st[:, 0, :]).cpu().numpy()  # (steps+1, W), row=time

    if args.render in ("final", "live"):
        for line in image:
            print("".join(".#"[v] for v in line))
    if cfg.track_population:
        print(f"gen {cfg.steps}  pop {int(image[-1].sum())}")
    if cfg.ppm:
        from .utils.render import save_ppm

        save_ppm(image, cfg.ppm)
        print(f"spacetime diagram written: {cfg.ppm}", file=sys.stderr)
    return 0


def _list_registries() -> int:
    """``--list``: what names ``--seed`` and ``--rule`` accept (plus the
    notation forms each family parses)."""
    from .models import seeds
    from .models.elementary import parse_elementary
    from .models.generations import GENERATIONS_REGISTRY
    from .models.ltl import LTL_REGISTRY
    from .models.rules import RULE_REGISTRY

    print("seed patterns (--seed NAME, or @file.rle / random / empty):")
    for name in sorted(seeds.PATTERNS):
        h, w = seeds.PATTERNS[name].shape
        print(f"  {name:16} {h}x{w}")
    print("\nlife-like rules (--rule, also any 'B…/S…' or classic 'S/B'):")
    for name, r in sorted(RULE_REGISTRY.items()):
        print(f"  {name:16} {r.notation}")
    print("\nGenerations rules (also 'B…/S…/C<n>' or Golly 'S/B/C'):")
    for name, r in sorted(GENERATIONS_REGISTRY.items()):
        print(f"  {name:16} {r.notation}")
    print("\nLarger-than-Life rules (also 'R,C,M,S..,B..[,NN]' HROT form):")
    for name, r in sorted(LTL_REGISTRY.items()):
        print(f"  {name:16} {r.notation}")
    print("\nelementary (1D): W0..W255, e.g. "
          f"{parse_elementary('W110').notation}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] == "serve":
        # multi-tenant session service: live grid sessions on batched
        # lanes behind an HTTP/JSON API
        from .serve.frontend import main as serve_main

        return serve_main(argv[1:])
    cfg, args = from_args(argv)
    if args.list:
        return _list_registries()

    from .models.elementary import ElementaryRule
    from .models.generations import parse_any

    # --resume wins over --rule (documented in the flag's help): a W-rule
    # left on the command line must not silently replace a resumed 2D run
    if cfg.resume is None and isinstance(parse_any(cfg.rule), ElementaryRule):
        return _run_elementary(cfg, args, parse_any(cfg.rule))
    if cfg.ppm_every and not cfg.ppm:
        raise SystemExit("--ppm-every needs --ppm PATH as the "
                         "filename stem for the frame sequence")

    coordinator, scheduler = cfg.build()

    if args.render == "live":
        coordinator.subscribe(ConsoleRenderer())
    seq = None
    if cfg.ppm_every:
        from .utils.render import PpmSequenceWriter

        seq = PpmSequenceWriter(cfg.ppm)
        # full-resolution snapshots, not the console's downsampled view
        # (the user controls cost via grid size and cadence); the initial
        # state is frame 0 so a movie starts from the seed
        coordinator.subscribe(
            lambda frame: seq.write(coordinator.engine.snapshot(),
                                    frame.generation))
        seq.write(coordinator.engine.snapshot(), coordinator.generation)
    # Pacing (rate limit / periodic metrics / live frames) needs the tick
    # loop; otherwise the whole run is one call into the engine.
    if args.render == "live" or cfg.rate_hz or cfg.metrics:
        scheduler.run(max_generations=cfg.steps)
    elif seq is not None:
        # surface a frame to the sequence every N generations
        coordinator.run(cfg.steps, render_every=cfg.ppm_every)
    else:
        coordinator.run(cfg.steps)

    if args.render == "final":
        ConsoleRenderer(ansi=False)(coordinator.current_frame())
    elif args.render == "off" and cfg.track_population:
        # --population with --render off still reports the number (live and
        # final rendering already show it in the status line)
        frame = coordinator.current_frame()
        print(f"gen {frame.generation}  pop {frame.population}")

    if seq is not None:
        print(f"{len(seq.paths)} frames written: {seq.paths[0]} .. "
              f"{seq.paths[-1]}", file=sys.stderr)
    elif cfg.ppm:
        from .utils.render import save_ppm

        save_ppm(coordinator.engine.snapshot(), cfg.ppm)
        print(f"final frame written: {cfg.ppm}", file=sys.stderr)

    if cfg.save_rle:
        from .models import seeds as seeds_lib

        # binary rules write legacy b/o tokens; multi-state universes get
        # Golly's extended encoding, with the rule in the header so
        # decoders pick the extended reading: the --rule string as given
        # (the JAX CLI's header), or the resumed checkpoint's rule, which
        # --resume puts in place of --rule
        rule = coordinator.rule.notation if cfg.resume else cfg.rule
        with open(cfg.save_rle, "w") as f:
            f.write(seeds_lib.to_rle(coordinator.engine.snapshot(), rule=rule))
        print(f"RLE written: {cfg.save_rle}", file=sys.stderr)

    if cfg.checkpoint:
        from .utils import checkpoint as ckpt_lib

        path = ckpt_lib.save(coordinator.engine, cfg.checkpoint)
        print(f"checkpoint written: {path}", file=sys.stderr)

    coordinator.engine.block_until_ready()
    return 0


if __name__ == "__main__":
    sys.exit(main())
