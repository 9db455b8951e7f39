"""Command-line entry point — the reference's ``Program`` role.

``python -m gameoflifewithactors_torch --grid 1024x1024 --seed random
--steps 1000 --population`` runs the stack: config → coordinator → tick
scheduler → renderer/metrics → optional PPM, RLE and checkpoint outputs,
on the GPU unless ``--device cpu``. ``--resume PATH`` continues a
checkpoint (either package's), ``--list`` prints what ``--seed`` and
``--rule`` accept, and a 1D W-rule takes the spacetime route.
``--supervise`` runs the steps under the restart supervisor
(:mod:`.resilience`); ``--telemetry-out`` writes a RunReport
(:mod:`.obs.report`), which ``python -m gameoflifewithactors_torch report
PATH [--json] [--diff OTHER]`` reads back (a report of either package).
``python -m gameoflifewithactors_torch serve ...`` starts the session
service (:mod:`.serve.frontend`), and ``python -m
gameoflifewithactors_torch warmup ...`` fills the warm-start caches
(:mod:`.aot`). Counterpart of ``gameoflifewithactors_tpu.cli``.
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
                        ("--supervise", cfg.supervise or None),
                        ("--metrics", cfg.metrics), ("--mesh", cfg.mesh),
                        ("--ppm-every", cfg.ppm_every or None),
                        ("--save-rle", cfg.save_rle),
                        ("--telemetry-out", cfg.telemetry_out),
                        ("--serve-metrics", cfg.serve_metrics),
                        ("--flight-dump", cfg.flight_dump),
                        ("--device-poll", cfg.device_poll),
                        ("--profile-sample", cfg.profile_sample)):
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


def _report_cmd(argv: Sequence[str]) -> int:
    """``python -m gameoflifewithactors_torch report run.json``: the human
    face of a RunReport written by ``--telemetry-out`` (either package's)
    -- phases, kernel builds, rates, stalls, the roofline, the device duty
    cycle. Pure file reading: builds no engine and never touches the
    device. ``--diff`` says first when a side's record is stale
    (:func:`.obs.diff.record_staleness` with :mod:`.utils.provenance`)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="gameoflifewithactors_torch report",
        description="summarize a RunReport JSON (--telemetry-out artifact)")
    ap.add_argument("path", help="RunReport JSON file (the baseline in "
                                 "--diff mode)")
    ap.add_argument("--json", action="store_true",
                    help="re-emit the raw JSON (validated) instead")
    ap.add_argument("--diff", default=None, metavar="OTHER.json",
                    help="instead of a summary, print the per-phase / "
                         "per-metric delta table PATH -> OTHER (thin "
                         "wrapper over obs.diff; OTHER is the newer run)")
    args = ap.parse_args(argv)
    from .obs.report import RunReport

    if args.diff:
        # raw-JSON loads: either side may be a bench record, not a
        # RunReport -- the differ speaks both shapes
        import json as json_lib

        from .obs import diff as diff_lib
        from .utils import provenance

        with open(args.path) as f:
            base = json_lib.load(f)
        with open(args.diff) as f:
            other = json_lib.load(f)
        rows = diff_lib.diff_records(base, other)
        if args.json:
            print(json_lib.dumps([r.to_dict() for r in rows], indent=1))
        else:
            for which, rec in (("baseline", base), ("current", other)):
                why = diff_lib.record_staleness(rec, provenance=provenance)
                if why:
                    print(f"{which} record is stale: {why}")
            print(f"delta {args.path} -> {args.diff} "
                  "(ratio = other / baseline):")
            print("\n".join(diff_lib.format_rows(rows)))
        return 0
    rep = RunReport.load(args.path)
    if args.json:
        print(rep.to_json())
    else:
        print("\n".join(rep.summary_lines()))
    return 0


def _warmup_cmd(argv: Sequence[str]) -> int:
    """``python -m gameoflifewithactors_torch warmup``: the warmup pipeline
    (README "Warm start") -- fill the kernel build cache and the runner
    registry for a manifest of engine specs ahead of serving, so the
    serving processes pay no ``nvcc``.

    ``--manifest specs.json`` warms a JSON list of EngineSpec dicts;
    ``--from-config`` warms the single spec the remaining (normal CLI)
    flags describe, e.g.::

        python -m gameoflifewithactors_torch warmup --from-config \\
            --grid 4096x4096 --rule B3/S23 --backend packed
    """
    import argparse

    ap = argparse.ArgumentParser(
        prog="gameoflifewithactors_torch warmup",
        description="build engine specs' kernels and registry records "
                    "into the warm-start caches")
    ap.add_argument("--manifest", metavar="PATH",
                    help="JSON list of spec objects: {rule, shape|height/"
                         "width, backend, topology, mesh, gens_per_exchange}")
    ap.add_argument("--from-config", action="store_true",
                    help="derive one spec from the remaining normal CLI "
                         "flags (--grid/--rule/--backend/...)")
    ap.add_argument("--cache-dir", default=None, metavar="PATH",
                    help="cache root override (default: $GOLTPU_CACHE_DIR "
                         "or gameoflifewithactors_torch/_build)")
    ap.add_argument("--no-aot", action="store_true",
                    help="fill the kernel build cache only; skip writing "
                         "registry records")
    ap.add_argument("--json", action="store_true",
                    help="emit the warmup report as one JSON line")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the specs' engines run (default cuda)")
    args, rest = ap.parse_known_args(argv)
    if bool(args.manifest) == bool(args.from_config):
        ap.error("exactly one of --manifest / --from-config is required")
    if rest and not args.from_config:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    from .aot import EngineSpec, warmup_specs
    from .aot.warmup import load_manifest_entries

    if args.manifest:
        # (spec, extras) pairs: entries carrying a "lanes" ladder also
        # warm the serve layer's lane kernel (README "Serving")
        specs = load_manifest_entries(args.manifest)
    else:
        cfg, _ = from_args(rest)
        cfg.device = args.device
        specs = [EngineSpec.from_config(cfg)]
    rows = warmup_specs(
        specs, aot=not args.no_aot, cache_dir=args.cache_dir,
        device=args.device,
        verbose=None if args.json else
        (lambda line: print(line, file=sys.stderr)))
    if args.json:
        import json

        print(json.dumps({"warmup": True, "specs": rows}))
    else:
        total = sum(r["wall_seconds"] for r in rows)
        compiling = sum(r["compile_seconds"] for r in rows)
        print(f"warmed {len(rows)} spec(s) in {total:.2f}s "
              f"({compiling:.2f}s compiling); next process warm-starts")
    return 0


def _check_supervise(cfg, needs_pacing: bool) -> None:
    """The JAX CLI's refusals of ``--supervise``: it restores from the
    checkpoint it keeps, and it owns the tick loop."""
    if not cfg.checkpoint:
        raise SystemExit(
            "--supervise needs --checkpoint PATH: the restart policy "
            "restores from the checkpoint it maintains there")
    if needs_pacing:
        raise SystemExit(
            "--supervise owns the tick loop; it is incompatible with "
            "--render live, --rate, and --metrics pacing (run the "
            "supervised process under --serve-metrics instead)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] == "report":
        return _report_cmd(argv[1:])
    if argv and argv[0] == "warmup":
        return _warmup_cmd(argv[1:])
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

    # Pacing (rate limit / periodic metrics / live frames) needs the tick
    # loop; otherwise the whole run is one call into the engine.
    needs_pacing = bool(args.render == "live" or cfg.rate_hz or cfg.metrics)
    if cfg.supervise:
        _check_supervise(cfg, needs_pacing)

    coordinator, scheduler = cfg.build()

    # continuous telemetry: live Prometheus exposition + device sampler,
    # started BEFORE the run loop (the point is scraping while stepping);
    # daemon threads, explicitly stopped at the end
    import os

    exporter = sampler = None
    serve_port = cfg.serve_metrics
    if serve_port is None and os.environ.get("GOLTPU_METRICS_PORT"):
        serve_port = int(os.environ["GOLTPU_METRICS_PORT"])
    if serve_port is not None:
        from .obs.device import DEFAULT_INTERVAL_S, DeviceSampler
        from .obs.exporter import serve_metrics

        exporter = serve_metrics(serve_port)
        poll = cfg.device_poll or float(
            os.environ.get("GOLTPU_DEVICE_POLL_S", DEFAULT_INTERVAL_S))
        sampler = DeviceSampler(poll).start()
        print(f"serving metrics: http://0.0.0.0:{exporter.port}/metrics",
              file=sys.stderr)

    # flight recorder: armed for any telemetry run (default path rides
    # next to the RunReport), or standalone via --flight-dump
    flight_path = cfg.flight_dump or (
        cfg.telemetry_out + ".flight.jsonl" if cfg.telemetry_out else None)
    # sampling profiler (obs/profiler.py): off by default, armed by
    # --profile-sample or $GOLTPU_PROFILE_SAMPLE_S
    profile_sample = cfg.profile_sample
    if profile_sample is None and os.environ.get("GOLTPU_PROFILE_SAMPLE_S"):
        profile_sample = float(os.environ["GOLTPU_PROFILE_SAMPLE_S"])
    standalone_profiler = None
    telem = None
    if cfg.telemetry_out:
        from .obs import begin_run_telemetry

        # the session starts AFTER build: the watchdog watches run time
        # only, not seed parsing
        telem = begin_run_telemetry(
            stall_deadline=cfg.stall_deadline or 60.0,
            flight_path=flight_path,
            profile_sample=profile_sample)
        telem.attach(coordinator)
    elif profile_sample:
        # no report to fold into, but the profile_* gauges still feed
        # --serve-metrics scrapes
        from .obs import profiler as profiler_lib

        standalone_profiler = profiler_lib.arm(
            profiler_lib.ProfileSampler(profile_sample))
        standalone_profiler.wait_open()
    if telem is None and flight_path:
        from .obs import flight as flight_lib

        fr = flight_lib.arm(flight_lib.FlightRecorder(flight_path))
        if coordinator.metrics is not None:
            # tape before user-facing sinks (see RunTelemetry.attach)
            coordinator.metrics.sinks.insert(0, fr.on_step)

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
    if cfg.supervise:
        from .resilience import RestartPolicy, Supervisor

        supervisor = Supervisor(
            coordinator, checkpoint_path=cfg.checkpoint,
            checkpoint_every=cfg.checkpoint_every,
            policy=RestartPolicy(max_restarts=cfg.max_restarts))
        stats = supervisor.run(cfg.steps)
        if stats["restarts"]:
            print(f"supervisor: recovered from {stats['restarts']} "
                  f"failure(s) {stats['restarts_by_cause']}",
                  file=sys.stderr)
    elif needs_pacing:
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

    if telem is not None:
        report = telem.finish(
            engine=coordinator.engine,
            config={"steps": cfg.steps, "argv": list(argv)})
        report.save(cfg.telemetry_out)
        print(f"telemetry report written: {cfg.telemetry_out}",
              file=sys.stderr)
        if report.profile is not None:
            # the standalone attribution artifact: the report's profile
            # section, greppable without the report
            import json as _json

            from .obs.profiler import attribution_path_for

            apath = attribution_path_for(cfg.telemetry_out)
            with open(apath, "w") as f:
                _json.dump(report.profile, f, indent=1)
                f.write("\n")
            print(f"profile attribution written: {apath}", file=sys.stderr)
    else:
        if standalone_profiler is not None:
            from .obs import profiler as profiler_lib

            if standalone_profiler is profiler_lib.active_sampler():
                profiler_lib.disarm()
            else:
                standalone_profiler.stop()
        if flight_path:
            from .obs import flight as flight_lib

            flight_lib.disarm()  # clean exit: no crash report to leave

    if sampler is not None:
        sampler.stop()
    if exporter is not None:
        exporter.stop()

    coordinator.engine.block_until_ready()
    return 0


if __name__ == "__main__":
    sys.exit(main())
