"""Simulation configuration and CLI parsing.

Counterpart of ``gameoflifewithactors_tpu.config`` for the flags of the
ported paths: grid, rule (life-like, Generations or Larger than Life),
topology, seed, backend (with the sparse backend's tile and capacity),
steps, rendering, rate, metrics, population, the device, the mesh, the
generations per halo exchange, checkpoint and resume, supervision
(``--supervise``, ``--checkpoint-every``, ``--max-restarts``), the
telemetry flags (``--telemetry-out``, ``--stall-deadline``,
``--flight-dump``, ``--serve-metrics``, ``--device-poll``,
``--profile-sample``), the PPM and RLE outputs, ``--cache-dir`` (the
kernel build cache root, :mod:`.aot.cache`) and ``--list``.
``SimulationConfig.build()`` points the kernel builds at the cache root,
then assembles the mesh, the coordinator (from a checkpoint with
``resume``) and the scheduler, so the CLI and library users share one
construction path.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
from typing import Optional, Tuple

from .ops.stencil import Topology


@dataclasses.dataclass
class SimulationConfig:
    height: int = 64
    width: int = 64
    rule: str = "B3/S23"                    # any family parse_any reads
    topology: str = "torus"                 # torus | dead
    seed: Optional[str] = "glider"          # pattern name, @file.rle, or None
    random_fill: Optional[float] = None     # Bernoulli p (overrides seed)
    seed_origin: Optional[Tuple[int, int]] = None
    rng_seed: int = 0
    backend: str = "auto"                   # auto | packed | dense | cuda | sparse
    sparse_tile: Optional[Tuple[int, int]] = None   # (rows, cols), cols % 32 == 0
    sparse_capacity: Optional[int] = None   # max active tiles before dense fallback
    device: str = "cuda"                    # cuda | cpu
    mesh: Optional[str] = None              # None | "auto" | "bands" | "2x4"
    gens_per_exchange: Optional[int] = None  # band chunk; None: the kernel's
    steps: int = 100
    render_every: int = 1
    view_height: int = 40
    view_width: int = 80
    rate_hz: Optional[float] = None
    metrics: Optional[str] = None           # "jsonl" | "csv:PATH" | None
    track_population: bool = False
    checkpoint: Optional[str] = None        # save path (written at end)
    resume: Optional[str] = None            # checkpoint to resume from
    supervise: bool = False                 # restart-with-rollback loop (resilience/)
    checkpoint_every: int = 100             # supervised: auto-checkpoint cadence
    max_restarts: int = 5                   # supervised: circuit-breaker threshold
    ppm: Optional[str] = None               # final-frame / spacetime PPM path
    ppm_every: int = 0                      # full-res frame sequence cadence
    save_rle: Optional[str] = None          # final state as RLE
    telemetry_out: Optional[str] = None     # RunReport JSON path (obs/)
    stall_deadline: Optional[float] = None  # watchdog deadline seconds
    serve_metrics: Optional[int] = None     # Prometheus /metrics port (obs/)
    flight_dump: Optional[str] = None       # flight-recorder dump path;
    #                                         default <telemetry_out>.flight.jsonl
    device_poll: Optional[float] = None     # device-sampler interval seconds
    profile_sample: Optional[float] = None  # sampling-profiler period seconds
    cache_dir: Optional[str] = None         # warm-start cache root (aot/);
    #                                         None = GOLTPU_CACHE_DIR env or
    #                                         gameoflifewithactors_torch/_build

    # -- assembly ------------------------------------------------------------

    def build_mesh(self):
        """The mesh ``--mesh`` names over every device of ``--device``'s
        type: every CUDA device, or the one CPU device. "auto" factors them
        near-square, "bands" stacks them as (n, 1) full-width row bands
        (the layout the band-kernel runners use; one CUDA device makes a
        (1, 1) mesh) and "NXxNY" must use them all."""
        import torch

        from .parallel import mesh as mesh_lib

        if self.mesh is None:
            return None
        devices = None if self.device == "cuda" else [torch.device(self.device)]
        if self.mesh == "auto":
            return mesh_lib.make_mesh(devices=devices)
        if self.mesh == "bands":
            n = torch.cuda.device_count() if devices is None else len(devices)
            return mesh_lib.make_mesh((n, 1), devices)
        try:
            shape = _parse_geometry(self.mesh)
        except argparse.ArgumentTypeError:
            raise ValueError(
                f"--mesh must be 'auto', 'bands', or like '2x4', "
                f"got {self.mesh!r}"
            ) from None
        return mesh_lib.make_mesh(shape, devices)

    def build_metrics(self):
        from .utils import metrics as metrics_lib

        if self.metrics is None:
            return None
        if self.metrics == "jsonl":
            return metrics_lib.MetricsLogger(metrics_lib.JsonlSink(sys.stderr))
        if self.metrics.startswith("csv:"):
            f = open(self.metrics[4:], "w", newline="")
            return metrics_lib.MetricsLogger(metrics_lib.CsvSink(f))
        raise ValueError(f"--metrics must be 'jsonl' or 'csv:PATH', got {self.metrics!r}")

    def build_sparse_opts(self) -> Optional[dict]:
        from .ops import bitpack

        opts = {}
        if self.sparse_tile is not None:
            rows, cols = self.sparse_tile
            if cols % bitpack.WORD:
                raise ValueError(
                    f"--sparse-tile columns must be a multiple of {bitpack.WORD}, got {cols}"
                )
            opts["tile_rows"] = rows
            opts["tile_words"] = cols // bitpack.WORD
        if self.sparse_capacity is not None:
            opts["capacity"] = self.sparse_capacity
        return opts or None

    def build(self):
        """Construct the (mesh, coordinator, scheduler) stack; with
        ``resume``, the coordinator wraps the checkpoint's engine (its
        grid, rule, topology and generation win over the config's)."""
        from .aot import cache as aot_cache
        from .coordinator import GridCoordinator
        from .models import seeds as seeds_lib
        from .scheduler import TickScheduler
        from .utils import checkpoint as ckpt_lib

        # before any engine exists, so an explicit --cache-dir governs
        # every kernel build of the run (Engine re-ensures idempotently)
        aot_cache.ensure_persistent_cache(self.cache_dir)
        mesh = self.build_mesh()
        if self.resume:
            engine = ckpt_lib.load_engine(self.resume, mesh=mesh,
                                          backend=self.backend,
                                          device=self.device)
            coordinator = GridCoordinator.from_engine(
                engine,
                track_population=self.track_population,
                metrics=self.build_metrics(),
                view_shape=(self.view_height, self.view_width),
            )
        else:
            # random_fill overrides the default seed (only an *explicitly*
            # conflicting combination should error, and GridCoordinator
            # can't tell a default 'glider' from a requested one)
            seed = None if self.random_fill is not None else self.seed
            if isinstance(seed, str) and seed.startswith("@"):
                with open(seed[1:]) as f:
                    seed = seeds_lib.from_rle(f.read())
            coordinator = GridCoordinator(
                (self.height, self.width),
                self.rule,
                seed=seed,
                seed_origin=self.seed_origin,
                random_fill=self.random_fill,
                rng_seed=self.rng_seed,
                topology=Topology(self.topology),
                backend=self.backend,
                device=self.device,
                track_population=self.track_population,
                metrics=self.build_metrics(),
                view_shape=(self.view_height, self.view_width),
                mesh=mesh,
                gens_per_exchange=self.gens_per_exchange,
                sparse_opts=self.build_sparse_opts(),
            )
        scheduler = TickScheduler(
            coordinator,
            rate_hz=self.rate_hz,
            generations_per_tick=max(1, self.render_every),
        )
        return coordinator, scheduler


def _parse_geometry(text: str) -> Tuple[int, int]:
    m = re.fullmatch(r"(\d+)x(\d+)", text)
    if not m:
        raise argparse.ArgumentTypeError(f"expected HxW like '1024x1024', got {text!r}")
    return int(m.group(1)), int(m.group(2))


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gameoflifewithactors_torch",
        description="Game of Life on PyTorch and CUDA (capabilities of "
                    "rikace/GameOfLifeWithActors)",
    )
    p.add_argument("--grid", type=_parse_geometry, default=(64, 64), metavar="HxW",
                   help="grid size, e.g. 1024x1024 (default 64x64, the reference's size)")
    p.add_argument("--rule", default="B3/S23",
                   help="rule string or name: life-like B/S (conway, highlife, "
                        "'day & night', ...), Generations (B2/S/C3, brain, "
                        "starwars, ...), Larger than Life "
                        "(R5,C0,M1,S34..58,B34..45, bosco, majority, ...) or "
                        "elementary 1D (W110, rule30: the spacetime route, "
                        "--grid 1xW)")
    p.add_argument("--topology", choices=[t.value for t in Topology], default="torus")
    p.add_argument("--seed", default="glider",
                   help="pattern name, @file.rle, 'random', or 'empty' "
                        "(1D W-rules: 'center', the default, 'random' or "
                        "'empty')")
    p.add_argument("--random-p", type=float, default=0.5, help="fill prob for --seed random")
    p.add_argument("--seed-at", type=_parse_geometry, default=None, metavar="RxC",
                   help="pattern top-left placement (default: centered)")
    p.add_argument("--rng-seed", type=int, default=0)
    p.add_argument("--backend", choices=["auto", "packed", "dense", "cuda", "sparse"],
                   default="auto")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the grid lives and steps (default cuda; cpu "
                        "runs the plain PyTorch path)")
    p.add_argument("--mesh", default=None,
                   help="'auto' (all devices, 2D tiles), 'bands' (all "
                        "devices as (N, 1) full-width row bands -- the "
                        "layout the band-kernel runners use), or 'NXxNY'; "
                        "default single-device")
    p.add_argument("--gens-per-exchange", type=int, default=None, metavar="G",
                   help="with --mesh and the cuda backend: generations per "
                        "halo exchange and kernel launch, 1..32 (default: "
                        "the rule family's kernel default)")
    p.add_argument("--sparse-tile", type=_parse_geometry, default=None, metavar="RxC",
                   help="sparse backend tile size in cells; C %% 32 == 0 "
                        "(default: auto-scaled so the activity map stays small; "
                        "32x128 for small grids)")
    p.add_argument("--sparse-capacity", type=int, default=None, metavar="N",
                   help="sparse backend: max active tiles per step before dense fallback")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--render", choices=["off", "live", "final"], default="off")
    p.add_argument("--render-every", type=int, default=1, metavar="N",
                   help="draw every N generations in live mode")
    p.add_argument("--view", type=_parse_geometry, default=(40, 80), metavar="HxW",
                   help="max console view size (grid is downsampled to fit)")
    p.add_argument("--rate", type=float, default=None, metavar="HZ",
                   help="tick rate limit; default unthrottled")
    p.add_argument("--metrics", default=None, help="'jsonl' (stderr) or 'csv:PATH'")
    p.add_argument("--population", action="store_true", help="track live-cell count")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write final state here")
    p.add_argument("--supervise", action="store_true",
                   help="run under a restart supervisor (resilience/): "
                        "auto-checkpoint to --checkpoint every "
                        "--checkpoint-every generations and, on a "
                        "coordinator exception or watchdog stall, restore "
                        "the last checkpoint and replay with capped "
                        "exponential backoff. Requires --checkpoint PATH")
    p.add_argument("--checkpoint-every", type=int, default=100, metavar="N",
                   help="with --supervise: checkpoint cadence in "
                        "generations (default 100)")
    p.add_argument("--max-restarts", type=int, default=5, metavar="N",
                   help="with --supervise: consecutive failed chunks "
                        "before the circuit breaker gives up (default 5)")
    p.add_argument("--ppm", default=None, metavar="PATH",
                   help="write the final grid (2D rules) or the full "
                        "spacetime diagram (1D W-rules) as a PPM image")
    p.add_argument("--ppm-every", type=int, default=0, metavar="N",
                   help="with --ppm PATH: write a FULL-resolution frame "
                        "every N generations as PATH-stem_NNNNNN.ppm "
                        "(ffmpeg-ready sequence; the final single --ppm "
                        "write is skipped -- the last frame is in the "
                        "sequence). Under --render live/--rate/--metrics "
                        "the sequence follows the tick cadence "
                        "(--render-every) instead")
    p.add_argument("--save-rle", default=None, metavar="PATH",
                   help="write the final state as standard RLE (Golly-"
                        "compatible; multi-state rules in Golly's extended "
                        "form -- round-trips with --seed @file.rle)")
    p.add_argument("--telemetry-out", default=None, metavar="PATH",
                   help="write a RunReport JSON here at end of run: host "
                        "spans (dispatch/sync/readback), kernel builds, "
                        "StepMetrics, halo-byte figures, stalls, the "
                        "roofline (inspect with the 'report' subcommand)")
    p.add_argument("--serve-metrics", type=int, default=None, metavar="PORT",
                   help="serve Prometheus text-format metrics (registry "
                        "counters + live device-memory gauges) at "
                        "http://0.0.0.0:PORT/metrics while the run steps; "
                        "0 picks an ephemeral port (printed to stderr). "
                        "Also honored via $GOLTPU_METRICS_PORT")
    p.add_argument("--flight-dump", default=None, metavar="PATH",
                   help="flight-recorder crash-report path (JSONL): the "
                        "last N StepMetrics/spans/kernel builds + a "
                        "registry snapshot, written on watchdog stall, "
                        "coordinator exception, or SIGTERM/SIGINT. "
                        "Default with --telemetry-out: "
                        "<telemetry-out>.flight.jsonl")
    p.add_argument("--device-poll", type=float, default=None, metavar="S",
                   help="device memory sampler interval in seconds "
                        "(default 1.0, or $GOLTPU_DEVICE_POLL_S); feeds "
                        "the hbm_bytes_* gauges --serve-metrics exposes")
    p.add_argument("--profile-sample", type=float, default=None, metavar="S",
                   help="arm the always-on sampling profiler: one 200 ms "
                        "torch.profiler window every S seconds, op-class "
                        "attribution into the RunReport profile section + "
                        "profile_* gauges (off by default; also honored "
                        "via $GOLTPU_PROFILE_SAMPLE_S; the window is "
                        "capped at 10%% of S)")
    p.add_argument("--stall-deadline", type=float, default=None, metavar="S",
                   help="with --telemetry-out: flag any tick exceeding S "
                        "seconds, naming the last-completed span "
                        "(default 60)")
    p.add_argument("--cache-dir", default=None, metavar="PATH",
                   help="warm-start cache root (the kernel libraries nvcc "
                        "builds + the runner registry; README 'Warm "
                        "start'). Default: $GOLTPU_CACHE_DIR, else "
                        "gameoflifewithactors_torch/_build; pass '' to "
                        "disable caching for this run")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a checkpoint (the checkpoint's grid/rule/"
                        "seed/topology win; --grid/--rule/--seed/--topology "
                        "are ignored)")
    p.add_argument("--list", action="store_true",
                   help="print the registered seed patterns and named rules "
                        "of every family, then exit")
    return p


def from_args(argv=None) -> "tuple[SimulationConfig, argparse.Namespace]":
    args = make_parser().parse_args(argv)
    (h, w) = args.grid
    cfg = SimulationConfig(
        height=h,
        width=w,
        rule=args.rule,
        topology=args.topology,
        seed=None if args.seed in ("random", "empty") else args.seed,
        random_fill=args.random_p if args.seed == "random" else None,
        seed_origin=args.seed_at,
        rng_seed=args.rng_seed,
        backend=args.backend,
        sparse_tile=args.sparse_tile,
        sparse_capacity=args.sparse_capacity,
        device=args.device,
        mesh=args.mesh,
        gens_per_exchange=args.gens_per_exchange,
        steps=args.steps,
        render_every=args.render_every,
        view_height=args.view[0],
        view_width=args.view[1],
        rate_hz=args.rate,
        metrics=args.metrics,
        track_population=args.population,
        checkpoint=args.checkpoint,
        resume=args.resume,
        supervise=args.supervise,
        checkpoint_every=args.checkpoint_every,
        max_restarts=args.max_restarts,
        ppm=args.ppm,
        ppm_every=args.ppm_every,
        save_rle=args.save_rle,
        telemetry_out=args.telemetry_out,
        stall_deadline=args.stall_deadline,
        serve_metrics=args.serve_metrics,
        flight_dump=args.flight_dump,
        device_poll=args.device_poll,
        profile_sample=args.profile_sample,
        cache_dir=args.cache_dir,
    )
    return cfg, args
