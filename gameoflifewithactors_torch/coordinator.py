"""GridCoordinator — the actor-shaped façade over the stencil engine.

Counterpart of ``gameoflifewithactors_tpu.coordinator``. The reference's
``GridCoordinator`` actor spawns an N×M grid of ``CellActor``s, broadcasts
Tick, barriers on N·M replies, and hands each finished generation to a
renderer. This class keeps that surface — construct, tick, run, snapshot,
subscribe — over one :class:`~.engine.Engine`: a cell's "mailbox" is bit
(32·j+i) of word (r, j), its "receive" the carry-save neighbour sum.

Subscribers play the reference's Renderer role: callables invoked after
each tick (or every ``render_every`` generations) with a RenderFrame. Any
rule the Engine takes (life-like, Generations, Larger than Life) passes
through unchanged; a multi-state frame carries the cells' states. A
``mesh`` (and ``gens_per_exchange``) pass through to the Engine, which
then shards the grid over it; ``sparse_opts`` passes through for the
activity-tiled backends ("sparse", "paged"), whose active tiles a metrics
record carries.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .engine import Engine, placement_device
from .models import seeds as seeds_lib
from .models.generations import GenRule
from .models.ltl import LtLRule
from .models.rules import Rule
from .obs import compile as obs_compile
from .obs import flight as obs_flight
from .obs import spans as obs_spans
from .obs import watchdog as obs_watchdog
from .ops.stencil import Topology
from .utils.metrics import MetricsLogger, StepMetrics


@dataclasses.dataclass(frozen=True)
class RenderFrame:
    """What a subscriber sees after a tick."""

    grid: np.ndarray            # possibly downsampled uint8 view
    generation: int
    population: Optional[int]   # None unless track_population is on
    full_shape: Tuple[int, int]


Subscriber = Callable[[RenderFrame], None]


class GridCoordinator:
    """Facade: construct(grid, rule, seed) / tick() / run(n) / snapshot()."""

    def __init__(
        self,
        shape: Tuple[int, int],
        rule: "Rule | GenRule | LtLRule | str" = "B3/S23",
        *,
        seed: "str | np.ndarray | None" = None,
        seed_origin: Optional[Tuple[int, int]] = None,
        random_fill: Optional[float] = None,
        rng_seed: int = 0,
        topology: Topology = Topology.TORUS,
        backend: str = "auto",
        device=None,
        track_population: bool = False,
        metrics: Optional[MetricsLogger] = None,
        view_shape: Optional[Tuple[int, int]] = None,
        mesh=None,
        gens_per_exchange: Optional[int] = None,
        sparse_opts: Optional[dict] = None,
    ):
        device = placement_device(device, mesh)
        grid = self._build_seed(shape, seed, seed_origin, random_fill,
                                rng_seed, device)
        engine = Engine(grid, rule, topology=topology, backend=backend,
                        device=device, mesh=mesh,
                        gens_per_exchange=gens_per_exchange,
                        sparse_opts=sparse_opts)
        self._init_from_engine(engine, track_population, metrics, view_shape)

    def _init_from_engine(self, engine, track_population, metrics, view_shape) -> None:
        self.engine = engine
        self.track_population = track_population
        self.metrics = metrics
        self.view_shape = view_shape
        self._subscribers: List[Subscriber] = []

    @classmethod
    def from_engine(
        cls,
        engine: Engine,
        *,
        track_population: bool = False,
        metrics: Optional[MetricsLogger] = None,
        view_shape: Optional[Tuple[int, int]] = None,
    ) -> "GridCoordinator":
        """Wrap an existing Engine (e.g. one handed over from the JAX
        package through :meth:`Engine.from_packed`)."""
        self = cls.__new__(cls)
        self._init_from_engine(engine, track_population, metrics, view_shape)
        return self

    @staticmethod
    def _build_seed(shape, seed, seed_origin, random_fill, rng_seed,
                    device: torch.device) -> "np.ndarray | torch.Tensor":
        if random_fill is not None:
            if seed is not None:
                raise ValueError("give either `seed` or `random_fill`, not both")
            gen = torch.Generator(device=device)
            gen.manual_seed(rng_seed)
            return seeds_lib.bernoulli(gen, shape, random_fill)
        if seed is None:
            return seeds_lib.empty(shape)
        if isinstance(seed, str):
            pat = seeds_lib.pattern(seed)
        else:
            pat = np.asarray(seed, dtype=np.uint8)
        if seed_origin is None:
            # center the pattern, like dropping a glider into the middle
            seed_origin = (
                (shape[0] - pat.shape[0]) // 2,
                (shape[1] - pat.shape[1]) // 2,
            )
        return seeds_lib.seeded(shape, pat, *seed_origin)

    # -- reference surface ---------------------------------------------------

    @property
    def rule(self) -> "Rule | GenRule | LtLRule":
        return self.engine.rule

    @property
    def generation(self) -> int:
        return self.engine.generation

    @property
    def shape(self) -> Tuple[int, int]:
        return self.engine.shape

    def subscribe(self, fn: Subscriber) -> Callable[[], None]:
        """Register a per-tick observer; returns an unsubscribe handle."""
        self._subscribers.append(fn)
        return lambda: self._subscribers.remove(fn)

    def tick(self, n: int = 1) -> None:
        """Advance n generations and notify subscribers once. With a
        metrics logger, the tick waits for the device and logs its rate.

        When a stall watchdog is armed (obs.watchdog.arm), the whole tick
        runs under its watch, so a wedged dispatch, sync or subscriber is
        flagged -- with the last-completed span named -- while still stuck
        (on the card the wait shows where the tick syncs: with a metrics
        logger). When a flight recorder is armed (obs.flight.arm), an
        exception escaping the tick leaves a crash dump before
        propagating."""
        wd = obs_watchdog.active_watchdog()
        try:
            if wd is not None:
                with wd.watch(f"tick@gen{self.generation}+{n}"):
                    self._tick(n)
            else:
                self._tick(n)
        except BaseException as exc:
            fr = obs_flight.active_flight_recorder()
            if fr is not None:
                fr.dump("exception in coordinator loop: "
                        f"{type(exc).__name__}: {exc}")
            raise

    def _tick(self, n: int) -> None:
        t0 = time.perf_counter()
        with obs_spans.span("coordinator.tick", generations=n):
            self.engine.step(n)
            if self.metrics is not None:
                self.engine.block_until_ready()
                t1 = time.perf_counter()
                # kernel builds that completed inside this tick (the first
                # launch of a source runs nvcc): reported apart, so
                # wall_seconds -- and the rate from it -- describe stepping
                compile_s = obs_compile.COMPILE_LOG.compile_seconds_between(
                    t0, t1)
                dt = max(t1 - t0 - compile_s, 1e-9)
                cells = self.shape[0] * self.shape[1] * n
                self.metrics.log(
                    StepMetrics(
                        generation=self.generation,
                        generations_stepped=n,
                        wall_seconds=dt,
                        cell_updates_per_sec=cells / dt,
                        population=self.population() if self.track_population else None,
                        # the arithmetic model: the measured source steps a
                        # copy of the state once, which a live loop should not
                        halo_bytes=self.engine.halo_bytes_per_gen(
                            source="model") * n or None,
                        active_tiles=self.engine.active_tiles(),
                        compile_seconds=compile_s or None,
                    )
                )
            self._notify()

    def run(self, generations: int, *, render_every: int = 0) -> None:
        """Run ``generations`` generations; if render_every > 0, surface a
        frame to subscribers every that many generations."""
        if render_every and render_every > 0:
            done = 0
            while done < generations:
                chunk = min(render_every, generations - done)
                self.tick(chunk)
                done += chunk
        else:
            self.tick(generations)

    def notify_now(self) -> None:
        """Surface the current state to subscribers outside a tick (the
        supervisor calls this after a checkpoint restore, so renderers see
        the rolled-back generation instead of a silent jump)."""
        self._notify()

    def snapshot(self) -> np.ndarray:
        return self.engine.snapshot()

    def population(self) -> int:
        return self.engine.population()

    # -- internals -----------------------------------------------------------

    def current_frame(self) -> RenderFrame:
        """The frame a subscriber would see right now (downsampled view)."""
        return RenderFrame(
            grid=self.engine.snapshot(max_shape=self.view_shape),
            generation=self.generation,
            population=self.population() if self.track_population else None,
            full_shape=self.shape,
        )

    def _notify(self) -> None:
        if not self._subscribers:
            return
        # subscriber time (renderers, PPM writers) is host time the tick
        # pays; its own span keeps it separable from dispatch and sync
        with obs_spans.span("coordinator.notify",
                            subscribers=len(self._subscribers)):
            frame = self.current_frame()
            for fn in list(self._subscribers):
                fn(frame)
