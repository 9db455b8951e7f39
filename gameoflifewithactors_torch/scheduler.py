"""TickScheduler — host-side generation driver (run/pause/step/rate).

Counterpart of ``gameoflifewithactors_tpu.scheduler``. The reference drives
generations with Akka's timer sending periodic Tick messages to the
coordinator; here a host loop *enqueues* device work and rate-limits with
wall-clock sleeps. Because Engine.step only enqueues, an unpaced scheduler
keeps the device pipeline full (the host is always one generation ahead); a
paced one (rate_hz) gives the reference's watchable-console behavior. Control
methods (pause/resume/stop/step_once) are thread-safe so an interactive
front-end can drive a running loop.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .coordinator import GridCoordinator
from .obs import spans as obs_spans


class TickScheduler:
    def __init__(
        self,
        coordinator: GridCoordinator,
        *,
        rate_hz: Optional[float] = None,
        generations_per_tick: int = 1,
    ):
        if rate_hz is not None and rate_hz <= 0:
            raise ValueError(f"rate_hz must be positive, got {rate_hz}")
        if generations_per_tick < 1:
            raise ValueError("generations_per_tick must be >= 1")
        self.coordinator = coordinator
        self.rate_hz = rate_hz
        self.generations_per_tick = generations_per_tick
        self._paused = threading.Event()
        self._stopped = threading.Event()
        self._wake = threading.Event()

    # -- control (thread-safe) ----------------------------------------------

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        self._wake.set()

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def step_once(self) -> None:
        """Single-step while paused (the reference's debug affordance)."""
        self.coordinator.tick(self.generations_per_tick)

    # -- the loop ------------------------------------------------------------

    def run(self, max_generations: Optional[int] = None) -> int:
        """Blocking tick loop; returns generations run. Use
        ``threading.Thread(target=scheduler.run)`` for a background driver.
        """
        done = 0
        period = 1.0 / self.rate_hz if self.rate_hz else 0.0
        next_due = time.perf_counter()
        # one enclosing span for the whole tick loop: rate-limit sleeps
        # and pause waits are scheduler.run time minus the nested
        # coordinator.tick time, with no extra per-iteration bookkeeping
        with obs_spans.span("scheduler.run",
                            max_generations=max_generations,
                            rate_hz=self.rate_hz):
            while not self._stopped.is_set():
                # quota check must precede the pause check: a completed run
                # should return even if someone paused it at the finish line
                if max_generations is not None and done >= max_generations:
                    break
                if self._paused.is_set():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                n = self.generations_per_tick
                if max_generations is not None:
                    n = min(n, max_generations - done)
                self.coordinator.tick(n)
                done += n
                if period:
                    next_due += period
                    delay = next_due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    else:
                        next_due = time.perf_counter()  # fell behind; don't burst
        return done
