"""Supervisor: restart-with-rollback over a GridCoordinator.

Counterpart of ``gameoflifewithactors_tpu.resilience.supervisor``. The
reference framework's one real claim is supervision -- the Akka.NET
coordinator keeps the simulation alive when something under it
misbehaves. Its restart semantics, though, silently re-initialize the
failed actor's state. This supervisor keeps the *policy* shape (detect,
restart with backoff, give up after too many) but makes the restart
honest: state comes back from the last validated checkpoint
(``utils/checkpoint.py``) and the lost generations are replayed, so a
recovered run is bit-identical to one that never faulted.

The loop runs in checkpoint-sized chunks. After each chunk the
supervisor decides *clean or faulted*, in a fixed order:

1. an exception escaped ``tick`` (kernel errors surface at sync time);
2. the armed StallWatchdog flagged the tick (``events_since``);
3. a fault was injected through :meth:`Supervisor.inject` since the
   last boundary -- the "detected failure" channel the fault plan uses;
4. a state validator (``utils/fault.py`` validators) rejected the grid.

Clean chunks checkpoint (atomically) and reset the failure streak;
faulted chunks restore the last checkpoint, sleep a capped exponential
backoff, and retry, until ``max_restarts`` consecutive failures open the
circuit breaker. Checkpoints are only ever written after a clean
verdict, so every restore point is valid by construction. A failure is
never turned into a run on another device: the restore lands on the
engine's own device, and a kernel that keeps failing opens the circuit.

Retrace faults are the exception to rollback: an induced kernel build
corrupts no state, so it is *attributed* -- the supervisor's
RetraceSentinel (armed after the first clean chunk) must have seen the
build, the sentinel is reset, and the run continues. Any build still
unexplained when :meth:`run` finishes raises ``RetraceError``: no kernel
build after warm-up, with teeth.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

from ..analysis import sanitizers as _sanitizers
from ..coordinator import GridCoordinator
from ..obs import flight as obs_flight
from ..obs import spans as obs_spans
from ..obs import watchdog as obs_watchdog
from ..obs.registry import REGISTRY
from ..utils import checkpoint as ckpt_lib
from ..utils.fault import Validator


class CircuitOpenError(RuntimeError):
    """Too many consecutive failed restarts -- the supervisor gave up."""


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How hard to try before declaring the run dead.

    ``max_restarts`` counts *consecutive* failures: any clean chunk
    resets the streak (the Akka "maxNrOfRetries within a window" knob,
    with the window measured in progress instead of wall time --
    deterministic under replay). Backoff is capped exponential:
    ``min(initial * factor**n, max)`` seconds before restart ``n``."""

    max_restarts: int = 5
    backoff_initial_seconds: float = 0.05
    backoff_max_seconds: float = 2.0
    backoff_factor: float = 2.0

    def backoff(self, consecutive_failures: int) -> float:
        n = max(0, consecutive_failures - 1)
        return min(self.backoff_initial_seconds * self.backoff_factor ** n,
                   self.backoff_max_seconds)


class Supervisor:
    """``Supervisor(coordinator, checkpoint_path=...).run(n)``.

    ``sleep_fn`` is injectable so tests assert the backoff schedule
    without paying it. ``validators`` are consulted on every chunk
    boundary; ``on_restart`` (if given) is called with
    ``(cause, restored_generation, attempt)`` after each restore."""

    def __init__(
        self,
        coordinator: GridCoordinator,
        *,
        checkpoint_path: str,
        checkpoint_every: int = 100,
        validators: Sequence[Validator] = (),
        policy: Optional[RestartPolicy] = None,
        sleep_fn: Callable[[float], None] = time.sleep,
        on_restart: Optional[Callable[[str, int, int], None]] = None,
        before_chunk: Optional[Callable[[int], None]] = None,
    ):
        if checkpoint_every <= 0:
            raise ValueError(
                f"checkpoint_every must be positive, got {checkpoint_every}")
        self.coordinator = coordinator
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.validators = list(validators)
        self.policy = policy or RestartPolicy()
        self._sleep = sleep_fn
        self._on_restart = on_restart
        # public on purpose: a fault applier is built around the
        # constructed supervisor, then hung here
        self.before_chunk = before_chunk
        # injected-fault channel + stats are read from other threads (the
        # metrics server's health_info hook, scrapes), so all mutable
        # shared state lives under one lock
        self._lock = threading.Lock()
        self._pending_fault: Optional[str] = None
        self._restarts = 0
        self._restarts_by_cause: dict = {}
        self._checkpoints = 0
        self._retraces_attributed = 0
        self._stalls_detected = 0
        self._validator_trips = 0
        self._checkpoint_fallbacks = 0
        self._circuit_open = False
        self._sentinel = _sanitizers.RetraceSentinel(
            context="supervised run (post-warm)")

    # -- the detected-failure channel ----------------------------------------

    def inject(self, kind: str, fn: Callable) -> None:
        """Apply a fault ``fn(engine)`` now and mark it pending, so the
        next chunk boundary treats the state as failed and restores --
        the *detected* half of the fault model (an exception or
        validator trip is the undetected half; both end in the same
        rollback). ``retrace`` faults are attributed on the spot instead:
        no state was harmed, but the sentinel must have seen the build."""
        with self._lock:
            if kind != "retrace":
                self._pending_fault = kind
        obs_flight.note_event("supervisor_inject",
                              {"fault": kind,
                               "at_gen": self.coordinator.generation})
        fn(self.coordinator.engine)
        if kind == "retrace":
            self._attribute_retrace()

    def _attribute_retrace(self) -> None:
        if not self._sentinel.misses():
            raise AssertionError(
                "induced retrace produced no cache_miss -- the injection "
                "is broken, not the sentinel")
        self._reset_sentinels()
        REGISTRY.counter("supervisor_faults_detected_total",
                         "faults the supervisor detected, by cause"
                         ).inc(cause="retrace")
        obs_flight.note_event("retrace_attributed",
                              {"at_gen": self.coordinator.generation})
        with self._lock:
            self._retraces_attributed += 1

    def _reset_sentinels(self) -> None:
        """Forget taped builds on the supervisor's sentinel: after an
        attributed retrace or a restore, taped misses are explained --
        leaving them would fail every later check."""
        self._sentinel.reset()

    # -- observability --------------------------------------------------------

    @property
    def generation(self) -> int:
        return self.coordinator.generation

    def stats(self) -> dict:
        """A snapshot for /healthz, reports, and tests."""
        with self._lock:
            return {
                "generation": self.coordinator.generation,
                "restarts": self._restarts,
                "restarts_by_cause": dict(self._restarts_by_cause),
                "checkpoints": self._checkpoints,
                "retraces_attributed": self._retraces_attributed,
                "stalls_detected": self._stalls_detected,
                "validator_trips": self._validator_trips,
                "checkpoint_fallbacks": self._checkpoint_fallbacks,
                "circuit_open": self._circuit_open,
            }

    # -- the supervised loop ---------------------------------------------------

    def run(self, generations: int) -> dict:
        """Advance ``generations`` generations under supervision; returns
        :meth:`stats`. Raises :class:`CircuitOpenError` after
        ``policy.max_restarts`` consecutive failed chunks, and
        ``RetraceError`` if any post-warm kernel build is left
        unattributed at the end."""
        target = self.coordinator.generation + generations
        # gen-0 restore point: the first chunk must have somewhere to
        # roll back to
        self._save_checkpoint()
        consecutive = 0
        warmed = False
        while self.coordinator.generation < target:
            if self.before_chunk is not None:
                self.before_chunk(self.coordinator.generation)
            chunk = min(self.checkpoint_every,
                        target - self.coordinator.generation)
            cause = self._run_chunk(chunk)
            if cause is None:
                self._save_checkpoint()
                consecutive = 0
                if not warmed:
                    # warm-up builds are legit; from here on a kernel
                    # build must be an attributed injection
                    warmed = True
                    self._sentinel.arm()
                continue
            consecutive += 1
            self._restart(cause, consecutive)
        self._sentinel.disarm()
        self._sentinel.check()  # unattributed post-warm retrace -> raise
        return self.stats()

    def _run_chunk(self, chunk: int) -> Optional[str]:
        """One chunk; returns None when clean, else the failure cause."""
        wd = obs_watchdog.active_watchdog()
        wd_mark = len(wd.events) if wd is not None else 0
        exc: Optional[BaseException] = None
        try:
            with obs_spans.span("supervisor.chunk", generations=chunk,
                                start_gen=self.coordinator.generation):
                self.coordinator.tick(chunk)
        except Exception as e:  # noqa: BLE001 -- the whole point is retry
            exc = e
        with self._lock:
            pending, self._pending_fault = self._pending_fault, None
        stalls = wd.events_since(wd_mark) if wd is not None else []
        if stalls:
            with self._lock:
                self._stalls_detected += len(stalls)
        if exc is not None:
            if pending is not None:
                # the injected fault is what blew up the tick (a
                # poisoned buffer): one fault, one restart, attributed to
                # the injection
                return f"fault:{pending}"
            return "exception"
        if stalls:
            return "stall" if pending != "stall" else "fault:stall"
        if pending is not None:
            return f"fault:{pending}"
        for validator in self.validators:
            if not validator(self.coordinator.engine):
                REGISTRY.counter(
                    "validator_trips_total",
                    "state-validator rejections (guard + supervisor)"
                ).inc(where="supervisor")
                obs_flight.note_event(
                    "validator_trip",
                    {"where": "supervisor",
                     "at_gen": self.coordinator.generation})
                with self._lock:
                    self._validator_trips += 1
                return "validator"
        return None

    def _save_checkpoint(self) -> None:
        # keep the outgoing checkpoint reachable as <path>.prev: if the
        # new file later turns out truncated/corrupt (bitrot, torn
        # write outside our atomic-replace discipline), restore falls
        # back to it instead of crashing the run
        # a span of its own (not in the JAX package): at full width the
        # saves, not the stepping, take a supervised run's time
        with obs_spans.span("supervisor.checkpoint",
                            generation=self.coordinator.generation):
            ckpt_lib.rotate_previous(self.checkpoint_path)
            ckpt_lib.save(self.coordinator.engine, self.checkpoint_path)
        REGISTRY.counter("supervisor_checkpoints_total",
                         "clean-chunk checkpoints written").inc()
        with self._lock:
            self._checkpoints += 1
        REGISTRY.gauge("supervisor_generation",
                       "last checkpointed generation"
                       ).set(self.coordinator.generation)

    def _load_restore_point(self):
        """The last checkpoint, or -- when it turns out corrupt or
        missing -- the ``.prev`` generation :meth:`_save_checkpoint`
        rotated aside. A corrupt checkpoint is a *detected durability
        fault*, not a crash: the fallback is counted, taped, and the
        (older) restore point's replay still converges bit-exactly."""
        try:
            return ckpt_lib.load_grid(self.checkpoint_path)
        except (ckpt_lib.CheckpointCorruptError, FileNotFoundError) as exc:
            prev = str(self.checkpoint_path) + ".prev"
            REGISTRY.counter(
                "supervisor_checkpoint_fallbacks_total",
                "restores that fell back to the .prev checkpoint "
                "because the newest one was corrupt/missing").inc()
            obs_flight.note_event(
                "checkpoint_fallback",
                {"path": str(self.checkpoint_path),
                 "error": f"{type(exc).__name__}: {exc}"})
            with self._lock:
                self._checkpoint_fallbacks += 1
            return ckpt_lib.load_grid(prev)

    def _restart(self, cause: str, consecutive: int) -> None:
        REGISTRY.counter("supervisor_faults_detected_total",
                         "faults the supervisor detected, by cause"
                         ).inc(cause=cause)
        if consecutive > self.policy.max_restarts:
            with self._lock:
                self._circuit_open = True
            REGISTRY.gauge("supervisor_circuit_open",
                           "1 when the restart circuit breaker tripped"
                           ).set(1)
            obs_flight.note_event("supervisor_circuit_open",
                                  {"cause": cause,
                                   "failures": consecutive})
            raise CircuitOpenError(
                f"{consecutive} consecutive failed chunks (last cause: "
                f"{cause}) exceeded max_restarts="
                f"{self.policy.max_restarts}; circuit open at generation "
                f"{self.coordinator.generation}")
        delay = self.policy.backoff(consecutive)
        if delay > 0:
            self._sleep(delay)
        with obs_spans.span("supervisor.restart", cause=cause,
                            attempt=consecutive):
            grid, meta = self._load_restore_point()
            self.coordinator.engine.set_grid(grid,
                                             generation=meta["generation"])
        self._reset_sentinels()
        REGISTRY.counter("supervisor_restarts_total",
                         "checkpoint-restore restarts, by cause"
                         ).inc(cause=cause)
        obs_flight.note_event(
            "supervisor_restart",
            {"cause": cause, "to_gen": self.coordinator.generation,
             "attempt": consecutive, "backoff_seconds": delay})
        with self._lock:
            self._restarts += 1
            self._restarts_by_cause[cause] = \
                self._restarts_by_cause.get(cause, 0) + 1
        if self._on_restart is not None:
            self._on_restart(cause, self.coordinator.generation,
                             consecutive)
        # renderers and other subscribers see the rolled-back state
        # instead of a silent generation jump
        self.coordinator.notify_now()
