"""Stall watchdog: a monitor thread that flags ticks exceeding a deadline.

A copy of ``gameoflifewithactors_tpu.obs.watchdog`` (stdlib only).
A wedged device shows up as a tick that never returns. The watchdog
watches each tick from a separate thread; when one overruns its deadline
it emits a :class:`StallEvent` naming the *last-completed span* -- so
"wedged inside the first kernel build" vs. "wedged in snapshot readback"
vs. "wedged in a subscriber callback" is readable straight off the
report, without a debugger attached to the hung process. On the card a
stall is visible only where the tick waits for the device: a tick with a
metrics sink (as under ``RunTelemetry``) syncs inside the watch.

One event per stalled tick (not one per poll), and the event fires
*while the tick is still stuck* -- that is the point: the diagnosis must
escape (stderr, a sink, the RunReport of a parallel thread) even if the
tick never finishes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from typing import Callable, Iterator, List, Optional

from . import spans as spans_lib
from .registry import REGISTRY


@dataclasses.dataclass(frozen=True)
class StallEvent:
    label: str                          # what was being watched ("tick@gen8")
    elapsed_seconds: float              # overrun at detection time
    deadline_seconds: float
    last_completed_span: Optional[str]  # where progress was last observed
    open_spans: tuple                   # the stalled thread's span stack
    t: float                            # perf_counter at detection

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["open_spans"] = list(self.open_spans)
        return d


def _default_on_stall(ev: StallEvent) -> None:
    sys.stderr.write(
        f"STALL: {ev.label} exceeded its {ev.deadline_seconds:.1f}s deadline "
        f"({ev.elapsed_seconds:.1f}s elapsed); last completed span: "
        f"{ev.last_completed_span or '<none>'}"
        + (f"; open: {' > '.join(ev.open_spans)}" if ev.open_spans else "")
        + "\n")


class StallWatchdog:
    """``with wd.watch("tick@gen8"): coordinator.tick(...)``.

    The monitor thread polls at ``deadline/4`` (min 10 ms, max 500 ms);
    detection latency is at most one poll past the deadline. ``on_stall``
    defaults to a stderr line; the RunReport reads ``wd.events`` either
    way. Use as a context manager (``with StallWatchdog(1.0) as wd:``)
    or call :meth:`start`/:meth:`stop` explicitly."""

    def __init__(self, deadline_seconds: float, *,
                 tracer: Optional[spans_lib.SpanTracer] = None,
                 on_stall: Optional[Callable[[StallEvent], None]] = None):
        if deadline_seconds <= 0:
            raise ValueError(
                f"deadline must be positive, got {deadline_seconds}")
        self.deadline = float(deadline_seconds)
        self._tracer = tracer or spans_lib.TRACER
        self._on_stall = on_stall or _default_on_stall
        self._extra_on_stall: List[Callable[[StallEvent], None]] = []
        self.events: List[StallEvent] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the watched tick: (label, t0, watched thread's live span stack,
        # flagged)
        self._active: Optional[list] = None

    # -- the watched section -------------------------------------------------

    @contextlib.contextmanager
    def watch(self, label: str) -> Iterator[None]:
        # capture the watched thread's live stack object NOW: the monitor
        # thread must read THIS thread's open spans, and a thread-local
        # getter called over there would see the monitor's own stack
        stack = self._tracer._live_stack()
        with self._lock:
            self._active = [label, time.perf_counter(), stack, False]
        try:
            yield
        finally:
            with self._lock:
                self._active = None

    # -- the monitor thread --------------------------------------------------

    def start(self) -> "StallWatchdog":
        # lifecycle state under the lock too: two threads racing
        # start() must not each spawn a monitor
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            t = self._thread = threading.Thread(
                target=self._monitor, name="stall-watchdog", daemon=True)
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _monitor(self) -> None:
        poll = min(max(self.deadline / 4.0, 0.01), 0.5)
        while not self._stop.wait(poll):
            self._check(time.perf_counter())

    def _check(self, now: float) -> Optional[StallEvent]:
        """One poll; factored out so tests can drive detection without
        racing a real thread."""
        with self._lock:
            active = self._active
            if active is None or active[3]:
                return None
            label, t0, stack, _ = active
            elapsed = now - t0
            if elapsed <= self.deadline:
                return None
            active[3] = True  # one event per stalled tick
            # snapshot the sink chain inside the lock: add_on_stall from
            # another thread (flight-recorder arming) must not mutate the
            # list this poll is iterating
            sinks = [self._on_stall, *self._extra_on_stall]
        last = self._tracer.last_completed()
        ev = StallEvent(
            label=label, elapsed_seconds=elapsed,
            deadline_seconds=self.deadline,
            last_completed_span=last.name if last else None,
            open_spans=tuple(stack), t=now)
        with self._lock:
            self.events.append(ev)
        # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
        REGISTRY.counter("stalls", "ticks that overran the watchdog deadline"
                         ).inc(label=label)
        for sink in sinks:
            try:
                sink(ev)
            except Exception:
                pass  # a broken sink must not kill the monitor thread
        return ev

    def events_since(self, n: int) -> List[StallEvent]:
        """Stall events recorded after index ``n`` — the supervisor's
        poll: snapshot ``len(wd.events)`` before a tick, read the tail
        after it, and any entries are the stalls that tick suffered.
        Under the lock: the monitor thread appends concurrently."""
        with self._lock:
            return list(self.events[n:])

    def add_on_stall(self, fn: Callable[[StallEvent], None]) -> None:
        """Chain an extra stall sink after ``on_stall`` (the flight
        recorder hangs its dump-on-stall here without displacing the
        stderr diagnostic)."""
        # under the lock: the monitor thread snapshots this list
        # mid-poll
        with self._lock:
            self._extra_on_stall = self._extra_on_stall + [fn]

    def remove_on_stall(self, fn: Callable[[StallEvent], None]) -> None:
        # equality, not identity: bound methods are rebuilt per access
        with self._lock:
            self._extra_on_stall = [f for f in self._extra_on_stall
                                    if f != fn]


# -- process-default arming (how the coordinator finds the watchdog) ---------
#
# GridCoordinator.tick wraps itself in the armed watchdog's watch() when
# one is armed, so telemetry setup needs no coordinator plumbing and a
# library user can arm/disarm around any code at all.

_ACTIVE: Optional[StallWatchdog] = None


def arm(wd: StallWatchdog) -> StallWatchdog:
    """Make ``wd`` the process-default watchdog (started) and return it."""
    global _ACTIVE
    _ACTIVE = wd.start()
    return wd


def disarm() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.stop()
    _ACTIVE = None


def active_watchdog() -> Optional[StallWatchdog]:
    return _ACTIVE
