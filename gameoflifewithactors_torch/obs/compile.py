"""Compile events and their log: the tape the flight recorder reads.

The event types of ``gameoflifewithactors_tpu.obs.compile``, copied so
that :mod:`.flight` (which taps :data:`COMPILE_LOG`) works as it does
there and dumps the same record shape. This package has no jit; nothing
in it records compile events yet (the kernel builds of ``_build`` are
the candidate, ROADMAP A15/A16), so the log stays empty.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, List

MAX_EVENTS = 4096  # a runaway retrace loop must not grow memory unbounded


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    runner: str            # the wrapped function's name
    signature: str         # shape/dtype signature that triggered the trace
    wall_seconds: float    # the compiling call's wall time (compile-dominated)
    cache_miss: bool       # True: this call paid a REAL XLA compile
    donated: bool          # which of the two jit instances compiled
    t0: float              # perf_counter at call start
    t1: float              # perf_counter at completion
    # warm-start attribution (aot/): "cache_miss" = a real XLA compile
    # ran; "cache_hit" = the jit cache grew but the executable was served
    # from the persistent disk cache (trace + disk read, no compile);
    # "aot_loaded" = a serialized jax.export runner was loaded in place
    # of jitting (aot/registry.py). Only "cache_miss" events count toward
    # compile-second totals — the whole point of the warm path is that
    # the other two cost ~nothing.
    kind: str = "cache_miss"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CompileEventLog:
    """Thread-safe bounded log of compile events, queryable by window —
    the coordinator asks "how much compile landed inside this tick"."""

    def __init__(self, maxlen: int = MAX_EVENTS):
        self._events: Deque[CompileEvent] = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._listeners: List = []

    def add_listener(self, fn) -> None:
        """Call ``fn(event)`` on every recorded event (flight recorder
        tap); runs on the recording thread, outside the log lock."""
        with self._lock:
            self._listeners = self._listeners + [fn]

    def remove_listener(self, fn) -> None:
        # equality, not identity: bound methods are rebuilt per access
        with self._lock:
            self._listeners = [f for f in self._listeners if f != fn]

    def record(self, ev: CompileEvent) -> None:
        with self._lock:
            self._events.append(ev)
            listeners = self._listeners
        for fn in listeners:
            try:
                fn(ev)
            except Exception:
                pass  # a broken tap must not break the compiling call

    def events(self) -> List[CompileEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def total_compile_seconds(self) -> float:
        return sum(e.wall_seconds for e in self.events() if e.cache_miss)

    def compile_seconds_between(self, t0: float, t1: float) -> float:
        """Compile seconds of events that *completed* in the
        ``perf_counter`` window [t0, t1] — a compiling call completes
        inside the tick that paid for it, so completion time is the
        right attribution point."""
        return sum(e.wall_seconds for e in self.events()
                   if e.cache_miss and t0 <= e.t1 <= t1)


COMPILE_LOG = CompileEventLog()
