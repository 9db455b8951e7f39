"""Compile events and their log: what the tick subtracts and the flight
recorder tapes.

The event types of ``gameoflifewithactors_tpu.obs.compile``. This package
has no jit: what compiles is a kernel library. ``_build`` records one
:class:`CompileEvent` per library it builds or loads: ``kind="cache_miss"``
when ``nvcc`` ran (seconds to minutes on the first call of a tick), and
``"cache_hit"`` when an existing ``.so`` was loaded (no compile), and
:func:`record_aot_load` one ``"aot_loaded"`` event per runner the
warm-start registry (:mod:`..aot.registry`) serves. Only misses count as
compile seconds, so
``COMPILE_LOG.compile_seconds_between`` tells ``GridCoordinator.tick`` how
much of its wall time was a build, as in the JAX package.

:func:`tracked_call` runs a call and records one event when kernel builds
or loads landed inside it (:func:`note_kernel_build` counts them, as the
JAX module's persistent-cache listener counts cache events, under one
name: there is no second counter).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, List

from .registry import REGISTRY

MAX_EVENTS = 4096  # a runaway retrace loop must not grow memory unbounded


def _describe(x) -> str:
    """'int32[512,16]'-style for tensor-likes, short repr otherwise."""
    dtype = getattr(x, "dtype", None)
    shape = getattr(x, "shape", None)
    if dtype is not None and shape is not None:
        return f"{str(dtype).replace('torch.', '')}[{','.join(map(str, shape))}]"
    r = repr(x)
    return r if len(r) <= 32 else r[:29] + "..."


def signature_of(args, kwargs) -> str:
    parts = [_describe(a) for a in args]
    parts += [f"{k}={_describe(v)}" for k, v in sorted(kwargs.items())]
    return ", ".join(parts)


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    runner: str            # what was built: "build:<source>" or a call's name
    signature: str         # the library file, or the call's shape signature
    wall_seconds: float    # the building call's wall time (build-dominated)
    cache_miss: bool       # True: this call ran nvcc
    donated: bool          # kept for the JAX record shape; always False here
    t0: float              # perf_counter at call start
    t1: float              # perf_counter at completion
    # "cache_miss" = nvcc built the library; "cache_hit" = an existing
    # .so was loaded (no compile); "aot_loaded" = a registry record served
    # the runner (aot/registry.py). Only "cache_miss" events count toward
    # compile-second totals.
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

# kernel libraries built (nvcc ran: "miss") and loaded from disk ("hit")
# in this process; tracked_call snapshots them around each call
_BUILD_LOCK = threading.Lock()
_BUILD_COUNTS = {"hit": 0, "miss": 0}


def note_kernel_build(kind: str) -> None:
    """Count one kernel library built (``"miss"``) or loaded from an
    existing file (``"hit"``)."""
    with _BUILD_LOCK:
        _BUILD_COUNTS[kind] += 1
    # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
    REGISTRY.counter("kernel_builds",
                     "kernel libraries built (miss) or loaded (hit)"
                     ).inc(kind=kind)


def build_counts() -> tuple:
    with _BUILD_LOCK:
        return _BUILD_COUNTS["hit"], _BUILD_COUNTS["miss"]


def record_build(runner: str, signature: str, t0: float, t1: float, *,
                 miss: bool, log: CompileEventLog = None) -> CompileEvent:
    """Record one build (``miss``) or load of a kernel library that ran
    over the ``perf_counter`` window [t0, t1]."""
    ev = CompileEvent(runner=runner, signature=signature,
                      wall_seconds=t1 - t0, cache_miss=miss, donated=False,
                      t0=t0, t1=t1, kind="cache_miss" if miss else "cache_hit")
    (log if log is not None else COMPILE_LOG).record(ev)
    if miss:
        REGISTRY.histogram("kernel_build_seconds",
                           "wall seconds of kernel library builds"
                           ).observe(t1 - t0, runner=runner)
    return ev


def record_aot_load(runner: str, signature: str, wall_seconds: float,
                    *, log: CompileEventLog = None) -> None:
    """Record that a registry record served a runner (aot/registry.py
    calls this at load time; on the card the load includes the CUDA-graph
    capture). Attributed like a compile event so the RunReport tells the
    whole warm-start story, but never counted as compile seconds."""
    t1 = time.perf_counter()
    (log if log is not None else COMPILE_LOG).record(CompileEvent(
        runner=runner, signature=signature, wall_seconds=wall_seconds,
        cache_miss=False, donated=False, t0=t1 - wall_seconds, t1=t1,
        kind="aot_loaded"))
    # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
    REGISTRY.counter(
        "aot_loads", "registry records that served a runner"
    ).inc(runner=runner)


def tracked_call(target: Callable, runner: str, args: tuple, kwargs: dict,
                 *, donated: bool = False, log: CompileEventLog = None):
    """Execute ``target(*args, **kwargs)``, recording a CompileEvent when
    kernel libraries were built or loaded inside the call: ``cache_miss``
    when any was built by nvcc, else ``cache_hit``. A call that built and
    loaded nothing costs two ``perf_counter`` and two counter reads."""
    hit0, miss0 = build_counts()
    t0 = time.perf_counter()
    out = target(*args, **kwargs)
    t1 = time.perf_counter()
    hit1, miss1 = build_counts()
    if hit1 > hit0 or miss1 > miss0:
        ev = CompileEvent(
            runner=runner, signature=signature_of(args, kwargs),
            wall_seconds=t1 - t0, cache_miss=miss1 > miss0, donated=donated,
            t0=t0, t1=t1, kind="cache_miss" if miss1 > miss0 else "cache_hit")
        (log if log is not None else COMPILE_LOG).record(ev)
    return out
