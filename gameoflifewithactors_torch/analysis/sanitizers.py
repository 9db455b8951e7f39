"""Runtime sanitizers: the transfer guard and the retrace budget.

Counterpart of ``gameoflifewithactors_tpu.analysis.sanitizers``, opt-in
through ``GOLTPU_SANITIZE=1`` (:func:`enabled`), so production runs pay
nothing.

**Transfer guard.** :func:`no_implicit_host_transfers` wraps the
engine's step dispatch: on a CUDA device it sets
``torch.cuda.set_sync_debug_mode("error")``, so any operation that makes
the host wait for the card -- a device-to-host read (``.item()``,
``.cpu()``, ``.tolist()``, ``int(t)``, ``torch.nonzero``) or a blocking
host-to-device copy -- raises instead of silently serializing the
dispatch loop. The sanctioned readbacks (snapshot, population, the
sparse engine's candidate count, the paged pool's flags, the gloo
staging of a strip between processes) declare themselves with
:func:`allow_host_transfers`; the allow scopes ARE the list of every
sync point. ``torch.cuda.synchronize()`` and ``Event.synchronize()`` wait
without the debug mode's hook, so a deliberate wait passes. On a CPU
device both scopes do nothing: a CPU tensor needs no transfer, and CPU
torch has no sync debug mode to set (it raises).

The mode is process-global, where JAX's transfer guard is thread-local.
The scopes therefore nest and restore under one lock with a depth count
per kind: while any allow scope is open in the process the mode is off,
else while any guard is open it is ``"error"``, else it is what it was
before the first scope opened. When threads overlap, this prefers a
missed sync to a false raise: an allow scope in one thread lifts the
guard of another for its duration. A thread that syncs outside any scope
while another holds the guard does raise; the package's own threads
either step and read under the session service's lock or read no device
memory (watchdog, exporter, profiler, aggregator).

**Retrace budget.** There, a warmed engine
must never pay a real XLA compile again; here what compiles is a kernel
library, so a warmed run must never run ``nvcc`` again (a build lands in
:data:`..obs.compile.COMPILE_LOG` as a ``"cache_miss"`` event; loading
an existing library is a ``"cache_hit"`` and costs nothing).
:class:`RetraceSentinel` taps the log; :meth:`RetraceSentinel.check`
raises :class:`RetraceError` naming what was built. With
``GOLTPU_SANITIZE=1`` (:func:`enabled`) an engine served by the warm-start
registry arms one and checks it after every step.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, List, Optional

from ..obs import compile as obs_compile

ENV_SANITIZE = "GOLTPU_SANITIZE"
_ENABLED_VALUES = ("1", "true", "on", "yes")


def enabled() -> bool:
    """Is the opt-in sanitizer wiring live (``GOLTPU_SANITIZE=1``)?
    Read per call, so a test can flip it with monkeypatch.setenv."""
    return os.environ.get(ENV_SANITIZE, "").strip().lower() \
        in _ENABLED_VALUES


# -- the transfer guard --------------------------------------------------------

_MODE_LOCK = threading.Lock()
_depth = {"guard": 0, "allow": 0}
_saved_mode: List[int] = []     # the mode before the outermost scope


def _set_mode_locked() -> None:
    import torch

    if _depth["allow"]:
        mode = 0
    elif _depth["guard"]:
        mode = 2                # "error"
    else:
        mode = _saved_mode.pop()
    torch.cuda.set_sync_debug_mode(mode)


def _enter(kind: str) -> bool:
    """Open a scope of ``kind``; an allow scope opens only inside another
    scope (returns whether it did)."""
    import torch

    with _MODE_LOCK:
        outermost = not _depth["guard"] and not _depth["allow"]
        if outermost and kind == "allow":
            return False
        if outermost:
            _saved_mode.append(torch.cuda.get_sync_debug_mode())
        _depth[kind] += 1
        try:
            _set_mode_locked()
        except BaseException:
            _depth[kind] -= 1
            if outermost:
                _saved_mode.pop()
            raise
        return True


def _exit(kind: str) -> None:
    with _MODE_LOCK:
        _depth[kind] -= 1
        _set_mode_locked()


def guard_depth() -> int:
    """Guards open in the process (for tests and reports)."""
    with _MODE_LOCK:
        return _depth["guard"]


@contextlib.contextmanager
def no_implicit_host_transfers(device=None) -> Iterator[None]:
    """Make every host sync inside the scope raise on ``device`` (a no-op
    unless sanitizing, and on a CPU device). ``device`` is where the
    guarded work runs: a ``torch.device``, a string, or None for the
    CPU."""
    if not enabled() or device is None or \
            getattr(device, "type", str(device).split(":")[0]) != "cuda":
        yield
        return
    _enter("guard")
    try:
        yield
    finally:
        _exit("guard")


@contextlib.contextmanager
def allow_host_transfers(reason: str) -> Iterator[None]:
    """Declare a sanctioned host readback. ``reason`` is mandatory and
    unused at run time: it makes every allow scope of the tree read as
    its own justification. Lifts the guard for the scope's duration; a
    no-op when no guard is open in the process (on the CPU, or not
    sanitizing)."""
    if not reason:
        raise ValueError("allow_host_transfers requires a reason string")
    if not enabled() or not _enter("allow"):
        yield
        return
    try:
        yield
    finally:
        _exit("allow")


class RetraceError(AssertionError):
    """A warmed run built a kernel library (retrace budget blown)."""


class RetraceSentinel:
    """Tap the compile log; fail fast when cache_miss events exceed the
    budget. ``arm()``/``disarm()`` bracket the watched window;
    ``check()`` raises; ``misses()`` inspects."""

    def __init__(self, budget: int = 0, *, context: str = "",
                 log: Optional[obs_compile.CompileEventLog] = None):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = budget
        self.context = context
        self._log = log if log is not None else obs_compile.COMPILE_LOG
        self._events: List[obs_compile.CompileEvent] = []
        self._lock = threading.Lock()
        self._armed = False

    def _on_event(self, ev) -> None:
        # listener exceptions are swallowed by CompileEventLog.record,
        # so never raise here — tape the miss, let check() do the failing
        if getattr(ev, "cache_miss", False):
            with self._lock:
                self._events.append(ev)

    def arm(self) -> "RetraceSentinel":
        if not self._armed:
            self._armed = True
            self._log.add_listener(self._on_event)
        return self

    def disarm(self) -> None:
        if self._armed:
            self._armed = False
            self._log.remove_listener(self._on_event)

    def misses(self) -> List[obs_compile.CompileEvent]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        """Forget taped misses without disarming -- supervised recovery
        attributes a *planned* retrace fault to its injection and re-arms
        the budget for the remainder of the run."""
        with self._lock:
            self._events.clear()

    def check(self) -> None:
        misses = self.misses()
        if len(misses) > self.budget:
            detail = "; ".join(
                f"{e.runner}({e.signature}) {e.wall_seconds:.2f}s"
                for e in misses[:4])
            more = f" (+{len(misses) - 4} more)" if len(misses) > 4 else ""
            raise RetraceError(
                f"retrace budget blown{' for ' + self.context if self.context else ''}: "
                f"{len(misses)} kernel build(s) after warm "
                f"(budget {self.budget}): {detail}{more} -- a warmed "
                "run building means a source, a header or the build "
                "flags changed under it, or a new variant was asked for")

    def __enter__(self) -> "RetraceSentinel":
        return self.arm()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.disarm()
        if exc_type is None:
            self.check()


@contextlib.contextmanager
def retrace_budget(budget: int = 0, *, context: str = "",
                   log: Optional[obs_compile.CompileEventLog] = None,
                   ) -> Iterator[RetraceSentinel]:
    """``with retrace_budget(): engine.step(n)`` -- raises RetraceError on
    exit if more than ``budget`` kernel builds landed inside the scope.
    Always live: the caller opting into the context *is* the opt-in."""
    sentinel = RetraceSentinel(budget, context=context, log=log)
    with sentinel:
        yield sentinel
