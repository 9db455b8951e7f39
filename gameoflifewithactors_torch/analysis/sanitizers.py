"""The retrace budget: the runtime check the Supervisor holds a warmed
run to.

Counterpart of the retrace half of
``gameoflifewithactors_tpu.analysis.sanitizers``. There, a warmed engine
must never pay a real XLA compile again; here what compiles is a kernel
library, so a warmed run must never run ``nvcc`` again (a build lands in
:data:`..obs.compile.COMPILE_LOG` as a ``"cache_miss"`` event; loading
an existing library is a ``"cache_hit"`` and costs nothing).
:class:`RetraceSentinel` taps the log; :meth:`RetraceSentinel.check`
raises :class:`RetraceError` naming what was built. With
``GOLTPU_SANITIZE=1`` (:func:`enabled`) an engine served by the warm-start
registry arms one and checks it after every step. The transfer guards of
the JAX module wait for their own port (ROADMAP A17).
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
