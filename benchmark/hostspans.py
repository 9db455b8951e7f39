"""Host spans of a run: the program's own and the benchmark's around them.

:class:`SpanLog` listens to the program's span tracer (its spans are
``coordinator.tick``, ``engine.step``, ``engine.sync``, ``serve.request``,
``lane.dispatch`` and more, each timed on ``time.perf_counter``) and takes
the benchmark's own spans around each call it makes into a layer
(:meth:`SpanLog.span`). Readers count and time them over a window, and
the trace names an idle gap of the device by the spans around it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

# (name, t0, t1, thread name, attrs)
Record = Tuple[str, float, float, str, Optional[dict]]


class SpanLog:
    def __init__(self):
        self.records: List[Record] = []
        self._lock = threading.Lock()
        self._tracer = None

    def start(self) -> "SpanLog":
        from gameoflifewithactors_torch.obs import spans

        self._tracer = spans.TRACER
        self._tracer.add_listener(self._on_span)
        return self

    def stop(self) -> None:
        if self._tracer is not None:
            self._tracer.remove_listener(self._on_span)
            self._tracer = None

    def _on_span(self, s) -> None:
        with self._lock:
            self.records.append((s.name, s.t0, s.t1, s.thread_name, s.attrs))

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1,
                                     threading.current_thread().name,
                                     attrs or None))

    def between(self, t0: float, t1: float) -> List[Record]:
        """The spans that started at or after ``t0`` and ended by ``t1``."""
        with self._lock:
            return [r for r in self.records if r[1] >= t0 and r[2] <= t1]


def summary(records: List[Record]) -> Dict[str, dict]:
    """Count and total seconds of each span name."""
    out: Dict[str, dict] = {}
    for name, t0, t1, _, _ in records:
        entry = out.setdefault(name, {"count": 0, "seconds": 0.0})
        entry["count"] += 1
        entry["seconds"] += t1 - t0
    return out


def innermost_at(records: List[Record], t: float) -> Optional[str]:
    """The name of the latest-starting span open at ``t``."""
    best = None
    for name, t0, t1, _, _ in records:
        if t0 <= t <= t1 and (best is None or t0 > best[1]):
            best = (name, t0)
    return None if best is None else best[0]
