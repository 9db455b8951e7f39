"""Labeled counters / gauges / histograms — the metrics registry.

A copy of ``gameoflifewithactors_tpu.obs.registry``; the serving layer's
metric names are the same in both packages.

``StepMetrics`` (utils/metrics.py) is the per-tick record stream; this is
the cumulative face: named instruments any layer can bump without
plumbing a logger through every call site, snapshotted into the
RunReport at the end of a run. Deliberately tiny and Prometheus-shaped
(name + label dict -> series), stdlib only.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Optional[dict]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class Counter:
    """Monotonic count (events, bytes, cache misses)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._series: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        k = _key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        # reads take the lock too: a dict resize mid-read from a writer
        # thread is a real (if rare) RuntimeError under free-threading,
        # and a torn read is worse — silently wrong
        with self._lock:
            return self._series.get(_key(labels), 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "counter", "help": self.help,
                    "series": [{"labels": dict(k), "value": v}
                               for k, v in self._series.items()]}


class Gauge:
    """Point-in-time value (active tiles, queue depth, HBM bytes)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._series: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_key(labels))

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "gauge", "help": self.help,
                    "series": [{"labels": dict(k), "value": v}
                               for k, v in self._series.items()]}


# decade buckets from 100 µs to 100 s — host-side phase times; compile
# times land in the seconds decades, steady-state ticks in the millis
DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


class Histogram:
    """Bucketed distribution (tick seconds, compile seconds)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._series: Dict[LabelKey, List] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        with self._lock:
            rec = self._series.get(k)
            if rec is None:
                # [bucket counts..., +inf count], total sum, n
                rec = self._series[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            rec[0][bisect.bisect_left(self.buckets, value)] += 1
            rec[1] += value
            rec[2] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "help": self.help,
                    "buckets": list(self.buckets),
                    "series": [{"labels": dict(k), "counts": list(rec[0]),
                                "sum": rec[1], "n": rec[2]}
                               for k, rec in self._series.items()]}


class MetricsRegistry:
    """Name -> instrument. ``counter``/``gauge``/``histogram`` get-or-create
    so call sites never race on registration."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        """Get-or-create. ``buckets=None`` means "whatever this
        instrument has" (DEFAULT_BUCKETS when creating) — so generic
        call sites compose with instruments registered under custom
        boundaries (queue-wait seconds are not step-latency decades).
        Passing explicit buckets that CONFLICT with an existing
        instrument raises: silently observing into someone else's
        boundaries is the bug this guard exists for."""
        inst = self._get(Histogram, name, help,
                         buckets=buckets if buckets is not None
                         else DEFAULT_BUCKETS)
        if buckets is not None and inst.buckets != tuple(sorted(buckets)):
            raise ValueError(
                f"histogram {name!r} is registered with buckets "
                f"{inst.buckets}, not {tuple(sorted(buckets))}; pick a "
                "different name or drop the buckets argument")
        return inst

    def snapshot(self) -> dict:
        with self._lock:
            insts = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(insts.items())}

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()


REGISTRY = MetricsRegistry()
