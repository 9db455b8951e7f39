"""Admission control: price a create against live HBM gauges, then
admit, queue, or reject.

A copy of ``gameoflifewithactors_tpu.serve.admission``. The gauges come
from this package's :class:`..obs.device.DeviceSampler`, which reads the
card with ``torch.cuda.mem_get_info``.

The cost model is the lane layer's own (:meth:`SpecFamily.slot_bytes` —
double-buffered packed words per occupied slot, plus the headroom a
growth-repack to the next ladder rung would claim). The *budget* comes
from the metrics registry: ``hbm_bytes_in_use`` / ``hbm_bytes_limit``
gauges that :class:`obs.device.DeviceSampler` maintains — the same
injectable-backend seam the sampler tests use lets the admission tests
fake an exhausted device without owning one. On CPU the sampler's
host-RSS fallback publishes no ``hbm_bytes_limit`` series, so with no
``static_limit_bytes`` configured the controller is deliberately
permissive (a gauge that does not exist must not reject traffic).

Decisions:

- ``admit`` — modelled usage after the create stays under
  ``headroom_fraction`` × limit;
- ``queue`` — over budget but the bounded backpressure queue has room;
  the create parks (session state ``pending``) until closes/compaction
  free memory, and its queue-wait lands in the
  ``session_queue_wait_seconds`` histogram (custom buckets — the
  registry's step-latency decades are wrong for multi-second waits);
- ``reject`` — over budget and the queue is full: fail fast with 429
  semantics rather than building an unbounded promise backlog.

Stdlib + registry only; no torch — admission must answer while the
device is wedged (that is precisely when it must say no).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional, Tuple

from ..obs.registry import REGISTRY, MetricsRegistry

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"

# queue waits run seconds-to-minutes, not the registry's default
# 100µs..100s step-latency decades
QUEUE_WAIT_BUCKETS = (0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

DEFAULT_HEADROOM = 0.85
DEFAULT_QUEUE_LIMIT = 64


class AdmissionRejected(Exception):
    """Raised to the frontend when a create is refused outright."""


class AdmissionController:
    """decide() + the bounded backpressure queue bookkeeping."""

    def __init__(self, *, registry: MetricsRegistry = REGISTRY,
                 headroom_fraction: float = DEFAULT_HEADROOM,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 static_limit_bytes: Optional[int] = None):
        if not 0.0 < headroom_fraction <= 1.0:
            raise ValueError(
                f"headroom_fraction must be in (0, 1], got "
                f"{headroom_fraction}")
        self.registry = registry
        self.headroom_fraction = float(headroom_fraction)
        self.queue_limit = int(queue_limit)
        self.static_limit_bytes = static_limit_bytes
        self._queue: Deque = deque()
        self._lock = threading.Lock()
        self._decisions = registry.counter(
            "session_admission_total",
            "admission decisions by verdict (admit/queue/reject)")
        self._depth = registry.gauge(
            "session_queue_depth", "creates parked by admission control")
        self._wait = registry.histogram(
            "session_queue_wait_seconds",
            "time creates spent parked in the admission queue",
            buckets=QUEUE_WAIT_BUCKETS)
        self._depth.set(0)

    # -- the budget ----------------------------------------------------------

    def hbm_usage(self) -> Optional[Tuple[float, float]]:
        """(bytes_in_use, bytes_limit) summed over devices from the live
        gauges, or None when no limit is known (no sampler running, or a
        backend — CPU host-RSS — that publishes no capacity)."""
        snap = self.registry.snapshot()
        limit_series = (snap.get("hbm_bytes_limit") or {}).get("series", [])
        limit = sum(s.get("value", 0.0) for s in limit_series)
        if self.static_limit_bytes is not None:
            limit = float(self.static_limit_bytes)
        if not limit:
            return None
        use_series = (snap.get("hbm_bytes_in_use") or {}).get("series", [])
        in_use = sum(s.get("value", 0.0) for s in use_series)
        return in_use, limit

    def decide(self, cost_bytes: int, *, tenant: str = "?",
               pool_needed: int = 0,
               pool_free: Optional[int] = None) -> str:
        """One verdict for a create whose modelled lane cost is
        ``cost_bytes``; records the decision counter.

        ``pool_needed``/``pool_free`` add the tile-pool budget (paged
        lanes price in physical tiles, serve/lanes.PagedLanePool
        .pool_pressure): a create whose seed needs more tiles than the
        pool has free queues or rejects exactly like an HBM overdraft —
        pool exhaustion is a scheduling verdict here, never a raise on
        the placement path."""
        verdict = ADMIT
        usage = self.hbm_usage()
        if usage is not None:
            in_use, limit = usage
            if in_use + cost_bytes > self.headroom_fraction * limit:
                verdict = self._queue_or_reject()
        if verdict == ADMIT and pool_free is not None \
                and pool_needed > pool_free:
            verdict = self._queue_or_reject()
        self._decisions.inc(decision=verdict, tenant=tenant)
        return verdict

    def _queue_or_reject(self) -> str:
        with self._lock:
            depth = len(self._queue)
        return QUEUE if depth < self.queue_limit else REJECT

    # -- the queue -----------------------------------------------------------

    def enqueue(self, item, enqueued_at: float) -> None:
        with self._lock:
            if len(self._queue) >= self.queue_limit:
                raise AdmissionRejected(
                    f"admission queue full ({self.queue_limit})")
            self._queue.append((item, enqueued_at))
            self._depth.set(len(self._queue))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self, cost_fn, now: float, fit_fn=None):
        """Pop every queued create that fits the *current* budget (FIFO —
        a big head request blocks smaller ones behind it; fairness over
        utilization). ``cost_fn(item) -> bytes``; optional
        ``fit_fn(item) -> bool`` adds a non-byte budget (tile-pool
        pressure) — a head that does not fit stays at the head, keeping
        its place for the next drain. Yields items and observes their
        queue wait."""
        out = []
        while True:
            with self._lock:
                if not self._queue:
                    break
                item, t0 = self._queue[0]
            usage = self.hbm_usage()
            if usage is not None:
                in_use, limit = usage
                if in_use + cost_fn(item) > self.headroom_fraction * limit:
                    break
            if fit_fn is not None and not fit_fn(item):
                break
            with self._lock:
                # re-check the head: a concurrent drain may have won
                if not self._queue or self._queue[0][0] is not item:
                    continue
                self._queue.popleft()
                self._depth.set(len(self._queue))
            self._wait.observe(max(0.0, now - t0))
            out.append(item)
        return out
