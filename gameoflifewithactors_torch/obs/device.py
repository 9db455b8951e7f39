"""Device-memory sampling into the registry's HBM gauges.

Counterpart of ``DeviceSampler`` in ``gameoflifewithactors_tpu.obs.device``
(the roofline attribution there waits for ROADMAP A15). A daemon thread
polls a memory backend into the ``hbm_bytes_in_use``, ``hbm_bytes_peak``
and ``hbm_bytes_limit`` gauges, the budget ``serve/admission.py`` prices
creates against.

:func:`cuda_memory_backend` reads each card with ``torch.cuda.mem_get_info``
(free and total bytes of the whole card): in use is total minus
free, which counts every process on the card and the caching allocator's
reserve, and the limit is the card's total; the peak is
``torch.cuda.max_memory_allocated`` of this process.
:func:`host_memory_backend` is the CPU stand-in: this process's RSS,
labelled ``source="host_rss"``, and no limit gauge, so admission stays
permissive where no device budget exists (as in the JAX package). Tests
inject their own backend to fake a full card.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional

from .registry import REGISTRY, MetricsRegistry

DEFAULT_INTERVAL_S = 1.0


def host_memory_backend() -> List[dict]:
    """One record: this process's resident set as the CPU stand-in for
    device memory (current RSS from /proc, peak from ``ru_maxrss``)."""
    import resource

    rec = {"device": "0", "platform": "cpu", "source": "host_rss",
           "peak_bytes_in_use":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    try:
        with open("/proc/self/statm") as f:
            rec["bytes_in_use"] = int(f.read().split()[1]) * os.sysconf(
                "SC_PAGE_SIZE")
    except OSError:
        rec["bytes_in_use"] = rec["peak_bytes_in_use"]
    return [rec]


def cuda_memory_backend() -> List[dict]:
    """One record per visible CUDA device: device-wide free/total bytes
    (``torch.cuda.mem_get_info``) and this process's allocation peak."""
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": str(i), "platform": "gpu",
                    "source": "mem_get_info",
                    "bytes_in_use": int(total - free),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_limit": int(total)})
    return out


class DeviceSampler:
    """Background poller: a memory backend -> registry gauges.

    ``with DeviceSampler(0.5): ...`` or ``start()``/``stop()``. Each sample
    sets ``hbm_bytes_in_use`` / ``hbm_bytes_peak`` / ``hbm_bytes_limit``
    labelled by device and platform (plus ``source`` for the host
    stand-in) and bumps ``device_samples``. ``backend`` is a callable
    returning one dict per device (default :func:`cuda_memory_backend`
    when CUDA is available, else :func:`host_memory_backend`);
    ``sample_once()`` is the deterministic step tests drive."""

    _GAUGES = {"bytes_in_use": ("hbm_bytes_in_use",
                                "device memory currently allocated (bytes)"),
               "peak_bytes_in_use": ("hbm_bytes_peak",
                                     "high-water device allocation (bytes)"),
               "bytes_limit": ("hbm_bytes_limit",
                               "device memory capacity (bytes)")}

    def __init__(self, interval_seconds: float = DEFAULT_INTERVAL_S, *,
                 registry: MetricsRegistry = REGISTRY,
                 backend: Optional[Callable[[], List[dict]]] = None):
        if interval_seconds <= 0:
            raise ValueError(
                f"poll interval must be positive, got {interval_seconds}")
        if backend is None:
            import torch

            backend = cuda_memory_backend if torch.cuda.is_available() \
                else host_memory_backend
        self.interval = float(interval_seconds)
        self.registry = registry
        self._backend = backend
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def sample_once(self) -> List[dict]:
        """One poll; returns what the backend reported. Never raises: a
        backend that raises yields an empty sample and a bumped
        ``device_sample_errors`` counter."""
        try:
            stats = self._backend()
        except Exception as exc:  # noqa: BLE001 — telemetry must not kill serving
            self.registry.counter(
                "device_sample_errors",
                "device memory polls that raised").inc(
                    error=type(exc).__name__)
            return []
        for rec in stats:
            labels = {"device": str(rec.get("device", "?")),
                      "platform": str(rec.get("platform", "?"))}
            if rec.get("source") == "host_rss":
                labels["source"] = "host_rss"
            for key, (gname, ghelp) in self._GAUGES.items():
                if rec.get(key) is not None:
                    self.registry.gauge(gname, ghelp).set(
                        float(rec[key]), **labels)
        self.samples += 1
        self.registry.counter(
            "device_samples", "device memory polls completed").inc()
        return stats

    def start(self) -> "DeviceSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll, name="device-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _poll(self) -> None:
        # sample at once (a short run still leaves gauges), then on the
        # interval until stopped
        self.sample_once()
        while not self._stop.wait(self.interval):
            self.sample_once()

    def __enter__(self) -> "DeviceSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
