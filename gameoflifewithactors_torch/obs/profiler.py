"""Always-on sampling profiler: duty-cycled capture -> op-class attribution.

Counterpart of ``gameoflifewithactors_tpu.obs.profiler`` on
``torch.profiler``. :class:`ProfileSampler` is a daemon that opens a short
profiler window (default 200 ms) once per period (default 30 s), reads the
Chrome trace through ``utils.profiling.perfetto_summary``, and publishes
**op-class attribution** -- busy seconds bucketed into
{collective-permute, stencil, copy/reshape, infeed/host, other} by
slice-name classification, the JAX package's five classes, so reports and
``obs.aggregate.PER_CHIP_GAUGES`` stay comparable -- as registry gauges
and a cumulative ``attribution()`` dict the RunReport carries, with the
device's measured duty cycle, its longest idle gaps (bare, and named by
the host span open in each) and its top kernels.

The window is opened from the sampler's thread; the profiler records the
kernels every thread of the process launches, so the device tracks see
the main thread's stepping. Only one ``torch.profiler`` may be active in
a process: a window is skipped (not waited for) while another capture
holds ``utils.profiling.PROFILER_LOCK``. The first window of a process
takes seconds to start on a card; :meth:`ProfileSampler.wait_open` lets
a run begin inside it.

Off by default; armed by ``--profile-sample S`` or
``GOLTPU_PROFILE_SAMPLE_S``. The budget is enforced, not aspirational:
a window/period ratio above :data:`MAX_DUTY_CYCLE` refuses to
construct, and the measured excess (capture wall beyond the window
itself -- start/stop/parse cost) is published as
``profile_overhead_ratio`` so the budget is auditable from a scrape.

Attribution fractions and the measured overlap ratio are per-chip
figures. On a host-only capture (the CPU: no device tracks) attribution
is labeled ``source="host_tracks"`` and ``halo_overlap_ratio_measured``
is ``None``, never a fabricated 0.0. Tests inject a fake ``capture``
callable; ``torch`` is imported inside the capture only.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from typing import Callable, Optional

from .registry import REGISTRY, MetricsRegistry

DEFAULT_WINDOW_S = 0.2
DEFAULT_PERIOD_S = 30.0
ENV_SAMPLE = "GOLTPU_PROFILE_SAMPLE_S"
#: Hard overhead budget: the capture window may occupy at most this
#: fraction of the sampling period.
MAX_DUTY_CYCLE = 0.1

OTHER_CLASS = "other"
#: The attribution buckets, in display order.
OP_CLASSES = ("collective_permute", "stencil", "copy_reshape",
              "infeed_host", OTHER_CLASS)

# First match wins. Collectives before everything (an async
# collective-permute-start must not read as a copy); then the card's
# device-to-device copies and indexing kernels (a "Memcpy DtoD" is no host
# transfer, and torch's "index_elementwise_kernel" no stencil);
# infeed/transfer next; fusions/kernels before copy_reshape so
# "broadcast_multiply_fusion" reads as compute, not as a broadcast; bare
# data-movement ops last. XLA's names classify as in the JAX package.
_CLASS_PATTERNS = (
    ("collective_permute",
     re.compile(r"collective-permute|collective_permute|all-reduce|"
                r"all-gather|reduce-scatter|all-to-all|ppermute|"
                r"^(send|recv)[.-]|nccl", re.IGNORECASE)),
    ("copy_reshape",
     re.compile(r"^memcpy (dtod|ptop)|catarraybatchedcopy|"
                r"index_elementwise|indexselect|indexfunc|index_put|"
                r"scatter_gather|direct_copy_kernel", re.IGNORECASE)),
    ("infeed_host",
     re.compile(r"infeed|outfeed|transfer|memcpy|h2d|d2h|"
                r"buffer[- ]?copy", re.IGNORECASE)),
    ("stencil",
     re.compile(r"fusion|conv|dot|while|custom-call|custom_call|mosaic|"
                r"stencil|reduce-window|select-and-scatter|gol_step|"
                r"goltpu\.dispatch|life_packed_kernel|"
                r"life_generations_kernel|ltl_kernel|elementwise_kernel",
                re.IGNORECASE)),
    ("copy_reshape",
     re.compile(r"copy|reshape|transpose|bitcast|broadcast|slice|"
                r"concatenate|\bpad\b|gather|scatter", re.IGNORECASE)),
)


def classify_slice(name: str) -> str:
    """Op class of one profiler slice name (first matching bucket)."""
    for cls, pat in _CLASS_PATTERNS:
        if pat.search(name):
            return cls
    return OTHER_CLASS


def attribution_path_for(report_path: str) -> str:
    """Where the standalone attribution JSON lives, next to its
    RunReport (``foo.json`` -> ``foo.attribution.json``) — one rule for
    the CLI writer, bench.py's pointer, and the CI artifact glob."""
    stem = (report_path[: -len(".json")]
            if report_path.endswith(".json") else report_path)
    return stem + ".attribution.json"


class ProfileSampler:
    """Duty-cycled sampling profiler: short capture windows -> gauges.

    ``ProfileSampler(period).start()`` captures one window immediately
    (a short run still gets attribution), then one per period until
    ``stop()``. Each window's summary updates cumulative op-class
    seconds, the measured comms/compute overlap, and the registry:

    - ``profile_windows_total`` / ``profile_capture_errors`` counters,
    - ``profile_op_class_seconds_total{op_class,source}`` counter
      (device-seconds: sums meaningfully across a fleet),
    - ``profile_op_class_fraction{op_class,source}`` gauge (per-chip:
      refuses fleet summing),
    - ``profile_duty_cycle`` / ``profile_overhead_ratio`` gauges,
    - ``halo_overlap_ratio_measured`` gauge — only when a device-track
      capture actually observed collectives.

    ``capture`` is the injectable seam (a callable ``(window_s) ->
    summary dict | None``); the default opens a real ``torch.profiler``
    window and reads its Chrome trace. ``sample_once()`` is the
    deterministic unit tests drive; it never raises.
    """

    def __init__(self, period_seconds: Optional[float] = None, *,
                 window_seconds: float = DEFAULT_WINDOW_S,
                 registry: MetricsRegistry = REGISTRY,
                 capture: Optional[Callable[[float], Optional[dict]]] = None):
        if period_seconds is None:
            period_seconds = float(
                os.environ.get(ENV_SAMPLE, DEFAULT_PERIOD_S))
        if period_seconds <= 0:
            raise ValueError(
                f"sampling period must be positive, got {period_seconds}")
        if window_seconds <= 0:
            raise ValueError(
                f"capture window must be positive, got {window_seconds}")
        if window_seconds > period_seconds * MAX_DUTY_CYCLE:
            raise ValueError(
                f"profiler duty cycle {window_seconds / period_seconds:.1%} "
                f"exceeds the {MAX_DUTY_CYCLE:.0%} overhead budget; raise "
                "the period or shrink the window")
        self.period = float(period_seconds)
        self.window = float(window_seconds)
        self.registry = registry
        self._capture = capture or self._capture_window
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._opened = threading.Event()
        with self._lock:
            self._thread: Optional[threading.Thread] = None
            self._started_at: Optional[float] = None
            self._windows = 0
            self._errors = 0
            self._capture_seconds = 0.0
            self._excess_seconds = 0.0   # capture wall beyond the window
            self._op_class_us: dict = {}
            self._collective_us = 0.0
            self._compute_us = 0.0
            self._overlapped_us = 0.0
            self._source: Optional[str] = None
            self._device_busy_us = 0.0
            self._device_span_us = 0.0
            self._idle_gaps_us: list = []
            self._idle_gaps_named: list = []
            self._kernel_us: dict = {}

    # -- capture --------------------------------------------------------------

    def _capture_window(self, window_seconds: float) -> Optional[dict]:
        """One real ``torch.profiler`` window, summarized
        (``utils.profiling.capture_window``); None when another capture
        held the profiler (nothing to attribute is not an error)."""
        from ..utils.profiling import capture_window

        return capture_window(window_seconds, self._stop, self._opened)

    def wait_open(self, timeout: float = 60.0) -> bool:
        """Wait until the first window records (or was skipped, or
        failed); a run started after this lies inside it."""
        return self._opened.wait(timeout)

    def sample_once(self) -> Optional[dict]:
        """One capture window, folded into cumulative state + gauges.
        Never raises — a wedged profiler bumps ``profile_capture_errors``
        instead of taking the run down."""
        t0 = time.perf_counter()
        try:
            summary = self._capture(self.window)
        except Exception as exc:
            self._opened.set()   # a failed window must not hold a waiter
            with self._lock:
                self._errors += 1
            # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
            self.registry.counter(
                "profile_capture_errors",
                "profiler capture windows that raised").inc(
                    error=type(exc).__name__)
            return None
        wall = time.perf_counter() - t0
        self._opened.set()   # an injected capture opens no window of its own
        if not summary:
            with self._lock:
                self._capture_seconds += wall
                self._excess_seconds += max(0.0, wall - self.window)
            return None
        self._fold(summary, wall)
        return summary

    def _fold(self, summary: dict, wall: float) -> None:
        op_us = summary.get("op_class_us") or {}
        overlap = summary.get("overlap") or {}
        source = summary.get("source") or (
            "host_tracks" if summary.get("tracks") else None)
        with self._lock:
            self._windows += 1
            self._capture_seconds += wall
            self._excess_seconds += max(0.0, wall - self.window)
            if source:
                self._source = source
            for cls, us in op_us.items():
                self._op_class_us[cls] = self._op_class_us.get(cls, 0.0) + us
            self._collective_us += overlap.get("collective_us") or 0.0
            self._compute_us += overlap.get("compute_us") or 0.0
            self._overlapped_us += overlap.get("overlapped_us") or 0.0
            self._device_busy_us += summary.get("device_busy_us") or 0.0
            self._device_span_us += summary.get("device_span_us") or 0.0
            self._idle_gaps_us = sorted(
                self._idle_gaps_us + list(summary.get("idle_gaps_us") or []),
                reverse=True)[:5]
            self._idle_gaps_named = sorted(
                self._idle_gaps_named
                + list(summary.get("idle_gaps_named") or []),
                key=lambda gap: -gap[1])[:5]
            for name, us in summary.get("top_kernels") or []:
                self._kernel_us[name] = self._kernel_us.get(name, 0.0) + us
            cum_op = dict(self._op_class_us)
            collective_us = self._collective_us
            overlapped_us = self._overlapped_us
            excess = self._excess_seconds
            started_at = self._started_at
        # publish outside our lock (the registry has its own)
        reg = self.registry
        label_source = source or "?"
        total_us = sum(cum_op.values())
        for cls in OP_CLASSES:
            us = op_us.get(cls)
            if us:
                reg.counter(
                    "profile_op_class_seconds_total",
                    "sampled busy seconds attributed to an op class "
                    "(device-seconds: sums across a fleet)").inc(
                        us / 1e6, op_class=cls, source=label_source)
            if total_us > 0:
                reg.gauge(
                    "profile_op_class_fraction",
                    "share of sampled busy time in an op class "
                    "(per-chip: refuses fleet summing)").set(
                        cum_op.get(cls, 0.0) / total_us,
                        op_class=cls, source=label_source)
        reg.counter("profile_windows_total",
                    "profiler capture windows completed").inc()
        reg.gauge("profile_duty_cycle",
                  "configured capture-window share of the sampling "
                  "period (per-chip)").set(self.window / self.period)
        elapsed = (time.perf_counter() - started_at
                   if started_at is not None else wall)
        if elapsed > 0:
            reg.gauge(
                "profile_overhead_ratio",
                "measured capture cost beyond the window itself, as a "
                "share of elapsed run time (per-chip)").set(
                    min(1.0, excess / elapsed))
        if source == "device_tracks" and collective_us > 0:
            reg.gauge(
                "halo_overlap_ratio_measured",
                "measured share of collective time overlapped with "
                "interior compute (interval-union, device tracks; "
                "per-chip)").set(overlapped_us / collective_us)

    # -- cumulative view ------------------------------------------------------

    def attribution(self) -> dict:
        """Cumulative attribution for the RunReport ``profile`` section.

        ``halo_overlap_ratio_measured`` is the busy-weighted ratio over
        all windows when a device-track capture observed collectives,
        and ``None`` otherwise (host-only capture, or no collectives in
        any window) — absent, never 0.0. The static schedule gauge
        (``halo_overlap_ratio``) rides along for the
        cross-check when the run set it.
        """
        with self._lock:
            windows = self._windows
            errors = self._errors
            cap = self._capture_seconds
            excess = self._excess_seconds
            cum_op = dict(self._op_class_us)
            collective_us = self._collective_us
            compute_us = self._compute_us
            overlapped_us = self._overlapped_us
            source = self._source
            busy_us, span_us = self._device_busy_us, self._device_span_us
            gaps = list(self._idle_gaps_us)
            named = [list(gap) for gap in self._idle_gaps_named]
            kernels = sorted(self._kernel_us.items(), key=lambda kv: -kv[1])
        total_us = sum(cum_op.values())
        out: dict = {
            "source": source,
            "windows": windows,
            "capture_errors": errors,
            "window_seconds": self.window,
            "period_seconds": self.period,
            "duty_cycle": self.window / self.period,
            "capture_seconds_total": round(cap, 6),
            "capture_excess_seconds_total": round(excess, 6),
            "op_class_seconds": {cls: round(cum_op.get(cls, 0.0) / 1e6, 6)
                                 for cls in OP_CLASSES},
            "op_class_fraction": ({cls: cum_op.get(cls, 0.0) / total_us
                                   for cls in OP_CLASSES}
                                  if total_us > 0 else {}),
            "per_chip": True,
            # the device tracks' measured activity (None on host tracks):
            # busy = union of kernel/copy/fill intervals, span = first to
            # last of them, summed over windows
            "device_busy_seconds": (round(busy_us / 1e6, 6)
                                    if source == "device_tracks" else None),
            "device_duty_cycle": (busy_us / span_us if span_us
                                  and source == "device_tracks" else None),
            "idle_gaps_us": gaps,
            # the same gaps where a window could name them: [the host
            # span in whose middle each lies, us] (perfetto_summary)
            "idle_gaps_named": named,
            "top_kernels": [[name, round(us, 1)] for name, us in kernels[:4]],
        }
        measured = None
        if source == "device_tracks" and collective_us > 0:
            measured = overlapped_us / collective_us
            out["overlap_collective_seconds"] = round(collective_us / 1e6, 6)
            out["overlap_compute_seconds"] = round(compute_us / 1e6, 6)
        out["halo_overlap_ratio_measured"] = measured
        static = self.registry.gauge(
            "halo_overlap_ratio",
            "interior compute share of the static block schedule "
            "(per-chip)").value()
        if static is not None:
            out["halo_overlap_ratio_static"] = static
            if measured is not None:
                out["overlap_measured_minus_static"] = measured - static
        return out

    # -- the sampler thread ---------------------------------------------------

    def start(self) -> "ProfileSampler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._started_at = time.perf_counter()
            self._thread = threading.Thread(
                target=self._run, name="profile-sampler", daemon=True)
            thread = self._thread
        thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            # a window's stop, export and parse take a while on a card
            thread.join(timeout=max(60.0, 4 * self.window))

    def _run(self) -> None:
        # capture immediately (a run shorter than one period still gets
        # attribution), then once per period until stopped
        self.sample_once()
        while not self._stop.wait(max(self.period - self.window, 0.01)):
            self.sample_once()

    def __enter__(self) -> "ProfileSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- the process-global armed sampler (mirrors obs.flight.arm) ---------------

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[ProfileSampler] = None


def arm(sampler: ProfileSampler) -> ProfileSampler:
    """Install + start ``sampler`` as the process's armed profiler
    (stopping any predecessor): ``dispatch_annotation`` regions only
    pay their cost while one is armed."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        previous, _ACTIVE = _ACTIVE, sampler
    if previous is not None:
        previous.stop()
    return sampler.start()


def disarm() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        sampler, _ACTIVE = _ACTIVE, None
    if sampler is not None:
        sampler.stop()


def active_sampler() -> Optional[ProfileSampler]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def dispatch_annotation(name: str):
    """A profiler timeline range (``torch.profiler.record_function``) that
    is free when no sampler is armed (``nullcontext``): the engine wraps
    every dispatch in one, so a trace names the dispatch without taxing
    unarmed runs."""
    if active_sampler() is None:
        return contextlib.nullcontext()
    from ..utils.profiling import annotate

    return annotate(name)
