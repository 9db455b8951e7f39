"""Tracing and profiling hooks on ``torch.profiler``.

Counterpart of ``gameoflifewithactors_tpu.utils.profiling``: the step loop
can be wrapped in a ``torch.profiler`` trace (a Chrome trace JSON, readable
in ui.perfetto.dev or chrome://tracing) with named ranges around the
phases that matter, plus a wall-clock timer that needs no trace viewer.

:func:`perfetto_summary` reads such a trace back: the device's busy time as
the union of its kernel, copy and fill intervals, the duty cycle over the
span they cover, the longest idle gaps, each named by the host span
(:mod:`.obs.spans`) in whose middle it lies, the top kernels and the
op-class attribution (:func:`.obs.profiler.classify_slice`).
:func:`device_activity` counts what the card ran over ``n`` more
generations of an engine.

The clock: every capture here opens one ``obs.clock_anchor`` range right
after the profiler starts and reads ``time.perf_counter`` (the spans'
clock) as it closes; the reading is stored in the exported trace
(top-level ``obsClockAnchor``), so the range's end places any span of the
process on the trace's timeline (:func:`clock_anchor`).

Only one ``torch.profiler`` can be active in a process: every capture here
(and the sampling profiler's windows) holds :data:`PROFILER_LOCK`, so two
never overlap. ``torch`` is imported inside the functions that need it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

#: Held by every profiler capture of the process (one may be active).
PROFILER_LOCK = threading.Lock()

#: Chrome-trace categories of work the card did: kernels, copies, fills.
#: ``gpu_user_annotation`` ranges lie on the device track too, but they
#: span idle time between kernels and are not work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_NAME = "trace.json"
IDLE_GAPS = 5   # the longest idle gaps a summary lists
#: The range that ties a capture's timeline to ``time.perf_counter``.
CLOCK_ANCHOR = "obs.clock_anchor"
#: Spans of a thread that waits for another rather than does what the
#: card waits on: an idle gap is never named after one.
WAITING_SPANS = frozenset({"serve.lock_wait"})
NO_HOST_SPAN = "no host span"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def annotate(name: str):
    """Named range that shows up on the profiler timeline (host track, and
    on the device track as a ``gpu_user_annotation`` around its work)."""
    import torch

    return torch.profiler.record_function(name)


def _start(prof) -> float:
    """Start ``prof`` and mark the :data:`CLOCK_ANCHOR` range; the
    ``perf_counter`` reading at its end. (Read right after the range
    closes, the reading lies 2-12 us after the end's timestamp; read
    inside, 30-60 us after its start's, and 1.3 ms on a process's first
    range: the entry's cost, measured with ``torch.profiler`` on a CPU.)"""
    import torch

    prof.start()
    with torch.profiler.record_function(CLOCK_ANCHOR):
        pass
    return time.perf_counter()


def _export(prof, path: str, anchor_s: float) -> None:
    """The Chrome trace of ``prof`` at ``path``, with the anchor's
    ``perf_counter`` reading and this process's id."""
    import json as _json

    prof.export_chrome_trace(path)
    with open(path) as f:
        data = _json.load(f)
    data["obsClockAnchor"] = {"perf_counter_s": anchor_s,
                              "pid": os.getpid()}
    with open(path, "w") as f:
        _json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a host and device profile into ``log_dir/trace.json`` (a
    Chrome trace, clock-anchored: see the module docstring)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with PROFILER_LOCK:
        prof = profile(activities=_activities())
        anchor_s = _start(prof)
        try:
            yield
        finally:
            prof.stop()
            _export(prof, os.path.join(log_dir, TRACE_NAME), anchor_s)


def profile_steps(engine, generations: int, log_dir: str, chunk: int = 1) -> None:
    """Trace a short stepped run: one annotated range per chunk, one sync
    at the end (so the trace shows pipelined dispatch, not sync stalls)."""
    with trace(log_dir):
        done = 0
        while done < generations:
            n = min(chunk, generations - done)
            with annotate(f"gol_step x{n}"):
                engine.step(n)
            done += n
        with annotate("gol_sync"):
            engine.block_until_ready()


def device_activity(engine, n: int):
    """(device ops per generation, device-busy ms per generation) of ``n``
    more generations of ``engine`` under ``torch.profiler``: every kernel,
    copy and fill the card ran, by ``key_averages``; (None, None) where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with PROFILER_LOCK:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.step(n)
            engine.block_until_ready()
    ops, busy_us = 0, 0.0
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = getattr(row, "self_cuda_time_total", 0.0)
        if t > 0:
            ops += row.count
            busy_us += t
    if busy_us == 0:
        return None, None
    return ops / n, busy_us / 1e3 / n


@dataclass
class PhaseTimer:
    """Wall-clock phase accumulator: ``with timer.phase("step"): ...``.

    Per-phase totals/counts land in ``summary()`` — the no-dependencies
    answer to "where did the wall-clock go" (device time needs trace()).
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / self.counts[name],
            }
            for name in self.totals
        }


# ---------------------------------------------------------------------------
# Reading a trace back
# ---------------------------------------------------------------------------


def _union_intervals(intervals: list) -> list:
    """Merge (start, end) intervals into a disjoint sorted list."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _union_len(intervals: list) -> float:
    return sum(e - s for s, e in _union_intervals(intervals))


def _intersect_len(a: list, b: list) -> float:
    """Length of the intersection of two interval unions (sweep)."""
    a, b = _union_intervals(a), _union_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _anchor_of(data) -> Optional[Tuple[float, float]]:
    """``(perf_counter seconds, trace us)`` of one instant of a loaded
    trace: the :data:`CLOCK_ANCHOR` range's end; None without one."""
    if not isinstance(data, dict) or "obsClockAnchor" not in data:
        return None
    for ev in data.get("traceEvents", []):
        if (ev.get("name") == CLOCK_ANCHOR and ev.get("ph") == "X"
                and ev.get("cat") != "gpu_user_annotation"):
            return (data["obsClockAnchor"]["perf_counter_s"],
                    float(ev["ts"]) + float(ev.get("dur", 0.0)))
    return None


def clock_anchor(trace_path: str) -> Optional[Tuple[float, float]]:
    """``(perf_counter seconds, trace us)`` of one instant of a capture
    written here, the pair :meth:`.obs.spans.SpanTracer.to_chrome_trace`
    takes to put the process's spans on the capture's timeline; None for
    a trace without an anchor."""
    import json as _json

    with open(trace_path) as f:
        return _anchor_of(_json.load(f))


def _innermost_working(spans: list, t: float) -> str:
    """The name an idle gap with middle ``t`` takes: of each thread's
    innermost span open at ``t``, leaving out threads that wait
    (:data:`WAITING_SPANS`), the latest-starting; :data:`NO_HOST_SPAN`
    where none is left."""
    innermost: dict = {}
    for s in spans:
        if s.t0 <= t <= s.t1:
            cur = innermost.get(s.thread_id)
            if cur is None or (s.depth, s.t0) > (cur.depth, cur.t0):
                innermost[s.thread_id] = s
    working = [s for s in innermost.values() if s.name not in WAITING_SPANS]
    if not working:
        return NO_HOST_SPAN
    return max(working, key=lambda s: s.t0).name


def perfetto_summary(trace_path: str, spans: Optional[list] = None) -> dict:
    """Measured device-activity summary of a Chrome trace written by
    ``torch.profiler`` (``export_chrome_trace``; ``.json`` or ``.json.gz``).

    Device work is every slice of a :data:`DEVICE_CATS` category (kernels,
    copies, fills; the profiler puts them on one track per stream, under
    the device's number as pid). Per device, ``device_busy_us`` is the
    union of its work intervals across streams, ``device_span_us`` the
    time from its first work to its last, ``duty_cycle`` their ratio, and
    ``idle_gaps_us`` the longest gaps between work (at most
    :data:`IDLE_GAPS`); the busiest device is reported.
    ``idle_gaps_named`` lists the same gaps as ``[span name, us]``, each
    named by :func:`_innermost_working` at its middle among ``spans``
    (:class:`.obs.spans.Span` records; by default this process's
    :data:`.obs.spans.TRACER`, when the trace is this process's), placed
    on the trace's timeline by its clock anchor; None where the trace has
    no anchor or the spans are another process's. ``source`` is
    ``"device_tracks"`` when the trace holds device work,
    ``"host_tracks"`` when only host activity was captured (a CPU run, or
    a card the profiler could not see), None for an empty trace.

    Op-class attribution: ``op_class_us`` buckets the reported device's
    work by :func:`.obs.profiler.classify_slice`, each bucket an interval
    union; on a host-only capture, the host track with the most classified
    time. ``top_kernels`` are the device's work names by summed time.
    ``overlap`` is the intersection of collective-class with stencil-class
    device work (None on a host-only capture, never a fabricated 0.0).
    ``tracks`` lists every (process, thread) track with its busy union,
    busiest first, as in the JAX package's summary.
    """
    import gzip
    import json as _json

    from ..obs.profiler import OTHER_CLASS, classify_slice

    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        data = _json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    anchor = _anchor_of(data)

    proc_names: dict = {}
    thread_names: dict = {}
    slices: dict = {}
    work: dict = {}   # device (pid) -> [(s, e, name)]
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                proc_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
            elif ev.get("name") == "thread_name":
                thread_names[(ev.get("pid"), ev.get("tid"))] = (
                    ev.get("args", {}).get("name", "").strip())
        elif ph == "X" and "dur" in ev:
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            name = ev.get("name", "")
            if ev.get("cat") in DEVICE_CATS:
                work.setdefault(ev.get("pid"), []).append((s, e, name))
            elif ev.get("cat") == "gpu_user_annotation":
                continue
            slices.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (s, e, name))

    def label(pid, tid) -> str:
        lbl = f"{proc_names.get(pid, '')}/{thread_names.get((pid, tid), '')}"
        return lbl.strip("/") or f"pid{pid}/tid{tid}"

    tracks = []
    for (pid, tid), evs in slices.items():
        by_name: dict = {}
        by_class: dict = {}
        for s, e, name in evs:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
            by_class.setdefault(classify_slice(name), []).append((s, e))
        tracks.append({
            "track": label(pid, tid),
            "device": pid in work,
            "busy_us": round(_union_len([(s, e) for s, e, _ in evs]), 1),
            "span_us": round(max(e for _, e, _ in evs)
                             - min(s for s, _, _ in evs), 1),
            "n_slices": len(evs),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
            "op_class_us": {cls: round(_union_len(iv), 1)
                            for cls, iv in sorted(by_class.items())},
        })
    tracks.sort(key=lambda t: -t["busy_us"])

    devices = []
    for pid, evs in work.items():
        merged = _union_intervals([(s, e) for s, e, _ in evs])
        busy = sum(e - s for s, e in merged)
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])), reverse=True)
        by_name: dict = {}
        by_class: dict = {}
        for s, e, name in evs:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
            by_class.setdefault(classify_slice(name), []).append((s, e))
        devices.append({
            "pid": pid, "busy": busy, "span": merged[-1][1] - merged[0][0],
            "gaps": gaps, "n": len(evs), "by_name": by_name,
            "by_class": by_class,
            "streams": len({tid for (p, tid) in slices if p == pid})})
    devices.sort(key=lambda d: -d["busy"])
    source = "device_tracks" if devices else ("host_tracks" if tracks else None)

    op_class_us: dict = {}
    attribution_track = None
    top_kernels: list = []
    overlap = None
    if devices:
        dev = devices[0]
        attribution_track = f"device {dev['pid']}"
        op_class_us = {cls: round(_union_len(iv), 1)
                       for cls, iv in sorted(dev["by_class"].items())}
        top_kernels = [[name, round(us, 1)] for name, us in sorted(
            dev["by_name"].items(), key=lambda kv: -kv[1])[:4]]
        coll = [iv for d in devices
                for iv in d["by_class"].get("collective_permute", [])]
        comp = [iv for d in devices for iv in d["by_class"].get("stencil", [])]
        coll_us = _union_len(coll)
        overlap = {
            "collective_us": round(coll_us, 1),
            "compute_us": round(_union_len(comp), 1),
            "overlapped_us": round(_intersect_len(coll, comp), 1),
        }
        overlap["ratio"] = (overlap["overlapped_us"] / coll_us
                            if coll_us > 0 else None)
    elif tracks:
        best = max(tracks, key=lambda t: (
            sum(v for c, v in t["op_class_us"].items() if c != OTHER_CLASS),
            t["busy_us"]))
        attribution_track = best["track"]
        op_class_us = dict(best["op_class_us"])

    dev = devices[0] if devices else None
    named = None
    if anchor is not None:
        if spans is None and data["obsClockAnchor"].get("pid") == os.getpid():
            from ..obs.spans import TRACER

            spans = TRACER.spans()
        if spans is not None:
            gaps = dev["gaps"][:IDLE_GAPS] if dev else []
            # the perf_counter seconds of each gap's middle
            mids = [anchor[0] + ((g0 + g1) / 2 - anchor[1]) / 1e6
                    for _, g0, g1 in gaps]
            spans = [s for s in spans if mids and s.t0 <= max(mids)
                     and s.t1 >= min(mids)]
            named = [[_innermost_working(spans, t), round(g[0], 1)]
                     for t, g in zip(mids, gaps)]
    return {
        "tracks": tracks[:12],
        "source": source,
        "device_tracks": sum(d["streams"] for d in devices),
        "device_track": attribution_track if dev else None,
        "device_busy_us": round(dev["busy"], 1) if dev else 0.0,
        "device_span_us": round(dev["span"], 1) if dev else 0.0,
        "duty_cycle": dev["busy"] / dev["span"] if dev and dev["span"] else None,
        "idle_gaps_us": [round(g[0], 1) for g in dev["gaps"][:IDLE_GAPS]]
        if dev else [],
        "idle_gaps_named": named,
        "device_slices": dev["n"] if dev else 0,
        "top_kernels": top_kernels,
        "attribution_track": attribution_track,
        "op_class_us": op_class_us,
        "overlap": overlap,
    }


def capture_window(window_seconds: float, stop: Optional[threading.Event] = None,
                   opened: Optional[threading.Event] = None) -> Optional[dict]:
    """One ``torch.profiler`` window of ``window_seconds`` (ended early when
    ``stop`` is set), summarized by :func:`perfetto_summary`; None when
    another capture holds :data:`PROFILER_LOCK` (nothing is waited for).
    ``opened`` is set once the profiler records, so a caller can start its
    work inside the window (the first window of a process takes seconds to
    start on a card). Work launched from any thread of the process lands
    on the device tracks."""
    import shutil
    import tempfile

    from torch.profiler import profile

    if not PROFILER_LOCK.acquire(blocking=False):
        if opened is not None:
            opened.set()   # no window comes: nobody should wait for one
        return None
    tmp = tempfile.mkdtemp(prefix="goltorch-profile-")
    try:
        prof = profile(activities=_activities())
        anchor_s = _start(prof)
        try:
            if opened is not None:
                opened.set()
            (stop or threading.Event()).wait(window_seconds)
        finally:
            prof.stop()
        path = os.path.join(tmp, TRACE_NAME)
        _export(prof, path, anchor_s)
        return perfetto_summary(path)
    finally:
        PROFILER_LOCK.release()
        shutil.rmtree(tmp, ignore_errors=True)
