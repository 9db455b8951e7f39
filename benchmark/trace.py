"""The traced window of a ``--trace 1`` run, and what is read from it.

:class:`TracedWindow` opens a ``torch.profiler`` window (host and CUDA
activity) over part of the measured window, between two ticks or while
the clients run, again where the trace lost records, and marks each
slice's start with a host annotation so that host spans
(``time.perf_counter``) and device records share one clock.
:func:`reduce` turns the exported trace into what the metrics read: each
card's busy seconds (the union of its kernels, copies and fills inside
the window), device time and records by kernel name, and the breakdown:
the device operations that took most time, and the longest idle gaps,
each named by the innermost host span open in its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from . import hostspans

ANCHOR = "benchmark.trace_anchor"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the program's kernels as the profiler names them (B1 and B2 share a body)
OWN_KERNELS = ("life_packed_kernel", "life_generations_kernel", "ltl_kernel")
# profiled slices of one run before its trace counts as not whole
TRACE_ATTEMPTS = 3
TOP = 10


def _activities(devices):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def own_records(trace: dict) -> int:
    """Records of the program's kernels in a reduced trace."""
    return sum(k["count"] for name, k in trace["kernels"].items()
               if any(own in name for own in OWN_KERNELS))


class TracedWindow:
    """Profiled slices of the measured window, one after another, until
    one is whole: its records of the program's kernels equal the launches
    the program counted in it (the tracer drops records now and then), or
    ``TRACE_ATTEMPTS`` slices were taken. The driver opens and closes each
    slice where no launch is in flight, reading the program's launch
    counters at both ends; :attr:`trace` is the last slice's, with
    ``whole`` set."""

    def __init__(self, devices: Sequence, log: hostspans.SpanLog):
        self.devices = list(devices)
        self.log = log
        self.attempts = 0
        self.trace: Optional[dict] = None
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self._launches0: Dict[str, int] = {}
        self._launches: Dict[str, int] = {}

    def warm(self) -> None:
        """Open and close one short window: the first of a process starts
        the device tracer, which takes seconds. Part of set-up."""
        import torch

        with torch.profiler.profile(activities=_activities(self.devices)):
            for d in self.devices:
                torch.ones(1, device=d).add_(1)
            for d in self.devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    def wanted(self) -> bool:
        """Whether another slice is to be taken."""
        return (self.prof is None and self.attempts < TRACE_ATTEMPTS
                and not (self.trace is not None and self.trace["whole"]))

    @property
    def open(self) -> bool:
        return self.prof is not None

    def start(self, launches: Dict[str, int]) -> None:
        import torch

        self._launches0 = dict(launches)
        self.t_stop = None
        self.prof = torch.profiler.profile(
            activities=_activities(self.devices))
        self.prof.start()
        with torch.profiler.record_function(ANCHOR):
            self.t_start = time.perf_counter()

    def stop(self, launches: Dict[str, int]) -> None:
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self._launches = {k: launches[k] - self._launches0.get(k, 0)
                          for k in launches}

    def reduce(self) -> Optional[dict]:
        """Export and reduce the slice just stopped; the trace, or None
        where it holds no anchor."""
        prof, self.prof = self.prof, None
        self.attempts += 1
        fd, path = tempfile.mkstemp(prefix="benchmark_trace_", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        trace = reduce(events, self.t_start, self.t_stop, len(self.devices),
                       self.log.between(self.t_start, self.t_stop))
        if trace is not None:
            counted = sum(self._launches.values())
            trace["counters"] = {"launches": self._launches}
            trace["whole"] = own_records(trace) == counted
            trace["attempt"] = self.attempts
            self.trace = trace
        return trace


def _merge(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(events: List[dict], t_start: float, t_stop: float,
           device_count: int, spans: List[hostspans.Record]) -> Optional[dict]:
    """What the metrics read from a traced window (see the module
    docstring); None where the trace holds no anchor."""
    anchors = [e for e in events if e.get("name") == ANCHOR
               and e.get("ph") == "X"]
    if not anchors:
        return None
    ts0 = float(anchors[0]["ts"])
    ws, we = ts0, ts0 + (t_stop - t_start) * 1e6
    per_device: Dict[object, List[tuple]] = {}
    kernels: Dict[str, dict] = {}
    ops: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        s2, e2 = max(s, ws), min(end, we)
        if e2 <= s2:
            continue
        device = (e.get("args") or {}).get("device", e.get("pid"))
        per_device.setdefault(device, []).append((s2, e2))
        name = e.get("name", "?")
        seconds = (e2 - s2) / 1e6
        ops[name] = ops.get(name, 0.0) + seconds
        if e["cat"] == "kernel":
            k = kernels.setdefault(name, {"count": 0, "seconds": 0.0})
            k["count"] += 1
            k["seconds"] += seconds
    busy: Dict[str, float] = {}
    gaps: List[tuple] = []
    for device, intervals in per_device.items():
        merged = _merge(intervals)
        busy[str(device)] = sum(e - s for s, e in merged) / 1e6
        edge = ws
        for s, e in merged + [(we, we)]:
            if s > edge:
                gaps.append((s - edge, edge, s))
            edge = max(edge, e)
    gaps.sort(reverse=True)
    idle = []
    for length, gs, ge in gaps[:TOP]:
        mid = t_start + ((gs + ge) / 2 - ts0) / 1e6
        name = hostspans.innermost_at(spans, mid) or "no host span"
        idle.append([name, length / 1e6])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (we - ws) / 1e6,
            "busy_s": sum(busy.values()) / max(device_count, 1),
            "busy_s_by_device": busy,
            "kernels": kernels,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": idle}}


def kernel_time(trace: dict, pattern: str) -> tuple:
    """``(records, seconds)`` of the kernels whose name holds ``pattern``."""
    count = seconds = 0
    for name, k in trace["kernels"].items():
        if pattern in name:
            count += k["count"]
            seconds += k["seconds"]
    return count, seconds
