"""Fleet aggregation: many per-process telemetry sources, one view.

A copy of ``gameoflifewithactors_tpu.obs.aggregate`` (stdlib plus the
sibling ``obs`` modules). Every ``obs`` artifact is per-process: each
worker serves its own ``/metrics``, tapes its own spans, dumps its own
flight recording. This module is the merge layer:

- **Metrics**: :func:`merge_expositions` folds N Prometheus expositions
  into one, tagging every series with a ``proc`` label so per-worker
  series stay distinct. There is deliberately NO automatic summing —
  the COST paper's complaint is fleet totals hiding per-chip
  regressions, so per-chip throughput/capacity gauges
  (:data:`PER_CHIP_GAUGES`) *refuse* to be summed
  (:func:`sum_across_procs` raises :class:`PerChipSumError`).
  :class:`FleetAggregator` scrapes live endpoints with a TTL cache;
  :class:`AggregatorServer` re-exports the merged view over HTTP.
- **Timelines**: :func:`write_merged_timeline` merges per-process span
  tapes (chrome-trace JSON) and flight dumps into ONE clock-aligned
  chrome-trace file. Alignment uses the wall-clock↔perf_counter anchor
  every process writes at startup (``SpanTracer.epoch_anchor``, carried
  in each flight-dump header): ``wall = perf_counter + anchor``, so
  tapes from processes whose perf_counter origins differ by minutes
  land on one monotonic epoch timeline. Flight-dump trigger headers are
  preserved verbatim under ``flight_headers``.

Stdlib only -- post-mortem merging must work on a machine where the
accelerator stack is wedged (that is when it is needed).
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

from . import flight as flight_lib
from .exporter import CONTENT_TYPE, PREFIX

#: Gauges whose value is a property of ONE chip/process — a cross-proc
#: sum is dimensionally wrong (summed HBM "in use" exceeds any real
#: chip; summed per-chip rates hide a straggler behind a healthy total).
#: The COST honesty check: these may be listed side by side, never added.
PER_CHIP_GAUGES = frozenset({
    "hbm_bytes_in_use", "hbm_bytes_peak", "hbm_bytes_limit",
    "tenant_steps_per_sec", "worker_steps_per_sec",
    "cell_updates_per_sec",
    # overlap efficiency is a ratio of one chip's block schedule; a
    # fleet "sum of ratios" is meaningless. The halo *totals*
    # (halo_bytes_total, halo_exchanges_total) are counters and sum.
    "halo_overlap_ratio",
    # same discipline for the sampling profiler's measured figures:
    # one chip's overlap ratio, attribution share, duty
    # cycle and overhead are per-chip ratios. The attributed
    # device-second *totals* (profile_op_class_seconds_total) are
    # counters and sum.
    "halo_overlap_ratio_measured",
    "profile_op_class_fraction",
    "profile_duty_cycle",
    "profile_overhead_ratio",
})


class PerChipSumError(ValueError):
    """Raised when asked to sum a per-chip gauge across processes."""


# -- exposition text parsing --------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> dict:
    """Prometheus text format -> ``{"types": {name: type}, "help":
    {name: help}, "samples": [(name, labels dict, value)]}``.

    ``name`` keeps its ``_bucket``/``_sum``/``_count`` suffix; ``types``
    and ``help`` are keyed by the family name from the ``# TYPE`` /
    ``# HELP`` lines. Tolerant of unparsable lines (skipped) — a
    half-written scrape must not kill the aggregate view."""
    out: dict = {"types": {}, "help": {}, "samples": []}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                out["types"][parts[2]] = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "HELP":
                out["help"][parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, rawlabels, rawval = m.groups()
        try:
            value = float(rawval)
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(rawlabels or "")}
        out["samples"].append((name, labels, value))
    return out


def base_name(sample_name: str) -> str:
    """Family name of a sample: strips the exporter prefix and the
    histogram ``_bucket``/``_sum``/``_count`` suffix."""
    name = sample_name
    if name.startswith(PREFIX):
        name = name[len(PREFIX):]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    return ("{"
            + ",".join(f'{k}="{_escape(str(v))}"'
                       for k, v in sorted(labels.items()))
            + "}")


def merge_expositions(per_proc: Dict[str, str]) -> str:
    """N expositions (``proc label -> text``) -> one, every series tagged
    ``proc="<label>"``. Series are *preserved*, never summed — the
    per-chip view survives the merge by construction. A source series
    already carrying a ``proc`` label raises: silently overwriting the
    provenance label would forge per-worker attribution."""
    families: Dict[str, dict] = {}
    for proc in sorted(per_proc):
        parsed = parse_exposition(per_proc[proc])
        for name, labels, value in parsed["samples"]:
            if "proc" in labels:
                raise ValueError(
                    f"series {name} from {proc!r} already has a proc label "
                    f"({labels['proc']!r}); refusing to relabel")
            fam_match = [f for f in parsed["types"]
                         if name == f or (name.startswith(f) and
                                          name[len(f):] in
                                          ("_bucket", "_sum", "_count"))]
            fam_name = max(fam_match, key=len) if fam_match else name
            fam = families.setdefault(fam_name, {
                "type": parsed["types"].get(fam_name, "untyped"),
                "help": parsed["help"].get(fam_name, ""),
                "samples": []})
            fam["samples"].append((name, {**labels, "proc": proc}, value))
    out: List[str] = []
    for fam_name in sorted(families):
        fam = families[fam_name]
        if fam["help"]:
            out.append(f"# HELP {fam_name} {fam['help']}")
        out.append(f"# TYPE {fam_name} {fam['type']}")
        for name, labels, value in fam["samples"]:
            sval = str(int(value)) if value == int(value) and \
                abs(value) < 1e15 else repr(value)
            out.append(f"{name}{_render_labels(labels)} {sval}")
    return "\n".join(out) + ("\n" if out else "")


def series_across_procs(per_proc: Dict[str, str], name: str
                        ) -> List[Tuple[str, dict, float]]:
    """All samples of a family across processes, as ``(proc, labels,
    value)`` — the honest (unsummed) per-chip view."""
    rows = []
    for proc in sorted(per_proc):
        for sname, labels, value in parse_exposition(
                per_proc[proc])["samples"]:
            if base_name(sname) == name:
                rows.append((proc, labels, value))
    return rows


def sum_across_procs(per_proc: Dict[str, str], name: str) -> float:
    """Sum a family's plain samples across the fleet — REFUSED for
    per-chip gauges (:class:`PerChipSumError`): a summed per-chip rate
    is the COST paper's configuration-that-outperforms-nothing. Use
    :func:`series_across_procs` for those instead."""
    if name in PER_CHIP_GAUGES:
        raise PerChipSumError(
            f"{name!r} is a per-chip gauge; summing it across processes "
            "fabricates a fleet number no chip ever produced — read the "
            "per-proc series via series_across_procs() instead")
    total = 0.0
    for proc in sorted(per_proc):
        for sname, _labels, value in parse_exposition(
                per_proc[proc])["samples"]:
            # plain samples only: histogram _bucket/_sum/_count triplets
            # must not be folded into one number
            if sname in (name, PREFIX + name):
                total += value
    return total


# -- live scraping ------------------------------------------------------------

class FleetAggregator:
    """Scrape N ``/metrics`` endpoints into one labeled view.

    ``targets`` maps a ``proc`` label to a base URL
    (``{"w0": "http://127.0.0.1:9001"}``) or a bare ``host:port``. A
    short TTL cache (``ttl_seconds``) coalesces concurrent pollers —
    ``fleet_top`` at 2 Hz and a scraped ``AggregatorServer`` must not
    multiply load on the workers. Cache access is lock-disciplined;
    the HTTP fetches themselves run outside the
    lock so one slow worker cannot serialize every reader."""

    def __init__(self, targets: Dict[str, str], *,
                 ttl_seconds: float = 1.0, timeout_seconds: float = 2.0):
        self.targets = {
            proc: (url if "//" in url else f"http://{url}")
            for proc, url in targets.items()}
        self.ttl_seconds = float(ttl_seconds)
        self.timeout_seconds = float(timeout_seconds)
        self._lock = threading.Lock()
        # (perf_counter stamp, {proc: exposition text or None})
        self._cache: Optional[Tuple[float, Dict[str, Optional[str]]]] = None

    def _fetch(self, url: str) -> Optional[str]:
        try:
            with urllib.request.urlopen(
                    url + "/metrics", timeout=self.timeout_seconds) as resp:
                return resp.read().decode("utf-8", "replace")
        except Exception:
            return None  # a down worker is a row in the view, not a crash

    def scrape(self, *, force: bool = False) -> Dict[str, Optional[str]]:
        """``proc -> exposition text`` (``None`` for unreachable
        workers). Served from the TTL cache when fresh."""
        now = time.perf_counter()
        with self._lock:
            cached = self._cache
        if (not force and cached is not None
                and now - cached[0] < self.ttl_seconds):
            return dict(cached[1])
        texts = {proc: self._fetch(url)
                 for proc, url in sorted(self.targets.items())}
        with self._lock:
            self._cache = (time.perf_counter(), texts)
        return dict(texts)

    def up(self) -> Dict[str, bool]:
        return {proc: text is not None
                for proc, text in self.scrape().items()}

    def render(self) -> str:
        """The merged exposition (down workers omitted — absence, not a
        forged zero)."""
        return merge_expositions({proc: text
                                  for proc, text in self.scrape().items()
                                  if text is not None})

    def view(self) -> Dict[str, Optional[dict]]:
        """``proc -> parse_exposition(...)`` (``None`` when down)."""
        return {proc: (parse_exposition(text) if text is not None else None)
                for proc, text in self.scrape().items()}


class AggregatorServer:
    """The fleet's aggregate endpoint: ``/metrics`` re-exports the
    merged exposition, ``/fleet`` answers a JSON liveness map. A thin
    HTTP face over a :class:`FleetAggregator` (same stdlib daemon-thread
    shape as ``MetricsServer``)."""

    def __init__(self, aggregator: FleetAggregator, port: int = 0, *,
                 host: str = "127.0.0.1"):
        self.aggregator = aggregator
        self.requested_port = int(port)
        self.host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "AggregatorServer":
        if self._httpd is not None:
            return self
        agg = self.aggregator

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path in ("/metrics", "/"):
                    body = agg.render().encode("utf-8")
                    ctype = CONTENT_TYPE
                elif path == "/fleet":
                    body = (json.dumps({"up": agg.up()}) + "\n"
                            ).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /fleet")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-aggregator",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "AggregatorServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- timeline merge -----------------------------------------------------------

def _tid_allocator():
    mapping: Dict[Tuple[str, str], int] = {}

    def tid_for(proc: str, thread_name: str) -> int:
        key = (proc, thread_name)
        if key not in mapping:
            mapping[key] = len(mapping) + 1
        return mapping[key]

    return mapping, tid_for


def merge_flight_dumps(paths: Iterable[str],
                       labels: Optional[Dict[str, str]] = None) -> dict:
    """Flight dumps -> one clock-aligned chrome-trace object.

    Every span/event/stall timestamp is perf_counter seconds in its own
    process; the dump header's ``epoch_anchor`` (written at tracer
    startup) converts it to wall clock, so tapes from processes started
    minutes apart land in true order. Dumps without an anchor (older
    files) cannot be aligned and are listed under ``"unaligned"``
    instead of being placed at a fabricated time. Each dump's trigger
    header is preserved verbatim under ``"flight_headers"``."""
    labels = labels or {}
    meta_events: List[dict] = []
    events: List[dict] = []
    headers: Dict[str, dict] = {}
    unaligned: List[str] = []
    _mapping, tid_for = _tid_allocator()
    for i, path in enumerate(sorted(str(p) for p in paths)):
        dump = flight_lib.load_dump(path)
        hdr = dump.get("flight", {})
        label = labels.get(path) or _default_label(path)
        headers[label] = hdr
        anchor = hdr.get("epoch_anchor")
        if anchor is None:
            unaligned.append(label)
            continue
        pid = hdr.get("pid", 100000 + i)
        meta_events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"{label} pid={pid} "
                             f"[{hdr.get('reason', '?')}]"}})
        seen_tids = set()
        for rec in dump.get("span", []):
            tid = tid_for(label, rec.get("thread", "main"))
            if tid not in seen_tids:
                seen_tids.add(tid)
                meta_events.append({
                    "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": rec.get("thread", "main")}})
            args = dict(rec.get("attrs") or {})
            for k in ("trace_id", "span_id", "parent_id"):
                if rec.get(k) is not None:
                    args[k] = rec[k]
            ev = {"ph": "X", "pid": pid, "tid": tid,
                  "name": rec.get("name", "?"),
                  "ts": (rec["t0"] + anchor) * 1e6,
                  "dur": max(0.0, rec["t1"] - rec["t0"]) * 1e6}
            if args:
                ev["args"] = args
            events.append(ev)
        for kind, name_prefix in (("event", ""), ("stall", "stall:")):
            for rec in dump.get(kind, []):
                t = rec.get("t")
                if t is None:
                    continue
                args = {k: v for k, v in rec.items()
                        if k not in ("t",) and _jsonable(v)}
                name = (name_prefix + str(rec.get("kind", rec.get(
                    "label", kind)))) if kind == "event" else \
                    name_prefix + str(rec.get("label", "?"))
                events.append({
                    "ph": "i", "s": "p", "pid": pid,
                    "tid": tid_for(label, rec.get("thread", "main")),
                    "name": name, "ts": (t + anchor) * 1e6,
                    "args": args})
    events.sort(key=lambda ev: ev["ts"])
    return {"traceEvents": meta_events + events,
            "displayTimeUnit": "ms",
            "flight_headers": headers,
            "unaligned": unaligned}


def _default_label(path: str) -> str:
    stem = path.rsplit("/", 1)[-1]
    return stem[:-6] if stem.endswith(".jsonl") else stem


def _jsonable(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict))


def merge_timelines(traces: Iterable[dict]) -> dict:
    """Merge already-epoch-anchored chrome-trace objects (a live
    tracer's ``to_chrome_trace()``, or :func:`merge_flight_dumps`
    output) into one: metadata events first, timed events interleaved in
    epoch order. Extra top-level keys (``flight_headers`` etc.) are
    union-merged."""
    meta_events: List[dict] = []
    events: List[dict] = []
    extra: dict = {"flight_headers": {}, "unaligned": []}
    for trace in traces:
        for ev in trace.get("traceEvents", []):
            (meta_events if ev.get("ph") == "M" else events).append(ev)
        extra["flight_headers"].update(trace.get("flight_headers", {}))
        extra["unaligned"].extend(trace.get("unaligned", []))
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    out = {"traceEvents": meta_events + events, "displayTimeUnit": "ms"}
    if extra["flight_headers"]:
        out["flight_headers"] = extra["flight_headers"]
    if extra["unaligned"]:
        out["unaligned"] = extra["unaligned"]
    return out


def validate_timeline(trace: dict) -> List[str]:
    """Clock-alignment lint for a merged timeline: negative durations
    and out-of-epoch-order timed events. Empty list = clean — what the
    chaos drill asserts before calling its artifact evidence."""
    problems: List[str] = []
    last_ts = None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        if ev.get("dur", 0.0) < 0.0:
            problems.append(
                f"negative duration on {ev.get('name')!r}: {ev['dur']}")
        ts = ev.get("ts")
        if last_ts is not None and ts is not None and ts < last_ts:
            problems.append(
                f"out-of-order event {ev.get('name')!r}: "
                f"ts {ts} after {last_ts}")
        if ts is not None:
            last_ts = max(last_ts, ts) if last_ts is not None else ts
    return problems


def write_merged_timeline(out_path: str, *,
                          flight_dumps: Iterable[str] = (),
                          chrome_traces: Iterable[dict] = (),
                          labels: Optional[Dict[str, str]] = None) -> str:
    """The post-mortem artifact: merge flight dumps and live tapes into
    one clock-aligned chrome-trace JSON at ``out_path`` (loadable in
    ui.perfetto.dev). Returns the path."""
    merged = merge_timelines(
        [merge_flight_dumps(flight_dumps, labels=labels),
         *chrome_traces])
    with open(out_path, "w") as f:
        json.dump(merged, f)
        f.write("\n")
    return out_path
