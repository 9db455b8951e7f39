"""Prometheus text-format exposition of the metrics registry.

A copy of ``gameoflifewithactors_tpu.obs.exporter`` (stdlib only): the
same ``goltpu_`` names, so one scrape configuration reads both packages.

The registry (obs/registry.py) is deliberately Prometheus-shaped — name
+ label dict -> series — so exposition is a pure rendering step:
:func:`render_prometheus` turns a registry snapshot into the text format
(version 0.0.4) any Prometheus/VictoriaMetrics/Grafana-agent scraper
ingests, and :class:`MetricsServer` serves it from a stdlib
``http.server`` daemon thread so a long-running engine can be scraped
*while stepping* (``--serve-metrics PORT`` on the CLI,
``GOLTPU_METRICS_PORT`` env).

Every metric is exported under the ``goltpu_`` namespace with the name
sanitized to the Prometheus grammar; histograms export the canonical
``_bucket``/``_sum``/``_count`` triplet with cumulative ``le`` buckets.
Stdlib only — the endpoint must stay alive precisely when the device
backend is wedged.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .registry import REGISTRY, MetricsRegistry

PREFIX = "goltpu_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")


def _metric_name(name: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not _NAME_OK.fullmatch(s):
        s = "_" + s
    return PREFIX + s


def _label_name(name: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not _LABEL_OK.fullmatch(s):
        s = "_" + s
    return s


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(labels: dict, extra: Optional[List[tuple]] = None) -> str:
    pairs = [(_label_name(k), str(v)) for k, v in sorted(labels.items())]
    pairs += extra or []
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


def _num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Registry snapshot (``MetricsRegistry.snapshot()``) -> exposition
    text. Deterministic ordering (sorted names, sorted labels) so the
    output is golden-testable."""
    out: List[str] = []
    for name in sorted(snapshot):
        inst = snapshot[name]
        mname = _metric_name(name)
        mtype = inst.get("type", "untyped")
        if inst.get("help"):
            out.append(f"# HELP {mname} {_escape(inst['help'])}")
        out.append(f"# TYPE {mname} {mtype}")
        if mtype == "histogram":
            uppers = [_num(b) for b in inst.get("buckets", [])] + ["+Inf"]
            for series in inst.get("series", []):
                labels = series.get("labels", {})
                cum = 0
                for upper, count in zip(uppers, series.get("counts", [])):
                    cum += count
                    out.append(
                        f"{mname}_bucket"
                        f"{_labels(labels, [('le', upper)])} {cum}")
                out.append(f"{mname}_sum{_labels(labels)}"
                           f" {_num(series.get('sum', 0.0))}")
                out.append(f"{mname}_count{_labels(labels)}"
                           f" {series.get('n', 0)}")
        else:
            for series in inst.get("series", []):
                out.append(f"{mname}{_labels(series.get('labels', {}))}"
                           f" {_num(series.get('value', 0.0))}")
    return "\n".join(out) + ("\n" if out else "")


class MetricsServer:
    """``/metrics`` over a stdlib HTTP daemon thread.

    ``MetricsServer(port).start()`` binds immediately (port 0 picks an
    ephemeral port — read it back from ``.port``); ``stop()`` shuts the
    thread down. ``/metrics`` renders the registry live per scrape;
    ``/healthz`` answers 200 with a one-line JSON heartbeat, merged with
    whatever ``health_info()`` returns — the soak harness's liveness +
    progress probe (a worker reports its generation/restart counts
    there, cheaper than parsing the full exposition). Also a context
    manager."""

    def __init__(self, port: int = 0, *,
                 registry: MetricsRegistry = REGISTRY,
                 host: str = "0.0.0.0",
                 health_info: Optional[Callable[[], dict]] = None):
        self.requested_port = int(port)
        self.host = host
        self.registry = registry
        self._health_info = health_info
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def set_health_info(self, health_info: Optional[Callable[[], dict]]
                        ) -> None:
        """Install or replace the /healthz info hook after construction.
        The serve layer starts the exporter first (scrapable during
        warmup) and wires its live session/lane/queue counts in once the
        session service exists; the handler reads the hook per request,
        so the swap needs no restart."""
        self._health_info = health_info

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry = self.registry
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path in ("/metrics", "/"):
                    body = render_prometheus(registry.snapshot()
                                             ).encode("utf-8")
                    ctype = CONTENT_TYPE
                elif path == "/healthz":
                    payload = {"ok": True}
                    health_info = srv._health_info  # late-bound per request
                    if health_info is not None:
                        try:
                            payload.update(health_info() or {})
                        except Exception:
                            # a broken info hook must not take the
                            # liveness probe down with it
                            payload["info_error"] = True
                    body = (json.dumps(payload) + "\n").encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes every few seconds must not spam stderr

        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exporter",
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

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_metrics(port: int, *, registry: MetricsRegistry = REGISTRY,
                  host: str = "0.0.0.0",
                  health_info: Optional[Callable[[], dict]] = None,
                  ) -> MetricsServer:
    """Start and return a :class:`MetricsServer` (CLI convenience)."""
    return MetricsServer(port, registry=registry, host=host,
                         health_info=health_info).start()
