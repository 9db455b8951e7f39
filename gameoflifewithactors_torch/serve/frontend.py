"""HTTP/JSON front-end + the ``serve`` CLI subcommand.

Counterpart of ``gameoflifewithactors_tpu.serve.frontend``: the same
routes, wire format, ``SERVE_PORT`` announce line, signal discipline and
flags, plus ``--device`` (default ``cuda``; ``serve`` raises without a
card unless given ``--device cpu``). ``--manifest`` (warm start from an
``aot/`` manifest) waits for ROADMAP A16 and is refused.

Same stdlib ``ThreadingHTTPServer`` idiom as obs/exporter.py — request
threads translate JSON to :class:`SessionService` calls (the service
lock serializes anything that touches lanes), and the metrics/health
endpoints are the exporter's own rendering, so one port serves both the
session API and the Prometheus scrape.

API (README "Serving" has the full table)::

    POST   /sessions                   create {tenant, spec, fill|cells_hex,
                                       rng_seed} -> session info (202 when
                                       queued by admission, 429 on reject)
    GET    /sessions/<sid>             session info
    POST   /sessions/<sid>/step        {"n": int} -> info after the pump
    GET    /sessions/<sid>/grid        packed grid hex + shape
    DELETE /sessions/<sid>             close (frees the slot, compacts)
    POST   /admin/checkpoint           write the atomic checkpoint now
    GET    /metrics                    Prometheus exposition (goltpu_*)
    GET    /healthz                    JSON: ok + session/lane/queue counts

Process shape (``python -m gameoflifewithactors_torch serve``): arm the
flight recorder, start the HTTP server, announce ``SERVE_PORT <port>`` on
stdout (the client protocol: ``chip_smoke.py`` and the tests parse it),
then sit in the checkpoint loop until SIGTERM/SIGINT. Signal discipline: the graceful
handler is installed FIRST and the flight recorder chains onto it
(obs/flight.py ``install``), so one SIGTERM yields both the crash dump
and a final checkpoint + clean exit — neither installer drops the other.
"""

from __future__ import annotations

import argparse
import json
import re
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..obs import exporter as obs_exporter
from ..obs import flight as obs_flight
from ..obs import spans as obs_spans
from ..obs.registry import REGISTRY
from .admission import AdmissionController, AdmissionRejected
from .service import SessionService

_SID = re.compile(r"^/sessions/([^/]+)(/grid|/step)?$")

#: Request header carrying a caller's trace context
#: (``<32-hex trace id>[:<16-hex parent span id>]``); absent, the
#: frontend mints a fresh trace id. Echoed on every response.
TRACE_HEADER = "X-Goltpu-Trace"


class SessionFrontend:
    """HTTP surface over one SessionService (start()/stop(), port 0 OK)."""

    def __init__(self, service: SessionService, port: int = 0, *,
                 host: str = "127.0.0.1"):
        self.service = service
        self.requested_port = int(port)
        self.host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "SessionFrontend":
        if self._httpd is not None:
            return self
        service = self.service

        class Handler(BaseHTTPRequestHandler):
            trace_id: Optional[str] = None  # this request's trace

            def _send(self, code: int, payload: dict,
                      ctype: str = "application/json") -> None:
                if self.trace_id is not None and "trace_id" not in payload:
                    payload = {**payload, "trace_id": self.trace_id}
                body = (json.dumps(payload) + "\n").encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self.trace_id is not None:
                    self.send_header(TRACE_HEADER, self.trace_id)
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str, ctype: str) -> None:
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self.trace_id is not None:
                    self.send_header(TRACE_HEADER, self.trace_id)
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                return json.loads(self.rfile.read(length) or b"{}")

            def _dispatch(self, method: str) -> None:
                path = self.path.split("?")[0]
                # one request = one trace: accept the caller's context
                # (continuing their trace under their parent span) or
                # mint a fresh 128-bit id. Binding is thread-local and
                # request threads are per-connection, so two concurrent
                # requests cannot cross-contaminate.
                header = self.headers.get(TRACE_HEADER)
                try:
                    caller = (obs_spans.parse_trace_header(header)
                              if header else None)
                except ValueError as exc:
                    self._send(400, {"error": str(exc)})
                    return
                with obs_spans.bind_trace(
                        caller.trace_id if caller else None,
                        caller.span_id if caller else None) as ctx:
                    self.trace_id = ctx.trace_id
                    with obs_spans.span("serve.request", method=method,
                                        path=path):
                        try:
                            self._route(method, path)
                        except (KeyError, FileNotFoundError) as exc:
                            self._send(404, {"error": str(exc)})
                        except AdmissionRejected as exc:
                            self._send(429, {"error": str(exc)})
                        except (ValueError, json.JSONDecodeError) as exc:
                            self._send(400, {"error": str(exc)})
                        except Exception as exc:  # noqa: BLE001 — HTTP boundary
                            self._send(500, {"error":
                                             f"{type(exc).__name__}: {exc}"})

            def _route(self, method: str, path: str) -> None:
                if method == "GET" and path in ("/metrics", "/"):
                    self._send_text(
                        200,
                        obs_exporter.render_prometheus(
                            service.registry.snapshot()),
                        obs_exporter.CONTENT_TYPE)
                    return
                if method == "GET" and path == "/healthz":
                    self._send(200, {"ok": True, **service.counts()})
                    return
                if method == "POST" and path == "/sessions":
                    body = self._body()
                    info = service.create(
                        str(body.get("tenant", "default")),
                        body.get("spec") or {},
                        fill=body.get("fill"),
                        rng_seed=int(body.get("rng_seed", 0)),
                        cells_hex=body.get("cells_hex"))
                    self._send(202 if info["state"] == "pending" else 201,
                               info)
                    return
                if method == "POST" and path == "/admin/checkpoint":
                    self._send(200, {"path": service.checkpoint()})
                    return
                m = _SID.match(path)
                if m is None:
                    self._send(404, {"error": f"no route {method} {path}"})
                    return
                sid, tail = m.group(1), m.group(2)
                if method == "GET" and tail == "/grid":
                    self._send(200, service.grid_hex(sid))
                elif method == "POST" and tail == "/step":
                    self._send(200, service.step(
                        sid, int(self._body().get("n", 1))))
                elif method == "GET" and tail is None:
                    self._send(200, service.info(sid))
                elif method == "DELETE" and tail is None:
                    self._send(200, service.close(sid))
                else:
                    self._send(404, {"error": f"no route {method} {path}"})

            def do_GET(self) -> None:    # noqa: N802 (http.server API)
                self._dispatch("GET")

            def do_POST(self) -> None:   # noqa: N802
                self._dispatch("POST")

            def do_DELETE(self) -> None:  # noqa: N802
                self._dispatch("DELETE")

            def log_message(self, *args) -> None:
                pass  # per-request stderr noise defeats the step-rate

        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-frontend",
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

    def __enter__(self) -> "SessionFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m gameoflifewithactors_torch serve ...`` — the server
    process (see module docstring for the client protocol)."""
    ap = argparse.ArgumentParser(
        prog="gameoflifewithactors_torch serve",
        description="multi-tenant session service over batched lanes")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral; announced on stdout)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--manifest", default=None, metavar="PATH",
                    help="warmup manifest: not ported yet (ROADMAP A16)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where lanes live and step (default cuda; cpu runs "
                         "the plain PyTorch paths)")
    ap.add_argument("--ladder", default=None, metavar="C1,C2,...",
                    help="lane capacity ladder (default 1,8,64,256)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                    help="atomic session checkpoint path (enables "
                         "/admin/checkpoint, --resume, periodic saves)")
    ap.add_argument("--checkpoint-every", type=float, default=30.0,
                    metavar="SECONDS", help="periodic checkpoint interval")
    ap.add_argument("--resume", action="store_true",
                    help="restore sessions from --checkpoint at boot")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="admission backpressure queue bound")
    ap.add_argument("--headroom", type=float, default=0.85,
                    help="admit while modelled usage stays under this "
                         "fraction of the HBM limit")
    ap.add_argument("--hbm-limit-bytes", type=int, default=None,
                    help="static memory budget override (the CPU has no "
                         "device limit gauge; set this to make admission "
                         "control binding there)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="per-lane consecutive-crash budget before its "
                         "sessions are evicted")
    ap.add_argument("--flight-dump", default=None, metavar="PATH",
                    help="flight recorder dump path (default: next to "
                         "the checkpoint, or serve.flight.jsonl)")
    ap.add_argument("--device-poll", type=float, default=1.0,
                    help="DeviceSampler interval feeding the HBM gauges")
    args = ap.parse_args(argv)
    if args.manifest:
        ap.error("--manifest (warm start from an aot/ manifest) is not yet "
                 "ported to gameoflifewithactors_torch (ROADMAP A16)")

    from ..obs.device import (DeviceSampler, cuda_memory_backend,
                              host_memory_backend)
    from ..resilience.supervisor import RestartPolicy
    from .lanes import LANE_LADDER

    ladder = (tuple(int(c) for c in args.ladder.split(","))
              if args.ladder else LANE_LADDER)
    admission = AdmissionController(
        registry=REGISTRY, headroom_fraction=args.headroom,
        queue_limit=args.queue_limit,
        static_limit_bytes=args.hbm_limit_bytes)
    service = SessionService(
        ladder=ladder, admission=admission,
        checkpoint_path=args.checkpoint,
        policy=RestartPolicy(max_restarts=args.max_restarts),
        device=args.device)

    stop = threading.Event()

    def graceful(signum, frame) -> None:
        stop.set()

    # graceful handler FIRST, flight recorder second: the recorder's
    # install() chains onto whatever is there, so one SIGTERM dumps the
    # tape AND requests the clean shutdown
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, graceful)
        except (ValueError, OSError):  # not the main thread
            pass
    flight_path = args.flight_dump or (
        f"{args.checkpoint}.flight.jsonl" if args.checkpoint
        else "serve.flight.jsonl")
    fr = obs_flight.arm(obs_flight.FlightRecorder(flight_path))

    if args.resume and args.checkpoint:
        import os

        if os.path.exists(args.checkpoint):
            n = service.resume()
            print(f"resumed {n} session(s) from {args.checkpoint}",
                  file=sys.stderr)

    sampler = DeviceSampler(
        args.device_poll, registry=REGISTRY,
        backend=cuda_memory_backend if service.device.type == "cuda"
        else host_memory_backend).start()
    frontend = SessionFrontend(service, args.port, host=args.host).start()
    print(f"SERVE_PORT {frontend.port}", flush=True)
    print(f"serving sessions: http://{args.host}:{frontend.port}/ "
          f"(ladder {','.join(str(c) for c in service.ladder)}, device "
          f"{service.device})", file=sys.stderr)

    try:
        while not stop.is_set():
            stop.wait(max(0.1, args.checkpoint_every))
            if args.checkpoint and not stop.is_set():
                service.checkpoint()
    finally:
        if args.checkpoint:
            try:
                service.checkpoint()
                print(f"final checkpoint: {args.checkpoint}",
                      file=sys.stderr)
            except Exception as exc:  # noqa: BLE001 — dying anyway
                print(f"final checkpoint failed: {exc}", file=sys.stderr)
        frontend.stop()
        sampler.stop()
        obs_flight.disarm()
    return 0


if __name__ == "__main__":
    sys.exit(main())
