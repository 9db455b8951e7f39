"""Flight recorder: a bounded black box that dumps on trouble.

A copy of ``gameoflifewithactors_tpu.obs.flight`` (stdlib only). In this
package the session service notes its lane faults, restores, evictions
and checkpoints here, and ``serve`` arms it so SIGTERM dumps the tape.

The wedged-probe failure mode (results/watch_r05.log) is a run that dies
with *zero* artifacts: the watchdog's stderr line is the only witness,
and a SIGTERM from a subprocess harness leaves nothing at all. The
flight recorder keeps ring buffers of the last N ``StepMetrics``, span
completions, and compile events (tapped live off the process recorders —
a later ``TRACER.clear()`` cannot erase what was already taped), and on

- a watchdog stall (chained via ``StallWatchdog.add_on_stall``),
- an unhandled exception escaping the coordinator tick loop, or
- SIGTERM / SIGINT

writes one JSONL crash report: a header line naming the trigger and the
last completed span, then the taped records, then a full metrics-registry
snapshot. The dump path is pre-opened-directory cheap (one atomic
``os.replace``), and dumping is idempotent per trigger but repeatable —
a stall dump followed by the SIGTERM dump overwrites with strictly more
recent tape.

Like the watchdog, a process-default recorder can be armed
(:func:`arm`) so ``GridCoordinator.tick`` finds it without plumbing.
Stdlib only; must stay importable and dumpable while the device is wedged.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Deque, List, Optional

from . import compile as compile_lib
from . import spans as spans_lib
from .registry import REGISTRY

DEFAULT_MAX_RECORDS = 256
SCHEMA_VERSION = 1


class FlightRecorder:
    """Tape the last N telemetry records; dump a crash report on demand."""

    def __init__(self, path: str, *, max_records: int = DEFAULT_MAX_RECORDS,
                 registry=REGISTRY,
                 tracer: Optional[spans_lib.SpanTracer] = None,
                 compile_log: Optional[compile_lib.CompileEventLog] = None):
        self.path = path
        self.registry = registry
        self._tracer = tracer or spans_lib.TRACER
        self._compile_log = compile_log or compile_lib.COMPILE_LOG
        self._steps: Deque[dict] = collections.deque(maxlen=max_records)
        self._spans: Deque[dict] = collections.deque(maxlen=max_records)
        self._compiles: Deque[dict] = collections.deque(maxlen=max_records)
        self._notes: Deque[dict] = collections.deque(maxlen=max_records)
        self._stalls: List[dict] = []
        self._lock = threading.Lock()
        self._installed = False
        self._watchdog = None
        self._prev_handlers: dict = {}
        self.dumps = 0
        self.last_dump_reason: Optional[str] = None

    # -- the tape (each is safe from any thread) -----------------------------

    def on_step(self, m) -> None:
        """StepMetrics sink — hang on a MetricsLogger next to the
        RunTelemetry buffer."""
        with self._lock:
            self._steps.append(m if isinstance(m, dict) else m.to_dict())

    def on_span(self, s) -> None:
        with self._lock:
            self._spans.append(s if isinstance(s, dict) else s.to_dict())

    def on_compile(self, ev) -> None:
        with self._lock:
            self._compiles.append(
                ev if isinstance(ev, dict) else ev.to_dict())

    def on_stall(self, ev) -> None:
        with self._lock:
            self._stalls.append(ev if isinstance(ev, dict) else ev.to_dict())
        self.dump(f"watchdog stall: {getattr(ev, 'label', '?')}")

    def note(self, kind: str, payload: Optional[dict] = None) -> None:
        """Tape a free-form event (fault injections, supervisor restarts —
        the resilience layer's breadcrumbs). Rides the same ring buffer
        discipline as the telemetry tapes and lands in every dump, so a
        crash report shows *what was done to* the run, not only what the
        run measured."""
        rec = {"kind": kind, "t": time.perf_counter()}
        if payload:
            rec.update(payload)
        with self._lock:
            self._notes.append(rec)

    # -- wiring --------------------------------------------------------------

    def install(self, *, watchdog=None, signals: bool = True) -> "FlightRecorder":
        """Tap the process recorders; optionally chain onto a watchdog's
        stall sink and take over SIGTERM/SIGINT (dump, then hand the
        signal on to whatever handler was there — default die included).
        Signal handlers only install from the main thread; elsewhere the
        tape still runs, just without the signal trigger."""
        # wiring state under the lock (goltpu-lint GOL004): install/
        # uninstall can race the signal handler and a second arm() call,
        # and the check-then-set on _installed was a classic TOCTOU
        with self._lock:
            if self._installed:
                return self
            self._installed = True
            if watchdog is not None:
                self._watchdog = watchdog
        self._tracer.add_listener(self.on_span)
        self._compile_log.add_listener(self.on_compile)
        if watchdog is not None:
            watchdog.add_on_stall(self.on_stall)
        if signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.getsignal(sig)
                    signal.signal(sig, self._on_signal)
                except (ValueError, OSError):  # not the main thread
                    continue
                with self._lock:
                    self._prev_handlers[sig] = prev
        return self

    def uninstall(self) -> None:
        with self._lock:
            if not self._installed:
                return
            self._installed = False
            watchdog, self._watchdog = self._watchdog, None
            prev_handlers = dict(self._prev_handlers)
            self._prev_handlers.clear()
        self._tracer.remove_listener(self.on_span)
        self._compile_log.remove_listener(self.on_compile)
        if watchdog is not None:
            watchdog.remove_on_stall(self.on_stall)
        for sig, prev in prev_handlers.items():
            try:
                if signal.getsignal(sig) == self._on_signal:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    def _on_signal(self, signum, frame) -> None:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        self.dump(f"signal {name}")
        _continue_previous(self._prev_handlers.get(signum), signum, frame)

    # -- the crash report ----------------------------------------------------

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Write the JSONL crash report (atomic replace). Returns the
        path. Never raises — a dump failure at crash time must not mask
        the crash itself; it falls back to a stderr line."""
        with self._lock:
            steps = list(self._steps)
            spans = list(self._spans)
            compiles = list(self._compiles)
            notes = list(self._notes)
            stalls = list(self._stalls)
        last = self._tracer.last_completed()
        ctx = spans_lib.current_trace()
        header = {
            "type": "flight",
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            # this process's wall-clock <-> perf_counter anchor (written at
            # tracer startup): obs/aggregate.py aligns per-process tapes
            # onto one timeline by adding it to every t/t0 in the dump
            "epoch_anchor": self._tracer.epoch_anchor,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "last_completed_span": last.name if last else None,
            "open_spans": self._tracer.current_stack(),
            "counts": {"step_metrics": len(steps), "spans": len(spans),
                       "compile_events": len(compiles),
                       "events": len(notes), "stalls": len(stalls)},
        }
        if extra:
            header.update(extra)
        try:
            # per-thread tmp name: a signal-handler dump racing the
            # watchdog thread's dump must not interleave one tmp file
            tmp = f"{self.path}.tmp{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for kind, records in (("step_metrics", steps),
                                      ("span", spans),
                                      ("compile_event", compiles),
                                      ("event", notes),
                                      ("stall", stalls)):
                    for rec in records:
                        f.write(json.dumps({"type": kind, **rec}) + "\n")
                f.write(json.dumps({"type": "registry",
                                    "snapshot": self.registry.snapshot()})
                        + "\n")
            os.replace(tmp, self.path)
        except Exception as exc:
            sys.stderr.write(
                f"flight recorder: dump to {self.path} failed "
                f"({type(exc).__name__}: {exc})\n")
            return self.path
        self.dumps += 1
        self.last_dump_reason = reason
        sys.stderr.write(
            f"flight recorder: dumped ({reason}) -> {self.path}\n")
        return self.path


def _continue_previous(prev, signum, frame) -> None:
    """Hand a handled signal on to the disposition that was installed
    before us — the one chaining rule every SIGTERM hook in this
    codebase must follow (FlightRecorder.install, the serve loop, the
    soak worker). A callable previous handler is called; SIG_DFL is
    restored and the signal re-raised so the process still dies with the
    right disposition (a harness watching the exit status must see
    SIGTERM, not a clean exit); SIG_IGN / None swallow it."""
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def chain_signal_handler(sig, fn, *, propagate: bool = True):
    """Install ``fn(signum, frame)`` for ``sig`` WITHOUT dropping the
    handler already there: ``fn`` runs first, then (with ``propagate``)
    the previous disposition via :func:`_continue_previous`.

    This is the fix for the two-installers hazard: a later component
    calling raw ``signal.signal`` silently discards whatever hook was
    installed before it — e.g. the serve loop's graceful-shutdown hook
    replacing the flight recorder's dump-on-SIGTERM (or vice versa),
    losing either the crash dump or the final checkpoint. Every
    additional SIGTERM/SIGINT hook should install through here (or
    through ``FlightRecorder.install``, which follows the same rule).

    Returns an ``uninstall()`` callable that restores the previous
    handler — only if the chained one is still installed, the same
    steal-safe discipline as ``FlightRecorder.uninstall``.
    """
    prev = signal.getsignal(sig)

    def handler(signum, frame):
        fn(signum, frame)
        if propagate:
            _continue_previous(prev, signum, frame)

    signal.signal(sig, handler)

    def uninstall() -> None:
        try:
            if signal.getsignal(sig) is handler:
                signal.signal(sig, prev)
        except (ValueError, OSError):
            pass

    return uninstall


def load_dump(path: str) -> dict:
    """Parse a dump back into {"flight": header, "step_metrics": [...],
    "span": [...], "compile_event": [...], "event": [...], "stall":
    [...], "registry": snapshot} — the reader tests and post-mortem
    tooling use."""
    out: dict = {"step_metrics": [], "span": [], "compile_event": [],
                 "event": [], "stall": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("type", None)
            if kind == "flight":
                out["flight"] = rec
            elif kind == "registry":
                out["registry"] = rec.get("snapshot", {})
            elif kind in out:
                out[kind].append(rec)
    return out


# -- process-default arming (how the coordinator finds the recorder) ----------

_ACTIVE: Optional[FlightRecorder] = None


def arm(fr: FlightRecorder) -> FlightRecorder:
    """Make ``fr`` the process-default recorder (installed) and return it."""
    global _ACTIVE
    _ACTIVE = fr.install()
    return fr


def disarm() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.uninstall()
    _ACTIVE = None


def active_flight_recorder() -> Optional[FlightRecorder]:
    return _ACTIVE


def note_event(kind: str, payload: Optional[dict] = None) -> None:
    """Tape an event onto the armed recorder; silently a no-op when none
    is armed — call sites (fault injectors, the supervisor) must not
    need to know whether a flight recorder exists."""
    fr = _ACTIVE
    if fr is not None:
        fr.note(kind, payload)
