"""Run telemetry: what a run reports through, the JAX package's ``obs``
ported.

- **Spans, compile events, metrics** (:mod:`.spans`, :mod:`.compile`,
  :mod:`.registry`, :mod:`.exporter`): host spans (``engine.step``,
  ``engine.sync``, ``engine.snapshot``, ``coordinator.tick``,
  ``coordinator.notify``), kernel builds and loads (a build's seconds
  are taken out of the tick's wall time), labelled counters, gauges and
  histograms, and their Prometheus rendering.
- **Stall watchdog, flight recorder** (:mod:`.watchdog`, :mod:`.flight`):
  a monitor thread flags a tick that overruns its deadline, naming the
  last-completed span; ring buffers of the last records dump as JSONL on
  a stall, an exception in the tick loop, or SIGTERM/SIGINT.
- **RunReport** (:mod:`.report`): spans, compile events, StepMetrics,
  halo bytes, stalls, the registry, the roofline (:mod:`.device`: the
  engine's counted work, :mod:`.cost`, against the card's peaks) and the
  sampling profiler's attribution (:mod:`.profiler`, on
  ``torch.profiler``) in one JSON artifact (CLI ``--telemetry-out``,
  ``report`` subcommand).
- **Device sampler** (:mod:`.device`): device memory into HBM gauges.
- **Differ and fleet merge** (:mod:`.diff`, :mod:`.aggregate`):
  tolerance-banded deltas between two reports (``report --diff``), and
  many processes' metrics and tapes merged into one view.

Stdlib modules are copies of the JAX package's; the sampler, the
profiler's capture and the peaks read the card through PyTorch, imported
inside the calls that need it.
"""

from .spans import (  # noqa: F401
    Span,
    SpanTracer,
    TRACER,
    TRACE_ENV_VAR,
    TraceContext,
    bind_trace,
    current_trace,
    new_span_id,
    new_trace_id,
    parse_trace_header,
    set_process_context,
    span,
)
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from .compile import (  # noqa: F401
    CompileEvent,
    CompileEventLog,
    COMPILE_LOG,
    tracked_call,
)
from .watchdog import StallEvent, StallWatchdog, active_watchdog, arm, disarm  # noqa: F401
from .report import RunReport, RunTelemetry, begin_run_telemetry  # noqa: F401
from .device import DeviceSampler, roofline_section  # noqa: F401
from .profiler import (  # noqa: F401
    OP_CLASSES,
    ProfileSampler,
    active_sampler,
    classify_slice,
    dispatch_annotation,
)
from .exporter import MetricsServer, render_prometheus, serve_metrics  # noqa: F401
from .flight import FlightRecorder, active_flight_recorder, load_dump  # noqa: F401
from .diff import diff_records, format_rows, gate  # noqa: F401

__all__ = [
    "Span", "SpanTracer", "TRACER", "span",
    "TRACE_ENV_VAR", "TraceContext", "bind_trace", "current_trace",
    "new_span_id", "new_trace_id", "parse_trace_header",
    "set_process_context",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "CompileEvent", "CompileEventLog", "COMPILE_LOG", "tracked_call",
    "StallEvent", "StallWatchdog", "active_watchdog", "arm", "disarm",
    "RunReport", "RunTelemetry", "begin_run_telemetry",
    "DeviceSampler", "roofline_section",
    "OP_CLASSES", "ProfileSampler", "active_sampler", "classify_slice",
    "dispatch_annotation",
    "MetricsServer", "render_prometheus", "serve_metrics",
    "FlightRecorder", "active_flight_recorder", "load_dump",
    "diff_records", "format_rows", "gate",
]
