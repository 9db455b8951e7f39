"""RunReport: one JSON artifact answering "where did this run's time go".

Counterpart of ``gameoflifewithactors_tpu.obs.report``, with the same
fields, so each package's ``RunReport.from_dict`` reads the other's
report. Folds the other pillars together -- host spans (per-phase time:
dispatch / sync / readback / subscribers), compile events (kernel builds
and loads), ``StepMetrics`` records, model-vs-measured halo bytes, stall
events, the metrics registry, the roofline of the engine's counted work
(``Engine.runner_cost_analysis`` against the card's peaks), the sampling
profiler's op-class attribution and, when a trace exists, the device duty
cycle from ``utils.profiling.perfetto_summary``. Written by the CLI
(``--telemetry-out``); read back by the ``report`` CLI subcommand and
:meth:`RunReport.load`.

:class:`RunTelemetry` is the session object: ``begin_run_telemetry()``
resets the process-global tracer/compile log, arms the stall watchdog,
and hands back the ``StepMetrics`` buffer sink to hang on a coordinator;
``finish()`` assembles the report.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

from . import compile as compile_lib
from . import spans as spans_lib
from . import watchdog as watchdog_lib
from .registry import REGISTRY

SCHEMA_VERSION = 1


@dataclasses.dataclass
class RunReport:
    created_at: str                    # ISO-8601 UTC
    config: dict                       # free-form run description
    platform: dict                     # the card or the CPU (may be empty)
    phase_seconds: dict                # span name -> {total_s, count, mean_s}
    spans: List[dict]                  # individual span records
    compile_events: List[dict]
    compile_seconds_total: float
    step_metrics: List[dict]           # StepMetrics.to_dict() records
    halo_bytes: dict                   # {"model_per_gen", "measured_per_gen"}
    stalls: List[dict]
    metrics: dict                      # registry snapshot
    perfetto: Optional[dict] = None    # device duty cycle, when a trace exists
    roofline: Optional[dict] = None    # obs.device.roofline_section output
    profile: Optional[dict] = None     # ProfileSampler.attribution(), armed runs
    schema_version: int = SCHEMA_VERSION

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("profile") is None:
            # sampler off (the default): the serialized report stays
            # byte-compatible with pre-profiler reports
            del d["profile"]
        return d

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path

    @classmethod
    def from_dict(cls, d: dict) -> "RunReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, text: str) -> "RunReport":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "RunReport":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- the human face (the `report` CLI subcommand) ------------------------

    def summary_lines(self) -> List[str]:
        lines = [f"RunReport {self.created_at}  "
                 f"platform={self.platform.get('platform', '?')}"]
        if self.config:
            lines.append("config: " + json.dumps(self.config, sort_keys=True))
        if self.phase_seconds:
            lines.append("host phases (where the wall-clock went):")
            width = max(map(len, self.phase_seconds))
            for name, rec in sorted(self.phase_seconds.items(),
                                    key=lambda kv: -kv[1]["total_s"]):
                lines.append(
                    f"  {name:{width}}  {rec['total_s']:10.4f}s"
                    f"  x{rec['count']:<6} mean {rec['mean_s']:.4f}s")
        # builds (nvcc ran) vs loads of built libraries; a JAX package
        # report adds its AOT loads; pre-`kind` reports only recorded misses
        kind_of = lambda e: e.get(  # noqa: E731 - local classifier
            "kind", "cache_miss" if e.get("cache_miss") else "cache_hit")
        misses = [e for e in self.compile_events
                  if kind_of(e) == "cache_miss"]
        hits = sum(1 for e in self.compile_events
                   if kind_of(e) == "cache_hit")
        aot = sum(1 for e in self.compile_events
                  if kind_of(e) == "aot_loaded")
        warm = (f", {hits} cache-hit" if hits else "") + \
               (f", {aot} aot-loaded" if aot else "")
        lines.append(
            f"compiles: {len(misses)} "
            f"({self.compile_seconds_total:.2f}s total){warm}")
        for e in misses:
            lines.append(f"  {e['wall_seconds']:8.3f}s  {e['runner']}"
                         f"({e['signature']})")
        if self.step_metrics:
            rates = [m["cell_updates_per_sec"] for m in self.step_metrics]
            lines.append(
                f"step metrics: {len(self.step_metrics)} records, "
                f"best {max(rates):.3g} cell-updates/s")
        hb = self.halo_bytes or {}
        if hb.get("model_per_gen") is not None:
            meas = hb.get("measured_per_gen")
            lines.append(
                f"halo bytes/gen: model {hb['model_per_gen']}"
                + (f", measured {meas}" if meas is not None else ""))
        if self.stalls:
            lines.append(f"STALLS: {len(self.stalls)}")
            for s in self.stalls:
                lines.append(
                    f"  {s['label']}: {s['elapsed_seconds']:.1f}s "
                    f"(deadline {s['deadline_seconds']:.1f}s), last span "
                    f"{s['last_completed_span'] or '<none>'}")
        if self.roofline:
            from . import device as device_lib

            lines.extend(device_lib.summary_lines(self.roofline))
        if self.perfetto:
            busy, span = (self.perfetto.get("device_busy_us", 0.0),
                          self.perfetto.get("device_span_us", 0.0))
            if span:
                lines.append(
                    f"device duty cycle: {busy / span:.1%} "
                    f"({self.perfetto.get('device_track')})")
        if self.profile:
            p = self.profile
            lines.append(
                f"sampling profiler: {p.get('windows', 0)} window(s), "
                f"source={p.get('source')}, "
                f"duty {p.get('duty_cycle', 0.0):.2%}")
            frac = p.get("op_class_fraction") or {}
            shares = sorted(((k, v) for k, v in frac.items() if v),
                            key=lambda kv: -kv[1])
            if shares:
                lines.append("  op classes: " + ", ".join(
                    f"{k} {v:.0%}" for k, v in shares))
            if p.get("device_duty_cycle") is not None:
                gaps = p.get("idle_gaps_us") or []
                lines.append(
                    f"  device busy {p['device_duty_cycle']:.1%} of the "
                    "span of its work"
                    + (f", longest idle gap {gaps[0]:.1f} us" if gaps else ""))
            if p.get("top_kernels"):
                name, us = p["top_kernels"][0]
                lines.append(f"  top kernel: {name} ({us:.1f} us)")
            meas = p.get("halo_overlap_ratio_measured")
            static = p.get("halo_overlap_ratio_static")
            if meas is not None:
                line = f"  halo overlap measured {meas:.1%}"
                if static is not None:
                    line += f" vs static {static:.1%}"
                lines.append(line)
            elif static is not None:
                lines.append(
                    f"  halo overlap static {static:.1%} "
                    f"(measured: n/a — {p.get('source')} capture)")
        return lines


def _power_limit(index: int) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _platform_info() -> dict:
    """Best-effort device description: the card's name through torch and
    its power limit through ``nvidia-smi``; the CPU where there is no
    card; {} when torch refuses (a wedged device must not take the report
    down)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"platform": "cpu", "device_kind": "cpu",
                    "device_count": 1}
        index = torch.cuda.current_device()
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(index),
                "device_count": torch.cuda.device_count(),
                "power_limit": _power_limit(index)}
    except Exception:
        return {}


def build_run_report(
    *,
    tracer: Optional[spans_lib.SpanTracer] = None,
    compile_log: Optional[compile_lib.CompileEventLog] = None,
    step_records: Optional[list] = None,
    engine=None,
    watchdog: Optional[watchdog_lib.StallWatchdog] = None,
    trace_path: Optional[str] = None,
    config: Optional[dict] = None,
    halo_bytes: Optional[dict] = None,
    roofline: Optional[dict] = None,
    profile: Optional[dict] = None,
) -> RunReport:
    """Assemble a RunReport from whichever pillars the run exercised.

    ``step_records`` may be StepMetrics objects or plain dicts. Halo
    bytes: the arithmetic model always (cheap); the measured figure only
    when the engine already measured it (no surprise run at report time).
    ``halo_bytes`` overrides for engine-less callers.
    """
    tracer = tracer or spans_lib.TRACER
    compile_log = compile_log or compile_lib.COMPILE_LOG

    halo: dict = dict(halo_bytes or {})
    if engine is not None:
        halo["model_per_gen"] = engine.halo_bytes_per_gen(source="model")
        measured = getattr(engine, "_halo_measured", None)
        halo["measured_per_gen"] = measured[0] if measured else None
        config = dict(config or {})
        config.setdefault("shape", list(engine.shape))
        config.setdefault("rule", engine.rule.notation)
        config.setdefault("backend", engine.backend)
        config.setdefault("sharded", engine.mesh is not None)

    perfetto = None
    if trace_path:
        from ..utils.profiling import perfetto_summary

        try:
            perfetto = perfetto_summary(trace_path)
        except Exception as exc:  # a malformed trace must not eat the report
            perfetto = {"error": f"{type(exc).__name__}: {exc}"}

    records = []
    for m in step_records or []:
        records.append(m if isinstance(m, dict) else m.to_dict())

    if roofline is None and engine is not None:
        # the counted work of the engine's rule and grid x measured step
        # rates, against the peaks of the platform the engine runs on
        from . import device as device_lib

        try:
            cost = engine.runner_cost_analysis()
        except Exception:
            cost = None
        platform = "gpu" if engine.device.type == "cuda" else \
            engine.device.type
        roofline = device_lib.roofline_section(
            cost=cost, step_records=records, platform=platform)

    return RunReport(
        created_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        config=config or {},
        platform=_platform_info(),
        phase_seconds=tracer.phase_seconds(),
        spans=[s.to_dict() for s in tracer.spans()],
        compile_events=[e.to_dict() for e in compile_log.events()],
        compile_seconds_total=compile_log.total_compile_seconds(),
        step_metrics=records,
        halo_bytes=halo,
        stalls=[e.to_dict() for e in (watchdog.events if watchdog else [])],
        metrics=REGISTRY.snapshot(),
        perfetto=perfetto,
        roofline=roofline,
        profile=profile,
    )


class RunTelemetry:
    """One run's telemetry session over the process-global recorders.

    ``flight_path`` arms a :class:`~.flight.FlightRecorder` (crash-report
    JSONL on stall / signal / coordinator-loop exception) for the
    session, and ``device_poll`` starts a :class:`~.device.DeviceSampler`
    feeding HBM gauges into the registry on that interval -- both torn
    down by :meth:`finish`. ``profile_sample`` arms a duty-cycled
    :class:`~.profiler.ProfileSampler` on that period and waits until its
    first window records, so the run that follows lies inside it; its
    cumulative op-class attribution lands in the report's ``profile``
    section."""

    def __init__(self, *, stall_deadline: Optional[float] = None,
                 flight_path: Optional[str] = None,
                 device_poll: Optional[float] = None,
                 profile_sample: Optional[float] = None):
        from ..utils.metrics import BufferSink

        spans_lib.TRACER.clear()
        compile_lib.COMPILE_LOG.clear()
        self.step_buffer = BufferSink()
        self.watchdog: Optional[watchdog_lib.StallWatchdog] = None
        if stall_deadline:
            self.watchdog = watchdog_lib.arm(
                watchdog_lib.StallWatchdog(stall_deadline))
        self.flight = None
        if flight_path:
            from . import flight as flight_lib

            self.flight = flight_lib.FlightRecorder(flight_path)
            self.flight.install(watchdog=self.watchdog)
            flight_lib.arm(self.flight)
        self.sampler = None
        if device_poll:
            from .device import DeviceSampler

            self.sampler = DeviceSampler(device_poll).start()
        self.profiler = None
        if profile_sample:
            from . import profiler as profiler_lib

            self.profiler = profiler_lib.arm(
                profiler_lib.ProfileSampler(profile_sample))
            self.profiler.wait_open()

    def attach(self, coordinator) -> None:
        """Hang the StepMetrics buffer on a coordinator (creating its
        MetricsLogger when it has none)."""
        from ..utils.metrics import MetricsLogger

        if coordinator.metrics is None:
            coordinator.metrics = MetricsLogger(self.step_buffer)
        else:
            coordinator.metrics.add_sink(self.step_buffer)
        if self.flight is not None:
            # the black box tapes FIRST: a signal landing between sinks
            # must not leave a dump whose tape is missing the record a
            # user-facing sink already printed
            coordinator.metrics.sinks.insert(0, self.flight.on_step)

    def finish(self, *, engine=None, trace_path: Optional[str] = None,
               config: Optional[dict] = None,
               halo_bytes: Optional[dict] = None) -> RunReport:
        """Disarm the watchdog and assemble the report. When an engine is
        given, close the run observably first: a sync (so in-flight
        dispatches land inside the spans being reported) and a tiny
        downsampled snapshot (so the readback phase exists even for runs
        that never rendered)."""
        if engine is not None:
            engine.block_until_ready()
            engine.snapshot(max_shape=(8, 8))
        profile = None
        if self.profiler is not None:
            from . import profiler as profiler_lib

            if self.profiler is profiler_lib.active_sampler():
                profiler_lib.disarm()
            else:
                self.profiler.stop()
            profile = self.profiler.attribution()
        if self.sampler is not None:
            self.sampler.sample_once()  # final gauges reflect end-of-run
            self.sampler.stop()
        if self.flight is not None:
            from . import flight as flight_lib

            if self.flight is flight_lib.active_flight_recorder():
                flight_lib.disarm()
            else:
                self.flight.uninstall()
        if self.watchdog is not None and self.watchdog is \
                watchdog_lib.active_watchdog():
            watchdog_lib.disarm()
        return build_run_report(
            step_records=self.step_buffer.records, engine=engine,
            watchdog=self.watchdog, trace_path=trace_path, config=config,
            halo_bytes=halo_bytes, profile=profile)


def begin_run_telemetry(*, stall_deadline: Optional[float] = None,
                        flight_path: Optional[str] = None,
                        device_poll: Optional[float] = None,
                        profile_sample: Optional[float] = None
                        ) -> RunTelemetry:
    """Start a fresh telemetry session (clears the global tracer and
    compile log — earlier runs' spans must not leak into this report)."""
    return RunTelemetry(stall_deadline=stall_deadline,
                        flight_path=flight_path, device_poll=device_poll,
                        profile_sample=profile_sample)
