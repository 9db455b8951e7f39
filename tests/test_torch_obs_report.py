"""The port's run report against the JAX package's, on the CPU: the
roofline section and its summary lines for the same cost dict and step
records, the differ's rows, table and gate for the same records, each
package's ``RunReport.from_dict`` reading the other's report, the stall
watchdog with injected clocks, and the tick's hooks (spans, build
seconds taken out of the wall time, a flight dump on an exception)."""

import json
import time

import numpy as np
import pytest

from gameoflifewithactors_torch.coordinator import GridCoordinator
from gameoflifewithactors_torch.obs import compile as t_compile
from gameoflifewithactors_torch.obs import device as t_device
from gameoflifewithactors_torch.obs import diff as t_diff
from gameoflifewithactors_torch.obs import flight as t_flight
from gameoflifewithactors_torch.obs import report as t_report
from gameoflifewithactors_torch.obs import spans as t_spans
from gameoflifewithactors_torch.obs import watchdog as t_watchdog
from gameoflifewithactors_torch.utils import provenance
from gameoflifewithactors_torch.utils.metrics import BufferSink, MetricsLogger
from gameoflifewithactors_tpu.obs import compile as j_compile
from gameoflifewithactors_tpu.obs import device as j_device
from gameoflifewithactors_tpu.obs import diff as j_diff
from gameoflifewithactors_tpu.obs import report as j_report
from gameoflifewithactors_tpu.obs import spans as j_spans

_STEPS = [
    {"generation": 8, "generations_stepped": 8, "wall_seconds": 2.0,
     "cell_updates_per_sec": 4e9},
    {"generation": 16, "generations_stepped": 8, "wall_seconds": 1.0,
     "cell_updates_per_sec": 8e9},
]
_COST = {"generations": 8, "flops": 8e6, "bytes_accessed": 4e6}


@pytest.mark.parametrize("cost,steps", [(_COST, _STEPS), (_COST, None),
                                        (None, _STEPS), (None, None)])
def test_roofline_section_and_summary_lines_match_jax(cost, steps):
    t = t_device.roofline_section(cost=cost, step_records=steps,
                                  platform="cpu")
    j = j_device.roofline_section(cost=cost, step_records=steps,
                                  platform="cpu")
    assert t == j
    if t is not None:
        assert t_device.summary_lines(t) == j_device.summary_lines(j)


def test_roofline_against_the_cards_peaks(monkeypatch):
    peaks = {"device": "card", "hbm_gbps": 2000.0, "int_ops_per_sec": 1e10,
             "sms": 100, "max_sm_clock_mhz": 1562.5, "int32_lanes_per_sm": 64}
    monkeypatch.setitem(t_device.PEAKS, "gpu", peaks)
    cost = dict(_COST, ops_kind="bitwise")
    sec = t_device.roofline_section(cost=cost, step_records=_STEPS,
                                    platform="gpu")
    # best record: 1e9 cells/gen at 8e9 cell/s -> 8 gens/s: 8e6 ops/s,
    # 4e6 B/s
    assert sec["achieved"]["flops_per_sec"] == pytest.approx(8e6)
    assert sec["achieved_fraction"] == pytest.approx(
        {"of_hbm_bandwidth": 4e6 / 2e12, "of_int_op_peak": 8e6 / 1e10})
    assert sec["cost_analysis"]["ops_kind"] == "bitwise"
    text = "\n".join(t_device.summary_lines(sec))
    assert "op counts of the packed formulation" in text
    assert "bitwise ops/gen" in text and "integer ops/s peak" in text
    assert "100 SMs x 64 x 1562 MHz" in text


def _report_dict(spans_lib, compile_lib, report_lib, steps, phase):
    tr = spans_lib.SpanTracer()
    with tr.span(phase):
        pass
    log = compile_lib.CompileEventLog()
    log.record(compile_lib.CompileEvent(
        runner="build:life_packed", signature="x", wall_seconds=1.5,
        cache_miss=True, donated=False, t0=0.0, t1=1.5))
    rep = report_lib.build_run_report(
        tracer=tr, compile_log=log, step_records=steps,
        config={"side": 48}, halo_bytes={"model_per_gen": 0,
                                         "measured_per_gen": None},
        roofline=j_device.roofline_section(cost=_COST, step_records=steps,
                                           platform="cpu"))
    return rep.to_dict()


@pytest.mark.parametrize("shape", ["reports", "bench"])
def test_diff_rows_table_and_gate_match_jax(shape):
    if shape == "reports":
        base = _report_dict(j_spans, j_compile, j_report, _STEPS[:1],
                            "engine.step")
        other = _report_dict(t_spans, t_compile, t_report, _STEPS,
                             "engine.sync")
        other["stalls"] = [{"label": "tick"}]
    else:
        base = {"metric": "cell-updates/s (cuda, 50% soup)", "value": 1e13}
        other = {"metric": "cell-updates/s (cuda, 50% soup)", "value": 7e12,
                 "single_chip_equivalent_updates_per_sec": 7e12}
    t_rows, j_rows = t_diff.diff_records(base, other), \
        j_diff.diff_records(base, other)
    assert [r.to_dict() for r in t_rows] == [r.to_dict() for r in j_rows]
    assert t_diff.format_rows(t_rows) == j_diff.format_rows(j_rows)
    t_gate, j_gate = t_diff.gate(base, other), j_diff.gate(base, other)
    assert t_gate["status"] == j_gate["status"] == "regression"
    assert t_gate["reason"] == j_gate["reason"]


def test_each_package_reads_the_others_report(tmp_path):
    t_dict = _report_dict(t_spans, t_compile, t_report, _STEPS, "engine.step")
    j_dict = _report_dict(j_spans, j_compile, j_report, _STEPS, "engine.step")
    assert set(t_dict) == set(j_dict)
    for d in (t_dict, j_dict):
        for cls in (t_report.RunReport, j_report.RunReport):
            back = cls.from_dict(json.loads(json.dumps(d)))
            assert back.to_dict() == d
            assert back.summary_lines()[1:] == \
                j_report.RunReport.from_dict(d).summary_lines()[1:]


def test_watchdog_flags_a_held_tick_with_injected_clocks():
    tr = t_spans.SpanTracer()
    seen = []
    wd = t_watchdog.StallWatchdog(1.0, tracer=tr, on_stall=seen.append)
    with tr.span("engine.step"):
        pass
    with wd.watch("tick@gen8+8"):
        with tr.span("engine.sync"):
            t0 = time.perf_counter()
            assert wd._check(t0 + 0.5) is None           # within deadline
            ev = wd._check(t0 + 1.5)                      # past it
            assert wd._check(t0 + 2.0) is None            # one per tick
    assert ev is not None and seen == [ev] and wd.events == [ev]
    assert ev.label == "tick@gen8+8"
    assert ev.last_completed_span == "engine.step"
    assert ev.open_spans == ("engine.sync",)
    assert wd.events_since(0) == [ev] and wd.events_since(1) == []
    assert wd._check(time.perf_counter() + 5) is None    # nothing watched
    with pytest.raises(ValueError, match="deadline"):
        t_watchdog.StallWatchdog(0)


def _coordinator():
    rng = np.random.default_rng(3)
    grid = (rng.random((48, 96)) < 0.35).astype(np.uint8)
    return GridCoordinator((48, 96), "B3/S23", seed=grid, device="cpu")


def test_tick_takes_build_seconds_out_of_its_wall_time():
    coord = _coordinator()
    sink = BufferSink()
    coord.metrics = MetricsLogger(sink)
    step = coord.engine.step
    built = []

    def building_step(n):
        # a kernel build (here a sleep) completing inside the tick
        t0 = time.perf_counter()
        time.sleep(0.05)
        built.append(t_compile.record_build(
            "build:life_packed", "x", t0, time.perf_counter(), miss=True))
        step(n)

    coord.engine.step = building_step
    t0 = time.perf_counter()
    coord.tick(4)
    wall = time.perf_counter() - t0
    m = sink.records[0]
    assert m.compile_seconds == built[0].wall_seconds >= 0.05
    assert m.wall_seconds + m.compile_seconds <= wall


def test_tracked_call_records_builds_and_loads():
    log = t_compile.CompileEventLog()
    assert t_compile.tracked_call(lambda: 7, "nothing", (), {}, log=log) == 7
    t_compile.tracked_call(lambda: t_compile.note_kernel_build("hit"),
                           "load", (), {}, log=log)
    t_compile.tracked_call(lambda x: t_compile.note_kernel_build("miss"),
                           "build", (np.zeros((3, 4), np.int32),), {}, log=log)
    events = log.events()
    assert [(e.runner, e.kind, e.cache_miss) for e in events] == [
        ("load", "cache_hit", False), ("build", "cache_miss", True)]
    assert events[1].signature == "int32[3,4]"
    assert log.total_compile_seconds() == events[1].wall_seconds


def test_run_telemetry_session_and_a_flight_dump_on_exception(tmp_path):
    telem = t_report.begin_run_telemetry(
        stall_deadline=30.0, flight_path=str(tmp_path / "f.jsonl"))
    assert not t_spans.TRACER.spans()
    coord = _coordinator()
    coord.subscribe(lambda frame: None)
    telem.attach(coord)
    coord.run(12, render_every=4)
    rep = telem.finish(engine=coord.engine, config={"steps": 12})
    for name in ("coordinator.tick", "coordinator.notify", "engine.step",
                 "engine.sync", "engine.snapshot"):
        assert name in rep.phase_seconds, name
    assert rep.phase_seconds["coordinator.tick"]["count"] == 3
    assert len(rep.step_metrics) == 3 and rep.platform["platform"] == "cpu"
    assert rep.roofline["cost_analysis"]["flops"] == \
        coord.engine.runner_cost_analysis()["flops"]
    assert rep.roofline["peak_modelled"] is None
    # an exception escaping the tick leaves a crash dump behind
    fr = t_flight.arm(t_flight.FlightRecorder(str(tmp_path / "crash.jsonl")))
    try:
        coord.subscribe(lambda frame: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            coord.tick(1)
        assert fr.dumps == 1 and "ZeroDivisionError" in fr.last_dump_reason
    finally:
        t_flight.disarm()


def test_provenance_says_when_a_record_is_stale(tmp_path):
    head = provenance.git_head()
    if head is None:
        pytest.skip("not a git checkout")
    fresh = {"metric": "x", "commit": head,
             "measured_paths": ["gameoflifewithactors_tpu/ops/stencil.py"]}
    assert provenance.staleness(fresh)["stale"] is False
    assert t_diff.record_staleness(fresh, provenance=provenance) is None
    # a record stamped at an older commit whose measured file changed
    # since (or a stamp git cannot check) is stale
    old = dict(fresh, measured_paths=["ROADMAP.md"], commit="2b61d12")
    assert provenance.staleness(old)["stale"] is True
    assert provenance.staleness({"metric": "x"})["stale"] is True
    stamp = provenance.head_stamp(fresh["measured_paths"])
    assert stamp == {"commit": head,
                     "measured_paths": fresh["measured_paths"]}


def test_fleet_merge_matches_jax_and_refuses_per_chip_sums():
    from gameoflifewithactors_torch.obs import aggregate as t_agg
    from gameoflifewithactors_torch.obs.exporter import render_prometheus
    from gameoflifewithactors_torch.obs.registry import MetricsRegistry
    from gameoflifewithactors_tpu.obs import aggregate as j_agg

    texts = {}
    for proc, n in (("w0", 3), ("w1", 5)):
        reg = MetricsRegistry()
        reg.counter("halo_bytes_total", "bytes").inc(n * 1024)
        reg.gauge("hbm_bytes_in_use", "bytes").set(n * 1e9, device="0")
        texts[proc] = render_prometheus(reg.snapshot())
    assert t_agg.merge_expositions(texts) == j_agg.merge_expositions(texts)
    assert t_agg.sum_across_procs(texts, "goltpu_halo_bytes_total") == 8192
    with pytest.raises(t_agg.PerChipSumError):
        t_agg.sum_across_procs(texts, "hbm_bytes_in_use")
