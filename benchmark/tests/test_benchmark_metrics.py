"""The metric arithmetic on canned inputs."""

from __future__ import annotations

import pytest

from benchmark import hostspans, manifest, trace


def ctx(**kw):
    base = {"driver": "batch", "setup_s": 7.5,
            "setup_compile_events": [], "spans": {}, "words": 8,
            "trace": None, "peaks": None,
            "config": manifest.config(manifest.load(), "conway-b3s23")}
    base.update(kw)
    return base


def read(name, c):
    got = manifest.read_metric(name, c)
    return None if got is None else got[0]


def test_rate_is_all_work_over_all_time():
    w = {"seconds": 4.0, "ticks": 3, "generations": 6000, "cells": 100,
         "launches": {"life_packed": 375}}
    assert read("cell_updates_per_s", ctx(window=w)) == 100 * 6000 / 4.0
    assert read("engine.launches_per_kgen", ctx(window=w)) == 62.5


def test_p95_is_over_all_requests():
    # 1000 fast requests and 100 slow ones in one stretch: the medians of
    # 10 chunks of 110 would all be fast; the 95th percentile is not
    lat = [0.01] * 1000 + [0.5] * 100
    w = {"seconds": 10.0, "requests": len(lat), "generations_per_request": 512,
         "cells": 1024 * 1024, "latencies_s": lat, "launches": {},
         "per_client": []}
    c = ctx(driver="sessions", window=w, dispatches=[], lane_capacity={})
    assert read("request_p95_ms", c) == pytest.approx(500.0)
    assert read("serve.request_p50_ms", c) == pytest.approx(10.0)
    assert read("served_cell_updates_per_s", c) == 1100 * 512 * 1024 * 1024 / 10
    assert read("cell_updates_per_s", c) is None


def test_lane_shares():
    dispatches = [{"lane": "a", "slots": 1, "generations": 512}] * 3 + \
        [{"lane": "a", "slots": 4, "generations": 512}]
    w = {"requests": 7, "latencies_s": [0.1] * 7}
    c = ctx(driver="sessions", window=w, dispatches=dispatches,
            lane_capacity={"a": 256})
    assert read("lanes.frozen_slot_share", c) == pytest.approx(1 - 7 / 1024)
    assert read("serve.dispatches_per_request", c) == pytest.approx(4 / 7)


def test_idle_share_and_breakdown_from_a_timeline():
    # a 10 ms window from the anchor at t = 1000 us; device 0 busy in two
    # kernels (2 ms and 3 ms, the first overlapping a 1 ms copy: 5.5 ms in
    # all), device 1 in one of 4 ms
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.ANCHOR,
         "ts": 1000.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 2000.0,
         "dur": 2000.0, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 3500.0,
         "dur": 1000.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 7000.0,
         "dur": 3000.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1000.0,
         "dur": 4000.0, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 20000.0,
         "dur": 5.0, "args": {"device": 1}},
    ]
    spans = [("benchmark.sync", 10.0, 10.0105, "main", None),
             ("engine.step", 10.004, 10.006, "main", None)]
    got = dict(trace.reduce(events, 10.0, 10.010, 2, spans), whole=True)
    assert got["window_s"] == pytest.approx(0.010)
    assert got["busy_s_by_device"] == {"0": pytest.approx(0.0055),
                                       "1": pytest.approx(0.004)}
    assert got["busy_s"] == pytest.approx(0.00475)
    assert got["kernels"]["k_a"] == {"count": 2, "seconds": pytest.approx(0.006)}
    assert "outside" not in got["kernels"]
    gaps = got["breakdown"]["idle_gaps"]
    assert gaps[0] == ["benchmark.sync", pytest.approx(0.006)]   # device 1
    assert ["engine.step", pytest.approx(0.0025)] in gaps        # device 0
    c = ctx(trace=got)
    assert read("device.idle_share.batch", c) == pytest.approx(0.525)
    assert read("device.idle_share.serve", c) is None
    assert hostspans.innermost_at(spans, 10.005) == "engine.step"
    # a trace that lost records of the program's kernels gives no idle share
    assert read("device.idle_share.batch", ctx(trace=dict(got, whole=False))) is None


def test_roofline_share_from_counts():
    # 10 launches of 16 generations over 1000 words at 20 ops a word:
    # 3.2e6 ops, 8e4 bytes; at 1e12 ops/s the bound is 3.2 us, bytes 0.8 us
    t = {"kernels": {"void life_packed_kernel<0, 2, 0>": {"count": 10,
                                                         "seconds": 6.4e-6}},
         "counters": {"generations": 160, "launches": {"life_packed": 10}},
         "busy_s": 1.0, "window_s": 2.0, "busy_s_by_device": {"0": 1.0},
         "whole": True}
    peaks = {"int_ops_per_sec": 1e12, "hbm_bytes_per_sec": 1e11}
    c = ctx(trace=t, peaks=peaks, words=1000)
    assert read("b1_roofline", c) == pytest.approx(50.0)
    assert read("b4_roofline", c) is None
    # a trace that lost records gives no share
    assert read("b1_roofline", ctx(trace=dict(t, whole=False), peaks=peaks,
                                   words=1000)) is None
    t["kernels"]["void life_packed_kernel<0, 2, 0>"] = {"count": 5,
                                                       "seconds": 3.2e-6}
    assert read("b1_roofline", c) is None


def test_setup_and_warm_start():
    events = [{"kind": "cache_hit", "wall_seconds": 0.25},
              {"kind": "cache_miss", "wall_seconds": 9.0}]
    c = ctx(setup_compile_events=events)
    assert read("warmstart.kernel_load_s", c) == 9.25
    assert read("setup_s", c) == 7.5
    assert read("warmstart.kernel_load_s", ctx()) is None


@pytest.mark.parametrize("cell", ["conway-batch-16384", "conway-sessions-1024"])
@pytest.mark.parametrize("lost", [False, True])
def test_a_traced_run_slices_again_where_the_trace_lost_records(
        cell, lost, monkeypatch):
    from benchmark.tests.conftest import drive_cpu

    slices = []
    real = trace.TracedWindow.reduce

    def reduce(self):
        got = real(self)
        slices.append(got["whole"])
        if lost:
            got["whole"] = False
        return got

    monkeypatch.setattr(trace.TracedWindow, "reduce", reduce)
    line = drive_cpu(cell, seconds=4.0, trace=True, trace_skip_seconds=0.05,
                     trace_seconds=0.1)
    assert line["correct"], line["checks"]
    idle = "device.idle_share." + ("serve" if "sessions" in cell else "batch")
    if lost:
        assert len(slices) == trace.TRACE_ATTEMPTS
        assert idle not in line["metrics"]
    else:
        assert slices == [True]
        assert line["metrics"][idle]["value"] == 1.0   # no card: nothing ran
