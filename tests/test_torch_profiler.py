"""The port's sampling profiler on ``torch.profiler``, on the CPU: the op
classes of the CUDA names a card's trace holds (and XLA's names classed
as the JAX package classes them), ``ProfileSampler`` with an injected
capture, its duty-cycle refusal, and ``perfetto_summary`` of a Chrome
trace: a real CPU ``torch.profiler`` trace (host tracks only) and one in
the shape the profiler writes on a card (kernels on a stream track)."""

import contextlib
import json
import threading
import time

import pytest
import torch

from gameoflifewithactors_torch.obs import profiler as profiler_lib
from gameoflifewithactors_torch.obs.profiler import (
    MAX_DUTY_CYCLE,
    OP_CLASSES,
    ProfileSampler,
    classify_slice,
)
from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.obs.report import RunReport, build_run_report
from gameoflifewithactors_torch.utils import profiling
from gameoflifewithactors_tpu.obs import profiler as j_profiler

_CUDA_NAMES = [
    ("void life_packed::life_packed_kernel<0, 2, 0>(life_packed::Args)",
     "stencil"),
    ("void life_generations::life_generations_kernel<2, false, 1>"
     "(life_generations::Args)", "stencil"),
    ("void life_ltl::ltl_kernel<5, false, false>(life_ltl::Args)", "stencil"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BitwiseAndFunctor<int>>", "stencil"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
     "collective_permute"),
    ("Memcpy HtoD (Pageable -> Device)", "infeed_host"),
    ("Memcpy DtoH (Device -> Pageable)", "infeed_host"),
    ("Memcpy DtoD (Device -> Device)", "copy_reshape"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
     "<at::native::(anonymous namespace)::OpaqueType<4u>>", "copy_reshape"),
    ("void at::native::index_elementwise_kernel<128, 4>", "copy_reshape"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>",
     "copy_reshape"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<int>",
     "copy_reshape"),
]
_XLA_NAMES = ["fusion.12", "collective-permute-start.3", "copy.7",
              "gather_fusion", "broadcast_multiply_fusion", "infeed",
              "custom-call.1", "while.2", "transpose.4", "dynamic-slice",
              "goltpu.dispatch[pallas]", "bitcast", "pad.1", "send.2"]


@pytest.mark.parametrize("names", ["cuda", "xla"])
def test_classify_slice(names):
    if names == "cuda":
        for name, cls in _CUDA_NAMES:
            assert classify_slice(name) == cls, name
    else:
        for name in _XLA_NAMES:
            assert classify_slice(name) == j_profiler.classify_slice(name), name
    assert OP_CLASSES == j_profiler.OP_CLASSES


def _fake_summary(source="device_tracks"):
    return {"source": source, "tracks": [{"track": "t", "busy_us": 800.0}],
            "op_class_us": {"collective_permute": 200.0, "stencil": 600.0},
            "overlap": ({"collective_us": 200.0, "compute_us": 600.0,
                         "overlapped_us": 100.0, "ratio": 0.5}
                        if source == "device_tracks" else None),
            "device_busy_us": 800.0 if source == "device_tracks" else 0.0,
            "device_span_us": 1000.0 if source == "device_tracks" else 0.0,
            "idle_gaps_us": [150.0, 50.0] if source == "device_tracks" else [],
            "top_kernels": [["life_packed_kernel", 600.0]]
            if source == "device_tracks" else []}


def test_sampler_folds_injected_windows():
    reg = MetricsRegistry()
    s = ProfileSampler(10.0, window_seconds=0.2, registry=reg,
                       capture=lambda w: _fake_summary())
    assert s.sample_once() is not None and s.sample_once() is not None
    att = s.attribution()
    assert att["windows"] == 2 and att["source"] == "device_tracks"
    assert att["op_class_fraction"]["stencil"] == pytest.approx(0.75)
    assert att["halo_overlap_ratio_measured"] == pytest.approx(0.5)
    assert att["duty_cycle"] == pytest.approx(0.02)
    assert att["device_busy_seconds"] == pytest.approx(1.6e-3)
    assert att["device_duty_cycle"] == pytest.approx(0.8)
    assert att["idle_gaps_us"] == [150.0, 150.0, 50.0, 50.0]
    assert att["top_kernels"] == [["life_packed_kernel", 1200.0]]
    assert reg.gauge("profile_op_class_fraction", "").value(
        op_class="stencil", source="device_tracks") == pytest.approx(0.75)
    # host tracks: measured overlap and device duty absent, never 0.0
    host = ProfileSampler(10.0, registry=MetricsRegistry(),
                          capture=lambda w: _fake_summary("host_tracks"))
    host.sample_once()
    att = host.attribution()
    assert att["source"] == "host_tracks"
    assert att["halo_overlap_ratio_measured"] is None
    assert att["device_duty_cycle"] is None
    assert att["device_busy_seconds"] is None


def test_sampler_refuses_duty_cycle_over_budget(monkeypatch):
    with pytest.raises(ValueError, match="overhead budget"):
        ProfileSampler(1.0, window_seconds=0.2)
    with pytest.raises(ValueError, match="positive"):
        ProfileSampler(0.0)
    s = ProfileSampler(2.0, window_seconds=2.0 * MAX_DUTY_CYCLE,
                       registry=MetricsRegistry(), capture=lambda w: None)
    assert s.window / s.period == pytest.approx(MAX_DUTY_CYCLE)
    monkeypatch.setenv(profiler_lib.ENV_SAMPLE, "5.5")
    assert ProfileSampler(registry=MetricsRegistry(),
                          capture=lambda w: None).period == 5.5


def test_sampler_errors_never_raise_and_release_waiters():
    def boom(_w):
        raise RuntimeError("wedged profiler")

    reg = MetricsRegistry()
    s = ProfileSampler(3600.0, registry=reg, capture=boom)
    with s:
        assert s.wait_open(5.0)
    att = s.attribution()
    assert att["windows"] == 0 and att["capture_errors"] == 1
    assert reg.counter("profile_capture_errors", "").value(
        error="RuntimeError") == 1


def test_armed_sampler_captures_at_once_and_annotates_dispatch():
    assert isinstance(profiler_lib.dispatch_annotation("x"),
                      contextlib.nullcontext)
    s = ProfileSampler(3600.0, registry=MetricsRegistry(),
                       capture=lambda w: _fake_summary())
    try:
        assert profiler_lib.arm(s) is s and s.wait_open(5.0)
        deadline = time.perf_counter() + 5.0
        while s.attribution()["windows"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert s.attribution()["windows"] == 1
        ctx = profiler_lib.dispatch_annotation("goltpu.dispatch[cuda]")
        assert isinstance(ctx, torch.profiler.record_function)
    finally:
        profiler_lib.disarm()
    assert profiler_lib.active_sampler() is None


def test_summary_of_a_cpu_torch_profiler_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("gol_step x4"):
            a = torch.arange(4096, dtype=torch.int32).reshape(64, 64)
            for _ in range(4):
                a = (a ^ torch.roll(a, 1, 0)) & 0x7FFF
    summary = profiling.perfetto_summary(str(tmp_path / profiling.TRACE_NAME))
    assert summary["source"] == "host_tracks"
    assert summary["device_tracks"] == 0 and summary["device_busy_us"] == 0.0
    assert summary["duty_cycle"] is None and summary["overlap"] is None
    assert summary["tracks"] and summary["tracks"][0]["busy_us"] > 0
    names = {n for t in summary["tracks"] for n, _ in t["top"]}
    assert "gol_step x4" in names
    assert summary["op_class_us"].get("stencil", 0) > 0   # gol_step


def _kernel(name, ts, dur, tid=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur}


def test_summary_of_device_tracks(tmp_path):
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 99,
         "tid": 99, "ts": 0.0, "dur": 5.0},
        # a user range on the device track spans the gaps: not work
        _kernel("goltpu.dispatch[cuda]", 90.0, 500.0,
                cat="gpu_user_annotation"),
        _kernel("void life_packed::life_packed_kernel<0, 2, 0>(a)", 100, 100),
        _kernel("void life_packed::life_packed_kernel<0, 2, 0>(a)", 150, 100),
        _kernel("void life_packed::life_packed_kernel<0, 2, 0>(a)", 300, 100),
        _kernel("Memcpy DtoH (Device -> Pageable)", 500, 20,
                cat="gpu_memcpy"),
        _kernel("ncclDevKernel_SendRecv", 320, 50, tid=9),
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    s = profiling.perfetto_summary(str(path))
    assert s["source"] == "device_tracks" and s["device_tracks"] == 2
    assert s["device_busy_us"] == 270.0          # [100,250] [300,400] [500,520]
    assert s["device_span_us"] == 420.0
    assert s["duty_cycle"] == pytest.approx(270 / 420)
    assert s["idle_gaps_us"] == [100.0, 50.0]
    assert s["top_kernels"][0][0].startswith("void life_packed::")
    assert s["op_class_us"] == {"collective_permute": 50.0,
                                "infeed_host": 20.0, "stencil": 250.0}
    assert s["overlap"]["overlapped_us"] == 50.0
    assert s["device_slices"] == 5


def test_capture_window_skips_while_the_profiler_is_held():
    opened = threading.Event()
    with profiling.PROFILER_LOCK:
        assert profiling.capture_window(0.01, opened=opened) is None
    assert opened.is_set()


def test_report_carries_the_profile_section_and_renders_it():
    s = ProfileSampler(10.0, registry=MetricsRegistry(),
                       capture=lambda w: _fake_summary())
    s.sample_once()
    rep = build_run_report(profile=s.attribution(), config={"x": 1})
    back = RunReport.from_dict(json.loads(rep.to_json()))
    text = "\n".join(back.summary_lines())
    assert "sampling profiler: 1 window(s), source=device_tracks" in text
    assert "device busy 80.0% of the span of its work, longest idle gap " \
           "150.0 us" in text
    assert "top kernel: life_packed_kernel (600.0 us)" in text
    assert "profile" not in build_run_report(config={}).to_dict()
