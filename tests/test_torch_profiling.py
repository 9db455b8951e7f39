"""The port's profiling hooks (``utils/profiling.py``) and the multi-state
LtL render, the behaviours ``tests/test_aux.py`` holds on the JAX
package, on the CPU:

- ``PhaseTimer`` accumulates per-phase counts and totals, its summary
  keyed as the JAX package's;
- ``profile_steps`` steps an engine under ``torch.profiler`` and writes
  its Chrome trace, one annotated range per chunk;
- ``perfetto_summary`` on a trace in ``torch.profiler``'s shape keeps the
  JAX test's semantics: a device's busy time is the union of its work
  intervals (nested and overlapping slices counted once, never summed
  over the streams that mirror them), within its span, and the device
  wins over a busier host track;
- a C >= 3 Larger-than-Life snapshot renders to the JAX package's text
  and PPM bytes.
"""

import io
import json

import numpy as np
import pytest

from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch.coordinator import RenderFrame
from gameoflifewithactors_torch.models import seeds
from gameoflifewithactors_torch.utils import render
from gameoflifewithactors_torch.utils.profiling import (
    TRACE_NAME,
    PhaseTimer,
    perfetto_summary,
    profile_steps,
)
from gameoflifewithactors_tpu.utils.profiling import PhaseTimer as JPhaseTimer


def test_phase_timer_counts_and_totals_like_the_jax_one():
    timers = (PhaseTimer(), JPhaseTimer())
    for t in timers:
        for name in ("step", "step", "sync"):
            with t.phase(name):
                pass
    s, j = (t.summary() for t in timers)
    assert s["step"]["count"] == 2 and s["sync"]["count"] == 1
    assert s["step"]["total_s"] >= 0
    assert s["step"]["mean_s"] == pytest.approx(s["step"]["total_s"] / 2)
    assert {k: sorted(v) for k, v in s.items()} == \
        {k: sorted(v) for k, v in j.items()}
    assert {k: v["count"] for k, v in s.items()} == \
        {k: v["count"] for k, v in j.items()}


def test_phase_timer_counts_a_phase_that_raises():
    t = PhaseTimer()
    with pytest.raises(RuntimeError):
        with t.phase("step"):
            raise RuntimeError("boom")
    assert t.summary()["step"]["count"] == 1


def test_profile_steps_writes_trace(tmp_path):
    e = Engine(seeds.seeded((32, 32), "glider", 1, 1), "conway", device="cpu")
    want = Engine(seeds.seeded((32, 32), "glider", 1, 1), "conway", device="cpu")
    profile_steps(e, 4, str(tmp_path), chunk=2)
    want.step(4)
    assert e.generation == 4
    np.testing.assert_array_equal(e.snapshot(), want.snapshot())
    path = tmp_path / TRACE_NAME
    assert path.exists(), "no profiler output written"
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [ev["name"] for ev in events
              if ev.get("ph") == "X" and ev.get("name", "").startswith("gol_")]
    assert ranges.count("gol_step x2") == 2 and ranges.count("gol_sync") == 1
    s = perfetto_summary(str(path))
    assert s["source"] == "host_tracks" and s["device_busy_us"] == 0.0


def _torch_shaped_trace():
    """The JAX test's trace in ``torch.profiler``'s shape: one device (pid
    0) with two streams that mirror the same wall time -- a 100 us kernel
    with a nested 60 us one, and two kernels of 50 and 40 us -- and a host
    track busy for 500 us."""
    def x(pid, tid, ts, dur, name, cat):
        return {"ph": "X", "cat": cat, "pid": pid, "tid": tid, "ts": ts,
                "dur": dur, "name": name}

    return {"traceEvents": [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "python3"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7 "}},
        {"ph": "M", "pid": 0, "tid": 9, "name": "thread_name",
         "args": {"name": "stream 9 "}},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "host"}},
        {"ph": "M", "pid": 2, "tid": 9, "name": "thread_name",
         "args": {"name": "python"}},
        x(0, 7, 0, 100, "void life_packed::life_packed_kernel<0, 2, 0>(a)",
          "kernel"),
        x(0, 7, 20, 60, "void at::native::vectorized_elementwise_kernel<4>",
          "kernel"),
        x(0, 9, 0, 50, "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
        x(0, 9, 50, 40, "Memset (Device)", "gpu_memset"),
        x(2, 9, 0, 500, "dispatch", "cpu_op"),
    ]}


def test_perfetto_summary_busiest_track_semantics(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_torch_shaped_trace()))
    s = perfetto_summary(str(path))
    assert s["source"] == "device_tracks" and s["device_tracks"] == 2
    # the device wins over the busier host track: union, not the 250 us sum
    assert s["device_track"] == "device 0"
    assert s["device_busy_us"] == 100.0
    assert s["device_busy_us"] <= s["device_span_us"] == 100.0
    assert s["duty_cycle"] == pytest.approx(1.0)
    assert s["device_slices"] == 4
    host = [t for t in s["tracks"] if t["track"] == "host/python"]
    assert host and host[0]["busy_us"] == 500.0 and not host[0]["device"]
    stream = [t for t in s["tracks"] if t["track"] == "python3/stream 7"]
    assert stream and stream[0]["busy_us"] == 100.0


def _render_ltl(engine_cls, render_mod, frame_cls, path, **kw):
    """Text and PPM bytes of the C4 LtL soup after two generations."""
    grid = np.random.default_rng(7).integers(0, 4, size=(16, 32), dtype=np.uint8)
    e = engine_cls(grid, "R2,C4,M1,S3..8,B5..9", **kw)     # auto: planes
    e.step(2)
    snap = e.snapshot()
    buf = io.StringIO()
    render_mod.ConsoleRenderer(buf, ansi=False, charset="·█▓░")(frame_cls(
        grid=snap, generation=e.generation, population=e.population(),
        full_shape=e.shape))
    render_mod.save_ppm(snap, path)
    return snap, buf.getvalue(), path.read_bytes()


def test_render_multistate_ltl_snapshot(tmp_path):
    """The renderer and PPM export take C >= 3 LtL states from the plane
    engine's snapshot (states 0..C-1, like Generations), and write the
    JAX package's bytes for the JAX engine's run."""
    from gameoflifewithactors_tpu import Engine as JEngine
    from gameoflifewithactors_tpu.coordinator import RenderFrame as JFrame
    from gameoflifewithactors_tpu.utils import render as j_render

    snap, text, ppm = _render_ltl(Engine, render, RenderFrame,
                                  tmp_path / "mltl.ppm", device="cpu")
    assert set(np.unique(snap)) <= {0, 1, 2, 3}
    lines = text.splitlines()
    assert len(lines) == 17 and "gen 2" in lines[-1]     # 16 rows + status
    assert ppm.startswith(b"P6") and len(ppm) > 16 * 32 * 3
    j_snap, j_text, j_ppm = _render_ltl(JEngine, j_render, JFrame,
                                        tmp_path / "j_mltl.ppm")
    np.testing.assert_array_equal(snap, j_snap)
    assert (text, ppm) == (j_text, j_ppm)
