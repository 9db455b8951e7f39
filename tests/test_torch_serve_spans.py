"""The session service's spans of where a request's time goes
(``serve/service.py``, ``serve/frontend.py``) and the naming of the
card's idle gaps by them (``utils/profiling.py``, ``obs/profiler.py``):

- one traced HTTP step and one read record ``serve.lock_wait``,
  ``serve.frame_sync``, ``serve.frame_copy``, ``serve.frame_encode`` and
  ``serve.respond`` under the caller's trace, with an unbroken parent
  chain, and the lock's wait a sibling of the dispatch it guards;
- a wait for a held lock is its span's length, and the ``lock_wait``
  phase of ``session_phase_seconds`` is the same two readings;
- a re-entered lock (the pump inside ``step``) records no second wait;
- a clock-anchored trace names each idle gap of the card after the span
  of a thread that works, not one that waits for the lock, and "no host
  span" where none is open; the sampling profiler carries the names;
- spans exported on a capture's anchor lie within 1 ms of the capture's
  own ranges of the same moments;
- trace and span ids keep their wire form and do not follow the
  process's global random state.

The service runs on the CPU (B2's plain version on its lanes); every HTTP
request and every join has a timeout.
"""

import json
import random
import threading
import time
import urllib.request

import pytest
import torch

from gameoflifewithactors_torch.obs import spans as obs_spans
from gameoflifewithactors_torch.obs.profiler import ProfileSampler
from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.obs.spans import (
    TRACER,
    Span,
    TraceContext,
    bind_trace,
    new_span_id,
    new_trace_id,
)
from gameoflifewithactors_torch.serve.frontend import TRACE_HEADER, SessionFrontend
from gameoflifewithactors_torch.utils import profiling

from .test_torch_serve import FILL, SPEC, make_service

NEW_SPANS = {"serve.lock_wait", "serve.frame_sync", "serve.frame_copy",
             "serve.frame_encode", "serve.respond"}


def _post(port, path, body, header=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={TRACE_HEADER: header} if header else {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _spans_of(trace_id, want, timeout_s=5.0):
    """The trace's spans, polled until every wanted name landed (a
    response's spans close just after the client has it)."""
    deadline = time.perf_counter() + timeout_s
    got = []
    while time.perf_counter() < deadline:
        got = [s for s in TRACER.spans() if s.trace_id == trace_id]
        if want <= {s.name for s in got}:
            return got
        time.sleep(0.01)
    raise AssertionError(f"saw {sorted({s.name for s in got})}, "
                         f"wanted {sorted(want)}")


def _lock_wait_samples(reg, tenant):
    """(sum, n) of the tenant's ``lock_wait`` phase."""
    for series in reg.snapshot()["session_phase_seconds"]["series"]:
        if series["labels"] == {"phase": "lock_wait", "tenant": tenant}:
            return series["sum"], series["n"]
    return 0.0, 0


def test_a_traced_step_and_read_record_the_new_spans_in_one_chain():
    svc, _reg = make_service()
    caller = TraceContext(new_trace_id(), new_span_id())
    with SessionFrontend(svc, 0) as fe:
        sid = _post(fe.port, "/sessions", {"tenant": "acme", "spec": SPEC,
                                           "fill": FILL, "rng_seed": 3})["sid"]
        _post(fe.port, f"/sessions/{sid}/step", {"n": 4}, caller.header())
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/sessions/{sid}/grid",
            headers={TRACE_HEADER: caller.header()})
        with urllib.request.urlopen(req, timeout=30) as r:
            frame = json.loads(r.read())
    assert frame["generation"] == 4 and frame["trace_id"] == caller.trace_id

    spans = _spans_of(caller.trace_id, NEW_SPANS | {"lane.dispatch"})
    ids = {s.span_id for s in spans}
    for s in spans:
        assert s.parent_id in ids or s.parent_id == caller.span_id, s.name
    by_id = {s.span_id: s for s in spans}
    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == 2
    # the waits are siblings of what the lock guards: children of the
    # request, as the dispatch is
    waits = [s for s in spans if s.name == "serve.lock_wait"]
    assert sorted(s.attrs["op"] for s in waits) == ["grid", "step"]
    for name in ("serve.lock_wait", "lane.dispatch", "serve.frame_sync",
                 "serve.frame_copy", "serve.frame_encode", "serve.respond"):
        for s in spans:
            if s.name == name:
                assert by_id[s.parent_id].name == "serve.request", name
    sync = [s for s in spans if s.name == "serve.frame_sync"]
    assert len(sync) == 1 and sync[0].attrs["slot"] is not None
    assert sync[0].attrs["lane"]
    dispatch = [s for s in spans if s.name == "lane.dispatch"][-1]
    assert dispatch.t1 <= sync[0].t0   # the step's enqueue, then the wait
    assert len([s for s in spans if s.name == "serve.respond"]) == 2


def test_a_held_lock_is_the_next_requests_wait_span_and_phase():
    svc, reg = make_service()
    sid = svc.create("acme", SPEC, fill=FILL, rng_seed=1)["sid"]
    held = threading.Event()

    def hold():
        with svc._lock:
            held.set()
            time.sleep(0.2)

    holder = threading.Thread(target=hold)
    holder.start()
    assert held.wait(10)
    sum0, n0 = _lock_wait_samples(reg, "acme")
    with bind_trace() as ctx:
        svc.step(sid, 2)
    holder.join(timeout=10)
    assert not holder.is_alive()
    wait = [s for s in TRACER.spans()
            if s.trace_id == ctx.trace_id and s.name == "serve.lock_wait"]
    assert len(wait) == 1 and wait[0].attrs == {"op": "step"}
    assert wait[0].seconds >= 0.15
    sum1, n1 = _lock_wait_samples(reg, "acme")
    assert n1 == n0 + 1
    assert sum1 - sum0 == pytest.approx(wait[0].seconds, abs=1e-3)


def test_a_reentered_lock_records_one_wait_per_public_call():
    svc, _reg = make_service()
    sid = svc.create("acme", SPEC, fill=FILL, rng_seed=2)["sid"]
    with bind_trace() as ctx:
        svc.step(sid, 3)            # pumps under the lock it holds
        svc.pump()
        svc.info(sid)
        with svc._lock:             # a holder's own calls wait for nothing
            svc.info(sid)
    ops = [s.attrs["op"] for s in TRACER.spans()
           if s.trace_id == ctx.trace_id and s.name == "serve.lock_wait"]
    assert ops == ["step", "pump", "info"]


# -- idle gaps named by the spans ---------------------------------------------

ANCHOR_PERF = 50.0   # perf_counter seconds at the anchor's end, 1000 us


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "life_packed_kernel",
            "pid": 0, "tid": 7, "ts": float(ts), "dur": float(dur)}


def _trace(tmp_path, anchor=True):
    events = [{"ph": "X", "cat": "user_annotation",
               "name": profiling.CLOCK_ANCHOR, "pid": 1, "tid": 1,
               "ts": 998.0, "dur": 2.0},
              # gaps: 3000-5000 us, 6000-6500 us, 7000-10000 us
              _kernel(2000, 1000), _kernel(5000, 1000), _kernel(6500, 500),
              _kernel(10000, 100)]
    data = {"traceEvents": events}
    if anchor:
        data["obsClockAnchor"] = {"perf_counter_s": ANCHOR_PERF, "pid": -1}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(data))
    return str(path)


def _span(name, us0, us1, thread, depth):
    """A span from trace time ``us0`` to ``us1`` (us), on the span clock."""
    return Span(name=name, t0=ANCHOR_PERF + (us0 - 1000) / 1e6,
                t1=ANCHOR_PERF + (us1 - 1000) / 1e6, thread_id=thread,
                thread_name=f"t{thread}", depth=depth)


SPANS = [
    # thread 1 waits for the lock through the first gap (mid 4000 us); its
    # wait began later than thread 2's frame sync, what the card waits on
    _span("serve.request", 3500, 5000, 1, 0),
    _span("serve.lock_wait", 3950, 4900, 1, 1),
    _span("serve.request", 3000, 5500, 2, 0),
    _span("serve.frame_sync", 3900, 4200, 2, 1),
    # the second gap (mid 6250 us) lies in an enqueue, inside a dispatch
    _span("serve.request", 5800, 6700, 3, 0),
    _span("lane.dispatch", 5900, 6600, 3, 1),
    _span("engine.step", 6000, 6500, 3, 2),
    # in the third (mid 8500 us) only a waiting thread has a span open
    _span("serve.lock_wait", 8000, 9000, 4, 1),
]


def test_idle_gaps_are_named_after_the_thread_that_does_not_wait(tmp_path):
    s = profiling.perfetto_summary(_trace(tmp_path), spans=SPANS)
    assert s["idle_gaps_us"] == [3000.0, 2000.0, 500.0]
    assert s["idle_gaps_named"] == [[profiling.NO_HOST_SPAN, 3000.0],
                                    ["serve.frame_sync", 2000.0],
                                    ["engine.step", 500.0]]
    # no anchor, or spans of another process by default: no names
    assert profiling.perfetto_summary(
        _trace(tmp_path, anchor=False), spans=SPANS)["idle_gaps_named"] is None
    assert profiling.perfetto_summary(_trace(tmp_path))[
        "idle_gaps_named"] is None


def test_the_sampler_carries_the_named_gaps():
    def capture(window_s):
        return {"source": "device_tracks", "op_class_us": {"stencil": 10.0},
                "device_busy_us": 10.0, "device_span_us": 20.0,
                "idle_gaps_us": [7.0, 3.0],
                "idle_gaps_named": [["engine.step", 7.0],
                                    [profiling.NO_HOST_SPAN, 3.0]]}

    s = ProfileSampler(10.0, registry=MetricsRegistry(), capture=capture)
    s.sample_once()
    s.sample_once()
    att = s.attribution()
    assert att["idle_gaps_named"] == [["engine.step", 7.0],
                                      ["engine.step", 7.0],
                                      [profiling.NO_HOST_SPAN, 3.0],
                                      [profiling.NO_HOST_SPAN, 3.0]]


def test_spans_exported_on_a_captures_anchor_line_up_with_it(tmp_path):
    names = [f"t.align{i}.{new_span_id()}" for i in range(3)]
    with profiling.trace(str(tmp_path)):
        for name in names:
            with obs_spans.span(name):
                with torch.profiler.record_function(name):
                    pass
            time.sleep(0.01)
    path = str(tmp_path / profiling.TRACE_NAME)
    with open(path) as f:
        data = json.load(f)
    assert data["obsClockAnchor"]["pid"] > 0
    prof = {e["name"]: float(e["ts"]) for e in data["traceEvents"]
            if e.get("ph") == "X" and e.get("name") in names
            and e.get("cat") != "gpu_user_annotation"}
    ours = {e["name"]: e["ts"] for e in
            TRACER.to_chrome_trace(profiling.clock_anchor(path))["traceEvents"]
            if e.get("ph") == "X" and e["name"] in names}
    assert set(prof) == set(ours) == set(names)
    for name in names:
        assert abs(ours[name] - prof[name]) < 1000.0, name


def test_ids_keep_their_form_and_ignore_the_global_random_state():
    random.seed(0)
    first = (new_trace_id(), new_span_id())
    random.seed(0)
    second = (new_trace_id(), new_span_id())
    assert first != second
    for tid, sid in (first, second):
        assert len(tid) == 32 and len(sid) == 16
        assert set(tid + sid) <= set("0123456789abcdef")
