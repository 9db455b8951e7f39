"""Distributed trace propagation on the port (``obs/spans.py``,
``serve/frontend.py``, ``serve/service.py``), the behaviours that
``tests/test_trace.py`` holds on the JAX package:

- a caller's ``X-Goltpu-Trace`` header threads one trace id through
  frontend -> admission -> lane dispatch -> engine step, with an unbroken
  parent chain (every span's ``parent_id`` is another span of the trace,
  or the caller's span id at the root);
- with no context bound, spans carry no ids;
- a trace binding is thread-local: concurrent requests with different
  trace ids never cross-contaminate each other's spans;
- the header's wire form is the JAX package's: each package parses what
  the other writes and refuses the same garbled values.

The service runs on the CPU (B2's plain version on its lanes); every HTTP
request has a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from gameoflifewithactors_torch.obs import spans as obs_spans
from gameoflifewithactors_torch.obs.spans import (
    TRACER,
    TraceContext,
    bind_trace,
    current_trace,
    new_span_id,
    new_trace_id,
    parse_trace_header,
    set_process_context,
)
from gameoflifewithactors_torch.serve.frontend import TRACE_HEADER, SessionFrontend
from gameoflifewithactors_tpu.obs import spans as j_spans
from gameoflifewithactors_tpu.serve.frontend import TRACE_HEADER as J_TRACE_HEADER

from .test_torch_serve import FILL, SPEC, _req, make_service

# -- unit: the context model --------------------------------------------------


def test_parse_trace_header_roundtrip_and_rejects():
    tid, sid = new_trace_id(), new_span_id()
    assert len(tid) == 32 and len(sid) == 16
    ctx = parse_trace_header(f"{tid}:{sid}")
    assert (ctx.trace_id, ctx.span_id) == (tid, sid)
    assert parse_trace_header(ctx.header()) == ctx
    root = parse_trace_header(tid)
    assert root.trace_id == tid and root.span_id is None
    for bad in ("", "xyz", tid[:-1], f"{tid}:{sid}x", f"{tid}:{sid}:extra",
                tid.upper()):
        with pytest.raises(ValueError):
            parse_trace_header(bad)
        with pytest.raises(ValueError):
            j_spans.parse_trace_header(bad)
    # the JAX package's wire form: the same header name, each package
    # reading what the other writes
    assert TRACE_HEADER == J_TRACE_HEADER
    assert obs_spans.TRACE_ENV_VAR == j_spans.TRACE_ENV_VAR
    j_ctx = j_spans.parse_trace_header(ctx.header())
    assert (j_ctx.trace_id, j_ctx.span_id) == (tid, sid)
    minted = j_spans.TraceContext(j_spans.new_trace_id(), j_spans.new_span_id())
    assert parse_trace_header(minted.header()) == TraceContext(
        minted.trace_id, minted.span_id)


def test_untraced_spans_carry_no_ids():
    assert current_trace() is None
    with obs_spans.span("t.naked"):
        pass
    s = TRACER.last_completed()
    assert s.name == "t.naked"
    assert s.trace_id is None and s.span_id is None and s.parent_id is None
    assert "trace_id" not in s.to_dict()  # byte-compatible with old tapes


def test_bind_trace_assigns_ids_and_chains_parents():
    caller = TraceContext(new_trace_id(), new_span_id())
    with bind_trace(caller.trace_id, caller.span_id) as ctx:
        assert ctx.trace_id == caller.trace_id
        with obs_spans.span("t.outer"):
            with obs_spans.span("t.inner"):
                pass
    inner = [s for s in TRACER.spans() if s.name == "t.inner"][-1]
    outer = [s for s in TRACER.spans() if s.name == "t.outer"][-1]
    assert outer.trace_id == inner.trace_id == caller.trace_id
    assert outer.parent_id == caller.span_id  # root chains to the caller
    assert inner.parent_id == outer.span_id  # unbroken chain inside
    assert current_trace() is None  # binding restored on exit


def test_bind_trace_mints_when_caller_sent_nothing():
    with bind_trace() as ctx:
        assert len(ctx.trace_id) == 32
        with obs_spans.span("t.minted"):
            pass
    s = [s for s in TRACER.spans() if s.name == "t.minted"][-1]
    assert s.trace_id == ctx.trace_id and s.parent_id is None


def test_process_context_is_the_ambient_fallback():
    ctx = TraceContext(new_trace_id(), new_span_id())
    prev = set_process_context(ctx)
    try:
        assert current_trace() == ctx
        with obs_spans.span("t.ambient"):
            pass
        s = [s for s in TRACER.spans() if s.name == "t.ambient"][-1]
        assert s.trace_id == ctx.trace_id and s.parent_id == ctx.span_id
        # an explicit binding wins over the process-ambient context
        with bind_trace() as bound:
            assert current_trace().trace_id == bound.trace_id
    finally:
        set_process_context(prev)
    assert current_trace() is None


def test_child_env_roundtrip():
    ctx = TraceContext(new_trace_id(), new_span_id())
    env = ctx.child_env()
    assert parse_trace_header(env[obs_spans.TRACE_ENV_VAR]) == ctx


# -- HTTP: the serve chain ----------------------------------------------------


def _spans_of(trace_id, want_names, timeout_s=5.0):
    """Spans of one trace, polled until every wanted name landed (the
    response is sent from inside serve.request, so its span closes just
    after the client returns)."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        got = [s for s in TRACER.spans() if s.trace_id == trace_id]
        if want_names <= {s.name for s in got}:
            return got
        time.sleep(0.01)
    raise AssertionError(
        f"trace {trace_id[:8]} never completed {want_names}; "
        f"saw {[s.name for s in got]}")


def _assert_unbroken_chain(spans, caller_span_id):
    ids = {s.span_id for s in spans}
    for s in spans:
        assert s.span_id and s.parent_id, f"{s.name} missing ids"
        assert s.parent_id in ids or s.parent_id == caller_span_id, \
            f"{s.name} parent {s.parent_id} is neither a sibling span " \
            f"nor the caller"


def test_http_trace_threads_frontend_to_engine_step(tmp_path):
    svc, _reg = make_service()
    caller = TraceContext(new_trace_id(), new_span_id())
    with SessionFrontend(svc, 0) as fe:
        data = b'{"tenant": "acme", "spec": ' + \
            json.dumps(SPEC).encode() + \
            b', "fill": 0.35, "rng_seed": 7}'
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/sessions", data=data,
            method="POST", headers={TRACE_HEADER: caller.header()})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
            assert r.headers[TRACE_HEADER] == caller.trace_id
            body = json.loads(r.read())
        assert body["trace_id"] == caller.trace_id
        sid = body["sid"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/sessions/{sid}/step",
            data=b'{"n": 3}', method="POST",
            headers={TRACE_HEADER: caller.header()})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200

    spans = _spans_of(caller.trace_id,
                      {"serve.request", "serve.admission",
                       "lane.dispatch", "engine.step"})
    _assert_unbroken_chain(spans, caller.span_id)
    # the roots (one per request) chain to the caller's span id
    roots = [s for s in spans if s.name == "serve.request"]
    assert len(roots) == 2
    assert all(s.parent_id == caller.span_id for s in roots)
    # the leaf chains through the dispatch, not straight to the root
    step = [s for s in spans if s.name == "engine.step"][-1]
    dispatch = [s for s in spans if s.name == "lane.dispatch"][-1]
    assert step.parent_id == dispatch.span_id


def test_http_mints_trace_when_header_absent(tmp_path):
    svc, _reg = make_service()
    with SessionFrontend(svc, 0) as fe:
        code, body = _req(fe.port, "POST", "/sessions",
                          {"tenant": "t", "spec": SPEC, "fill": FILL})
        assert code == 201
        assert len(body["trace_id"]) == 32  # minted server-side


def test_http_rejects_garbled_trace_header(tmp_path):
    svc, _reg = make_service()
    with SessionFrontend(svc, 0) as fe:
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/healthz",
            headers={TRACE_HEADER: "not-a-trace"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400


def test_concurrent_requests_never_cross_contaminate(tmp_path):
    svc, _reg = make_service()
    callers = [TraceContext(new_trace_id(), new_span_id())
               for _ in range(2)]
    with SessionFrontend(svc, 0) as fe:
        sids = []
        for i, c in enumerate(callers):
            code, body = _req(fe.port, "POST", "/sessions",
                              {"tenant": f"t{i}", "spec": SPEC,
                               "fill": FILL, "rng_seed": i})
            assert code == 201
            sids.append(body["sid"])

        errors = []
        barrier = threading.Barrier(len(callers))

        def hammer(caller, sid):
            try:
                barrier.wait(timeout=10)
                for _ in range(5):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{fe.port}/sessions/{sid}/step",
                        data=b'{"n": 1}', method="POST",
                        headers={TRACE_HEADER: caller.header()})
                    with urllib.request.urlopen(req, timeout=10) as r:
                        got = json.loads(r.read())
                        if got["trace_id"] != caller.trace_id:
                            errors.append(
                                f"response for {caller.trace_id[:8]} "
                                f"claimed {got['trace_id'][:8]}")
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors.append(repr(exc))

        threads = [threading.Thread(target=hammer, args=(c, s))
                   for c, s in zip(callers, sids)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors

    for caller in callers:
        spans = _spans_of(caller.trace_id,
                          {"serve.request", "lane.dispatch", "engine.step"})
        # every span of this trace chains within the trace: a single
        # foreign parent id would mean thread-local state leaked
        _assert_unbroken_chain(spans, caller.span_id)
        assert all(s.trace_id == caller.trace_id for s in spans)
