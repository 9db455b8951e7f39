"""The readers of the session service's spans: milliseconds a request
spent waiting for the service's lock, waiting for the card under it,
copying and encoding its frame under it, and writing its responses; none
where the program records no such span, the window no request, or the
cell is a batch cell."""

from __future__ import annotations

import pytest

from benchmark import manifest

READERS = {
    "serve.lock_wait_ms_per_request": ("serve.lock_wait",),
    "serve.frame_sync_ms_per_request": ("serve.frame_sync",),
    "serve.frame_host_ms_per_request": ("serve.frame_copy",
                                        "serve.frame_encode"),
    "serve.respond_ms_per_request": ("serve.respond",),
}
SPANS = {"serve.request": {"count": 40, "seconds": 9.0},
         "serve.lock_wait": {"count": 40, "seconds": 5.0},
         "serve.frame_sync": {"count": 20, "seconds": 0.2},
         "serve.frame_copy": {"count": 20, "seconds": 0.01},
         "serve.frame_encode": {"count": 20, "seconds": 0.03},
         "serve.respond": {"count": 40, "seconds": 0.02}}


def ctx(driver="sessions", requests=20, spans=SPANS):
    return {"driver": driver, "spans": dict(spans),
            "window": {"requests": requests, "seconds": 4.0}}


def read(name, c):
    got = manifest.read_metric(name, c)
    return None if got is None else got[0]


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_seconds_over_requests(name):
    seconds = sum(SPANS[span]["seconds"] for span in READERS[name])
    assert read(name, ctx()) == pytest.approx(1e3 * seconds / 20)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read(name):
    without = {k: v for k, v in SPANS.items() if k not in READERS[name]}
    assert read(name, ctx(spans=without)) is None
    assert read(name, ctx(requests=0)) is None
    # the batch driver's context has no requests in its window
    assert read(name, {"driver": "batch", "spans": dict(SPANS),
                       "window": {"seconds": 4.0, "ticks": 3}}) is None


def test_one_of_the_frames_host_spans_is_read_alone():
    only_copy = {k: v for k, v in SPANS.items() if k != "serve.frame_encode"}
    assert read("serve.frame_host_ms_per_request",
                ctx(spans=only_copy)) == pytest.approx(1e3 * 0.01 / 20)


def test_a_traced_sessions_run_reports_each_reader():
    from benchmark.tests.conftest import drive_cpu

    line = drive_cpu("conway-sessions-1024", seconds=1.5, trace=True,
                     trace_skip_seconds=0.05, trace_seconds=0.1)
    assert line["correct"], line["checks"]
    for name in READERS:
        assert line["metrics"][name]["value"] >= 0.0, name
        assert line["metrics"][name]["unit"] == "ms"
