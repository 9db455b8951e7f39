"""Concurrent session steps coalesced into one lane dispatch
(``serve/service.py``'s credit list): a step posts its generations before
it waits for the service lock, and whichever pump holds the lock next
dispatches every credit posted by then.

- eight steps posted while another thread holds the lock ride one
  dispatch of eight slots; seven of them are counted as coalesced; each
  reply names the step's generation and each frame equals a session
  stepped alone (on ``"packed"`` and ``"cuda"`` lanes on the CPU, B2's
  plain version on the latter, and on the card where one is present);
- a posted step whose session a ``close`` kills first raises
  ``ValueError`` (HTTP 400); a negative step raises before posting and
  without waiting for the lock; a public ``pump()`` applies posted
  credits;
- a lane fault in a coalesced dispatch restores every coalesced session
  and re-credits its lost generations, bit for bit.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_serve_coalesce.py``.
Every thread join and HTTP request has a timeout.
"""

import contextlib
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.obs.spans import TRACER
from gameoflifewithactors_torch.serve import AdmissionController, SessionService
from gameoflifewithactors_torch.serve.frontend import SessionFrontend

SPEC = {"rule": "B3/S23", "height": 16, "width": 32, "topology": "torus"}
DEAD_SPEC = {"rule": "B36/S23", "height": 16, "width": 64, "topology": "dead"}
FILL = 0.35
TIMEOUT_S = 30.0

# (device, lane backend): the card's case skips without one
LANES = [
    ("cpu", "packed"),
    ("cpu", "cuda"),
    pytest.param("cuda", "cuda", marks=pytest.mark.gpu),
]


def _service(device="cpu", ladder=(8,)):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the lane kernel has no CPU mode)")
    reg = MetricsRegistry()
    return SessionService(ladder=ladder, registry=reg,
                          admission=AdmissionController(registry=reg),
                          sleep_fn=lambda s: None, device=device), reg


def _alone(spec, rng_seed, gens, device):
    """The frame of a session stepped alone, in a service of its own."""
    svc, _ = _service(device, ladder=(1,))
    sid = svc.create("t", spec, fill=FILL, rng_seed=rng_seed)["sid"]
    svc.step(sid, gens)
    return svc.grid(sid)


def _posted(svc):
    with svc._credits_lock:
        return len(svc._credits)


def _wait_posted(svc, k):
    deadline = time.perf_counter() + TIMEOUT_S
    while _posted(svc) < k:
        assert time.perf_counter() < deadline, f"{_posted(svc)} of {k} posted"
        time.sleep(0.001)


@contextlib.contextmanager
def _lock_held(svc, then=None):
    """Another thread holds the service lock until the block ends, then
    runs ``then()`` still holding it, and lets go."""
    held, release = threading.Event(), threading.Event()

    def hold():
        with svc._lock:
            held.set()
            release.wait(TIMEOUT_S)
            if then is not None:
                then()

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    assert held.wait(TIMEOUT_S)
    try:
        yield
    finally:
        release.set()
        holder.join(TIMEOUT_S)
        assert not holder.is_alive()


def _steps_in_threads(call, args):
    """Start one thread per argument; returns (threads, replies, errors)."""
    replies, errors = {}, {}

    def run(a):
        try:
            replies[a] = call(a)
        except Exception as exc:  # noqa: BLE001 — the test reads it
            errors[a] = exc

    threads = [threading.Thread(target=run, args=(a,), daemon=True)
               for a in args]
    for t in threads:
        t.start()
    return threads, replies, errors


def _join(threads):
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive()


@contextlib.contextmanager
def _dispatch_spans():
    got = []

    def tap(span):
        if span.name == "lane.dispatch":
            got.append(span)

    TRACER.add_listener(tap)
    try:
        yield got
    finally:
        TRACER.remove_listener(tap)


@pytest.mark.parametrize("device,backend", LANES)
def test_steps_posted_behind_the_lock_share_one_dispatch(device, backend):
    svc, reg = _service(device)
    spec = dict(SPEC, backend=backend)
    sids = [svc.create("t", spec, fill=FILL, rng_seed=i)["sid"]
            for i in range(8)]
    family = svc.store.get(sids[0]).family_key
    assert len({svc.info(sid)["lane"] for sid in sids}) == 1
    with _dispatch_spans() as dispatches:
        with _lock_held(svc):
            threads, replies, errors = _steps_in_threads(
                lambda sid: svc.step(sid, 37), sids)
            _wait_posted(svc, 8)
        _join(threads)
    assert not errors, errors
    assert [(d.attrs["slots"], d.attrs["generations"]) for d in dispatches] \
        == [(8, 37)]
    assert reg.counter("session_coalesced_steps_total").value(
        family=family) == 7
    assert sorted(r["generation"] for r in replies.values()) == [37] * 8
    assert all(r["pending_steps"] == 0 for r in replies.values())
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(svc.grid(sid),
                                      _alone(spec, i, 37, device))


def test_a_lone_step_dispatches_as_before_and_is_not_coalesced():
    svc, reg = _service()
    sids = [svc.create("t", SPEC, fill=FILL, rng_seed=i)["sid"]
            for i in range(3)]
    with _dispatch_spans() as dispatches:
        for sid in sids:
            assert svc.step(sid, 5)["generation"] == 5
    assert [d.attrs["slots"] for d in dispatches] == [1, 1, 1]
    assert reg.counter("session_coalesced_steps_total").value(
        family=svc.store.get(sids[0]).family_key) == 0


@pytest.mark.parametrize("via", ["service", "http"])
def test_a_posted_step_of_a_session_closed_before_it_applies_is_refused(via):
    svc, _ = _service()
    sid, other = (svc.create("t", SPEC, fill=FILL, rng_seed=i)["sid"]
                  for i in range(2))
    with SessionFrontend(svc, 0) as fe:
        def call(s):
            if via == "service":
                return svc.step(s, 6)
            req = urllib.request.Request(
                f"http://127.0.0.1:{fe.port}/sessions/{s}/step",
                data=json.dumps({"n": 6}).encode(), method="POST")
            try:
                with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as exc:
                return exc.code, json.loads(exc.read())

        with _lock_held(svc, then=lambda: svc.close(sid)):
            threads, replies, errors = _steps_in_threads(call, [sid, other])
            _wait_posted(svc, 2)
        _join(threads)
    if via == "service":
        assert isinstance(errors.pop(sid), ValueError)
        assert not errors and replies[other]["generation"] == 6
    else:
        assert not errors
        assert replies[sid][0] == 400 and "closed" in replies[sid][1]["error"]
        assert replies[other][0] == 200 and replies[other][1]["generation"] == 6
    assert svc.info(sid)["state"] == "closed"
    assert svc.info(sid)["pending_steps"] == 0
    assert _posted(svc) == 0


def test_a_negative_step_raises_before_posting_or_waiting_for_the_lock():
    svc, _ = _service()
    sid = svc.create("t", SPEC, fill=FILL)["sid"]
    with _lock_held(svc):
        with pytest.raises(ValueError, match="negative"):
            svc.step(sid, -1)
        assert _posted(svc) == 0
    assert svc.info(sid)["pending_steps"] == 0
    assert svc.info(sid)["generation"] == 0


def test_a_public_pump_applies_the_posted_credits():
    svc, reg = _service()
    sids = [svc.create("t", SPEC, fill=FILL, rng_seed=i)["sid"]
            for i in range(3)]
    pumped = []
    with _lock_held(svc, then=lambda: pumped.append(svc.pump())):
        threads, replies, errors = _steps_in_threads(
            lambda sid: svc.step(sid, 11), sids)
        _wait_posted(svc, 3)
    _join(threads)
    assert not errors and pumped == [1]
    assert sorted(r["generation"] for r in replies.values()) == [11] * 3
    assert reg.counter("session_coalesced_steps_total").value(
        family=svc.store.get(sids[0]).family_key) == 3


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_a_fault_in_a_coalesced_dispatch_recovers_every_session(backend):
    svc, reg = _service()
    spec = dict(DEAD_SPEC, backend=backend)
    sids = [svc.create("t", spec, fill=FILL, rng_seed=i)["sid"]
            for i in range(6)]
    for sid in sids:
        svc.step(sid, 3)          # lost at the fault: re-credited
    s0 = svc.store.get(sids[0])
    lane = svc.pools[s0.family_key].lanes[s0.lane_id]
    lane.fail_next = True
    with _dispatch_spans() as dispatches:
        with _lock_held(svc):
            threads, replies, errors = _steps_in_threads(
                lambda sid: svc.step(sid, 10), sids)
            _wait_posted(svc, 6)
        _join(threads)
    assert not errors, errors
    # the faulted dispatch of all six, then its replay with the three
    # generations lost since the snapshot re-credited
    assert [(d.attrs["slots"], d.attrs["generations"]) for d in dispatches] \
        == [(6, 10), (6, 13)]
    assert reg.counter("session_lane_recoveries_total").value(
        family=s0.family_key) == 1
    assert reg.counter("session_coalesced_steps_total").value(
        family=s0.family_key) == 5
    assert sorted(r["generation"] for r in replies.values()) == [13] * 6
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(svc.grid(sid),
                                      _alone(spec, i, 13, "cpu"))


def test_many_threads_stepping_at_once_lose_no_generation():
    """More stepping threads than cores, with the interpreter switching
    threads as often as it can: every step's generations are applied
    once, whichever pump dispatched them."""
    svc, reg = _service(ladder=(8,))
    threads_n, rounds = 24, 4
    sids = [svc.create("t", SPEC, fill=FILL, rng_seed=i)["sid"]
            for i in range(threads_n)]
    gens = {sid: [1 + (i + r) % 5 for r in range(rounds)]
            for i, sid in enumerate(sids)}
    replies = {sid: [] for sid in sids}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(sid):
            for n in gens[sid]:
                replies[sid].append(svc.step(sid, n)["generation"])

        threads, _, errors = _steps_in_threads(client, sids)
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for sid in sids:
        assert replies[sid] == list(np.cumsum(gens[sid]))
        assert svc.info(sid)["pending_steps"] == 0
    assert reg.counter("session_steps_total").value(tenant="t") == \
        sum(map(sum, gens.values()))
    for i in (0, threads_n - 1):
        np.testing.assert_array_equal(
            svc.grid(sids[i]), _alone(SPEC, i, sum(gens[sids[i]]), "cpu"))
