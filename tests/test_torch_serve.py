"""The session service (serve/) of the port against the JAX package's, and
its behaviour on the ladder, on the CPU.

- The same request sequence (creates, steps with mixed cursors, closes
  that compact) through the JAX service on ``"packed"`` lanes and the
  port's on ``"packed"`` and ``"cuda"`` lanes (kernel B2's plain version
  here) gives equal grids, generations, placements and relocations.
- Admission against a faked full card, lane crash recovery, eviction,
  checkpoints that load across the two packages, the HTTP surface, and
  the ``serve`` entry point in a subprocess.
- The JAX ``"pallas"`` lane's step of ``n·g`` generations, pinned.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from gameoflifewithactors_torch.obs.device import (DeviceSampler,
                                                   host_memory_backend)
from gameoflifewithactors_torch.obs.exporter import render_prometheus
from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.resilience import RestartPolicy
from gameoflifewithactors_torch.serve import (AdmissionController,
                                              AdmissionRejected,
                                              SessionService, SpecFamily,
                                              decode_words)
from gameoflifewithactors_torch.serve import lanes as t_lanes
from gameoflifewithactors_torch.serve.frontend import SessionFrontend
from gameoflifewithactors_tpu.models.generations import parse_any
from gameoflifewithactors_tpu.models.rules import CONWAY as J_CONWAY
from gameoflifewithactors_tpu.obs.registry import \
    MetricsRegistry as JMetricsRegistry
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.packed import multi_step_packed
from gameoflifewithactors_tpu.ops.stencil import Topology
from gameoflifewithactors_tpu.serve import \
    AdmissionController as JAdmissionController
from gameoflifewithactors_tpu.serve import SessionService as JSessionService
from gameoflifewithactors_tpu.serve import lanes as j_lanes

from .oracle import numpy_run

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {"rule": "B3/S23", "height": 16, "width": 32, "topology": "torus"}
DEAD_SPEC = {"rule": "B36/S23", "height": 16, "width": 64, "topology": "dead"}
FILL = 0.35


def expected_grid(spec, rng_seed, gens, fill=FILL):
    """A dedicated run of the session's seed by the NumPy oracle."""
    seed = (np.random.default_rng(rng_seed).random(
        (spec["height"], spec["width"])) < fill).astype(np.uint8)
    return numpy_run(seed, parse_any(spec["rule"]),
                     Topology(spec.get("topology", "torus")), gens)


def make_service(ladder=(1, 2, 4), *, admission_kw=None, **kw):
    reg = MetricsRegistry()
    adm = AdmissionController(registry=reg, **(admission_kw or {}))
    return SessionService(ladder=ladder, registry=reg, admission=adm,
                          sleep_fn=lambda s: None, device="cpu", **kw), reg


def make_jax_service(ladder=(1, 2, 4), **kw):
    reg = JMetricsRegistry()
    return JSessionService(ladder=ladder, registry=reg,
                           admission=JAdmissionController(registry=reg),
                           sleep_fn=lambda s: None, **kw)


def fake_card(bytes_in_use, bytes_limit):
    return [{"device": "0", "platform": "gpu", "bytes_in_use": bytes_in_use,
             "peak_bytes_in_use": bytes_in_use, "bytes_limit": bytes_limit}]


def _placement(info):
    """(lane number, slot): lane ids name the family, whose backend differs."""
    lane = info["lane"]
    return None if lane is None else (lane.rsplit("#", 1)[1], info["slot"])


# -- against the JAX service ---------------------------------------------------


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_service_matches_the_jax_service(backend):
    """Creates that grow the ladder 1 -> 2 -> 4 -> 4+1 on two families,
    steps on mixed cursors (n not a multiple of g = 8), closes that
    compact, then more steps: every observable agrees."""
    port, _ = make_service()
    ref = make_jax_service()
    specs = [SPEC, DEAD_SPEC]
    pairs = []
    for i in range(7):
        spec = specs[i % 2] if i < 6 else SPEC
        a = port.create("t", dict(spec, backend=backend), fill=FILL, rng_seed=i)
        b = ref.create("t", dict(spec, backend="packed"), fill=FILL, rng_seed=i)
        assert _placement(a) == _placement(b)
        pairs.append((a["sid"], b["sid"]))

    def agree():
        for sa, sb in pairs:
            a, b = port.info(sa), ref.info(sb)
            assert (a["state"], a["generation"], a["pending_steps"]) == \
                (b["state"], b["generation"], b["pending_steps"])
            assert _placement(a) == _placement(b), (a, b)
            if a["state"] not in ("closed", "evicted"):
                np.testing.assert_array_equal(port.grid(sa), ref.grid(sb))

    for k, (sa, sb) in enumerate(pairs):
        port.step(sa, 3 + 5 * (k % 3), pump=False)
        ref.step(sb, 3 + 5 * (k % 3), pump=False)
    assert port.pump() == ref.pump()
    agree()
    for k in (0, 3, 4):
        port.close(pairs[k][0])
        ref.close(pairs[k][1])
    agree()
    for k, (sa, sb) in enumerate(pairs):
        if k not in (0, 3, 4):
            port.step(sa, 9 + k)
            ref.step(sb, 9 + k)
    agree()
    assert [ln["capacity"] for ln in port.lane_stats()] == \
        [ln["capacity"] for ln in ref.lane_stats()]
    np.testing.assert_array_equal(port.grid(pairs[6][0]),
                                  expected_grid(SPEC, 6, 3 + 5 * 0 + 9 + 6))


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_sequential_steps_issue_the_jax_service_dispatches(backend):
    """Rounds of ``step(..., pump=False)`` then ``pump()``, and lone
    ``step`` calls, on five sessions over lanes of 4 and 1: the port's
    credit list changes no dispatch count a lone caller issues."""
    from gameoflifewithactors_torch.obs.spans import TRACER
    from gameoflifewithactors_tpu.obs.spans import TRACER as J_TRACER

    port, _ = make_service()
    ref = make_jax_service()
    pairs = [(port.create("t", dict(SPEC, backend=backend), fill=FILL,
                          rng_seed=i)["sid"],
              ref.create("t", dict(SPEC, backend="packed"), fill=FILL,
                         rng_seed=i)["sid"]) for i in range(5)]
    counts = {"port": 0, "ref": 0}

    def tap(side):
        def count(span):
            if span.name == "lane.dispatch":
                counts[side] += 1
        return count

    taps = (tap("port"), tap("ref"))
    TRACER.add_listener(taps[0])
    J_TRACER.add_listener(taps[1])
    try:
        for r in range(3):
            for k, (sa, sb) in enumerate(pairs):
                if (k + r) % 4:
                    port.step(sa, 2 + (k * r) % 5, pump=False)
                    ref.step(sb, 2 + (k * r) % 5, pump=False)
            assert port.pump() == ref.pump()
            sa, sb = pairs[r]
            assert port.step(sa, 3 + r)["generation"] == \
                ref.step(sb, 3 + r)["generation"]
            assert port.pump() == ref.pump() == 0
            assert counts["port"] == counts["ref"]
    finally:
        TRACER.remove_listener(taps[0])
        J_TRACER.remove_listener(taps[1])
    assert counts["port"] > 0
    for sa, sb in pairs:
        assert port.info(sa)["generation"] == ref.info(sb)["generation"]
        np.testing.assert_array_equal(port.grid(sa), ref.grid(sb))


def test_cuda_lane_steps_n_where_the_jax_pallas_lane_steps_n_times_g():
    """Pins today's behaviour of the JAX package: its "pallas" lane runs
    ``n`` chunks of ``gens_per_exchange`` = 8 generations for
    ``Lane.step(n)`` (batched.py make_multi_step_pallas_batched counts
    chunks; lanes.py passes n), so step(3) advances 24 generations while
    the service records 3. The port's "cuda" lane advances exactly 3."""
    spec = {"rule": "B3/S23", "height": 32, "width": 64, "topology": "torus"}
    cells = (np.random.default_rng(3).random((32, 64)) < 0.4).astype(np.uint8)
    words = j_bitpack.pack_np(cells)
    j_lane = j_lanes.Lane("j", j_lanes.SpecFamily.from_spec(
        dict(spec, backend="pallas")), 1)
    j_lane.place("s", words)
    j_lane.step(3, np.ones(1, np.uint32))
    t_lane = t_lanes.Lane("t", t_lanes.SpecFamily.from_spec(
        dict(spec, backend="cuda"), "cpu"), 1, "cpu")
    t_lane.place("s", words)
    t_lane.step(3, np.ones(1, np.uint32))

    def packed(n):
        return np.asarray(multi_step_packed(jnp.asarray(words), n,
                                            rule=J_CONWAY))

    np.testing.assert_array_equal(j_lane.read(0), packed(24))
    np.testing.assert_array_equal(t_lane.read(0), packed(3))


def test_lane_specs_the_port_refuses_or_resolves():
    with pytest.raises(ValueError, match="'cuda'"):
        SpecFamily.from_spec(dict(SPEC, backend="pallas"), "cpu")
    with pytest.raises(ValueError, match="binary life-like"):
        SpecFamily("brain", 16, 32)
    with pytest.raises(ValueError, match="mesh"):
        SpecFamily.from_spec(dict(SPEC, mesh="auto"), "cpu")
    with pytest.raises(ValueError, match="at least 8 rows"):
        SpecFamily("B3/S23", 4, 32, backend="cuda")    # g > H
    # "auto" is "packed" on the CPU; on the card B2 unless g > H
    assert SpecFamily.from_spec(dict(SPEC, backend="auto"),
                                "cpu").backend == "packed"
    assert SpecFamily.from_spec({"rule": "B3/S23", "shape": [16, 32]},
                                "cpu").slot_bytes() == 2 * 16 * 1 * 4
    assert not t_lanes.kernel_takes(4, 1) and t_lanes.kernel_takes(8, 1)
    # paged lanes are ported (tests/test_torch_paged_serve.py): "auto"
    # pages where the shape divides the tiles, as the JAX "auto" does
    paged = SessionService(paged=True, device="cpu")
    assert paged._family(dict(SPEC, backend="auto")).backend == "packed"


def test_lane_classes_default_to_the_card(monkeypatch):
    """``SpecFamily.from_spec``, ``Lane`` and ``LanePool`` resolve their
    device as every entry point does: the card unless the caller names
    the CPU, and a RuntimeError where there is no card (an "auto" spec
    never falls back to "packed" on the CPU unasked)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    family = SpecFamily.from_spec(dict(SPEC, backend="packed"), "cpu")
    for make in (lambda: SpecFamily.from_spec(dict(SPEC, backend="auto")),
                 lambda: t_lanes.Lane("t", family, 1),
                 lambda: t_lanes.LanePool(family)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- behaviour on the ladder ---------------------------------------------------


def test_admission_rejects_then_queues_and_drains_on_a_faked_full_card():
    svc, reg = make_service(admission_kw={"queue_limit": 1})
    state = {"in_use": 2 ** 30 - 10}
    sampler = DeviceSampler(registry=reg, backend=lambda: fake_card(
        state["in_use"], 2 ** 30))
    sampler.sample_once()
    info = svc.create("t", SPEC, fill=FILL, rng_seed=3)
    assert info["state"] == "pending" and svc.admission.queue_depth() == 1
    with pytest.raises(AdmissionRejected, match="over HBM budget"):
        svc.create("t", SPEC, fill=FILL)
    svc.step(info["sid"], 4)           # debt accrues while parked
    assert svc.info(info["sid"])["state"] == "pending"
    state["in_use"] = 0
    sampler.sample_once()
    svc.pump()                         # drains the queue into the budget
    svc.pump()                         # applies the parked debt
    got = svc.info(info["sid"])
    assert got["state"] == "running" and got["generation"] == 4
    np.testing.assert_array_equal(svc.grid(info["sid"]),
                                  expected_grid(SPEC, 3, 4))
    text = render_prometheus(reg.snapshot())
    assert ('goltpu_session_admission_total{decision="reject",tenant="t"} 1'
            in text)
    assert "goltpu_session_queue_depth 0" in text
    # the CPU stand-in publishes no limit: admission stays permissive
    assert "bytes_limit" not in host_memory_backend()[0]
    fresh, reg2 = make_service()
    DeviceSampler(registry=reg2, backend=host_memory_backend).sample_once()
    assert fresh.create("t", SPEC, fill=FILL)["state"] == "packed"


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_lane_crash_recovery_bit_identical(backend):
    svc, reg = make_service(ladder=(4,))
    spec = dict(DEAD_SPEC, backend=backend)
    sids = [svc.create("t", spec, fill=FILL, rng_seed=i)["sid"]
            for i in range(3)]
    for sid in sids:
        svc.step(sid, 3)
    s0 = svc.store.get(sids[0])
    svc.pools[s0.family_key].lanes[s0.lane_id].fail_next = True
    svc.step(sids[0], 10)   # the pump hits the fault, recovers, replays
    for i, (sid, gens) in enumerate(zip(sids, (13, 3, 3))):
        assert svc.info(sid)["generation"] == gens
        np.testing.assert_array_equal(svc.grid(sid),
                                      expected_grid(DEAD_SPEC, i, gens))
    assert reg.counter("session_lane_recoveries_total").value(
        family=s0.family_key) == 1


def test_lane_circuit_open_evicts_not_wedges():
    svc, reg = make_service(ladder=(2,), policy=RestartPolicy(
        max_restarts=2, backoff_initial_seconds=0.0))
    sid = svc.create("t", SPEC, fill=FILL)["sid"]
    s = svc.store.get(sid)
    lane = svc.pools[s.family_key].lanes[s.lane_id]

    def always_fails(n, mask):
        raise RuntimeError("life_slab kernel launch failed")

    lane.step = always_fails
    svc.step(sid, 1)   # restarts burn the budget, then the circuit opens
    assert svc.info(sid)["state"] == "evicted"
    assert reg.counter("session_evictions_total").value(
        family=s.family_key) == 1
    sid2 = svc.create("t", SPEC, fill=FILL, rng_seed=9)["sid"]
    svc.step(sid2, 2)
    np.testing.assert_array_equal(svc.grid(sid2), expected_grid(SPEC, 9, 2))
    with pytest.raises(ValueError, match="evicted"):
        svc.step(sid, 1)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_loads_in_the_other_package(tmp_path, direction):
    """Live sessions on mixed cursors plus one parked with debt: the
    other package resumes the same generations, debts and grids."""
    ck = str(tmp_path / "sessions.npz")
    make_src = make_jax_service if direction == "jax_to_torch" else \
        (lambda **kw: make_service(**kw)[0])
    make_dst = (lambda **kw: make_service(**kw)[0]) \
        if direction == "jax_to_torch" else make_jax_service
    src = make_src(checkpoint_path=ck)
    sids = [src.create("t", [SPEC, DEAD_SPEC][i % 2], fill=FILL,
                       rng_seed=i)["sid"] for i in range(3)]
    for i, sid in enumerate(sids):
        src.step(sid, 2 + 3 * i)
    src.step(sids[1], 5, pump=False)   # debt outstanding at the cut
    src.checkpoint()
    dst = make_dst(checkpoint_path=ck)
    assert dst.resume() == 3
    for i, sid in enumerate(sids):
        a, b = src.info(sid), dst.info(sid)
        assert (a["generation"], a["pending_steps"], a["state"]) == \
            (b["generation"], b["pending_steps"], b["state"])
        np.testing.assert_array_equal(dst.grid(sid), src.grid(sid))
    dst.pump()
    np.testing.assert_array_equal(dst.grid(sids[1]),
                                  expected_grid(DEAD_SPEC, 1, 10))


def _req(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read()
            if r.headers.get("Content-Type", "").startswith("application/json"):
                return r.status, json.loads(raw)
            return r.status, raw.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _roundtrip(port, spec, rng_seed, n):
    """create, step, grid, healthz, metrics, delete over HTTP; returns
    the grid's cells."""
    code, info = _req(port, "POST", "/sessions", {
        "tenant": "acme", "spec": spec, "fill": FILL, "rng_seed": rng_seed})
    assert code == 201 and info["state"] == "packed", info
    sid = info["sid"]
    code, info = _req(port, "POST", f"/sessions/{sid}/step", {"n": n})
    assert code == 200 and info["generation"] == n
    code, g = _req(port, "GET", f"/sessions/{sid}/grid")
    assert code == 200 and g["encoding"] == "packed_le_u32_hex"
    cells = j_bitpack.unpack_np(decode_words(g["cells_hex"], g["height"],
                                             g["width"] // 32))
    code, h = _req(port, "GET", "/healthz")
    assert code == 200 and h["ok"] and h["sessions"]["live"] == 1
    code, text = _req(port, "GET", "/metrics")
    assert code == 200 and f'goltpu_session_steps_total{{tenant="acme"}} {n}' in text
    assert _req(port, "GET", "/sessions/ghost")[0] == 404
    assert _req(port, "POST", "/sessions", {"spec": dict(spec, rule="brain")})[0] == 400
    code, info = _req(port, "DELETE", f"/sessions/{sid}")
    assert code == 200 and info["state"] == "closed"
    return cells


def test_frontend_http_roundtrip_and_429():
    svc, _ = make_service()
    with SessionFrontend(svc, 0) as fe:
        cells = _roundtrip(fe.port, dict(SPEC, backend="cuda"), 7, 11)
    np.testing.assert_array_equal(cells, expected_grid(SPEC, 7, 11))
    svc, reg = make_service(admission_kw={"queue_limit": 0})
    DeviceSampler(registry=reg, backend=lambda: fake_card(
        2 ** 30, 2 ** 30)).sample_once()
    with SessionFrontend(svc, 0) as fe:
        code, err = _req(fe.port, "POST", "/sessions",
                         {"spec": SPEC, "fill": FILL})
        assert code == 429 and "HBM" in err["error"]


def test_serve_entry_point_on_the_cpu(tmp_path):
    """``python -m gameoflifewithactors_torch serve --device cpu``:
    announce, serve, and exit 0 on SIGTERM with a final checkpoint."""
    ck = str(tmp_path / "s.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", "serve",
         "--device", "cpu", "--port", "0", "--checkpoint", ck,
         "--flight-dump", str(tmp_path / "flight.jsonl")],
        cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_PORT "), line + proc.stderr.read()
        cells = _roundtrip(int(line.split()[1]), DEAD_SPEC, 4, 9)
        np.testing.assert_array_equal(cells, expected_grid(DEAD_SPEC, 4, 9))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert os.path.exists(ck)
    # --manifest is read now (no longer refused): a missing file fails
    # before the port opens, naming the file, as the JAX server does
    missing = str(tmp_path / "m.json")
    out = subprocess.run([sys.executable, "-m", "gameoflifewithactors_torch",
                          "serve", "--device", "cpu", "--manifest", missing],
                         cwd=_REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "SERVE_PORT" not in out.stdout
    assert "FileNotFoundError" in out.stderr and missing in out.stderr
