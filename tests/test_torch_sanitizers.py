"""The port's transfer guard on the CPU: the scope logic of
``no_implicit_host_transfers`` / ``allow_host_transfers`` over a stand-in
for torch.cuda's process-global sync debug mode (nesting, allow inside a
guard, the mandatory reason, no call when disabled or on the CPU, two
threads, a failed arm), the engine's wiring of the guard and of its
declared readbacks, and every backend under ``GOLTPU_SANITIZE=1`` (dense,
packed, sparse, paged, a (2, 2) mesh) bit-identical to the unsanitized run
and to the JAX engine under its own guard. The guard's teeth need a card:
``tests/test_torch_gpu_analysis.py``.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch.analysis import sanitizers
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.parallel.mesh import make_mesh
from gameoflifewithactors_tpu import Engine as JEngine
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import mesh as j_mesh


@pytest.fixture
def mode(monkeypatch):
    """Sanitizing on, with a stand-in for the sync debug mode: a list of
    every mode set, starting from 1 ("warn") so a restore is visible."""
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "1")
    calls = [1]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: calls[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", calls.append)
    yield calls
    assert sanitizers.guard_depth() == 0


def test_scopes_nest_and_restore_the_previous_mode(mode):
    with sanitizers.no_implicit_host_transfers("cuda"):
        assert mode[-1] == 2
        with sanitizers.no_implicit_host_transfers(torch.device("cuda", 0)):
            assert mode[-1] == 2 and sanitizers.guard_depth() == 2
        assert mode[-1] == 2
    assert mode == [1, 2, 2, 2, 1]


def test_an_allow_scope_lifts_the_guard_and_gives_it_back(mode):
    with sanitizers.no_implicit_host_transfers("cuda"):
        with sanitizers.allow_host_transfers("a declared readback"):
            assert mode[-1] == 0
            with sanitizers.no_implicit_host_transfers("cuda"):
                assert mode[-1] == 0      # allow wins while it is open
        assert mode[-1] == 2
    assert mode[-1] == 1


def test_an_allow_scope_needs_a_reason(mode, monkeypatch):
    with pytest.raises(ValueError, match="reason"):
        with sanitizers.allow_host_transfers(""):
            pass
    monkeypatch.delenv(sanitizers.ENV_SANITIZE)
    with pytest.raises(ValueError, match="reason"):
        with sanitizers.allow_host_transfers(""):
            pass
    assert mode == [1]


def test_disabled_or_on_the_cpu_nothing_is_set(mode, monkeypatch):
    with sanitizers.no_implicit_host_transfers("cpu"), \
            sanitizers.no_implicit_host_transfers(None), \
            sanitizers.allow_host_transfers("no guard is open"):
        pass
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "0")
    with sanitizers.no_implicit_host_transfers("cuda"):
        with sanitizers.allow_host_transfers("not sanitizing"):
            pass
    assert mode == [1]


def test_two_threads_prefer_a_missed_sync(mode):
    """An allow scope in one thread lifts the guard another thread holds,
    for its duration; the last scope out restores the mode."""
    guarded, allowed, release = (threading.Event() for _ in range(3))
    seen = []

    def guard_thread():
        with sanitizers.no_implicit_host_transfers("cuda"):
            guarded.set()
            allowed.wait(5)
            seen.append(mode[-1])          # inside the other's allow scope
            release.set()
        seen.append("guard out")

    def allow_thread():
        guarded.wait(5)
        with sanitizers.allow_host_transfers("another thread's readback"):
            allowed.set()
            release.wait(5)
        seen.append(mode[-1])

    threads = [threading.Thread(target=f) for f in (guard_thread,
                                                    allow_thread)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen[0] == 0
    assert mode[-1] == 1 and sanitizers.guard_depth() == 0


def test_a_failed_arm_leaves_no_scope_open(monkeypatch):
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "1")

    def refuse(mode):
        raise RuntimeError("no sync debug mode here")

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    with pytest.raises(RuntimeError, match="no sync debug mode"):
        with sanitizers.no_implicit_host_transfers("cuda"):
            pass
    assert sanitizers.guard_depth() == 0 and sanitizers._saved_mode == []


def test_the_engine_wires_its_guard_and_declared_readbacks(monkeypatch):
    """Engine.step opens the guard on its device around the dispatch;
    the sparse engine's chunk read, snapshot, population and active_tiles
    declare themselves."""
    log = []
    real_guard = sanitizers.no_implicit_host_transfers
    real_allow = sanitizers.allow_host_transfers

    def guard(device=None):
        log.append(("guard", str(device)))
        return real_guard(device)

    def allow(reason):
        log.append(("allow", reason.split()[0]))
        return real_allow(reason)

    monkeypatch.setattr(sanitizers, "no_implicit_host_transfers", guard)
    monkeypatch.setattr(sanitizers, "allow_host_transfers", allow)
    grid = np.zeros((64, 64), np.uint8)
    grid[10:13, 11] = 1
    engine = Engine(grid, "B3/S23", backend="sparse", device="cpu",
                    sparse_opts={"tile_rows": 16, "tile_words": 1})
    log.clear()
    engine.step(3)
    assert log[0] == ("guard", "cpu")
    assert ("allow", "the") in log[1:]        # "the sparse step reads ..."
    log.clear()
    engine.snapshot()
    engine.population()
    engine.active_tiles()
    assert [k for k, _ in log] == ["allow"] * len(log) and len(log) >= 3


def _grid(shape=(64, 128), seed=3):
    return np.random.default_rng(seed).integers(0, 2, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("backend", ["dense", "packed", "sparse", "paged",
                                     "mesh"])
def test_every_backend_under_the_sanitizer_matches(monkeypatch, backend):
    grid = _grid()
    opts = ({"tile_rows": 16, "tile_words": 1}
            if backend in ("sparse", "paged") else None)

    def port():
        if backend == "mesh":
            return Engine(grid, "B3/S23", topology=Topology.TORUS,
                          backend="packed", device="cpu",
                          mesh=make_mesh((2, 2), ["cpu"] * 4))
        return Engine(grid, "B3/S23", topology=Topology.TORUS,
                      backend=backend, device="cpu", sparse_opts=opts)

    def reference():
        if backend == "mesh":
            return JEngine(grid, "B3/S23", topology=JTopology.TORUS,
                           backend="packed",
                           mesh=j_mesh.make_mesh((2, 2), jax.devices()[:4]))
        return JEngine(grid, "B3/S23", topology=JTopology.TORUS,
                       backend=backend, sparse_opts=opts)

    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv(sanitizers.ENV_SANITIZE, flag)
        engine = port()
        engine.step(9)
        out[flag] = (engine.snapshot(), engine.population())
    ref = reference()          # the JAX engine, under its own guard ("1")
    ref.step(9)
    np.testing.assert_array_equal(out["1"][0], out["0"][0])
    np.testing.assert_array_equal(out["1"][0], ref.snapshot())
    assert out["1"][1] == out["0"][1] == ref.population() > 0
