"""Warm start, layer 2: the port's runner registry on the CPU, against the
JAX engine. A record written from one port engine serves the next engine
of the same spec (``aot_loaded``, one ``aot_loaded`` event, the plain
runner on the CPU), which steps bit for bit as the JAX engine does from
the same numpy grid; corrupt records and records of another environment
warn and keep the normal runner; sharded, sparse, paged and ``cuda``
engines are out of scope (the JAX registry's scope); ``GOLTPU_AOT=0``
opts out; ``GOLTPU_SANITIZE=1`` arms the retrace sentinel. Every record
goes to a temporary cache root, never the suite's."""

import json
import os

import numpy as np
import pytest
import torch

import gameoflifewithactors_torch as tg
import gameoflifewithactors_tpu as jg
from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch import engine as engine_mod
from gameoflifewithactors_torch.analysis import sanitizers
from gameoflifewithactors_torch.aot import EngineSpec, cache as aot_cache
from gameoflifewithactors_torch.aot import registry as aot_registry
from gameoflifewithactors_torch.obs import compile as obs_compile
from gameoflifewithactors_torch.ops.packed import multi_step_packed
from gameoflifewithactors_torch.parallel.mesh import make_mesh

LTL_BOX = "R2,C0,M1,S6..11,B6..9"


@pytest.fixture
def root(tmp_path):
    """A temporary cache root for the test, the process's put back after."""
    saved, build_dir = dict(aot_cache._state), _build.BUILD_DIR
    aot_cache.ensure_persistent_cache(str(tmp_path / "root"))
    yield str(tmp_path / "root")
    aot_cache._state.update(saved)
    _build.BUILD_DIR = build_dir


def _cells(states, shape, seed):
    return np.random.default_rng(seed).integers(0, states, size=shape,
                                                dtype=np.uint8)


def _aot_events():
    return [e for e in obs_compile.COMPILE_LOG.events() if e.kind == "aot_loaded"]


@pytest.mark.parametrize("topology", ["torus", "dead"])
@pytest.mark.parametrize("rule,states,backend,runner", [
    ("B3/S23", 2, "auto", "multi_step_packed"),              # packed words
    ("brain", 3, "auto", "multi_step_packed_generations"),   # plane stack
    (LTL_BOX, 2, "auto", "multi_step_ltl"),                  # LtL bytes
    (LTL_BOX, 2, "packed", "multi_step_ltl_packed"),         # bit-sliced
])
def test_registry_round_trip_matches_jax(rule, states, backend, runner,
                                         topology, root):
    grid = _cells(states, (40, 64), seed=states + len(rule))
    top = tg.Topology(topology)
    cold = tg.Engine(grid, rule, topology=top, backend=backend, device="cpu")
    assert not cold.aot_loaded   # nothing registered yet
    blob = aot_registry.serialize_engine(cold)
    with open(blob[:-len(".torchaot")] + ".json") as f:
        meta = json.load(f)
    assert meta["runner"] == runner and meta["kernels"] == []
    assert meta["state_shape"] == list(cold.state.shape)
    n_events = len(_aot_events())
    warm = tg.Engine(grid, rule, topology=top, backend=backend, device="cpu")
    assert warm.aot_loaded and warm._aot_run.aot_key in blob
    assert len(_aot_events()) == n_events + 1
    je = jg.Engine(grid, rule, topology=jg.Topology(topology))
    for n in (1, 6):
        warm.step(n)
        je.step(n)
        np.testing.assert_array_equal(warm.snapshot(), je.snapshot())
    assert warm.population() == je.population()
    # a registry load is never compile time
    assert not any(e.cache_miss for e in _aot_events())


def test_load_runner_for_a_spec_resolves_auto(root):
    grid = _cells(2, (32, 64), seed=3)
    engine = tg.Engine(grid, "B36/S23", device="cpu")
    aot_registry.serialize_engine(engine)
    run = aot_registry.load_runner(EngineSpec(32, 64, rule="highlife"),
                                   device="cpu")
    state = tg.pack(torch.from_numpy(grid))
    want = multi_step_packed(state, 9, rule=tg.parse_rule("B36/S23"))
    assert torch.equal(run(state, 9), want)
    assert aot_registry.load_runner(EngineSpec(32, 96), device="cpu") is None


def test_corrupt_record_warns_and_keeps_the_plain_runner(root):
    engine = tg.Engine(_cells(2, (32, 64), 1), "B3/S23", device="cpu")
    blob = aot_registry.serialize_engine(engine)
    with open(blob, "w") as f:
        f.write("not a record")
    with pytest.warns(RuntimeWarning, match="failed to load"):
        assert aot_registry.load_runner(engine) is None
    with pytest.warns(RuntimeWarning, match="failed to load"):
        fresh = tg.Engine(_cells(2, (32, 64), 1), "B3/S23", device="cpu")
    assert not fresh.aot_loaded
    # a record of another format version
    aot_registry.serialize_engine(engine)
    meta_path = blob[:-len(".torchaot")] + ".json"
    for path in (blob, meta_path):
        with open(path) as f:
            meta = json.load(f)
        meta["format_version"] = 99
        with open(path, "w") as f:
            json.dump(meta, f)
    with pytest.warns(RuntimeWarning, match="registry format 99"):
        assert aot_registry.load_runner(engine) is None


def test_record_of_another_environment_warns(root):
    spec = EngineSpec(32, 64, rule="B3/S23", backend="packed")
    aot_registry.serialize_engine(spec.build_engine(device="cpu"))
    reg = aot_cache.aot_registry_dir()
    (meta_name,) = [n for n in os.listdir(reg) if n.endswith(".json")]
    with open(os.path.join(reg, meta_name)) as f:
        meta = json.load(f)
    meta["env"]["torch"] = "0.0.0-elsewhere"
    with open(os.path.join(reg, "f" * 24 + ".json"), "w") as f:
        json.dump(meta, f)
    for n in (meta_name, meta_name.replace(".json", ".torchaot")):
        os.remove(os.path.join(reg, n))
    with pytest.warns(RuntimeWarning, match="different environment"):
        assert aot_registry.load_runner(spec, device="cpu") is None
    # the JAX registry beside it never reads the port's records
    from gameoflifewithactors_tpu.aot import cache as jax_cache
    from gameoflifewithactors_tpu.aot import registry as jax_registry

    jspec = jg.aot.EngineSpec(32, 64, rule="B3/S23", backend="packed")
    assert jax_registry._mismatch_candidates(
        jspec, jax_cache.aot_registry_dir(root)) == []


def test_out_of_scope_engines_raise_and_skip(root, monkeypatch):
    grid = _cells(2, (32, 64), 2)
    engines = {
        "sharded": tg.Engine(grid, "B3/S23", mesh=make_mesh((2, 1), ["cpu"] * 2),
                             backend="packed", device="cpu"),
        "sparse": tg.Engine(grid, "B3/S23", backend="sparse", device="cpu",
                            sparse_opts={"tile_rows": 16, "tile_words": 1}),
        "paged": tg.Engine(grid, "B3/S23", backend="paged", device="cpu",
                           sparse_opts={"tile_rows": 16, "tile_words": 1}),
    }
    # the cuda backend on the CPU: its checks pass as on a card
    monkeypatch.setattr(engine_mod, "_kernels_run_on", lambda device: True)
    engines["kernel build cache"] = tg.Engine(grid, "B3/S23", backend="cuda",
                                              device="cpu")
    for match, engine in engines.items():
        with pytest.raises(aot_registry.AotUnsupported, match=match):
            aot_registry._exportable_runner(engine)
        with pytest.raises(aot_registry.AotUnsupported):
            aot_registry.serialize_engine(engine)
        assert aot_registry.maybe_load_for_engine(engine) is None
        assert not engine.aot_loaded


def test_goltpu_aot_0_keeps_the_plain_runner(root, monkeypatch):
    grid = _cells(3, (24, 64), 4)
    aot_registry.serialize_engine(tg.Engine(grid, "brain", device="cpu"))
    monkeypatch.setenv(aot_registry.ENV_AOT, "0")
    assert not aot_registry.aot_enabled()
    assert not tg.Engine(grid, "brain", device="cpu").aot_loaded
    monkeypatch.setenv(aot_registry.ENV_AOT, "1")
    assert tg.Engine(grid, "brain", device="cpu").aot_loaded


def test_sanitize_arms_the_retrace_sentinel_on_a_warm_engine(root, monkeypatch):
    grid = _cells(2, (24, 64), 5)
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "1")
    assert sanitizers.enabled()
    cold = tg.Engine(grid, "B3/S23", device="cpu")
    assert cold._retrace_sentinel is None   # cold engines may build
    aot_registry.serialize_engine(cold)
    warm = tg.Engine(grid, "B3/S23", device="cpu")
    assert warm.aot_loaded and warm._retrace_sentinel is not None
    warm.step(3)   # no build: the budget holds
    obs_compile.record_build("build:life_packed", "life_packed-x.so",
                             0.0, 0.5, miss=True)
    with pytest.raises(sanitizers.RetraceError, match="warm-started engine"):
        warm.step(1)
    warm._retrace_sentinel.disarm()
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "0")
    assert tg.Engine(grid, "B3/S23", device="cpu")._retrace_sentinel is None
