"""Warm start on a card: a cold ``nvcc`` build into a fresh cache root is
a ``cache_miss`` and the next load a ``cache_hit``; the registry's CUDA
graphs of the plain loop step bit for bit as the eager runner does, for
every plain runner and for ``n`` that are not a multiple of the captured
chunk; a state the engine handed out keeps its values after later steps.
Each test skips without a CUDA device; every root is a temporary one.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_gpu_warmstart.py``.
"""

import os

import numpy as np
import pytest
import torch

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch.aot import cache as aot_cache
from gameoflifewithactors_torch.aot import registry as aot_registry
from gameoflifewithactors_torch.obs import compile as obs_compile
from gameoflifewithactors_torch.ops import cuda_stencil


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture
def root(tmp_path):
    """A temporary cache root for the test, the process's put back after."""
    _need_cuda()
    saved, build_dir = dict(aot_cache._state), _build.BUILD_DIR
    aot_cache.ensure_persistent_cache(str(tmp_path / "root"))
    yield str(tmp_path / "root")
    aot_cache._state.update(saved)
    _build.BUILD_DIR = build_dir


def _cells(states, shape, seed):
    return np.random.default_rng(seed).integers(0, states, size=shape,
                                                dtype=np.uint8)


@pytest.mark.gpu
def test_cold_build_is_a_miss_and_the_next_load_a_hit(root, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    before = len(obs_compile.COMPILE_LOG.events())
    built = _build.load("life_packed")
    assert built.build_seconds > 0
    assert os.path.dirname(built.path) == os.path.join(root, "cuda")
    _build._loaded.clear()   # a fresh process: the library is on disk
    again = _build.load("life_packed")
    assert again.build_seconds == 0.0 and again.path == built.path
    events = obs_compile.COMPILE_LOG.events()[before:]
    assert [(e.runner, e.kind) for e in events] == [
        ("build:life_packed", "cache_miss"), ("build:life_packed", "cache_hit")]
    assert events[0].wall_seconds >= built.build_seconds


@pytest.mark.gpu
@pytest.mark.parametrize("rule,states,backend,topology", [
    ("B3/S23", 2, "packed", "torus"),
    ("B36/S23", 2, "dense", "dead"),
    ("brain", 3, "packed", "dead"),
    ("starwars", 4, "dense", "torus"),
    ("bosco", 2, "packed", "torus"),
    ("R2,C0,M1,S6..11,B6..9", 2, "dense", "dead"),
    ("R2,C4,M1,S3..8,B5..9", 4, "packed", "torus"),
])
def test_graph_runner_matches_the_eager_runner(rule, states, backend,
                                               topology, root):
    grid = _cells(states, (256, 512), seed=states + len(rule))
    top = tg.Topology(topology)
    eager = tg.Engine(grid, rule, topology=top, backend=backend)
    aot_registry.serialize_engine(eager)
    warm = tg.Engine(grid, rule, topology=top, backend=backend)
    assert warm.aot_loaded and not eager.aot_loaded
    assert isinstance(warm._aot_run, aot_registry.GraphRunner)
    chunk = aot_registry.GRAPH_CHUNK
    for n in (1, chunk, 2 * chunk + 5, 3):
        eager.step(n)
        warm.step(n)
        assert torch.equal(warm.state, eager.state), n
    assert warm.population() == eager.population()


@pytest.mark.gpu
def test_a_handed_out_state_is_not_overwritten(root):
    grid = _cells(2, (1024, 1024), seed=9)
    aot_registry.serialize_engine(tg.Engine(grid, "B3/S23", backend="packed"))
    warm = tg.Engine(grid, "B3/S23", backend="packed")
    assert warm.aot_loaded
    warm.step(21)
    held = warm.state
    copy = held.clone()
    counters = ("KERNEL_LAUNCHES", "SLAB_LAUNCHES", "GENERATIONS_LAUNCHES",
                "LTL_LAUNCHES", "GENERATIONS_SLAB_LAUNCHES", "LTL_SLAB_LAUNCHES")
    before = [getattr(cuda_stencil, c) for c in counters]
    warm.step(40)
    warm.step(1)
    torch.cuda.synchronize()
    assert torch.equal(held, copy)
    assert not torch.equal(warm.state, held)
    # the graphs replay the plain loop: no kernel of the package launches
    assert [getattr(cuda_stencil, c) for c in counters] == before
