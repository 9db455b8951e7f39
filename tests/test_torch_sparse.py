"""The activity-tiled sparse engine (ops/sparse.py, ``Engine(backend=
"sparse")``) of the port against the JAX package's, on the CPU, for
life-like B/S rules: the same numpy-seeded packed words step through both
``SparseEngineState``s and must agree bit for bit (tolerance 0: integer
words), with equal ``capacity`` and ``active_tiles()`` after every step.

Cases: a glider, a gun and a soup under TORUS and DEAD, chunk depths 1 and
2-4 with remainders, adaptive escalation and a fixed capacity's dense
fallback, the period-divides-chunk oscillator, the rejections, the
Engine's ``sparse_opts`` and ``set_grid``, the coordinator's metrics, the
CLI's ``--backend sparse --sparse-tile --sparse-capacity`` output, and a
run handed over from the JAX package mid-way.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import GridCoordinator
from gameoflifewithactors_torch.engine import Engine
from gameoflifewithactors_torch.models.generations import parse_any
from gameoflifewithactors_torch.models.rules import parse_rule
from gameoflifewithactors_torch.ops import bitpack, sparse
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.parallel.mesh import make_mesh
from gameoflifewithactors_torch.utils.interop import (sparse_state_from_numpy,
                                                      state_from_numpy,
                                                      state_to_numpy)
from gameoflifewithactors_torch.utils.metrics import BufferSink, MetricsLogger
from gameoflifewithactors_tpu.engine import Engine as JEngine
from gameoflifewithactors_tpu.models import seeds as j_seeds
from gameoflifewithactors_tpu.models.generations import \
    parse_any as j_parse_any
from gameoflifewithactors_tpu.models.rules import parse_rule as j_parse_rule
from gameoflifewithactors_tpu.ops import sparse as j_sparse
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cells(shape, pattern, seed=0):
    """A numpy-seeded grid: a named pattern near the middle, or a soup
    patch in one corner region (``"soup"``)."""
    h, w = shape
    if pattern == "soup":
        grid = np.zeros(shape, np.uint8)
        rng = np.random.default_rng(seed)
        grid[:h // 3, w // 4:w // 2] = rng.random((h // 3, w // 2 - w // 4)) < 0.4
        return grid
    return j_seeds.seeded(shape, pattern, h // 2 - 5, w // 2 - 19)


def _pair(cells, rule, topology, **opts):
    """(JAX state, port state) over the same packed words."""
    words = bitpack.pack_np(cells)
    j = j_sparse.SparseEngineState(jnp.asarray(words), j_parse_rule(rule),
                                   topology=JTopology(topology), **opts)
    t = sparse.SparseEngineState(state_from_numpy(words), parse_rule(rule),
                                 topology=Topology(topology), **opts)
    return j, t


def _agree(j, t):
    np.testing.assert_array_equal(state_to_numpy(t.packed.contiguous()),
                                  np.asarray(j.packed))
    assert (t.capacity, t.active_tiles()) == (j.capacity, j.active_tiles())


@pytest.mark.parametrize("pattern,topology,chunk", [
    ("glider", "torus", 1),
    ("glider", "dead", 3),
    ("gosper_gun", "torus", 2),
    ("soup", "dead", 4),
])
def test_sparse_state_matches_jax(pattern, topology, chunk):
    """Steps of 1, a chunk's remainder and several chunks, with explicit
    tiles; a glider at 1 generation per chunk crosses the torus seams."""
    shape = (96, 256) if pattern != "glider" else (64, 128)
    j, t = _pair(_cells(shape, pattern, seed=2), "B3/S23", topology,
                 tile_rows=16, tile_words=2, chunk_gens=chunk)
    _agree(j, t)
    for n in (1, 7, 2 * chunk, 45):
        j.step(n)
        t.step(n)
        _agree(j, t)


def test_adaptive_escalation_matches_jax():
    """An R-pentomino outgrowing its seeded start: the adaptive capacity
    escalates to ``max(2·cap, need)`` (a power of 2, capped at the tile
    count) exactly as JAX's does, and a soup forced down to 32 climbs
    back the same way."""
    cells = j_seeds.seeded((128, 256), "r_pentomino", 60, 120)
    j, t = _pair(cells, "B3/S23", "dead", tile_rows=8, tile_words=1)
    caps = []
    for _ in range(5):
        j.step(40)
        t.step(40)
        _agree(j, t)
        caps.append(t.capacity)
    assert caps[0] < caps[-1]           # escalated at least once
    soup = (np.random.default_rng(4).random((256, 1024)) < 0.5).astype(np.uint8)
    j, t = _pair(soup, "B3/S23", "torus")
    j._set_capacity(32)
    t._set_capacity(32)
    for n in (5, 19):
        j.step(n)
        t.step(n)
        _agree(j, t)
    assert t.capacity == 64


def test_fixed_capacity_dense_fallback_matches_jax():
    """An explicit capacity never escalates: each overflow runs exactly one
    dense full-grid generation, exact under both topologies and with a
    chunked ring (the dense step reads the inner sub-ring)."""
    soup = (np.random.default_rng(5).random((128, 256)) < 0.45).astype(np.uint8)
    for topology, chunk in (("dead", 1), ("torus", 3)):
        j, t = _pair(soup, "B3/S23", topology, tile_rows=16, tile_words=2,
                     capacity=8, chunk_gens=chunk)
        before = t.dispatches
        t.step(1)
        j.step(1)
        _agree(j, t)
        assert t.dispatches - before == 2      # the refused chunk, one dense
        for n in (4, 11):
            j.step(n)
            t.step(n)
            _agree(j, t)
        assert t.capacity == 8


def test_period_divides_chunk_oscillator_wakes_neighbors():
    """A blinker has period 2 | chunk 4: only a change seen at ANY
    generation of the chunk keeps its tile (and its neighbours) awake."""
    cells = np.zeros((128, 128), np.uint8)
    cells[64:67, 64] = 1
    cells[70:90, 60:80] = np.random.default_rng(5).integers(0, 2, (20, 20))
    j, t = _pair(cells, "B3/S23", "dead", chunk_gens=4, tile_rows=8,
                 tile_words=1)
    for _ in range(4):
        j.step(12)
        t.step(12)
        _agree(j, t)
    assert 0 < t.active_tiles() < t.active.numel()


def test_rejections_match_jax():
    """B0 rules (sparse and paged), tiles that do not divide the grid, a
    chunk too deep for the halo word, multi-state LtL on a 2D board, and
    the mesh: sparse names the sharded runners' item, paged is refused as
    single-device."""
    words = state_from_numpy(np.zeros((64, 4), np.uint32))
    zeros = np.zeros((64, 128), np.uint8)
    with pytest.raises(ValueError, match="birth-from-nothing"):
        sparse.SparseEngineState(words, parse_rule("B03/S23"))
    for backend in ("sparse", "paged"):
        with pytest.raises(ValueError, match="birth") as got:
            Engine(zeros, "B0/S8", backend=backend, device="cpu")
        with pytest.raises(ValueError, match="birth") as want:
            JEngine(zeros, "B0/S8", backend=backend)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible"):
        sparse.SparseEngineState(words, parse_rule("B3/S23"), tile_rows=24)
    with pytest.raises(ValueError, match="chunk_gens"):
        sparse.SparseEngineState(words, parse_rule("B3/S23"), chunk_gens=33)
    with pytest.raises(ValueError, match="sparse tiles") as got:
        Engine(zeros, "B3/S23", backend="sparse", device="cpu",
               sparse_opts={"tile_rows": 48})
    with pytest.raises(ValueError, match="sparse tiles") as want:
        JEngine(zeros, "B3/S23", backend="sparse", sparse_opts={"tile_rows": 48})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="bit-plane stack"):
        sparse.SparseEngineState(words, parse_any("R2,C3,M1,S2..4,B3..4"))
    mesh = make_mesh((1, 1), devices=[torch.device("cpu")])
    # the sharded form is ported (tests/test_torch_engine_mesh_paths.py)
    assert Engine(zeros, "B3/S23", backend="sparse", device="cpu",
                  mesh=mesh).active_tiles() == 0
    with pytest.raises(ValueError, match="single-device"):
        Engine(zeros, "B3/S23", backend="paged", device="cpu", mesh=mesh)
    # "auto" never picks the activity-tiled backends
    assert Engine(zeros, "B3/S23", device="cpu").backend == "packed"


def test_engine_sparse_backend_matches_jax():
    """``Engine(backend="sparse")`` with ``sparse_opts``, its snapshot,
    population and ``active_tiles``; ``set_grid`` reseeds through the
    state, keeping the adaptive policy."""
    cells = _cells((96, 256), "gosper_gun")
    for topology in ("torus", "dead"):
        j = JEngine(cells, "B3/S23", topology=JTopology(topology),
                    backend="sparse", sparse_opts={"tile_rows": 16})
        t = Engine(cells, "B3/S23", topology=Topology(topology),
                   backend="sparse", sparse_opts={"tile_rows": 16},
                   device="cpu")
        for n in (13, 30):
            j.step(n)
            t.step(n)
            np.testing.assert_array_equal(t.snapshot(), j.snapshot())
            assert (t.population(), t.active_tiles(), t.generation) == \
                (j.population(), j.active_tiles(), j.generation)
        j.set_grid(cells, 0)
        t.set_grid(cells, 0)
        j.step(21)
        t.step(21)
        np.testing.assert_array_equal(t.snapshot(), j.snapshot())
        assert t._sparse._adaptive and t._sparse.capacity == j._sparse.capacity
    assert Engine(cells, "B3/S23", device="cpu").active_tiles() is None


def test_coordinator_metrics_carry_active_tiles():
    """Each metrics record of a sparse coordinator carries the engine's
    active tiles, as the JAX coordinator's records do."""
    from gameoflifewithactors_tpu.coordinator import \
        GridCoordinator as JGridCoordinator
    from gameoflifewithactors_tpu.utils import metrics as j_metrics

    opts = {"tile_rows": 16, "tile_words": 2}
    sink, j_sink = BufferSink(), j_metrics.BufferSink()
    coord = GridCoordinator((96, 256), "B3/S23", seed="gosper_gun",
                            backend="sparse", device="cpu", sparse_opts=opts,
                            metrics=MetricsLogger(sink))
    j_coord = JGridCoordinator((96, 256), "B3/S23", seed="gosper_gun",
                               backend="sparse", sparse_opts=opts,
                               metrics=j_metrics.MetricsLogger(j_sink))
    coord.run(30, render_every=10)
    j_coord.run(30, render_every=10)
    got = [r.active_tiles for r in sink.records]
    assert got == [r.active_tiles for r in j_sink.records]
    assert len(got) == 3 and all(n > 0 for n in got)
    assert sink.records[-1].to_dict()["active_tiles"] == got[-1]
    np.testing.assert_array_equal(coord.snapshot(), j_coord.snapshot())


def _cli(package, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", package, *argv], cwd=_REPO,
                          capture_output=True, text=True, timeout=300, env=env)


def test_cli_sparse_backend_matches_jax():
    """``--backend sparse --sparse-tile --sparse-capacity`` print the JAX
    CLI's bytes; a tile width off the word fails in both."""
    flags = ["--grid", "96x256", "--seed", "gosper_gun", "--steps", "40",
             "--backend", "sparse", "--sparse-tile", "16x64",
             "--sparse-capacity", "6", "--render", "final", "--population"]
    want = _cli("gameoflifewithactors_tpu", *flags)
    got = _cli("gameoflifewithactors_torch", "--device", "cpu", *flags)
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    bad = [("16x48" if f == "16x64" else f) for f in flags]
    for run in (_cli("gameoflifewithactors_tpu", *bad),
                _cli("gameoflifewithactors_torch", "--device", "cpu", *bad)):
        assert run.returncode != 0 and run.stdout == ""
        assert "--sparse-tile columns must be a multiple of 32" in run.stderr


@pytest.mark.parametrize("adaptive", [True, False])
def test_interop_hand_over_continues_a_jax_run(adaptive):
    """n1 generations in JAX, the padded buffer, map and policy handed to
    the port, n2 more there: equal to JAX's n1 + n2 run, capacity and
    active tiles included."""
    cells = _cells((96, 256), "soup", seed=6)
    opts = dict(tile_rows=16, tile_words=2, chunk_gens=2,
                capacity=None if adaptive else 12)
    j, _ = _pair(cells, "B3/S23", "torus", **opts)
    j.step(17)
    t = sparse_state_from_numpy(
        np.asarray(j.padded), np.asarray(j.active), parse_rule("B3/S23"),
        topology=Topology.TORUS, tile_rows=16, tile_words=2,
        capacity=j.capacity, adaptive=j._adaptive, chunk_gens=2,
        device="cpu")
    _agree(j, t)
    j.step(23)
    t.step(23)
    _agree(j, t)


def test_tiling_helpers_match_jax():
    """auto_tile, max_chunk_gens, the wake dilation and the host
    coordinate dilation: the same numbers and sets as the JAX module."""
    for h, wp in [(64, 2), (96, 8), (65536, 2048), (8192, 256), (1000, 7)]:
        assert sparse.auto_tile(h, wp) == j_sparse.auto_tile(h, wp)
    for spec in ("B3/S23", "R5,C0,M1,S34..58,B34..45", "brain"):
        t_rule, j_rule = parse_any(spec), j_parse_any(spec)
        assert sparse.max_chunk_gens(t_rule) == j_sparse.max_chunk_gens(j_rule)
        assert sparse.rule_layout(t_rule) == j_sparse.rule_layout(j_rule)
        for g in (1, 3):
            assert sparse.wake_dilation(t_rule, 16, 1, g) == \
                j_sparse.wake_dilation(j_rule, 16, 1, g)
    coords = {(0, 0), (3, 5), (7, 7)}
    for kw in ({}, {"bounds": (8, 8)}, {"bounds": (8, 8), "wrap": True}):
        assert sparse.dilate_coords(coords, 1, 2, **kw) == \
            j_sparse.dilate_coords(coords, 1, 2, **kw)
    act = np.random.default_rng(1).random((6, 9)) < 0.2
    for wrap in (False, True):
        got = sparse._dilate(torch.from_numpy(act), wrap, 2, 1).numpy()
        want = np.asarray(j_sparse._dilate(jnp.asarray(act), wrap, 2, 1))
        np.testing.assert_array_equal(got, want)
