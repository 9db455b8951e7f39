"""``Engine(mesh=...)``, ``GridCoordinator(mesh=...)`` and ``--mesh``
against the JAX package's sharded engine on its 8 fake CPU devices, cell
for cell.

The port's band path (backend "cuda") launches the slab kernels on the
card; asked for by name on a mesh of CPU positions it runs here, the
kernel wrappers taking their plain versions (``on_card`` makes "auto"
choose as on the card), so the engine's band wiring
(runner per family, default depth, exact ``n``, per-band edge codes) is
held against JAX ``Engine(mesh=..., backend="pallas")`` in interpret
mode. ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` run it on the
card.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch import engine as t_engine
from gameoflifewithactors_torch.config import SimulationConfig
from gameoflifewithactors_torch.ops import cuda_stencil
from gameoflifewithactors_torch.parallel import mesh as t_mesh
import gameoflifewithactors_tpu as jg
from gameoflifewithactors_tpu.parallel import mesh as j_mesh

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LTL_BOX = "R2,C0,M1,S9..16,B8..12"


def _meshes(shape):
    n = shape[0] * shape[1]
    return (t_mesh.make_mesh(shape, ["cpu"] * n),
            j_mesh.make_mesh(shape, jax.devices()[:n]))


def _cells(shape, states, seed):
    return np.random.default_rng(seed).integers(0, states, size=shape,
                                                dtype=np.uint8)


@pytest.fixture
def on_card(monkeypatch):
    """The port's engine treats the CPU as a card: the kernel wrappers then
    run their plain versions on the CPU tensors."""
    monkeypatch.setattr(t_engine, "_kernels_run_on", lambda device: True)


def _same(te, je):
    np.testing.assert_array_equal(te.snapshot(), je.snapshot())
    assert te.population() == je.population()
    assert te.generation == je.generation


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_tile_engine_matches_jax(topology):
    """backend auto, packed and dense on a (2, 4) mesh, 2D tiles, for B/S,
    Generations, binary and multi-state LtL, 19 generations in two
    steps."""
    tm, jm = _meshes((2, 4))
    for rule, states, shape in [("highlife", 2, (64, 256)),
                                ("brain", 3, (64, 256)),
                                (LTL_BOX, 2, (64, 128)),
                                ("R2,C3,M1,S3..8,B5..9", 3, (64, 128))]:
        cells = _cells(shape, states, 3)
        for backend in ("auto", "packed", "dense"):
            te = tg.Engine(cells, rule, topology=tg.Topology(topology),
                           mesh=tm, backend=backend, device="cpu")
            je = jg.Engine(cells, rule, topology=jg.Topology(topology),
                           mesh=jm, backend=backend)
            assert te.backend == je.backend, (rule, backend)
            for n in (7, 12):
                te.step(n)
                je.step(n)
            _same(te, je)
            np.testing.assert_array_equal(
                te.snapshot(max_shape=(10, 20)), je.snapshot(max_shape=(10, 20)))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_band_engine_matches_jax_pallas_engine(topology):
    """backend "cuda" with a mesh is JAX's "pallas": 19 generations (two
    chunks of 8 and a remainder of 3) for B/S and Generations on (8, 1)
    and flattened (2, 4) meshes, and 7 of a radius-2 LtL box (three chunks
    of 2 and one of 1), no kernel launched on the CPU."""
    before = (cuda_stencil.SLAB_LAUNCHES, cuda_stencil.GENERATIONS_SLAB_LAUNCHES,
              cuda_stencil.LTL_SLAB_LAUNCHES)
    for rule, states, shape, mesh, g, n in [
            ("conway", 2, (64, 256), (8, 1), 8, 19),
            ("brain", 3, (64, 96), (2, 4), 8, 19),
            ("B2/S345/C5", 5, (64, 96), (4, 1), 3, 10),
            (LTL_BOX, 2, (96, 128), (4, 1), 2, 7)]:
        tm, jm = _meshes(mesh)
        cells = _cells(shape, states, 5)
        te = tg.Engine(cells, rule, topology=tg.Topology(topology), mesh=tm,
                       backend="cuda", device="cpu", gens_per_exchange=g)
        je = jg.Engine(cells, rule, topology=jg.Topology(topology), mesh=jm,
                       backend="pallas", gens_per_exchange=g)
        assert te.gens_per_exchange == je.gens_per_exchange == g
        te.step(n)
        je.step(n)
        _same(te, je)
    assert (cuda_stencil.SLAB_LAUNCHES, cuda_stencil.GENERATIONS_SLAB_LAUNCHES,
            cuda_stencil.LTL_SLAB_LAUNCHES) == before


def test_auto_picks_the_band_runner_on_the_card(on_card):
    """On the card "auto" takes the band runner wherever the slab kernel
    takes the bands, with the family's default depth (8, 16, 4); a chunk
    deeper than a band leaves it to the 2D tiles."""
    tm, _ = _meshes((4, 1))
    for rule, states, g in [("conway", 2, 8), ("brain", 3, 16),
                            ("bosco", 2, cuda_stencil.DEFAULT_LTL_GENS_PER_CALL)]:
        e = tg.Engine(_cells((128, 64), states, 7), rule, mesh=tm,
                      device="cpu")
        assert (e.backend, e.gens_per_exchange) == ("cuda", g), rule
        assert e.sharded_state.banded
    e = tg.Engine(_cells((32, 64), 3, 7), "brain", mesh=tm, device="cpu")
    assert e.backend == "packed" and not e.sharded_state.banded   # 8-row bands < 16
    e = tg.Engine(_cells((32, 64), 3, 7), "brain", mesh=tm, device="cpu",
                  gens_per_exchange=4)
    assert (e.backend, e.gens_per_exchange) == ("cuda", 4)
    assert tg.Engine(_cells((32, 64), 3, 7), "R2,C3,M1,S3..8,B5..9", mesh=tm,
                     device="cpu").backend == "packed"   # no kernel for C >= 3


def test_auto_off_the_card_picks_what_jax_picks():
    tm, jm = _meshes((2, 4))
    for rule, states in [("conway", 2), ("brain", 3), (LTL_BOX, 2),
                         ("R2,C3,M1,S3..8,B5..9", 3), ("R5,C3,M1,S3..8,B5..9", 3)]:
        cells = _cells((64, 128), states, 9)
        assert tg.Engine(cells, rule, mesh=tm, device="cpu").backend == \
            jg.Engine(cells, rule, mesh=jm).backend, rule


def test_a_chunk_deeper_than_a_band_raises_as_in_jax():
    tm, jm = _meshes((8, 1))
    cells = _cells((64, 256), 2, 11)
    je = jg.Engine(cells, "conway", mesh=jm, backend="pallas",
                   gens_per_exchange=16)
    with pytest.raises(ValueError, match="band height"):
        je.step(16)
    te = tg.Engine(cells, "conway", mesh=tm, backend="cuda", device="cpu",
                   gens_per_exchange=16)
    te.step(8)                      # one shorter chunk fits the 8-row bands
    with pytest.raises(ValueError, match="band height"):
        te.step(16)


def test_shape_errors_match_jax():
    """The JAX engine's divisibility and radius messages, before any
    step."""
    tm8, jm8 = _meshes((8, 1))
    tm24, jm24 = _meshes((2, 4))
    cases = [
        ((60, 256), "conway", tm8, jm8, "cuda", "full-width row bands"),
        ((64, 96), "conway", tm24, jm24, "packed", "not divisible over mesh"),
        ((64, 102), "conway", tm24, jm24, "dense", "not divisible over mesh"),
        ((32, 128), "bosco", tm8, jm8, "cuda", "smaller than the rule radius"),
        ((8, 256), "bosco", tm24, jm24, "packed", "smaller than the rule radius"),
    ]
    for shape, rule, tm, jm, backend, match in cases:
        cells = np.zeros(shape, np.uint8)
        with pytest.raises(ValueError, match=match):
            jg.Engine(cells, rule, mesh=jm,
                      backend="pallas" if backend == "cuda" else backend)
        with pytest.raises(ValueError, match=match):
            tg.Engine(cells, rule, mesh=tm, backend=backend, device="cpu")


def test_gens_per_exchange_and_unported_combinations():
    tm, jm = _meshes((2, 4))
    cells = np.zeros((64, 256), np.uint8)
    for rule, kwargs, err, match in [
            ("conway", dict(mesh=jm, gens_per_exchange=0), ValueError, ">= 1"),
            ("conway", dict(gens_per_exchange=4), ValueError, "applies to"),
            ("brain", dict(mesh=jm, backend="packed", gens_per_exchange=4),
             ValueError, "applies to")]:
        with pytest.raises(err, match=match):
            jg.Engine(cells, rule, **kwargs)
        kwargs = dict(kwargs, device="cpu")
        if "mesh" in kwargs:
            kwargs["mesh"] = tm
        with pytest.raises(err, match=match):
            tg.Engine(cells, rule, **kwargs)
    # mesh + "sparse" and mesh + "packed" + G > 1 are ported: they build
    # the runners JAX builds
    for kwargs in [dict(backend="sparse"),
                   dict(backend="packed", gens_per_exchange=4)]:
        te = tg.Engine(cells, "conway", mesh=tm, device="cpu", **kwargs)
        je = jg.Engine(cells, "conway", mesh=jm, **kwargs)
        assert (te.backend, te.gens_per_exchange, te._ghost_pipeline) == \
            (je.backend, je.gens_per_exchange, je._ghost_pipeline)
    # the paged backend is single-device: the JAX engine's ValueError
    with pytest.raises(ValueError) as j_err:
        jg.Engine(cells, "conway", mesh=jm, backend="paged")
    with pytest.raises(ValueError) as t_err:
        tg.Engine(cells, "conway", mesh=tm, device="cpu", backend="paged")
    assert str(t_err.value) == str(j_err.value)
    # "cuda" on CPU positions is the band runner, as JAX's "pallas" is in
    # interpret mode; a single grid needs the card
    te = tg.Engine(cells, "conway", mesh=tm, backend="cuda", device="cpu")
    je = jg.Engine(cells, "conway", mesh=jm, backend="pallas")
    assert (te.backend, te.gens_per_exchange) == ("cuda", je.gens_per_exchange)
    assert te.sharded_state.banded
    with pytest.raises(ValueError, match="CUDA device"):
        tg.Engine(cells, "conway", backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="not where mesh"):
        tg.Engine(cells, "conway", mesh=tm, device="meta")


def test_sharded_state_observation_and_injection():
    tm, jm = _meshes((4, 2))
    grid = _cells((64, 256), 2, 13)
    te = tg.Engine(grid, "conway", mesh=tm, device="cpu")
    je = jg.Engine(grid, "conway", mesh=jm)
    assert isinstance(te.sharded_state, t_mesh.ShardedGrid)
    assert len(te.sharded_state.parts) == 1 and \
        te.sharded_state.parts[0].shape == (8, 16, 4)
    np.testing.assert_array_equal(te.state.numpy().view(np.uint32),
                                  np.asarray(je.state))
    block = jg.seeds.seeded((64, 256), "glider", 30, 60)
    te.set_grid(block, generation=4)
    je.set_grid(block, generation=4)
    te.step(9)
    je.step(9)
    _same(te, je)
    assert tg.Engine(grid, "conway", device="cpu").sharded_state is None


def test_coordinator_with_a_mesh_matches_jax():
    tm, jm = _meshes((2, 4))
    for rule in ["brain", "conway"]:
        tc = tg.GridCoordinator((64, 128), rule, seed="r_pentomino", mesh=tm,
                                backend="cuda", device="cpu",
                                track_population=True, view_shape=(16, 32))
        jc = jg.GridCoordinator((64, 128), rule, seed="r_pentomino", mesh=jm,
                                backend="pallas", track_population=True,
                                view_shape=(16, 32))
        frames = []
        tc.subscribe(frames.append)
        tc.run(20, render_every=7)
        jc.run(20, render_every=7)
        assert [f.generation for f in frames] == [7, 14, 20]
        np.testing.assert_array_equal(frames[-1].grid, jc.current_frame().grid)
        np.testing.assert_array_equal(tc.snapshot(), jc.snapshot())
        assert tc.population() == jc.population() == frames[-1].population
        assert tc.engine.device == torch.device("cpu")


def test_config_builds_the_mesh():
    cpu = SimulationConfig(device="cpu")
    assert cpu.build_mesh() is None
    for text, shape in [("bands", {"x": 1, "y": 1}), ("auto", {"x": 1, "y": 1}),
                        ("1x1", {"x": 1, "y": 1})]:
        cpu.mesh = text
        assert cpu.build_mesh().shape == shape
    cpu.mesh = "2x2"
    with pytest.raises(ValueError, match="needs 4 devices"):
        cpu.build_mesh()
    cpu.mesh = "rows"
    with pytest.raises(ValueError, match="--mesh"):
        cpu.build_mesh()


def _cli(package, *argv, env=None):
    return subprocess.run([sys.executable, "-m", package, *argv], cwd=_REPO,
                          capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("rule", ["brain", "bosco"])
def test_cli_mesh_matches_jax(rule):
    """``--mesh bands`` on the CPU (one device: a (1, 1) mesh) prints what
    the JAX CLI prints with ``--mesh bands``."""
    flags = ["--rule", rule, "--grid", "48x64", "--seed", "r_pentomino",
             "--steps", "9", "--render", "final", "--population",
             "--mesh", "bands"]
    want = _cli("gameoflifewithactors_tpu", *flags,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert want.returncode == 0, want.stderr
    got = _cli("gameoflifewithactors_torch", "--device", "cpu", *flags)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert got.stdout.splitlines()[-1].startswith("gen 9 ")
