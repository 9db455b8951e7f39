"""``Engine(mesh=..., backend="sparse")``, ``Engine(mesh=...,
backend="packed", gens_per_exchange=G > 1)`` and
``Engine.halo_bytes_per_gen`` against the JAX package's sharded engine on
its 8 fake CPU devices: state, ``active_tiles()``, the halo-byte model
(and the port's measured figure, equal to it), ``_ghost_pipeline``,
``set_grid`` re-seeding, the coordinator's ``halo_bytes`` and the CLI's
new mesh routes."""

import jax
import numpy as np
import pytest

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch import cli as t_cli
from gameoflifewithactors_torch import engine as t_engine
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.utils import metrics as t_metrics
import gameoflifewithactors_tpu as jg
from gameoflifewithactors_tpu import cli as j_cli
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.utils import metrics as j_metrics

LTL = "R2,C0,M1,S9..16,B8..12"


def _meshes(shape):
    n = shape[0] * shape[1]
    return (t_mesh.make_mesh(shape, ["cpu"] * n),
            j_mesh.make_mesh(shape, jax.devices()[:n]))


def _blob(shape, states, seed):
    rng = np.random.default_rng(seed)
    cells = np.zeros(shape, np.uint8)
    h, w = shape
    cells[h // 2 - 10:h // 2 + 10, w // 2 - 30:w // 2 + 30] = rng.integers(
        0, states, (20, 60))
    return cells


def _pair(cells, rule, shape, topology, **kwargs):
    tm, jm = _meshes(shape)
    te = tg.Engine(cells, rule, topology=tg.Topology(topology), mesh=tm,
                   device="cpu", **kwargs)
    je = jg.Engine(cells, rule, topology=jg.Topology(topology), mesh=jm,
                   **kwargs)
    return te, je


def _same(te, je):
    np.testing.assert_array_equal(te.snapshot(), je.snapshot())
    assert te.population() == je.population()
    assert te.active_tiles() == je.active_tiles()
    assert te.generation == je.generation


def _halo_bytes_agree(te, je):
    model = je.halo_bytes_per_gen("model")
    assert te.halo_bytes_per_gen("model") == model
    assert te.halo_bytes_per_gen("measured") == model
    assert te.halo_bytes_per_gen() == model
    return model


@pytest.mark.parametrize("topology,shape", [("torus", (2, 2)),
                                            ("dead", (4, 1))])
def test_sparse_engine_matches_jax(topology, shape):
    """B/S with auto tiles on the local shard, Brian's Brain with explicit
    tiles and a capacity of 2 (its shards overflow), binary LtL: 22
    generations in two steps, then ``set_grid`` re-seeds the tile map
    and 9 more."""
    for rule, states, opts in [
            ("B3/S23", 2, None),
            ("brain", 3, {"tile_rows": 8, "tile_words": 1, "capacity": 2}),
            (LTL, 2, None)]:
        cells = _blob((64, 256), states, 3)
        te, je = _pair(cells, rule, shape, topology, backend="sparse",
                       sparse_opts=opts)
        assert te._sparse_tiles == je._sparse_tiles
        for n in (9, 13):
            te.step(n)
            je.step(n)
        _same(te, je)
        assert _halo_bytes_agree(te, je) > 0
        fresh = _blob((64, 256), states, 4)
        te.set_grid(fresh, generation=0)
        je.set_grid(fresh, generation=0)
        assert te.active_tiles() == je.active_tiles()
        te.step(9)
        je.step(9)
        _same(te, je)


@pytest.mark.parametrize("shape,grid,topology,ghost", [
    ((2, 2), (64, 256), "torus", True),
    ((2, 1), (32, 32), "dead", False)], ids=["ghost", "deep"])
def test_ghost_and_deep_engines_match_jax(shape, grid, topology, ghost):
    """G = 3: a (2, 2) mesh whose tiles hold the rings takes the ghost
    pipeline, a (2, 1) mesh of one-word tiles the deep runner (the
    function-level tests hold both runners under both topologies); 11
    generations (three chunks and a remainder of 2), then ``set_grid``."""
    cells = np.random.default_rng(5).integers(0, 2, grid, dtype=np.uint8)
    te, je = _pair(cells, "B3/S23", shape, topology, backend="packed",
                   gens_per_exchange=3)
    assert te._ghost_pipeline is je._ghost_pipeline is ghost
    te.step(11)
    je.step(11)
    _same(te, je)
    _halo_bytes_agree(te, je)
    te.set_grid(cells[::-1].copy())
    je.set_grid(cells[::-1].copy())
    te.step(6)
    je.step(6)
    _same(te, je)


def test_halo_bytes_sources(monkeypatch):
    """The model and the measured figure equal JAX's model for tile
    engines of each family and for the band path; 0 without a mesh;
    "auto" falls back to the model with a RuntimeWarning only when the
    measurement fails, where "measured" raises."""
    cells = np.random.default_rng(2).integers(0, 2, (64, 128), dtype=np.uint8)
    for rule, backend in [("B3/S23", "packed"), ("brain", "packed"),
                          ("brain", "dense"), (LTL, "packed"),
                          ("R2,C3,M1,S3..8,B5..9", "packed")]:
        te, je = _pair(cells, rule, (2, 2), "dead", backend=backend)
        _halo_bytes_agree(te, je)
    with monkeypatch.context() as patch:
        patch.setattr(t_engine, "_kernels_run_on", lambda device: True)
        te = tg.Engine(cells, "brain", mesh=_meshes((4, 1))[0],
                       backend="cuda", device="cpu")
        je = jg.Engine(cells, "brain", mesh=_meshes((4, 1))[1],
                       backend="pallas")
        _halo_bytes_agree(te, je)
    assert tg.Engine(cells, "B3/S23", device="cpu").halo_bytes_per_gen() == 0
    te, je = _pair(cells, "B3/S23", (2, 2), "torus", backend="packed")
    with pytest.raises(ValueError, match="source must be"):
        te.halo_bytes_per_gen("hlo")

    def broken():
        raise RuntimeError("no counter")
    monkeypatch.setattr(te, "_measure_halo_bytes", broken)
    with pytest.warns(RuntimeWarning, match="no counter"):
        assert te.halo_bytes_per_gen() == je.halo_bytes_per_gen("model")
    with pytest.raises(RuntimeError, match="source='model'"):
        te.halo_bytes_per_gen("measured")


def test_mesh_path_errors_match_jax():
    tm, jm = _meshes((2, 2))
    cells = np.zeros((64, 256), np.uint8)
    for rule, kwargs in [
            ("B3/S23", dict(backend="sparse",
                            sparse_opts={"tile_rows": 24})),
            ("B0/S8", dict(backend="sparse")),
            ("brain", dict(backend="sparse", grid=(64, 96))),
            ("B3/S23", dict(backend="packed", gens_per_exchange=40,
                            grid=(64, 128)))]:
        grid = np.zeros(kwargs.pop("grid", (64, 256)), np.uint8)
        with pytest.raises(ValueError) as j_err:
            jg.Engine(grid, rule, mesh=jm, **kwargs)
        with pytest.raises(ValueError) as t_err:
            tg.Engine(grid, rule, mesh=tm, device="cpu", **kwargs)
        assert str(t_err.value) == str(j_err.value), rule
    # the message names the port's "cuda" where JAX's names "pallas"
    with pytest.raises(ValueError, match="applies to the sharded packed"):
        tg.Engine(cells, "B3/S23", mesh=tm, device="cpu", backend="sparse",
                  gens_per_exchange=4)


def test_coordinator_logs_halo_bytes_like_jax():
    records = {}
    for name, pkg, metrics, extra in [
            ("port", tg, t_metrics, {"device": "cpu"}),
            ("jax", jg, j_metrics, {})]:
        sink = metrics.BufferSink()
        mesh = _meshes((2, 2))[0 if name == "port" else 1]
        coord = pkg.GridCoordinator(
            (64, 256), "B3/S23", seed="r_pentomino", mesh=mesh,
            backend="packed", gens_per_exchange=3,
            metrics=metrics.MetricsLogger(sink), **extra)
        coord.run(10, render_every=4)
        records[name] = [r.halo_bytes for r in sink.records]
    assert records["port"] == records["jax"]
    assert records["port"][0] > 0


@pytest.mark.parametrize("route", [
    ["--backend", "sparse", "--sparse-tile", "16x64", "--sparse-capacity",
     "8", "--seed", "gosper_gun", "--steps", "40"],
    ["--backend", "packed", "--gens-per-exchange", "2", "--seed",
     "r_pentomino", "--steps", "23"]], ids=["sparse", "ghost"])
def test_cli_mesh_routes_match_jax(route, tmp_path, capsys, monkeypatch):
    """``--mesh 1x1`` (one device of each package) on the sharded sparse
    and the ghost-zone routes, each CLI's ``main`` run in this process
    (``python -m`` of both is held in ``test_torch_cli.py``), JAX's seeing
    only its first fake device as its own process would: the same stdout
    and the same RLE file."""
    flags = ["--grid", "64x128", "--mesh", "1x1", "--render", "final",
             "--population", *route]
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args, **kwargs: first)
    assert j_cli.main([*flags, "--save-rle", str(tmp_path / "jax.rle")]) == 0
    want = capsys.readouterr().out
    assert t_cli.main(["--device", "cpu", *flags, "--save-rle",
                       str(tmp_path / "port.rle")]) == 0
    assert capsys.readouterr().out == want
    assert (tmp_path / "port.rle").read_bytes() == \
        (tmp_path / "jax.rle").read_bytes()
