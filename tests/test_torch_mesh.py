"""The port's single-controller mesh, sharded placement and halo exchange
against the JAX package on its 8 fake CPU devices (tests/conftest.py).

The port's mesh here is eight CPU positions (one device repeated), so a
position's halo comes from its neighbour's block on the same device: the
code path a one-card machine runs, and, with ``.to(device)`` moving the
strips, the one a multi-GPU node runs. Integers throughout: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_torch.parallel import halo as t_halo
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.parallel import halo as j_halo
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel._compat import shard_map

SHAPES = [(8, 1), (4, 1), (2, 4), (4, 2)]


def _jmesh(shape):
    return j_mesh.make_mesh(shape, jax.devices()[:shape[0] * shape[1]])


def _tmesh(shape):
    return t_mesh.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def test_pure_arithmetic_matches_jax():
    for n in range(1, 17):
        assert t_mesh.factor2d(n) == j_mesh.factor2d(n)
        for rows, words in [(64, 8), (96, 12), (4096, 128)]:
            for k in (0, 1, 8, 40):
                assert t_mesh.best_mesh_shape(
                    n, rows, words, gens_per_exchange=k) == \
                    j_mesh.best_mesh_shape(n, rows, words, gens_per_exchange=k)
    for k in (0, 1, 31, 32, 33, 64):
        assert t_mesh.ghost_halo_words(k) == j_mesh.ghost_halo_words(k)
        assert t_mesh.ghost_fits(16, 2, k) == j_mesh.ghost_fits(16, 2, k)


def test_mesh_shape_and_band_axis_match_jax():
    for shape in SHAPES + [(1, 8)]:
        tm, jm = _tmesh(shape), _jmesh(shape)
        assert tm.shape == dict(jm.shape)
        assert t_mesh.band_axis(tm) == j_mesh.band_axis(jm)
        assert tm.groups == ((torch.device("cpu"), tuple(range(tm.size))),)


def test_make_mesh_devices_and_errors(monkeypatch):
    m = t_mesh.make_mesh((2, 2), ["cpu", torch.device("cpu")] * 2)
    assert m.devices.shape == (2, 2) and len(m.groups) == 1
    assert t_mesh.make_mesh(devices=["cpu"] * 8).shape == {"x": 2, "y": 4}
    with pytest.raises(ValueError, match="needs 9 devices"):
        t_mesh.make_mesh((3, 3), ["cpu"] * 8)
    with pytest.raises(ValueError, match="CUDA devices or CPU devices"):
        t_mesh.Mesh([["cpu", "meta"]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_mesh.make_mesh((1, 1))


@pytest.mark.parametrize("banded", [False, True])
def test_placement_matches_jax_shards(banded):
    """Every position holds the block JAX's sharding puts on the device at
    that mesh position: words, a plane stack and bytes."""
    for shape in [(2, 4), (4, 2)]:
        tm, jm = _tmesh(shape), _jmesh(shape)
        for grid in [_words((64, 8), 1), _words((3, 64, 8), 2),
                     _words((64, 8), 3).astype(np.uint8)]:
            placed = t_mesh.device_put_sharded_grid(
                torch.from_numpy(grid.view(np.int32) if grid.dtype == np.uint32
                                 else grid).clone(), tm, banded=banded)
            jarr = j_mesh.device_put_sharded_grid(jnp.asarray(grid), jm,
                                                  banded=banded)
            shards = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
            for p, block in enumerate(placed.blocks()):
                want = shards[jm.devices.flat[p]]
                got = block.numpy()
                if grid.dtype == np.uint32:
                    got = got.view(np.uint32)
                np.testing.assert_array_equal(got, want, err_msg=f"{shape} {p}")
            back = placed.gather().numpy()
            np.testing.assert_array_equal(
                back.view(np.uint32) if grid.dtype == np.uint32 else back, grid)


def test_placement_refuses_what_jax_refuses():
    tm, jm = _tmesh((4, 2)), _jmesh((4, 2))
    grid = np.zeros((30, 64), np.uint8)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        j_mesh.device_put_sharded_grid(jnp.asarray(grid), jm)
    with pytest.raises(ValueError, match="not divisible by mesh"):
        t_mesh.device_put_sharded_grid(torch.from_numpy(grid), tm)
    with pytest.raises(ValueError, match="full-width bands"):
        t_mesh.device_put_sharded_grid(torch.from_numpy(grid), tm, banded=True)
    with pytest.raises(ValueError, match="full-width bands"):
        j_mesh.device_put_sharded_grid(jnp.asarray(grid), jm, banded=True)


def _jax_exchange(grid, jm, spec, fn):
    """``fn`` on every device's block in shard_map; the extended blocks laid
    out as ``spec`` shards them."""
    run = shard_map(fn, mesh=jm, in_specs=spec, out_specs=spec)
    return np.asarray(run(jnp.asarray(grid)))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_exchange_halo_matches_jax(topology):
    """The two-phase exchange of 2D tiles, corners included, at depths 1
    and 2, on words and on a plane stack (JAX ``exchange_halo_stack``)."""
    for shape in [(2, 4), (4, 2), (8, 1)]:
        tm, jm = _tmesh(shape), _jmesh(shape)
        nx, ny = shape
        for depth in (1, 2):
            words = _words((32, 16), 4 + depth)
            want = _jax_exchange(words, jm, P("x", "y"),
                                 lambda t: j_halo.exchange_halo(
                                     t, nx, ny, JTop(topology), depth=depth))
            placed = t_mesh.device_put_sharded_grid(_t(words), tm)
            ext = t_halo.exchange_halo(placed.parts, tm, TTop(topology),
                                       depth=depth)
            np.testing.assert_array_equal(
                _u32(placed.with_parts(ext).gather()), want, err_msg=str(shape))
        planes = _words((3, 32, 16), 7)
        want = _jax_exchange(planes, jm, P(None, "x", "y"),
                             lambda t: j_halo.exchange_halo_stack(
                                 t, nx, ny, JTop(topology)))
        placed = t_mesh.device_put_sharded_grid(_t(planes), tm)
        ext = t_halo.exchange_halo(placed.parts, tm, TTop(topology))
        np.testing.assert_array_equal(_u32(placed.with_parts(ext).gather()),
                                      want, err_msg=str(shape))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_band_rows_and_edge_codes_match_jax(shape, topology):
    """Rows along the flattened band axis (x-major), three deep, on words
    and planes, and each band's edge code."""
    tm, jm = _tmesh(shape), _jmesh(shape)
    axis, nb = j_mesh.band_axis(jm)
    words = _words((64, 4), 8)
    want = _jax_exchange(words, jm, P(axis, None), lambda t: j_halo.exchange_rows(
        t, nb, JTop(topology), axis=axis, depth=3))
    placed = t_mesh.device_put_sharded_grid(_t(words), tm, banded=True)
    ext = t_halo.exchange_rows(placed.parts, tm, TTop(topology),
                               axis=t_mesh.band_axis(tm)[0], depth=3)
    np.testing.assert_array_equal(_u32(placed.with_parts(ext).gather()), want)
    planes = _words((2, 64, 4), 9)
    want = _jax_exchange(planes, jm, P(None, axis, None),
                         lambda t: j_halo.exchange_rows_stack(
                             t, nb, JTop(topology), axis=axis, depth=2))
    placed = t_mesh.device_put_sharded_grid(_t(planes), tm, banded=True)
    ext = t_halo.exchange_rows(placed.parts, tm, TTop(topology), axis=axis,
                               depth=2)
    np.testing.assert_array_equal(_u32(placed.with_parts(ext).gather()), want)
    codes = shard_map(lambda t: j_halo.band_edge_code(nb, axis=axis),
                      mesh=jm, in_specs=P(axis, None), out_specs=P(axis, None))
    want = np.asarray(codes(jnp.asarray(words))).ravel()
    np.testing.assert_array_equal(t_halo.band_edge_codes(tm)[0].numpy(), want)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_asymmetric_depths_match_jax(topology):
    """r halo rows, then one halo word: the LtL tiles' exchange
    (JAX ``exchange_cols_stack`` after ``exchange_rows_stack``)."""
    tm, jm = _tmesh((2, 4)), _jmesh((2, 4))
    planes = _words((2, 32, 16), 10)

    def jfn(t):
        return j_halo.exchange_cols_stack(
            j_halo.exchange_rows_stack(t, 2, JTop(topology), depth=3), 4,
            JTop(topology), depth=1)

    want = _jax_exchange(planes, jm, P(None, "x", "y"), jfn)
    placed = t_mesh.device_put_sharded_grid(_t(planes), tm)
    ext = t_halo.exchange_cols(
        t_halo.exchange_rows(placed.parts, tm, TTop(topology), depth=3), tm,
        TTop(topology), depth=1)
    np.testing.assert_array_equal(_u32(placed.with_parts(ext).gather()), want)


def test_exchange_deeper_than_a_band_raises():
    tm = _tmesh((8, 1))
    placed = t_mesh.device_put_sharded_grid(_t(_words((64, 2), 11)), tm,
                                            banded=True)
    t_halo.exchange_rows(placed.parts, tm, TTop.TORUS, depth=8)
    with pytest.raises(ValueError, match="band height"):
        t_halo.exchange_rows(placed.parts, tm, TTop.TORUS, depth=9)
    with pytest.raises(ValueError, match="axis"):
        t_halo.exchange_rows(placed.parts, tm, TTop.TORUS, axis="z")


def test_positions_on_two_devices_take_the_same_path():
    """A mesh whose positions sit in two stacks (two device groups) gives
    what one stack gives: strips cross between stacks as they would cross
    devices. Both "devices" are the CPU here, so the groups are made by
    hand."""
    one = _tmesh((4, 1))
    two = _tmesh((4, 1))
    two.groups = ((torch.device("cpu"), (0, 1)), (torch.device("cpu"), (2, 3)))
    two.slot_of = {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}
    words = _t(_words((32, 4), 12))
    for topology in TTop:
        a = t_mesh.device_put_sharded_grid(words, one, banded=True)
        b = t_mesh.device_put_sharded_grid(words, two, banded=True)
        assert len(b.parts) == 2 and b.parts[0].shape[0] == 2
        ea = a.with_parts(t_halo.exchange_rows(a.parts, one, topology, depth=3))
        eb = b.with_parts(t_halo.exchange_rows(b.parts, two, topology, depth=3))
        assert torch.equal(ea.gather(), eb.gather())
        assert torch.equal(b.gather(), words)
