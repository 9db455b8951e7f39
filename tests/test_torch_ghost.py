"""The communication-avoiding packed runners on a mesh: the ghost-zone
pipeline and the deep runner against the JAX package's on its 8 fake CPU
devices, bit for bit, with their byte models, the bytes the port's halo
exchange counts, their refusals and the registry instruments.

k stays at 4 or less on the JAX side: XLA's CPU compile of the unrolled
shrinking slabs is slow. k = 33 (past the deep runner's cap of 32) is
held against the port's own single-device packed path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models.rules import parse_rule
from gameoflifewithactors_torch.obs.registry import REGISTRY as T_REGISTRY
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.ops.packed import multi_step_packed
from gameoflifewithactors_torch.ops.stencil import Topology as TTopology
from gameoflifewithactors_torch.parallel import halo as t_halo
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.parallel import sharded as t_sharded
from gameoflifewithactors_tpu.models.rules import CONWAY as J_CONWAY
from gameoflifewithactors_tpu.obs.registry import REGISTRY as J_REGISTRY
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import sharded as j_sharded

CONWAY = parse_rule("B3/S23")


def _meshes(shape):
    n = shape[0] * shape[1]
    return (t_mesh.make_mesh(shape, ["cpu"] * n),
            j_mesh.make_mesh(shape, jax.devices()[:n]))


def _soup(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape,
                                                dtype=np.uint8)


def _placed(cells, tm, jm):
    return (t_mesh.device_put_sharded_grid(
                t_bitpack.pack(torch.from_numpy(cells)), tm),
            j_mesh.device_put_sharded_grid(
                j_bitpack.pack(jnp.asarray(cells)), jm))


def _words(sharded_grid):
    return sharded_grid.gather().numpy()


def _instruments(registry):
    return (registry.counter("halo_exchanges_total").value(),
            registry.counter("halo_bytes_total").value(),
            registry.gauge("halo_overlap_ratio").value())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ghost_and_deep_match_jax(shape, topology):
    """Ghost (k = 2, three blocks) and deep (g = 3, two chunks) on a
    48x192 soup, the words equal to JAX's; each ghost call moves the
    registry instruments exactly as JAX's does."""
    tm, jm = _meshes(shape)
    t_state, j_state = _placed(_soup((48, 192), 7), tm, jm)
    tt, jt = TTopology(topology), JTopology(topology)
    t_ghost = t_sharded.make_multi_step_packed_ghost(tm, CONWAY, tt, 2)
    j_ghost = j_sharded.make_multi_step_packed_ghost(jm, J_CONWAY, jt, 2)
    for chunks in (3, 1):
        t0, j0 = _instruments(T_REGISTRY), _instruments(J_REGISTRY)
        t_out = t_ghost(t_state, chunks)
        j_out = j_ghost(j_state, chunks)
        np.testing.assert_array_equal(
            _words(t_out), np.asarray(j_out).view(np.int32))
        t1, j1 = _instruments(T_REGISTRY), _instruments(J_REGISTRY)
        assert [t1[0] - t0[0], t1[1] - t0[1], t1[2]] == \
            [j1[0] - j0[0], j1[1] - j0[1], j1[2]]
    t_out = t_sharded.make_multi_step_packed_deep(tm, CONWAY, tt, 3)(t_state, 2)
    j_out = j_sharded.make_multi_step_packed_deep(jm, J_CONWAY, jt, 3)(j_state, 2)
    np.testing.assert_array_equal(_words(t_out),
                                  np.asarray(j_out).view(np.int32))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_k33_matches_the_single_device_packed_path(topology):
    """k = 33 needs two halo words: two blocks of the ghost pipeline equal
    the port's single-device packed stepping; so does a chunk of the
    deep runner at its cap of 32."""
    tt = TTopology(topology)
    cells = _soup((136, 2048), 11)
    words = t_bitpack.pack(torch.from_numpy(cells))
    tm = t_mesh.make_mesh((2, 2), ["cpu"] * 4)
    state = t_mesh.device_put_sharded_grid(words, tm)
    ghost = t_sharded.make_multi_step_packed_ghost(tm, CONWAY, tt, 33)
    np.testing.assert_array_equal(
        ghost(state, 2).gather().numpy(),
        multi_step_packed(words, 66, rule=CONWAY, topology=tt).numpy())
    deep = t_sharded.make_multi_step_packed_deep(tm, CONWAY, tt, 32)
    np.testing.assert_array_equal(
        deep(state, 1).gather().numpy(),
        multi_step_packed(words, 32, rule=CONWAY, topology=tt).numpy())


def test_byte_models_equal_jax():
    """Both byte models, arithmetic only, over meshes, shapes, topologies
    and depths (k past 32 included for the ghost)."""
    for shape in [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (2, 4), (1, 8)]:
        tm, jm = _meshes(shape)
        for grid in [(64, 8), (256, 64), (16384, 512)]:
            for topology in ("torus", "dead"):
                tt, jt = TTopology(topology), JTopology(topology)
                for k in (1, 3, 8, 32, 33, 70):
                    assert t_sharded.ghost_exchange_bytes(grid, tm, tt, k) \
                        == j_sharded.ghost_exchange_bytes(grid, jm, jt, k)
                    assert t_sharded.deep_exchange_bytes(grid, tm, tt, k) \
                        == j_sharded.deep_exchange_bytes(grid, jm, jt, k)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (4, 1), (1, 1)])
def test_counted_bytes_equal_the_models(shape):
    """The strips the halo exchange moves between distinct positions add
    up to the models: one ghost exchange (the unrolled one-block build
    makes only its prologue) and one deep chunk, on meshes whose
    positions all share the one CPU device."""
    tm, _ = _meshes(shape)
    grid = (64, 256)
    words = t_bitpack.pack(torch.from_numpy(_soup(grid, 5)))
    state = t_mesh.device_put_sharded_grid(words, tm)
    for topology in ("torus", "dead"):
        tt = TTopology(topology)
        for k in (2, 4, 33):
            if not t_mesh.ghost_fits(grid[0] // shape[0],
                                     grid[1] // 32 // shape[1], k):
                continue
            before = t_halo.exchanged_bytes()
            t_sharded.make_multi_step_packed_ghost(
                tm, CONWAY, tt, k, unroll_chunks=1)(state)
            assert t_halo.exchanged_bytes() - before == \
                t_sharded.ghost_exchange_bytes(words.shape, tm, tt, k)
        for g in (1, 5):
            before = t_halo.exchanged_bytes()
            t_sharded.make_multi_step_packed_deep(tm, CONWAY, tt, g)(state, 1)
            assert t_halo.exchanged_bytes() - before == \
                t_sharded.deep_exchange_bytes(words.shape, tm, tt, g)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_refusals_carry_jax_messages():
    tm, jm = _meshes((4, 1))
    t_state, j_state = _placed(_soup((16, 64), 3), tm, jm)   # 4-row tiles
    t, j = TTopology.TORUS, JTopology.TORUS
    for g in (0, 33):
        assert _message(lambda: t_sharded.make_multi_step_packed_deep(
            tm, CONWAY, t, g)) == _message(
            lambda: j_sharded.make_multi_step_packed_deep(jm, J_CONWAY, j, g))
    assert _message(lambda: t_sharded.make_multi_step_packed_deep(
        tm, CONWAY, t, 5)(t_state, 1)) == _message(
        lambda: j_sharded.make_multi_step_packed_deep(
            jm, J_CONWAY, j, 5)(j_state, 1))
    assert _message(lambda: t_sharded.make_multi_step_packed_ghost(
        tm, CONWAY, t, 0)) == _message(
        lambda: j_sharded.make_multi_step_packed_ghost(jm, J_CONWAY, j, 0))
    for k, chunks in [(3, 1), (1, 0)]:      # rings deeper than the tile
        assert _message(lambda: t_sharded.make_multi_step_packed_ghost(
            tm, CONWAY, t, k)(t_state, chunks)) == _message(
            lambda: j_sharded.make_multi_step_packed_ghost(
                jm, J_CONWAY, j, k)(j_state, chunks))
    assert _message(lambda: t_sharded.make_multi_step_packed_ghost(
        tm, CONWAY, t, 1, unroll_chunks=0)) == _message(
        lambda: j_sharded.make_multi_step_packed_ghost(
            jm, J_CONWAY, j, 1, unroll_chunks=0))
