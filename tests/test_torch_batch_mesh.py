"""The batch mesh: ``(nb, nx, ny)`` replicas of a spatial mesh, each
holding a slice of a batch of universes, against the JAX package's
``parallel.batched`` on its 8 fake CPU devices -- the validation, the
placements, the plain-torch tile runner and the slab-form band runner
(B2's plain version on CPU tensors; JAX's Pallas slab kernel in interpret
mode), masked and unmasked, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models.rules import parse_rule
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.ops.stencil import Topology as TTopology
from gameoflifewithactors_torch.parallel import batched as t_batched
from gameoflifewithactors_tpu.models.rules import CONWAY as J_CONWAY
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import batched as j_batched

CONWAY = parse_rule("B3/S23")
MASK = np.array([1, 0, 1, 1], np.uint32)


def _meshes(shape):
    n = shape[0] * shape[1] * shape[2]
    return (t_batched.make_batch_mesh(shape, ["cpu"] * n),
            j_batched.make_batch_mesh(shape, jax.devices()[:n]))


def _batch(seed=31, shape=(4, 32, 64)):
    grids = np.random.default_rng(seed).integers(0, 2, size=shape,
                                                 dtype=np.uint8)
    return (torch.stack([t_bitpack.pack(torch.from_numpy(u)) for u in grids]),
            jnp.stack([j_bitpack.pack(jnp.asarray(u)) for u in grids]))


def test_batch_mesh_validation():
    """JAX ``test_batched.py::test_batch_mesh_validation``: a shape that
    does not use the devices given is refused, with JAX's message; and
    the placements refuse what does not divide."""
    with pytest.raises(ValueError) as t_err:
        t_batched.make_batch_mesh((3, 2, 2), ["cpu"] * 8)
    with pytest.raises(ValueError) as j_err:
        j_batched.make_batch_mesh((3, 2, 2), jax.devices()[:8])
    assert str(t_err.value) == str(j_err.value)
    tm, _ = _meshes((2, 2, 1))
    with pytest.raises(ValueError, match="not divisible over 2 replicas"):
        t_batched.device_put(torch.zeros((3, 32, 2), dtype=torch.int32),
                             t_batched.batch_sharding(tm))
    with pytest.raises(ValueError, match="full-width bands"):
        t_batched.device_put(torch.zeros((2, 31, 2), dtype=torch.int32),
                             t_batched.batch_band_sharding(tm))


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2), (1, 2, 2)])
def test_placement_round_trip(shape):
    """``device_put`` by either placement and ``gather`` give the batch
    back; position (b, i, j) holds the universes of replica b."""
    tm, _ = _meshes(shape)
    grids, _ = _batch()
    for sharding in (t_batched.batch_sharding(tm),
                     t_batched.batch_band_sharding(tm)):
        placed = t_batched.device_put(grids, sharding)
        assert torch.equal(placed.gather(), grids)
        nb = shape[0]
        assert placed.parts[0].shape[:2] == (tm.size, 4 // nb)


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_slab_form_runner_matches_jax_pallas_batched(shape, topology):
    """The band runner (B2's slab form, its plain version here) against
    JAX ``make_multi_step_pallas_batched`` in interpret mode: two chunks
    of g = 3, unmasked and masked (mask-0 universes bit-identical to
    their input)."""
    tm, jm = _meshes(shape)
    t_grids, j_grids = _batch()
    t_sharding = (t_batched.batch_band_sharding(tm) if shape[2] > 1
                  else t_batched.batch_sharding(tm))
    j_sharding = (j_batched.batch_band_sharding(jm) if shape[2] > 1
                  else j_batched.batch_sharding(jm))
    for masked in (False, True):
        extra = (MASK,) if masked else ()
        t_run = t_batched.make_multi_step_kernel_batched_mesh(
            tm, CONWAY, TTopology(topology), gens_per_exchange=3,
            masked=masked)
        j_run = j_batched.make_multi_step_pallas_batched(
            jm, J_CONWAY, JTopology(topology), gens_per_exchange=3,
            interpret=True, masked=masked)
        got = t_run(t_batched.device_put(t_grids, t_sharding), 2, *extra)
        want = j_run(jax.device_put(j_grids, j_sharding), 2,
                     *(jnp.asarray(m) for m in extra))
        np.testing.assert_array_equal(got.gather().numpy(),
                                      np.asarray(want).view(np.int32))
        if masked:
            assert torch.equal(got.gather()[1], t_grids[1])


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 1, 2)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_tile_runner_matches_jax_packed_batched(shape, topology):
    """The plain-torch 2D-tile runner against JAX
    ``make_multi_step_packed_batched`` on the same mesh, 5 generations,
    unmasked and masked."""
    tm, jm = _meshes(shape)
    t_grids, j_grids = _batch(seed=7)
    for masked in (False, True):
        extra = (MASK,) if masked else ()
        t_run = t_batched.make_multi_step_packed_batched_mesh(
            tm, CONWAY, TTopology(topology), masked=masked)
        j_run = j_batched.make_multi_step_packed_batched(
            jm, J_CONWAY, JTopology(topology), masked=masked)
        got = t_run(t_batched.device_put(
            t_grids, t_batched.batch_sharding(tm)), 5, *extra)
        want = j_run(jax.device_put(j_grids, j_batched.batch_sharding(jm)),
                     5, *(jnp.asarray(m) for m in extra))
        np.testing.assert_array_equal(got.gather().numpy(),
                                      np.asarray(want).view(np.int32))


def test_band_runner_refusals():
    tm, _ = _meshes((2, 1, 2))
    grids, _ = _batch()
    run = t_batched.make_multi_step_kernel_batched_mesh(
        tm, CONWAY, gens_per_exchange=17)
    with pytest.raises(ValueError, match="exceeds the per-device band"):
        run(t_batched.device_put(grids, t_batched.batch_band_sharding(tm)), 1)
    with pytest.raises(ValueError, match="batch_band_sharding"):
        run(t_batched.device_put(grids, t_batched.batch_sharding(tm)), 1)
    with pytest.raises(ValueError, match="batch_sharding"):
        t_batched.make_multi_step_packed_batched_mesh(tm, CONWAY)(
            t_batched.device_put(grids, t_batched.batch_band_sharding(tm)), 1)
