"""The sharded sparse runners against the JAX package's on its 8 fake CPU
devices: the per-tile runners (B/S, Generations, binary and multi-state
LtL) and the per-position flagged runners, state and activity map bit
for bit, the overflow branch of a shard with more candidates than its
capacity, and the refusal of birth-from-nothing rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gameoflifewithactors_torch.models.generations import parse_any as t_parse
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.ops.packed_generations import (
    pack_generations_for as t_planes,
)
from gameoflifewithactors_torch.ops.stencil import Topology as TTopology
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.parallel import sharded as t_sharded
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.packed_generations import (
    pack_generations_for as j_planes,
)
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import sharded as j_sharded

LTL = "R2,C0,M1,S9..16,B8..12"
LTL_DECAY = "R2,C3,M1,S3..8,B5..9"


def _meshes(shape):
    n = shape[0] * shape[1]
    return (t_mesh.make_mesh(shape, ["cpu"] * n),
            j_mesh.make_mesh(shape, jax.devices()[:n]))


def _blob(shape, states, seed):
    """A blob across the centre of the grid (so across shard seams), the
    rest dead."""
    rng = np.random.default_rng(seed)
    cells = np.zeros(shape, np.uint8)
    h, w = shape
    cells[h // 2 - 12:h // 2 + 12, w // 2 - 40:w // 2 + 40] = rng.integers(
        0, states, (24, 80))
    return cells


def _states(cells, rule, tm, jm):
    """(port state, JAX state) placed on the meshes: words, or the plane
    stack of a multi-state rule (plane axis replicated)."""
    t_rule, j_rule = t_parse(rule), j_parse(rule)
    if getattr(t_rule, "states", 2) > 2:
        return (t_mesh.device_put_sharded_grid(
                    t_planes(torch.from_numpy(cells), t_rule), tm),
                jax.device_put(j_planes(jnp.asarray(cells), j_rule),
                               NamedSharding(jm, P(None, "x", "y"))))
    return (t_mesh.device_put_sharded_grid(
                t_bitpack.pack(torch.from_numpy(cells)), tm),
            j_mesh.device_put_sharded_grid(
                j_bitpack.pack(jnp.asarray(cells)), jm))


def _same(t_state, j_state):
    np.testing.assert_array_equal(t_state.gather().numpy(),
                                  np.asarray(j_state).astype(np.int32))


def _tiled(rule, states, topology, shape, capacity, steps=(6, 7)):
    tm, jm = _meshes(shape)
    cells = _blob((64, 256), states, 3)
    t_state, j_state = _states(cells, rule, tm, jm)
    tr, tw = 8, 1
    planes = states > 2
    t_make = (t_sharded.make_multi_step_generations_packed_sparse_tiled
              if planes else t_sharded.make_multi_step_packed_sparse_tiled)
    j_make = (j_sharded.make_multi_step_generations_packed_sparse_tiled
              if planes else j_sharded.make_multi_step_packed_sparse_tiled)
    t_act = t_sharded.initial_tile_activity(t_state, tm, tr, tw)
    j_act = j_sharded.initial_tile_activity(
        j_planes(jnp.asarray(cells), j_parse(rule)) if planes
        else j_bitpack.pack(jnp.asarray(cells)), jm, tr, tw)
    _same(t_act, j_act)
    t_run = t_make(tm, t_parse(rule), TTopology(topology), tile_rows=tr,
                   tile_words=tw, capacity=capacity)
    j_run = j_make(jm, j_parse(rule), JTopology(topology), tile_rows=tr,
                   tile_words=tw, capacity=capacity)
    for n in steps:
        t_state, t_act = t_run(t_state, t_act, n)
        j_state, j_act = j_run(j_state, j_act, n)
        _same(t_state, j_state)
        _same(t_act, j_act)
    return t_act


@pytest.mark.parametrize("rule,states", [("B3/S23", 2), ("brain", 3),
                                         (LTL, 2), (LTL_DECAY, 3)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_tiled_runners_match_jax(rule, states, topology):
    """A blob across the seams of a (2, 2) mesh, 13 generations in two
    calls (the second call steps the buffers the first one returned)."""
    act = _tiled(rule, states, topology, (2, 2), None)
    assert int(act.gather().sum()) > 0


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_capacity_overflow_takes_a_whole_shard_generation(topology):
    """At capacity 2 every awake shard overflows and takes the dense
    branch; state and activity map equal JAX's, on a (4, 1) mesh."""
    tm, _ = _meshes((4, 1))
    cells = _blob((64, 256), 2, 3)
    state, _ = _states(cells, "B3/S23", tm, _meshes((4, 1))[1])
    act = t_sharded.initial_tile_activity(state, tm, 8, 1)
    assert int(act.parts[0].flatten(1).sum(1).max()) > 2
    _tiled("B3/S23", 2, topology, (4, 1), 2)


@pytest.mark.parametrize("rule,states", [("B3/S23", 2), ("brain", 3)])
def test_flagged_runners_match_jax(rule, states):
    """Per-position flags on a (2, 2) mesh: the blob sits in the top
    half of the middle columns, so the lower positions sleep at times."""
    tm, jm = _meshes((2, 2))
    cells = np.zeros((64, 256), np.uint8)
    cells[8:24, 100:160] = np.random.default_rng(4).integers(0, states,
                                                              (16, 60))
    t_state, j_state = _states(cells, rule, tm, jm)
    planes = states > 2
    t_make = (t_sharded.make_multi_step_generations_packed_sparse if planes
              else t_sharded.make_multi_step_packed_sparse)
    j_make = (j_sharded.make_multi_step_generations_packed_sparse if planes
              else j_sharded.make_multi_step_packed_sparse)
    for topology in ("torus", "dead"):
        t_run = t_make(tm, t_parse(rule), TTopology(topology))
        j_run = j_make(jm, j_parse(rule), JTopology(topology))
        t_out, t_flags = t_run(t_state, t_sharded.initial_flags(tm), 9)
        j_out, j_flags = j_run(j_state, j_sharded.initial_flags(jm), 9)
        _same(t_out, j_out)
        _same(t_flags, j_flags)


def test_birth_from_nothing_is_refused_with_jax_messages():
    tm, jm = _meshes((2, 2))
    for rule in ("B0/S8", "R1,C0,M1,S0..8,B0..3"):
        with pytest.raises(ValueError) as t_err:
            t_sharded.make_multi_step_packed_sparse_tiled(
                tm, t_parse(rule), tile_rows=8, tile_words=1)
        with pytest.raises(ValueError) as j_err:
            j_sharded.make_multi_step_packed_sparse_tiled(
                jm, j_parse(rule), tile_rows=8, tile_words=1)
        assert str(t_err.value) == str(j_err.value)
