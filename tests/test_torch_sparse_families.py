"""The sparse engine (ops/sparse.py) and the paged engine (memory/) of the
port against the JAX package's for the multi-state and radius-r families,
on the CPU, bit for bit (tolerance 0): Generations plane stacks, binary
Larger than Life (box and diamond) and multi-state LtL plane stacks, with
chunk depths 1..4 (at most 4 for LtL: deeper JAX chunk programs are slow
to compile here), remainders, the dense fallback and the capacity policy
(``capacity`` and ``active_tiles()`` after every step).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gameoflifewithactors_torch.engine import Engine
from gameoflifewithactors_torch.models.generations import parse_any
from gameoflifewithactors_torch.ops import bitpack, sparse
from gameoflifewithactors_torch.ops.packed_generations import \
    pack_generations_for
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.utils.interop import (state_from_numpy,
                                                      state_to_numpy)
from gameoflifewithactors_tpu.engine import Engine as JEngine
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse_any
from gameoflifewithactors_tpu.ops import sparse as j_sparse
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology

BRAIN = "brain"
BOSCO = "R5,C0,M1,S34..58,B34..45"
DIAMOND = "R2,C0,M1,S2..5,B3..4,NN"
LTL3_BOX = "R2,C3,M1,S2..5,B3..4"
LTL3_DIAMOND = "R2,C4,M0,S1..3,B2..3,NN"


def _blob(spec, shape, seed, at=(0.3, 0.3), size=(24, 40), fill=0.4):
    """Cells of a numpy-seeded blob of random states (0..C-1) inside an
    empty grid."""
    states = getattr(parse_any(spec), "states", 2)
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = int(at[0] * h), int(at[1] * w)
    cells = np.zeros(shape, np.uint8)
    live = rng.random(size) < fill
    cells[y:y + size[0], x:x + size[1]] = live * rng.integers(1, states, size)
    return cells


def _words(spec, cells):
    """The port's packed layout of ``cells`` as host uint32 words."""
    rule = parse_any(spec)
    planes, _ = sparse.rule_layout(rule)
    if planes == 1:
        return bitpack.pack_np(cells)
    import torch

    return state_to_numpy(pack_generations_for(torch.from_numpy(cells), rule))


def _pair(spec, cells, topology, **opts):
    words = _words(spec, cells)
    j = j_sparse.SparseEngineState(jnp.asarray(words), j_parse_any(spec),
                                   topology=JTopology(topology), **opts)
    t = sparse.SparseEngineState(state_from_numpy(words), parse_any(spec),
                                 topology=Topology(topology), **opts)
    return j, t


def _run(j, t, steps):
    for n in steps:
        j.step(n)
        t.step(n)
        np.testing.assert_array_equal(state_to_numpy(t.packed.contiguous()),
                                      np.asarray(j.packed))
        assert (t.capacity, t.active_tiles()) == (j.capacity, j.active_tiles())


@pytest.mark.parametrize("spec,topology,chunk", [
    (BRAIN, "torus", 1),
    (BRAIN, "dead", 3),
    (BOSCO, "dead", 2),
    (BOSCO, "torus", 1),
    (DIAMOND, "dead", 4),
    (LTL3_BOX, "torus", 2),
    (LTL3_DIAMOND, "dead", 1),
])
def test_sparse_families_match_jax(spec, topology, chunk):
    """Plane stacks scatter as (b, K, tr, tw); radius-r windows carry
    r·g halo rows; steps of 1, a remainder and several chunks."""
    shape = (96, 128)
    j, t = _pair(spec, _blob(spec, shape, seed=3), topology,
                 tile_rows=16, tile_words=1, chunk_gens=chunk)
    _run(j, t, (1, 5, 2 * chunk, 9))


@pytest.mark.parametrize("spec", [BRAIN, BOSCO])
def test_capacity_policy_on_families_matches_jax(spec):
    """A fixed capacity's dense fallback on a plane stack and on a radius-5
    ring, and the adaptive start and escalation of a growing blob."""
    shape = (96, 128)
    cells = _blob(spec, shape, seed=8, size=(40, 60), fill=0.5)
    j, t = _pair(spec, cells, "torus", tile_rows=16, tile_words=1, capacity=4)
    _run(j, t, (1, 3, 4))
    j, t = _pair(spec, cells, "dead", tile_rows=8, tile_words=1)
    j._set_capacity(32)
    t._set_capacity(32)
    _run(j, t, (2, 3, 6))


@pytest.mark.parametrize("backend", ["sparse", "paged"])
def test_engine_tiled_backends_on_families_match_jax(backend):
    """``Engine(backend=...)`` over the three families, snapshot,
    population and active tiles after each step; ``set_grid`` reseeds."""
    for spec, topology in ((BRAIN, "dead"), (BOSCO, "torus"),
                           (LTL3_BOX, "dead")):
        cells = _blob(spec, (64, 128), seed=5)
        opts = {"tile_rows": 16, "tile_words": 1}
        j = JEngine(cells, spec, topology=JTopology(topology),
                    backend=backend, sparse_opts=opts)
        t = Engine(cells, spec, topology=Topology(topology), backend=backend,
                   sparse_opts=opts, device="cpu")
        for n in (3, 8):
            j.step(n)
            t.step(n)
            np.testing.assert_array_equal(t.snapshot(), j.snapshot())
            assert (t.population(), t.active_tiles()) == \
                (j.population(), j.active_tiles())
        j.set_grid(cells, 0)
        t.set_grid(cells, 0)
        j.step(4)
        t.step(4)
        np.testing.assert_array_equal(t.snapshot(), j.snapshot())


def test_engine_width_errors_match_jax():
    """A width that does not pack into words: the JAX engine's messages for
    Generations and LtL under both tiled backends."""
    for spec in (BRAIN, BOSCO):
        for backend in ("sparse", "paged"):
            cells = np.zeros((64, 48), np.uint8)
            with pytest.raises(ValueError) as got:
                Engine(cells, spec, backend=backend, device="cpu")
            with pytest.raises(ValueError) as want:
                JEngine(cells, spec, backend=backend)
            assert str(got.value) == str(want.value)
