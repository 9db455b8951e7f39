"""Kernel B3's rule lookup and its plain versions at the depths and tiles
of its redesign.

- ``cuda_stencil._generations_rule_encoding`` (which counts the kernel
  tests, or the table) and its plain twin
  ``packed_generations.encoded_rule_planes`` against ``_mask_plane`` for
  every born set and every survive set, over every count 0..8 and the
  dead, alive and dying states;
- ``multi_step_generations_reference`` and
  ``slab_step_generations_reference`` (the kernel's algorithm in plain
  torch) against the JAX package's plain stepper and its Pallas kernels in
  interpret mode, for b = 2..8, C = 2^b, both rule paths, B0, g = 16 and
  32, and tiles that split the grid raggedly.

Integers throughout: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import generations as t_gen
from gameoflifewithactors_torch.ops import cuda_stencil as cs
from gameoflifewithactors_torch.ops import packed_generations as t_pg
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import generations as j_gen
from gameoflifewithactors_tpu.ops import packed_generations as j_pg
from gameoflifewithactors_tpu.ops import pallas_stencil as ps
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop


def _plane(bits) -> torch.Tensor:
    """One int32 word whose bit i is ``bits[i]``."""
    word = sum(int(b) << i for i, b in enumerate(bits))
    return torch.tensor([word], dtype=torch.int64).to(torch.int32)


# every (state, count) pair in one word: bit 9*s + n holds state s (0 dead,
# 1 alive, 2 dying) at count n
_STATES = [s for s in range(3) for _ in range(9)]
_COUNTS = [n for _ in range(3) for n in range(9)]
_BITS = [_plane([(n >> k) & 1 for n in _COUNTS]) for k in range(4)]
_PLANES = (_plane([s & 1 for s in _STATES]), _plane([s >> 1 for s in _STATES]))
_ALIVE = _PLANES[0] & ~_PLANES[1]


def _sets(mask: int):
    return [n for n in range(9) if (mask >> n) & 1]


def _next_states(rule, encoding):
    """The next state of every (state, count) pair, with the rule's masks
    looked up as ``_mask_plane`` does (encoding None) or as the kernel
    does."""
    if encoding is None:
        born = t_pg._mask_plane(_BITS, rule.born, _ALIVE)
        keep = t_pg._mask_plane(_BITS, rule.survive, _ALIVE)
    else:
        born, keep = t_pg.encoded_rule_planes(_BITS, _ALIVE, rule, encoding)
    return t_pg.transition_planes(_PLANES, _ALIVE, born, keep, rule.states)


def _hold_every_set(fixed, vary_born: bool) -> int:
    paths = set()
    for mask in range(512):
        born, survive = (_sets(mask), fixed) if vary_born else (fixed, _sets(mask))
        rule = t_gen.GenRule(born=born, survive=survive, states=3)
        encoding = cs._generations_rule_encoding(rule)
        paths.add(len(encoding))
        got = _next_states(rule, encoding)
        want = _next_states(rule, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (born, survive, encoding)
    return len(paths)


# the fixed set, and how many of the paths (the table, 1..4 counts) the
# 512 sets of the other then take: (0, 8) forces the table
@pytest.mark.parametrize("survive, paths", [((), 5), ((2, 3), 4), ((0, 8), 1)])
def test_rule_encoding_matches_mask_plane_for_every_born_set(survive, paths):
    assert _hold_every_set(list(survive), vary_born=True) == paths


@pytest.mark.parametrize("born, paths", [((), 5), ((2,), 5), ((0, 8), 1)])
def test_rule_encoding_matches_mask_plane_for_every_survive_set(born, paths):
    assert _hold_every_set(list(born), vary_born=False) == paths


def test_rule_encoding_sizes_the_lookup_to_the_rule():
    enc = cs._generations_rule_encoding
    assert enc(t_gen.parse_any("brain")) == ((2, 1, 0),)
    assert enc(t_gen.parse_any("belzhab")) == ((2, 1, 1), (3, 1, 1))
    assert enc(t_gen.parse_any("B2/S34/C5")) == ((2, 1, 0), (3, 0, 1), (4, 0, 1))
    assert enc(t_gen.parse_any("starwars")) == (
        (2, 1, 0), (3, 0, 1), (4, 0, 1), (5, 0, 1))
    # the table: count 0 or 8 named, more than four counts, or none
    for name in ["B0/S8/C4", "B2/S8/C3", "B0/S2/C3", "B1357/S02468/C17",
                 "B12345/S/C3", "B/S/C3"]:
        assert enc(t_gen.parse_any(name)) == (), name
    assert cs.MAX_GENERATIONS_COUNTS == 4


def test_default_tiles_fill_whole_warps_and_two_blocks_where_they_can():
    # 28 words plus a halo word per side: one warp of 30 written words
    assert cs._resolve_generations(2, None, None) == (16, 192, 28)
    assert cs._resolve_generations(2, 32, None) == (32, 160, 28)
    assert cs._resolve_generations(8, 16, None) == (16, 16, 28)
    for b in range(2, 9):
        for g in (1, 8, 16, 32):
            _, th, tw = cs._resolve_generations(b, g, None)
            smem = cs._generations_smem(b, g)(th, tw)
            assert smem <= cs._SMEM_LIMIT
            assert (th, tw) in cs._GENERATIONS_TILES
    # the mesh main path's bands: 4128 extended rows in 188-row tiles
    assert cs._resolve_generations_slab(2, 16, 4128, 512, None) == (16, 188, 28)


def _stack(name, h, w, seed):
    rule = j_gen.parse_any(name)
    cells = np.random.default_rng(seed).integers(0, rule.states, size=(h, w),
                                                 dtype=np.uint8)
    jp = j_pg.pack_generations_for(jnp.asarray(cells), rule)
    return jp, torch.from_numpy(np.asarray(jp).view(np.int32).copy())


def _same(got: torch.Tensor, want, msg: str = "") -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want),
                                  err_msg=msg)


# C = 2^b for b = 2..8, B0 and count 8 (the table), and a rule on each
# count of the equality path
_EVERY_PLANE_COUNT = ["B2/S345/C4", "B3/S23/C8", "B2/S34/C16", "B36/S23/C32",
                      "B3/S2/C64", "B2/S/C128", "B3/S23/C256", "B0/S8/C4",
                      "brain", "B2/S34/C5", "starwars"]


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_plain_version_matches_the_packed_stepper_at_depth(topology):
    """b = 2..8 with C = 2^b, both rule paths, B0, g = 16 and 32 on tiles
    that split the 40 x 96 grid raggedly (and one larger than it)."""
    for i, name in enumerate(_EVERY_PLANE_COUNT):
        jp, tp = _stack(name, 40, 96, seed=50 + i)
        for g, tile in [(16, (7, 2)), (32, (16, 1)), (16, None)]:
            n = 2 * g + 3
            want = j_pg.multi_step_packed_generations(
                jp, n, rule=j_gen.parse_any(name), topology=JTop(topology))
            got = cs.multi_step_generations_reference(
                tp, n, rule=t_gen.parse_any(name), topology=TTop(topology),
                gens_per_call=g, tile=tile)
            _same(got, want, f"{name} g={g} tile={tile}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_plain_version_matches_pallas_interpret_at_depth(topology):
    """The Pallas kernel in interpret mode at 16 generations per call, on
    each rule path, b = 2 and 3."""
    for i, name in enumerate(["brain", "starwars", "B0/S8/C4", "B2/S34/C5"]):
        jp, tp = _stack(name, 64, 64, seed=60 + i)
        want = ps.multi_step_pallas_generations(
            jp, 35, rule=j_gen.parse_any(name), topology=JTop(topology),
            block_rows=32, gens_per_call=16, interpret=True)
        got = cs.multi_step_generations_reference(
            tp, 35, rule=t_gen.parse_any(name), topology=TTop(topology),
            gens_per_call=16, tile=(9, 2))
        _same(got, want, name)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("g", [16, 32])
def test_slab_plain_version_matches_pallas_slab_at_depth(g):
    """A batch of four bands with edge codes 0-3 (one per band) against the
    JAX slab step per band, TORUS and DEAD, on each rule path and C = 4 =
    2^b, with ragged tiles."""
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    He = 32 + 2 * g
    for i, name in enumerate(["brain", "starwars", "B0/S8/C4"]):
        b = t_pg.n_planes(t_gen.parse_any(name).states)
        words = _words((4, b, He, 2), 70 + i)
        for topology in ("torus", "dead"):
            got = cs.slab_step_generations_reference(
                torch.from_numpy(words.view(np.int32)), g,
                rule=t_gen.parse_any(name), topology=TTop(topology),
                edge_code=codes, tile=(11, 1)).numpy().view(np.uint32)
            for k in range(4):
                step = ps.make_pallas_gen_slab_step(
                    j_gen.parse_any(name), JTop(topology), words[k].shape,
                    gens=g, block_rows=32, interpret=True, dead_band=True)
                want = np.asarray(step(jnp.asarray(words[k]),
                                       jnp.full((1, 1), k, jnp.int32)))
                np.testing.assert_array_equal(
                    got[k], want, err_msg=f"{name} {topology} g={g} code={k}")
