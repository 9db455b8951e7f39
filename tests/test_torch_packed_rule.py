"""Kernels B1 and B2's rule lookup, B2's lane form and the plain versions at
the depth and tile of their redesign.

- ``cuda_stencil._generations_rule_encoding`` applied to B/S rules
  (which counts the kernels test, or the table) and its plain twin ``packed.encoded_next_plane`` against
  ``packed.apply_rule_planes`` for every born set and every survive set,
  over every count 0..8 and both alive states;
- the lane form's plain version (``lane_step_reference``, the lane
  runner's chunk on the CPU) against the JAX package's masked batched
  packed runner, a mask freezing some slots, under TORUS and DEAD, at ``n``
  not a multiple of ``g``;
- ``multi_step_reference`` and ``slab_step_reference`` (the kernels'
  algorithm in plain torch) at the default depth and tile and at a ragged
  tile against the JAX package's Pallas kernels in interpret mode.

Integers throughout: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import rules as t_rules
from gameoflifewithactors_torch.ops import cuda_stencil as cs
from gameoflifewithactors_torch.ops import packed as t_packed
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_torch.parallel import batched as t_batched
from gameoflifewithactors_tpu.models import rules as j_rules
from gameoflifewithactors_tpu.ops import pallas_stencil as ps
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.parallel import batched as j_batched


def _plane(bits) -> torch.Tensor:
    """One int32 word whose bit i is ``bits[i]``."""
    word = sum(int(b) << i for i, b in enumerate(bits))
    return torch.tensor([word], dtype=torch.int64).to(torch.int32)


# every (alive, count) pair in one word: bit 9*a + n holds a cell that is
# alive (a = 1) or not at count n
_ALIVE = _plane([a for a in range(2) for _ in range(9)])
_BITS = [_plane([(n >> k) & 1 for _ in range(2) for n in range(9)])
         for k in range(4)]


def _sets(mask: int):
    return frozenset(n for n in range(9) if (mask >> n) & 1)


def _hold_every_set(fixed, vary_born: bool) -> int:
    paths = set()
    for mask in range(512):
        born, survive = (_sets(mask), fixed) if vary_born else (fixed, _sets(mask))
        rule = t_rules.Rule(born=born, survive=survive)
        encoding = cs._generations_rule_encoding(rule)
        paths.add(len(encoding))
        got = t_packed.encoded_next_plane(_ALIVE, _BITS, rule, encoding)
        want = t_packed.apply_rule_planes(_ALIVE, _BITS, rule)
        assert torch.equal(got, want), (sorted(born), sorted(survive), encoding)
    return len(paths)


# the fixed set, and how many of the paths (the table, 1..4 counts) the
# 512 sets of the other then take: (0, 8) forces the table
@pytest.mark.parametrize("survive, paths", [((), 5), ((2, 3), 4), ((0, 8), 1)])
def test_rule_encoding_matches_apply_rule_planes_for_every_born_set(survive, paths):
    assert _hold_every_set(frozenset(survive), vary_born=True) == paths


@pytest.mark.parametrize("born, paths", [((), 5), ((3,), 5), ((0, 8), 1)])
def test_rule_encoding_matches_apply_rule_planes_for_every_survive_set(born, paths):
    assert _hold_every_set(frozenset(born), vary_born=False) == paths


def test_rule_encoding_sizes_the_lookup_to_the_rule():
    enc = cs._generations_rule_encoding
    assert enc(t_rules.CONWAY) == ((2, 0, 1), (3, 1, 1))
    assert enc(t_rules.HIGHLIFE) == ((2, 0, 1), (3, 1, 1), (6, 1, 0))
    assert enc(t_rules.parse_rule("B3/S245")) == (
        (2, 0, 1), (3, 1, 0), (4, 0, 1), (5, 0, 1))
    assert enc(t_rules.parse_rule("B1/S1")) == ((1, 1, 1),)
    # the table: count 0 or 8 named, more than four counts, or none
    for name in ["B03/S23", "B3/S238", "B3678/S34678", "B36/S125"]:
        assert enc(t_rules.parse_rule(name)) == (), name
    assert enc(t_rules.Rule(born=frozenset(), survive=frozenset())) == ()


def test_default_tiles_fill_whole_warps():
    # 58 words plus a halo word per side: two warps of 30 written words
    assert cs._resolve(None, None) == (cs.DEFAULT_GENS_PER_CALL,) + cs.DEFAULT_TILE
    assert cs.DEFAULT_TILE[1] == 58 and cs.DEFAULT_BAND_GENS_PER_CALL == 8
    for g in (1, 8, 16, 32):
        _, th, tw = cs._resolve(g, None)
        assert cs._packed_smem(g)(th, tw) <= cs._SMEM_LIMIT
    # a lane of 1024-cell rows takes the row form: the tile spans the 32
    # words, its rows split the grid evenly
    g, th, tw = cs._resolve_lane(8, 1024, 32, None)
    assert tw == 32 and -(-1024 // th) * th - 1024 < -(-1024 // th)
    assert cs._resolve_lane(8, 16384, 512, None) == (8, 193, 58)
    assert cs.supported_lane((1024, 32), 8, batch=256)
    assert not cs.supported_lane((7, 32), 8)            # g > H
    assert not cs.supported_lane((1024, 32), 8, batch=70000)


def _batch(shape, seed):
    words = np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return words, torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_lane_plain_version_matches_the_jax_masked_batched_runner(topology):
    """19 generations at g = 8 and 5 (chunks of 8, 8, 3 and 5, 5, 5, 4) on
    five 24-row universes, two of them frozen, B3/S23 and a B0 rule."""
    words, t = _batch((5, 24, 3), seed=31)
    mask = np.array([1, 0, 1, 1, 0], np.uint32)
    mesh = j_batched.make_batch_mesh((1, 1, 1), jax.devices()[:1])
    for rule in ("conway", "B0123478/S01234678"):
        j_run = j_batched.make_multi_step_packed_batched(
            mesh, j_rules.parse_rule(rule), JTop(topology), masked=True)
        want = np.asarray(j_run(jnp.asarray(words), 19, jnp.asarray(mask)))
        for g in (8, 5):
            got = t
            for gens in cs._launch_plan(19, g):
                got = cs.lane_step_reference(
                    got, gens, rule=t_rules.parse_rule(rule),
                    topology=TTop(topology), mask=mask)
            np.testing.assert_array_equal(_u32(got), want, err_msg=f"{rule} g={g}")
            np.testing.assert_array_equal(_u32(got)[[1, 4]], words[[1, 4]])
            via_runner = t_batched.multi_step_kernel_batched(
                t, 19, mask, rule=t_rules.parse_rule(rule),
                topology=TTop(topology), gens_per_exchange=g)
            assert torch.equal(via_runner, got)


def test_lane_wrapper_runs_the_plain_version_on_the_cpu_only():
    _, t = _batch((3, 16, 2), seed=32)
    before = cs.SLAB_LAUNCHES
    got = cs.multi_step_lane_kernel(t, 4, [1, 0, 1], rule=t_rules.CONWAY,
                                    gens_per_call=4)
    assert cs.SLAB_LAUNCHES == before   # no kernel on the CPU
    assert torch.equal(got, cs.lane_step_reference(
        t, 4, rule=t_rules.CONWAY, mask=torch.tensor([1, 0, 1])))
    assert torch.equal(got[1], t[1])
    run = cs.multi_step_lane_kernel
    with pytest.raises(ValueError, match="no kernel for device"):
        run(t.to("meta"), 4, rule=t_rules.CONWAY)
    with pytest.raises(ValueError, match="exceeds the band height"):
        run(t, 17, rule=t_rules.CONWAY, gens_per_call=17)
    with pytest.raises(ValueError, match="mask"):
        run(t, 4, [1, 1], rule=t_rules.CONWAY)
    with pytest.raises(ValueError, match="3D"):
        run(t[0], 4, rule=t_rules.CONWAY)


def _grid(h, w, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(h, w), dtype=np.uint8)


def _both(cells):
    from gameoflifewithactors_tpu.ops import bitpack as j_bitpack

    jp = j_bitpack.pack(jnp.asarray(cells))
    return jp, torch.from_numpy(np.asarray(jp).view(np.int32).copy())


# the default depth and tile (larger than the grid: one tile, wrapped),
# and ragged tiles that split neither axis
@pytest.mark.parametrize("rule", ["conway", "B03/S23"])
def test_plain_version_matches_pallas_interpret_at_depth(rule):
    jp, tp = _both(_grid(64, 96, seed=33))
    for topology in ("torus", "dead"):
        for g, tile in [(None, None), (8, (7, 2)), (16, (11, 1))]:
            n = 2 * (g or cs.DEFAULT_GENS_PER_CALL) + 3
            want = ps.multi_step_pallas(
                jp, n, rule=j_rules.parse_rule(rule), topology=JTop(topology),
                block_rows=16, gens_per_call=8, interpret=True)
            got = cs.multi_step_reference(
                tp, n, rule=t_rules.parse_rule(rule), topology=TTop(topology),
                gens_per_call=g, tile=tile)
            np.testing.assert_array_equal(_u32(got), np.asarray(want),
                                          err_msg=f"{rule} {topology} g={g} {tile}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_slab_plain_version_matches_pallas_slab_at_depth(topology):
    """Four bands with edge codes 0-3 (one per band) against the JAX slab
    step per band, at the bands' default depth and tile and a ragged tile,
    B3/S23 and HighLife (the equality path) and a B0 rule (the table)."""
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    g = cs.DEFAULT_BAND_GENS_PER_CALL
    words, t = _batch((4, 32 + 2 * g, 3), seed=34)
    for rule in ("conway", "highlife", "B0123478/S01234678"):
        for tile in (None, (9, 2)):
            got = _u32(cs.slab_step_reference(
                t, g, rule=t_rules.parse_rule(rule), topology=TTop(topology),
                edge_code=codes, tile=tile))
            for k in range(4):
                step = ps.make_pallas_slab_step(
                    j_rules.parse_rule(rule), JTop(topology), words[k].shape,
                    gens=g, block_rows=16, interpret=True, dead_band=True)
                want = np.asarray(step(jnp.asarray(words[k]),
                                       jnp.full((1, 1), k, jnp.int32)))
                np.testing.assert_array_equal(
                    got[k], want, err_msg=f"{rule} {tile} code={k}")
