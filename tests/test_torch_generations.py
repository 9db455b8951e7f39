"""The port's Generations family — rule model, dense stepper, bit-plane
stack — and the multi-state RLE reading, against the JAX package on the
CPU. Inputs are made with numpy from a seed and handed to both packages;
states and words are integers, so the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import generations as t_gen
from gameoflifewithactors_torch.models import seeds as t_seeds
from gameoflifewithactors_torch.models.rules import Rule as TRule
from gameoflifewithactors_torch.ops import generations as t_dense
from gameoflifewithactors_torch.ops import packed_generations as t_pg
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import generations as j_gen
from gameoflifewithactors_tpu.models import seeds as j_seeds
from gameoflifewithactors_tpu.ops import generations as j_dense
from gameoflifewithactors_tpu.ops import packed_generations as j_pg
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop

# C = 3, 4, 5, 8 and 256: b = 2, 2, 3, 3 and 8 planes; 2**b == C for 4 and 8
RULES = ["brain", "starwars", "B2/S34/C5", "belzhab", "B3/S23/C256"]


def _cells(rule, h, w, seed):
    return np.random.default_rng(seed).integers(0, rule.states, size=(h, w),
                                                dtype=np.uint8)


def _stack(cells, rule):
    """The JAX stack and the port's stack of the same cells."""
    jp = j_pg.pack_generations_for(jnp.asarray(cells), j_gen.parse_any(rule))
    return jp, torch.from_numpy(np.asarray(jp).view(np.int32).copy())


def _same_words(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def _key(rule):
    return (sorted(rule.born), sorted(rule.survive), rule.states, rule.notation)


def test_parse_parity_for_every_name_and_notation_form():
    specs = list(j_gen.GENERATIONS_REGISTRY) + [
        "B2/S/C3", "b2/s/g3", "B2 / S / C3", "2/3/3", "/2/3", "345/2/4",
        "B34/S12/C3", "B3/S23/C256", "BRAIN", "Star Wars"]
    for spec in specs:
        assert _key(t_gen.parse_any(spec)) == _key(j_gen.parse_any(spec)), spec
        assert _key(t_gen.parse_generations(spec)) == \
            _key(j_gen.parse_generations(spec)), spec
    assert sorted(t_gen.GENERATIONS_REGISTRY) == sorted(j_gen.GENERATIONS_REGISTRY)
    brain = t_gen.BRIANS_BRAIN
    assert t_gen.parse_any(brain) is brain
    assert (brain.birth_mask, brain.survive_mask, str(brain)) == (4, 0, "B2/S/C3")
    assert isinstance(t_gen.parse_any("B3/S23"), TRule)


def test_error_parity():
    for bad in ["B2/S/C2", "B2/S/C300", "B2/S/C1", "B9/S/C3", "B2/S", "2/3",
                "nonsense/3/3", "B2/S/Cx"]:
        with pytest.raises(ValueError) as j_err:
            j_gen.parse_generations(bad)
        with pytest.raises(ValueError) as t_err:
            t_gen.parse_generations(bad)
        assert str(t_err.value) == str(j_err.value)
    for states in (2, 257):
        with pytest.raises(ValueError, match="3..256 states"):
            t_gen.GenRule(frozenset({2}), frozenset(), states)
    with pytest.raises(ValueError, match="0..8"):
        t_gen.GenRule(frozenset({9}), frozenset(), 3)
    # the elementary family dispatches as in the JAX package
    for spec in ["W110", "rule30", "Rule 90"]:
        got, want = t_gen.parse_any(spec), j_gen.parse_any(spec)
        assert type(got).__name__ == type(want).__name__ == "ElementaryRule"
        assert (got.number, got.notation) == (want.number, want.notation)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_dense_stepper_matches_jax(topology):
    for i, name in enumerate(RULES):
        rule = t_gen.parse_any(name)
        cells = _cells(rule, 24, 40, seed=i)
        got = t_dense.multi_step_generations(
            torch.from_numpy(cells), 9, rule=rule, topology=TTop(topology))
        want = j_dense.multi_step_generations(
            jnp.asarray(cells), 9, rule=j_gen.parse_any(name),
            topology=JTop(topology))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_decay_select_and_ext_step_match_jax():
    rng = np.random.default_rng(3)
    for states in (3, 5, 256):
        state = rng.integers(0, states, size=(16, 16), dtype=np.uint8)
        born, keep = rng.random((2, 16, 16)) < 0.5
        got = t_dense.decay_select(torch.from_numpy(state), torch.from_numpy(born),
                                   torch.from_numpy(keep), states)
        want = j_dense.decay_select(jnp.asarray(state), jnp.asarray(born),
                                    jnp.asarray(keep), states)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rule = t_gen.parse_any("starwars")
    ext = _cells(rule, 18, 34, seed=4)
    np.testing.assert_array_equal(
        t_dense.step_generations_ext(torch.from_numpy(ext), rule).numpy(),
        np.asarray(j_dense.step_generations_ext(jnp.asarray(ext),
                                                j_gen.parse_any("starwars"))))


def test_plane_stack_layout_matches_jax_word_for_word():
    for i, name in enumerate(RULES):
        rule = t_gen.parse_any(name)
        cells = _cells(rule, 8, 96, seed=10 + i)
        jp, _ = _stack(cells, name)
        tp = t_pg.pack_generations_for(torch.from_numpy(cells), rule)
        assert tp.shape == (t_pg.n_planes(rule.states), 8, 3) == jp.shape
        _same_words(tp, jp)
        np.testing.assert_array_equal(t_pg.unpack_generations(tp).numpy(), cells)
        np.testing.assert_array_equal(t_pg.unpack_generations_np(np.asarray(jp)),
                                      cells)
        assert t_pg.population_packed_generations(tp) == \
            j_pg.population_packed_generations(jp) == int((cells == 1).sum())
        _same_words(t_pg.alive_plane(tp), j_pg.alive_plane(jp))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_packed_stepper_matches_jax(topology):
    for i, name in enumerate(RULES):
        rule = t_gen.parse_any(name)
        jp, tp = _stack(_cells(rule, 20, 64, seed=20 + i), name)
        got = t_pg.multi_step_packed_generations(tp, 11, rule=rule,
                                                 topology=TTop(topology))
        want = j_pg.multi_step_packed_generations(
            jp, 11, rule=j_gen.parse_any(name), topology=JTop(topology))
        _same_words(got, want)
        _same_words(t_pg.step_planes(tp, rule, TTop(topology)),
                    j_pg.step_planes(jp, j_gen.parse_any(name), JTop(topology)))


def test_slab_and_ext_steps_match_jax():
    for i, name in enumerate(RULES):
        rule, jrule = t_gen.parse_any(name), j_gen.parse_any(name)
        jp, tp = _stack(_cells(rule, 12, 96, seed=30 + i), name)
        b = tp.shape[0]
        for top in ("torus", "dead"):
            got = t_pg.step_planes_slab(tuple(tp[j] for j in range(b)), rule,
                                        TTop(top))
            want = j_pg.step_planes_slab(tuple(jp[j] for j in range(b)), jrule,
                                         JTop(top))
            _same_words(torch.stack(got), jnp.stack(want))
        got = t_pg.step_planes_ext(tuple(tp[j] for j in range(b)), rule)
        want = j_pg.step_planes_ext(tuple(jp[j] for j in range(b)), jrule)
        _same_words(torch.stack(got), jnp.stack(want))


def test_from_rle_reads_a_golly_generations_pattern_as_the_jax_package_does():
    rle = ("#C Brian's Brain, Golly's extended states\n"
           "x = 5, y = 3, rule = B2/S/C3\n"
           "A.BA$2.pA.B$3AB!\n")
    got = t_seeds.from_rle(rle)
    np.testing.assert_array_equal(got, j_seeds.from_rle(rle))
    np.testing.assert_array_equal(got, [[1, 0, 2, 1, 0], [0, 0, 25, 0, 2],
                                        [1, 1, 1, 2, 0]])
    # Golly's survive/born/states header form and an LtL C>=3 header too
    for header in ["rule = 2/3/4", "rule = R2,C4,M1,S3..8,B5..9"]:
        text = f"x = 3, y = 2, {header}\nA.B$.C!"
        np.testing.assert_array_equal(t_seeds.from_rle(text), j_seeds.from_rle(text))
    # binary headers (and absent or unported ones) keep the b/o reading
    for header in ["rule = B3/S23", "rule = bosco", "rule = W110", ""]:
        text = f"x = 3, y = 2, {header}\nbo$2o!"
        np.testing.assert_array_equal(t_seeds.from_rle(text), j_seeds.from_rle(text))
    grid = _cells(t_gen.BELZHAB, 6, 9, seed=5)
    text = t_seeds.to_rle(grid, rule="belzhab")
    np.testing.assert_array_equal(t_seeds.from_rle(text), grid)
    np.testing.assert_array_equal(j_seeds.from_rle(text), grid)
