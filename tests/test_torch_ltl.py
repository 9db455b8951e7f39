"""The port's Larger-than-Life family — rule model, dense stepper, bit-sliced
packed stepper and the C >= 3 plane stack — against the JAX package on
the CPU. Inputs are made with numpy from a seed and handed to both
packages; states and words are integers, so the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import generations as t_gen
from gameoflifewithactors_torch.models import ltl as t_ltl
from gameoflifewithactors_torch.ops import ltl as t_dense
from gameoflifewithactors_torch.ops import packed_generations as t_pg
from gameoflifewithactors_torch.ops import packed_ltl as t_pl
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import generations as j_gen
from gameoflifewithactors_tpu.models import ltl as j_ltl
from gameoflifewithactors_tpu.ops import ltl as j_dense
from gameoflifewithactors_tpu.ops import packed_generations as j_pg
from gameoflifewithactors_tpu.ops import packed_ltl as j_pl
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop

BINARY = ["bosco", "majority", "R1,C0,M0,S2..3,B3..3",
          "R2,C0,M0,S6..11,B6..9,NN", "R3,C0,M1,S5..12,B6..9,NN",
          "R2,C2,S6-9,12-14,B7-8", "R1,C2,S,B1-8"]
MULTISTATE = ["R2,C3,M1,S3..8,B5..9", "R2,C4,M0,S3..8,B5..9,NN",
              "R1,C5,M1,S2..4,B3..3", "R3,C8,M1,S8..20,B9..14"]


def _key(rule):
    return (rule.radius, rule.born_intervals, rule.survive_intervals,
            rule.middle, rule.neighborhood, rule.states, rule.notation,
            rule.window_size)


def _words(h, wp, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=(h, wp),
                                             dtype=np.uint32)
    return jnp.asarray(w), torch.from_numpy(w.view(np.int32).copy())


def _same_words(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_parse_parity_for_every_name_and_notation_form():
    specs = list(j_ltl.LTL_REGISTRY) + BINARY + MULTISTATE + [
        "R5, C0, M1, S34..58, B34..45", "r5,c0,m1,s34..58,b34..45",
        "R3,C0,M1,S5..12,B6..9,NM", "R2,C2,S2,4-6,B5,7..8", "R2,C1,M1,S3..8,B5..9",
        "R1,C256,M0,S2..3,B3..3", "R1,C2,S,B1-8"]
    for spec in specs:
        got, want = t_gen.parse_any(spec), j_gen.parse_any(spec)
        assert _key(got) == _key(want), spec
        assert _key(t_ltl.parse_ltl(spec)) == _key(j_ltl.parse_ltl(spec)), spec
        assert t_ltl.parse_ltl(got.notation) == got
    assert sorted(t_ltl.LTL_REGISTRY) == sorted(j_ltl.LTL_REGISTRY)
    assert t_ltl.BOSCO.notation == "R5,C0,M1,S34..58,B34..45"
    assert t_ltl.LtLRule(radius=2, born=((3, 5),), survive=((2, 3),)) == \
        t_ltl.LtLRule(radius=2, born=(3, 5), survive=(2, 3))


def test_error_parity():
    bad_specs = ["R8,C0,M1,S1..2,B1..2", "R0,C0,M1,S1..2,B1..2",
                 "R2,C300,M1,S1..2,B1..2", "R2,C2,S4-6,2,B7", "R2,C2,S2-4,5-6,B7",
                 "R2,C2,B7", "R2,C0,M2,S1,B1", "R2,Cx,S1,B1", "R1,C0,M1,S1..20,B1",
                 "R2,C0,M1,S1..2,B1..2,NX", "R2,C0,M1,S1..2,B3..1"]
    for bad in bad_specs:
        with pytest.raises(ValueError) as j_err:
            j_ltl.parse_ltl(bad)
        with pytest.raises(ValueError) as t_err:
            t_ltl.parse_ltl(bad)
        assert str(t_err.value) == str(j_err.value), bad
    for kwargs in [dict(radius=8), dict(states=257), dict(neighborhood="X"),
                   dict(born=((1, 3), (2, 5))), dict(born=(0, 30), neighborhood="N",
                                                     radius=3), dict(born=[1, 2])]:
        args = dict(radius=2, born=(3, 5), survive=(3, 5))
        args.update(kwargs)
        with pytest.raises(ValueError) as j_err:
            j_ltl.LtLRule(**args)
        with pytest.raises(ValueError) as t_err:
            t_ltl.LtLRule(**args)
        assert str(t_err.value) == str(j_err.value), kwargs


def test_window_sums_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2, size=(30, 26), dtype=np.uint8)
    for k in (1, 2, 3, 5, 11, 15):
        for axis in (0, 1):
            np.testing.assert_array_equal(
                t_dense.sliding_sum(torch.from_numpy(x).to(torch.int32), k, axis).numpy(),
                np.asarray(j_dense.sliding_sum(jnp.asarray(x, jnp.int32), k, axis)))
    for r in (1, 3, 7):
        ext = x[:16 + 2 * r, :10 + 2 * r] if r < 7 else x[:, :]
        for fn in ("box_sums_ext", "diamond_sums_ext"):
            np.testing.assert_array_equal(
                getattr(t_dense, fn)(torch.from_numpy(ext), r).numpy(),
                np.asarray(getattr(j_dense, fn)(jnp.asarray(ext), r)), err_msg=fn)
    with pytest.raises(ValueError):
        t_dense.sliding_sum(torch.zeros(4, 4, dtype=torch.int32), 5, 0)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_dense_stepper_matches_jax(topology):
    for i, name in enumerate(BINARY + MULTISTATE):
        rule, jrule = t_gen.parse_any(name), j_gen.parse_any(name)
        cells = np.random.default_rng(i).integers(0, rule.states, size=(20, 24),
                                                  dtype=np.uint8)
        got = t_dense.multi_step_ltl(torch.from_numpy(cells), 4, rule=rule,
                                     topology=TTop(topology))
        want = j_dense.multi_step_ltl(jnp.asarray(cells), 4, rule=jrule,
                                      topology=JTop(topology))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # a torus narrower than the radius wraps more than once
    rule = t_gen.parse_any("R5,C0,M1,S3..9,B3..6")
    cells = np.random.default_rng(9).integers(0, 2, size=(3, 4), dtype=np.uint8)
    np.testing.assert_array_equal(
        t_dense.step_ltl(torch.from_numpy(cells), rule=rule).numpy(),
        np.asarray(j_dense.step_ltl(jnp.asarray(cells),
                                    rule=j_gen.parse_any("R5,C0,M1,S3..9,B3..6"))))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_packed_stepper_matches_jax(topology):
    for i, name in enumerate(BINARY):
        rule, jrule = t_gen.parse_any(name), j_gen.parse_any(name)
        # widths narrower and wider than the halo; XLA takes minutes to
        # compile the JAX reference for the HROT list rule one word wide
        for wp in ((3,) if "-" in name else (1, 3)):
            jp, tp = _words(24, wp, seed=10 * i + wp)
            got = t_pl.multi_step_ltl_packed(tp, 3, rule=rule,
                                             topology=TTop(topology))
            want = j_pl.multi_step_ltl_packed(jp, 3, rule=jrule,
                                              topology=JTop(topology))
            _same_words(got, want)


def test_slab_and_ext_steps_match_jax():
    for i, name in enumerate(BINARY):
        rule, jrule = t_gen.parse_any(name), j_gen.parse_any(name)
        r = rule.radius
        jp, tp = _words(12 + 2 * r, 4, seed=50 + i)
        for top in ("torus", "dead"):
            _same_words(t_pl.step_ltl_packed_slab(tp, rule, TTop(top)),
                        j_pl.step_ltl_packed_slab(jp, jrule, JTop(top)))
        _same_words(t_pl.step_ltl_packed_ext(tp, rule),
                    j_pl.step_ltl_packed_ext(jp, jrule))
    with pytest.raises(ValueError, match="1 bit/cell"):
        t_pl.step_ltl_packed(tp, t_gen.parse_any(MULTISTATE[0]), TTop.TORUS)


def test_bit_sliced_helpers_match_jax():
    jp, tp = _words(6, 3, seed=2)
    jq, tq = _words(6, 3, seed=3)
    for d in (0, 1, 5, 31, 32, 33, 70):
        for top in ("torus", "dead"):
            for fn in ("hshift_west", "hshift_east"):
                _same_words(getattr(t_pl, fn)(tp, d, TTop(top)),
                            getattr(j_pl, fn)(jp, d, JTop(top)))
            _same_words(t_pl.vshift(tp, d % 7 - 3, TTop(top)),
                        j_pl.vshift(jp, d % 7 - 3, JTop(top)))
    for got, want in zip(t_pl.bs_add([tp, tq], [tq]), j_pl.bs_add([jp, jq], [jq])):
        _same_words(got, want)
    for got, want in zip(t_pl.bs_sub_bit([tp, tq], tp & tq),
                         j_pl.bs_sub_bit([jp, jq], jp & jq)):
        _same_words(got, want)
    for c in (-1, 0, 1, 2, 3, 4, 9):
        _same_words(t_pl.bs_ge([tp, tq], c), j_pl.bs_ge([jp, jq], c))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_plane_stack_stepper_matches_jax(topology):
    for i, name in enumerate(MULTISTATE):
        rule, jrule = t_gen.parse_any(name), j_gen.parse_any(name)
        cells = np.random.default_rng(60 + i).integers(0, rule.states,
                                                       size=(20, 64), dtype=np.uint8)
        jp = j_pg.pack_generations_for(jnp.asarray(cells), jrule)
        tp = t_pg.pack_generations_for(torch.from_numpy(cells), rule)
        _same_words(tp, jp)
        got = t_pl.multi_step_ltl_planes(tp, 3, rule=rule, topology=TTop(topology))
        want = j_pl.multi_step_ltl_planes(jp, 3, rule=jrule, topology=JTop(topology))
        _same_words(got, want)
        b = tp.shape[0]
        _same_words(torch.stack(t_pl.step_ltl_planes_slab(
                        tuple(tp[j] for j in range(b)), rule, TTop(topology))),
                    jnp.stack(j_pl.step_ltl_planes_slab(
                        tuple(jp[j] for j in range(b)), jrule, JTop(topology))))
        if topology == "torus":
            _same_words(torch.stack(t_pl.step_ltl_planes_ext(
                            tuple(tp[j] for j in range(b)), rule)),
                        jnp.stack(j_pl.step_ltl_planes_ext(
                            tuple(jp[j] for j in range(b)), jrule)))
    with pytest.raises(ValueError, match="C >= 3"):
        t_pl.step_ltl_planes((tp[0],), t_gen.parse_any("bosco"), TTop.TORUS)
