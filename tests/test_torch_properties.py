"""The property laws of ``tests/test_properties.py`` on the port, each
drawn case also held against the JAX package at tolerance 0.

Hypothesis draws rules (B0 included), shapes, seeds and topologies as the
JAX file does, never more examples per law than it takes. Every drawn
case builds its input with numpy and runs it through the port's function
and the JAX counterpart the JAX law uses (``ops.stencil.step`` or
``ops.packed.step_packed`` and their multi-step runners); cells and words
must be equal. Three laws are the port's own: drawn Generations rules
(C 3..20) on the packed planes, drawn binary Larger-than-Life rules
(radius 1..3, box and diamond, M0 and M1, interval lists) and drawn B/S
rules through B1's plain version at drawn depths and tiles -- the plain
versions are what ``chip_smoke.py``'s rule sweep holds the kernels
against on the card, so these laws close that chain to the JAX package.
Every LtL case uses the JAX package's dense ``ops/ltl.multi_step_ltl``,
never its packed LtL path (XLA's compile of that path can take minutes at
these shapes). ``derandomize=True`` draws the same cases in every run and
``database=None`` writes no ``.hypothesis/``. The JAX shapes that the
cold-cache tests compile (64 x 64 B3/S23 packed) are not drawn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from gameoflifewithactors_torch.models import seeds as t_seeds  # noqa: E402
from gameoflifewithactors_torch.models.generations import \
    GenRule as TGenRule  # noqa: E402
from gameoflifewithactors_torch.models.ltl import LtLRule as TLtLRule  # noqa: E402
from gameoflifewithactors_torch.models.rules import Rule as TRule  # noqa: E402
from gameoflifewithactors_torch.ops import bitpack as t_bitpack  # noqa: E402
from gameoflifewithactors_torch.ops import cuda_stencil as cs  # noqa: E402
from gameoflifewithactors_torch.ops import ltl as t_ltl  # noqa: E402
from gameoflifewithactors_torch.ops import packed as t_packed  # noqa: E402
from gameoflifewithactors_torch.ops import packed_generations as t_gen  # noqa: E402
from gameoflifewithactors_torch.ops import packed_ltl as t_packed_ltl  # noqa: E402
from gameoflifewithactors_torch.ops import stencil as t_stencil  # noqa: E402
from gameoflifewithactors_torch.ops.sparse import \
    SparseEngineState as TSparse  # noqa: E402
from gameoflifewithactors_torch.ops.stencil import Topology as TTop  # noqa: E402
from gameoflifewithactors_tpu.models import seeds as j_seeds  # noqa: E402
from gameoflifewithactors_tpu.models.generations import \
    GenRule as JGenRule  # noqa: E402
from gameoflifewithactors_tpu.models.ltl import LtLRule as JLtLRule  # noqa: E402
from gameoflifewithactors_tpu.models.rules import Rule as JRule  # noqa: E402
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack  # noqa: E402
from gameoflifewithactors_tpu.ops import ltl as j_ltl  # noqa: E402
from gameoflifewithactors_tpu.ops import packed as j_packed  # noqa: E402
from gameoflifewithactors_tpu.ops import packed_generations as j_gen  # noqa: E402
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop  # noqa: E402
from gameoflifewithactors_tpu.ops.stencil import step as j_step  # noqa: E402

# the JAX file's universe of shapes: word-boundary-rich widths, odd heights
SHAPES = [(7, 32), (16, 64), (23, 96)]
DRAWN = dict(derandomize=True, database=None, deadline=None)

counts = st.frozensets(st.integers(0, 8), max_size=9)
rules = st.builds(lambda born, survive: (born, survive), counts, counts)
shapes = st.sampled_from(SHAPES)
seeds_ = st.integers(0, 2**32 - 1)
topologies = st.sampled_from(["torus", "dead"])


@pytest.fixture(autouse=True, scope="module")
def _hypothesis_home(tmp_path_factory):
    """Hypothesis caches the constants it mines from local modules under
    its home directory (``.hypothesis/`` in the working directory unless
    told otherwise): this module's draws keep it in a temporary one."""
    from hypothesis import configuration

    configuration.set_hypothesis_home_dir(tmp_path_factory.mktemp("hypothesis"))
    yield
    configuration.set_hypothesis_home_dir(None)


def _grid(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.uint8)


def _both(rule):
    """A drawn (born, survive) pair as each package's Rule."""
    return TRule(*rule), JRule(*rule)


def _dual(born, survive):
    """Complement duality: B' = {8-k: k not in S}, S' = {8-k: k not in B}."""
    return (frozenset(8 - k for k in range(9) if k not in survive),
            frozenset(8 - k for k in range(9) if k not in born))


def _t_step(g, rule, topology):
    return t_stencil.step(torch.from_numpy(g), rule=TRule(*rule),
                          topology=TTop(topology)).numpy()


def _j_step(g, rule, topology):
    return np.asarray(j_step(jnp.asarray(g), rule=JRule(*rule),
                             topology=JTop(topology)))


def _same_words(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want),
                                  err_msg=msg)


@settings(max_examples=12, **DRAWN)
@given(rule=rules, shape=shapes, seed=seeds_)
def test_complement_duality_dense(rule, shape, seed):
    g = _grid(shape, seed)
    lhs = _t_step(g, rule, "torus")
    rhs = 1 - _t_step(1 - g, _dual(*rule), "torus")
    np.testing.assert_array_equal(lhs, rhs)
    np.testing.assert_array_equal(lhs, _j_step(g, rule, "torus"))


@settings(max_examples=12, **DRAWN)
@given(rule=rules, shape=shapes, seed=seeds_, topology=topologies)
def test_packed_matches_dense_random_rules(rule, shape, seed, topology):
    g = _grid(shape, seed)
    want = _j_step(g, rule, topology)
    np.testing.assert_array_equal(_t_step(g, rule, topology), want)
    t_rule, j_rule = _both(rule)
    got = t_packed.step_packed(t_bitpack.pack(torch.from_numpy(g)), rule=t_rule,
                               topology=TTop(topology))
    np.testing.assert_array_equal(t_bitpack.unpack(got).numpy(), want)
    _same_words(got, j_packed.step_packed(j_bitpack.pack(jnp.asarray(g)),
                                          rule=j_rule, topology=JTop(topology)))


@settings(max_examples=10, **DRAWN)
@given(rule=rules, shape=shapes, seed=seeds_,
       dy=st.integers(-5, 5), dx=st.integers(-33, 33))
def test_translation_equivariance_on_torus(rule, shape, seed, dy, dx):
    """roll(step(g)) == step(roll(g)) on the dense and the packed path
    (dx up to +-33 crosses word seams), and the JAX step agrees."""
    g = _grid(shape, seed)
    rolled = np.roll(g, (dy, dx), axis=(0, 1))
    a = np.roll(_t_step(g, rule, "torus"), (dy, dx), axis=(0, 1))
    b = _t_step(rolled, rule, "torus")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, _j_step(rolled, rule, "torus"))
    bp = t_bitpack.unpack(t_packed.step_packed(
        t_bitpack.pack(torch.from_numpy(rolled)), rule=TRule(*rule),
        topology=TTop.TORUS)).numpy()
    np.testing.assert_array_equal(bp, b)


@settings(max_examples=8, **DRAWN)
@given(rule=rules, topology=topologies)
def test_empty_grid_stays_empty_unless_b0(rule, topology):
    g = np.zeros((8, 32), dtype=np.uint8)
    out = _t_step(g, rule, topology)
    if 0 in rule[0]:
        assert out.sum() > 0
    else:
        assert out.sum() == 0
    np.testing.assert_array_equal(out, _j_step(g, rule, topology))


@settings(max_examples=8, **DRAWN)
@given(rule=rules)
def test_full_torus_is_uniform(rule):
    """Every cell of a full torus has 8 live neighbours: the next grid is
    all ones iff 8 survives."""
    g = np.ones((8, 32), dtype=np.uint8)
    out = _t_step(g, rule, "torus")
    assert (out == (1 if 8 in rule[1] else 0)).all()
    np.testing.assert_array_equal(out, _j_step(g, rule, "torus"))


@settings(max_examples=20, **DRAWN)
@given(shape=shapes, seed=seeds_)
def test_pack_roundtrip_random(shape, seed):
    g = _grid(shape, seed)
    packed = t_bitpack.pack(torch.from_numpy(g))
    np.testing.assert_array_equal(t_bitpack.unpack(packed).numpy(), g)
    np.testing.assert_array_equal(t_bitpack.pack_np(g), packed.numpy().view(np.uint32))
    _same_words(packed, j_bitpack.pack(jnp.asarray(g)))
    np.testing.assert_array_equal(t_bitpack.pack_np(g), j_bitpack.pack_np(g))


# -- multi-state LtL plane stack vs the dense byte paths ----------------------

def _mk_multistate(radius, states, middle, hood, b_lo, b_w, s_lo, s_w):
    """The JAX law's rule: intervals clamped to the rule's own window, born
    off 0 (birth from nothing is the sparse paths' refusal)."""
    win = (2 * radius + 1) ** 2 if hood == "M" else 2 * radius * (radius + 1) + 1
    b_lo = min(max(1, b_lo), win)
    s_lo = min(s_lo, win)
    return dict(radius=radius, states=states, middle=middle, neighborhood=hood,
                born=(b_lo, min(b_lo + b_w, win)),
                survive=(s_lo, min(s_lo + s_w, win)))


_ltl_multistate = st.builds(
    _mk_multistate,
    radius=st.integers(1, 3),
    states=st.integers(3, 8),
    middle=st.booleans(),
    hood=st.sampled_from(["M", "N"]),
    b_lo=st.integers(1, 9), b_w=st.integers(0, 12),
    s_lo=st.integers(0, 9), s_w=st.integers(0, 12),
)


@settings(max_examples=12, **DRAWN)
@given(rule=_ltl_multistate, seed=seeds_, topology=topologies)
def test_ltl_planes_match_dense_for_random_multistate_rules(rule, seed, topology):
    """Any C >= 3 LtL rule: the bit-plane decay stepper equals the port's
    dense byte path and the JAX package's dense ``multi_step_ltl``."""
    t_rule, j_rule = TLtLRule(**rule), JLtLRule(**rule)
    grid = np.random.default_rng(seed).integers(
        0, t_rule.states, size=(24, 64), dtype=np.uint8)
    want = np.asarray(j_ltl.multi_step_ltl(jnp.asarray(grid), 3, rule=j_rule,
                                           topology=JTop(topology)))
    dense = t_ltl.multi_step_ltl(torch.from_numpy(grid), 3, rule=t_rule,
                                 topology=TTop(topology)).numpy()
    np.testing.assert_array_equal(dense, want, err_msg=t_rule.notation)
    planes = t_packed_ltl.multi_step_ltl_planes(
        t_gen.pack_generations_for(torch.from_numpy(grid), t_rule), 3,
        rule=t_rule, topology=TTop(topology))
    np.testing.assert_array_equal(t_gen.unpack_generations(planes).numpy(), want,
                                  err_msg=t_rule.notation)


# -- temporal-chunked sparse engine vs the packed steppers --------------------

@settings(max_examples=8, **DRAWN)
@given(rule=rules.filter(lambda r: 0 not in r[0]),
       seed=seeds_, chunk=st.integers(2, 8), gens=st.integers(1, 19),
       topology=topologies)
def test_chunked_sparse_matches_packed_random_rules(rule, seed, chunk, gens,
                                                    topology):
    """The chunked sparse engine equals the port's packed stepper and the
    JAX package's for drawn non-B0 rules, chunk depths and generation
    counts, ``n % chunk`` remainders and both topologies included."""
    g = _grid((16, 64), seed)
    t_rule, j_rule = _both(rule)
    p = t_bitpack.pack(torch.from_numpy(g))
    state = TSparse(p, t_rule, topology=TTop(topology), chunk_gens=chunk,
                    tile_rows=8, tile_words=1)
    state.step(gens)
    want = j_packed.multi_step_packed(j_bitpack.pack(jnp.asarray(g)), gens,
                                      rule=j_rule, topology=JTop(topology))
    _same_words(state.packed, want)
    _same_words(t_packed.multi_step_packed(p, gens, rule=t_rule,
                                           topology=TTop(topology)), want)


# -- RLE round trip (Golly's extended multi-state tokens included) -----------

@settings(max_examples=25, **DRAWN)
@given(seed=seeds_, h=st.integers(1, 20), w=st.integers(1, 40),
       states=st.sampled_from([2, 3, 5, 26, 200, 256]))
def test_rle_round_trip_random(seed, h, w, states):
    """to_rle/from_rle is the identity in every state range the format
    covers, and the port writes the JAX package's text."""
    g = np.random.default_rng(seed).integers(0, states, size=(h, w),
                                             dtype=np.uint8)
    text = t_seeds.to_rle(g)
    assert text == j_seeds.to_rle(g)
    n = max(states, int(g.max()) + 1)
    np.testing.assert_array_equal(t_seeds.from_rle(text, states=n), g)
    np.testing.assert_array_equal(j_seeds.from_rle(text, states=n), g)


# -- the port's own laws: drawn rules of the other families, B1's plain ------

@settings(max_examples=8, **DRAWN)
@given(rule=rules, states=st.integers(3, 20), shape=shapes, seed=seeds_,
       topology=topologies, n=st.integers(1, 6), g=st.integers(1, 4))
def test_generations_planes_match_jax_for_random_rules(rule, states, shape, seed,
                                                       topology, n, g):
    """Any Generations rule (B0 included, C 3..20): the port's plane
    stepper and B3's plain version at a drawn depth equal the JAX packed
    Generations stepper, word for word in every plane."""
    t_rule, j_rule = TGenRule(*rule, states), JGenRule(*rule, states)
    grid = np.random.default_rng(seed).integers(0, states, size=shape,
                                                dtype=np.uint8)
    want = j_gen.multi_step_packed_generations(
        j_gen.pack_generations_for(jnp.asarray(grid), j_rule), n, rule=j_rule,
        topology=JTop(topology))
    planes = t_gen.pack_generations_for(torch.from_numpy(grid), t_rule)
    _same_words(t_gen.multi_step_packed_generations(
        planes, n, rule=t_rule, topology=TTop(topology)), want, t_rule.notation)
    _same_words(cs.multi_step_generations_reference(
        planes, n, rule=t_rule, topology=TTop(topology), gens_per_call=g,
        tile=(5, 1)), want, t_rule.notation)


def _binary_ltl(radius, hood, middle, born, survive):
    """A binary LtL rule from drawn boundaries: each set's sorted distinct
    values in 0..window + 1 taken in pairs (lo, hi + 1), so the intervals
    are sorted, disjoint and non-adjacent (HROT lists of 1..3)."""
    win = (2 * radius + 1) ** 2 if hood == "M" else 2 * radius * (radius + 1) + 1

    def intervals(values):
        bounds = sorted({v % (win + 2) for v in values})
        if len(bounds) < 2:
            bounds = [bounds[0] // 2, bounds[0] // 2 + 1] if bounds else [1, 2]
        bounds = bounds[:len(bounds) // 2 * 2]
        return tuple((bounds[i], bounds[i + 1] - 1)
                     for i in range(0, len(bounds), 2))

    return dict(radius=radius, neighborhood=hood, middle=middle,
                born=intervals(born), survive=intervals(survive))


_ltl_binary = st.builds(
    _binary_ltl,
    radius=st.integers(1, 3),
    hood=st.sampled_from(["M", "N"]),
    middle=st.booleans(),
    born=st.lists(st.integers(0, 60), min_size=2, max_size=6),
    survive=st.lists(st.integers(0, 60), min_size=2, max_size=6),
)


@settings(max_examples=8, **DRAWN)
@given(rule=_ltl_binary, shape=shapes, seed=seeds_, topology=topologies,
       n=st.integers(1, 4), g=st.integers(1, 3))
def test_binary_ltl_matches_jax_dense_for_random_rules(rule, shape, seed,
                                                       topology, n, g):
    """Any binary LtL rule (radius 1..3, box and diamond, M0 and M1, born
    0 allowed): the port's dense and packed steppers and B4's plain
    version at a drawn depth equal the JAX package's dense stepper."""
    t_rule, j_rule = TLtLRule(**rule), JLtLRule(**rule)
    g_ = _grid(shape, seed)
    want = np.asarray(j_ltl.multi_step_ltl(jnp.asarray(g_), n, rule=j_rule,
                                           topology=JTop(topology)))
    msg = t_rule.notation
    np.testing.assert_array_equal(t_ltl.multi_step_ltl(
        torch.from_numpy(g_), n, rule=t_rule, topology=TTop(topology)).numpy(),
        want, err_msg=msg)
    p = t_bitpack.pack(torch.from_numpy(g_))
    np.testing.assert_array_equal(t_bitpack.unpack(t_packed_ltl.multi_step_ltl_packed(
        p, n, rule=t_rule, topology=TTop(topology))).numpy(), want, err_msg=msg)
    np.testing.assert_array_equal(t_bitpack.unpack(cs.multi_step_ltl_reference(
        p, n, rule=t_rule, topology=TTop(topology), gens_per_call=g,
        tile=(6, 1))).numpy(), want, err_msg=msg)


@settings(max_examples=8, **DRAWN)
@given(rule=rules, shape=shapes, seed=seeds_, topology=topologies,
       n=st.integers(1, 12), g=st.integers(1, 5), th=st.integers(1, 9),
       tw=st.integers(1, 3))
def test_b1_plain_version_matches_jax_for_random_rules(rule, shape, seed,
                                                       topology, n, g, th, tw):
    """B1's plain version (the kernel's tiles, halos and shorter last
    launch in plain torch) equals the JAX packed multi-step runner for any
    B/S rule, depth and tile."""
    t_rule, j_rule = _both(rule)
    g_ = _grid(shape, seed)
    want = j_packed.multi_step_packed(j_bitpack.pack(jnp.asarray(g_)), n,
                                      rule=j_rule, topology=JTop(topology))
    p = t_bitpack.pack(torch.from_numpy(g_))
    _same_words(cs.multi_step_reference(p, n, rule=t_rule, topology=TTop(topology),
                                        gens_per_call=g, tile=(th, tw)),
                want, t_rule.notation)


def test_card_sweep_draws_cover_every_kernel_form():
    """``chip_smoke.py``'s rule sweep, drawn here without a card: at least
    200 B/S rules (B0 among them) under both topologies, 100 Generations
    rules over b = 2..8 planes, 100 binary LtL rules over radius 1..7, box
    and diamond, M0 and M1, with interval lists that the kernel refuses
    among them; every multi-launch case hits the ``n % g`` launch, and
    the slab and lane forms meet per-band edge codes, masks and refusals.
    The draw is a function of its seed alone."""
    import chip_smoke

    draws = chip_smoke.draw_rule_sweep(chip_smoke.RULE_SWEEP_SEED)
    again = chip_smoke.draw_rule_sweep(chip_smoke.RULE_SWEEP_SEED)
    assert [[str(c) for c in cases] for cases in draws.values()] == \
        [[str(c) for c in cases] for cases in again.values()]
    assert set(draws) == set(chip_smoke.SWEEP_FORMS)
    bs = draws["life_packed"]
    assert len({c["rule"] for c in bs}) >= 200
    assert any(0 in c["rule"].born for c in bs)
    assert {(c["rule"], c["topology"].value) for c in bs} == \
        {(c["rule"], t) for c in bs for t in ("torus", "dead")}
    gen = draws["life_generations"] + draws["life_generations_slab"]
    assert len({c["rule"] for c in draws["life_generations"]}) >= 100
    assert {t_gen.n_planes(c["rule"].states) for c in gen} == set(range(2, 9))
    ltl = draws["life_ltl"]
    assert len({c["rule"] for c in ltl}) >= 100
    assert {(c["rule"].radius, c["rule"].neighborhood, c["rule"].middle)
            for c in ltl} >= {(r, h, m) for r in (1, 7) for h in "MN"
                              for m in (False, True)}
    fits = [cs._ltl_rule_fits(c["rule"]) for c in ltl]
    assert any(fits) and not all(fits)
    for form in ("life_packed", "life_slab_lane", "life_generations", "life_ltl"):
        assert all(c["n"] % c["g"] for c in draws[form] if c["g"] > 1)
    assert any(isinstance(c["code"], list) for c in draws["life_slab"])
    lane = draws["life_slab_lane"]
    assert any(c["mask"] is not None and 0 in c["mask"] for c in lane)
    assert any(c["g"] > c["shape"][1] for c in lane)      # refused: g > H
    for cases in draws.values():
        for c in cases:
            assert c["shape"][-2] <= 255 + 2 * 7 * 32 and c["shape"][-1] <= 16
