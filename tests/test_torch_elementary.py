"""The port's elementary (1D Wolfram) family -- rule model, packed SWAR
stepping, the spacetime diagram and the sharded runner -- against a numpy
truth-table reference and against the JAX package on the CPU (its 8 fake
devices for the sharded runner). Rows are made with numpy from a seed;
words are integers, so the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import elementary as t_elem
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.ops import elementary as t_ops
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.parallel import sharded as t_sharded
from gameoflifewithactors_tpu.models import elementary as j_elem
from gameoflifewithactors_tpu.ops import elementary as j_ops
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import sharded as j_sharded

SAMPLE = (0, 30, 90, 110, 150, 184, 255)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _truth_table_step(cells, rule, topology):
    """One generation of (..., W) uint8 cells from the rule's 8-entry
    truth table (``pattern_bit``), with rolled neighbours under TORUS and
    zeros past the ends under DEAD."""
    left = np.roll(cells, 1, axis=-1)
    right = np.roll(cells, -1, axis=-1)
    if topology == "dead":
        left[..., 0] = 0
        right[..., -1] = 0
    table = np.array([rule.pattern_bit((k >> 2) & 1, (k >> 1) & 1, k & 1)
                      for k in range(8)], np.uint8)
    return table[(left.astype(np.intp) << 2) | (cells << 1) | right]


def _unpack(words):
    return t_bitpack.unpack_np(words.reshape(-1, words.shape[-1])).reshape(
        words.shape[:-1] + (-1,))


def test_rule_model_matches_jax():
    for n in range(256):
        got, want = t_elem.ElementaryRule(n), j_elem.ElementaryRule(n)
        assert (got.notation, str(got)) == (want.notation, str(want))
        assert [got.pattern_bit(k >> 2, (k >> 1) & 1, k & 1) for k in range(8)] \
            == [want.pattern_bit(k >> 2, (k >> 1) & 1, k & 1) for k in range(8)]
    for spec in ["W110", "rule30", "w 90", "RULE255", t_elem.RULE_90]:
        assert t_elem.parse_elementary(spec).number == \
            j_elem.parse_elementary(str(spec)).number
    for bad in ["W256", "rule", "B3/S23", "W-1"]:
        with pytest.raises(ValueError) as j_err:
            j_elem.parse_elementary(bad)
        with pytest.raises(ValueError) as t_err:
            t_elem.parse_elementary(bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="0..255"):
        t_elem.ElementaryRule(256)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_every_rule_matches_the_truth_table(topology):
    """All 256 rules, three generations of four (64-word) universes."""
    words = _words((4, 64), 3)
    cells = _unpack(words)
    for n in range(256):
        rule = t_elem.ElementaryRule(n)
        got = t_ops.multi_step_elementary(_t(words), 3, rule=rule,
                                          topology=TTop(topology))
        want = cells
        for _ in range(3):
            want = _truth_table_step(want, rule, topology)
        np.testing.assert_array_equal(_unpack(_u32(got)), want,
                                      err_msg=f"W{n}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_sample_rules_match_jax(topology):
    """step, multi_step and the spacetime diagram, bit for bit, on a
    (3, 2, 4)-word ensemble (two leading axes of universes)."""
    words = _words((3, 2, 4), 11)
    for n in SAMPLE:
        t_rule, j_rule = t_elem.ElementaryRule(n), j_elem.ElementaryRule(n)
        kw_t = dict(rule=t_rule, topology=TTop(topology))
        kw_j = dict(rule=j_rule, topology=JTop(topology))
        np.testing.assert_array_equal(
            _u32(t_ops.step_elementary(_t(words), **kw_t)),
            np.asarray(j_ops.step_elementary(jnp.asarray(words), **kw_j)))
        np.testing.assert_array_equal(
            _u32(t_ops.multi_step_elementary(_t(words), 9, **kw_t)),
            np.asarray(j_ops.multi_step_elementary(jnp.asarray(words), 9,
                                                   **kw_j)))
        got = t_ops.evolve_spacetime(_t(words[0, 0]), 12, **kw_t)
        want = np.asarray(j_ops.evolve_spacetime(jnp.asarray(words[0, 0]), 12,
                                                 **kw_j))
        assert got.shape == (13, 4)
        np.testing.assert_array_equal(_u32(got), want, err_msg=f"W{n}")


def test_steppers_leave_their_input_and_row_zero_alone():
    words = _t(_words((2, 3), 5))
    before = words.clone()
    same = t_ops.multi_step_elementary(words, 0, rule=t_elem.RULE_30)
    assert torch.equal(same, before) and same.data_ptr() != words.data_ptr()
    st = t_ops.evolve_spacetime(words, 5, rule=t_elem.RULE_110)
    assert torch.equal(st[0], before) and torch.equal(words, before)
    assert torch.equal(st[5], t_ops.multi_step_elementary(
        words, 5, rule=t_elem.RULE_110))
    with pytest.raises(ValueError, match="negative"):
        t_ops.multi_step_elementary(words, -1, rule=t_elem.RULE_30)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_sharded_runner_matches_jax(shape, topology):
    """The width over the mesh's column axis (rows, independent universes,
    over its row axis), g = 8, three chunks, against JAX's runner and
    against 24 single-device generations."""
    n = shape[0] * shape[1]
    tm = t_mesh.make_mesh(shape, ["cpu"] * n)
    jm = j_mesh.make_mesh(shape, jax.devices()[:n])
    words = _words((4, 8), 17)
    for num in (110, 30):
        t_run = t_sharded.make_multi_step_elementary_sharded(
            tm, t_elem.ElementaryRule(num), TTop(topology), gens_per_exchange=8)
        j_run = j_sharded.make_multi_step_elementary_sharded(
            jm, j_elem.ElementaryRule(num), JTop(topology), gens_per_exchange=8)
        got = t_run(t_mesh.device_put_sharded_grid(_t(words), tm), 3)
        assert not got.banded and len(got.blocks()) == n
        want = np.asarray(j_run(
            j_mesh.device_put_sharded_grid(jnp.asarray(words), jm), 3))
        np.testing.assert_array_equal(_u32(got.gather()), want)
        single = t_ops.multi_step_elementary(
            _t(words), 24, rule=t_elem.ElementaryRule(num),
            topology=TTop(topology))
        np.testing.assert_array_equal(_u32(got.gather()), _u32(single))


def test_sharded_runner_bounds_g():
    tm = t_mesh.make_mesh((1, 4), ["cpu"] * 4)
    jm = j_mesh.make_mesh((1, 4), jax.devices()[:4])
    for g in (0, 33):
        with pytest.raises(ValueError) as j_err:
            j_sharded.make_multi_step_elementary_sharded(
                jm, j_elem.RULE_110, gens_per_exchange=g)
        with pytest.raises(ValueError) as t_err:
            t_sharded.make_multi_step_elementary_sharded(
                tm, t_elem.RULE_110, gens_per_exchange=g)
        assert str(t_err.value) == str(j_err.value)
    for g in (1, 32):   # the bounds themselves run, bit for bit
        run = t_sharded.make_multi_step_elementary_sharded(
            tm, t_elem.RULE_90, TTop("dead"), gens_per_exchange=g)
        words = _words((2, 4), 23)
        got = run(t_mesh.device_put_sharded_grid(_t(words), tm), 2).gather()
        assert torch.equal(got, t_ops.multi_step_elementary(
            _t(words), 2 * g, rule=t_elem.RULE_90, topology=TTop("dead")))
