"""The counting order of the LtL kernel (B4), in plain torch, against the
JAX package on the CPU: ``packed_ltl.box_counts_sliding`` (one window sum
per row, a running count down column segments, exact plane counts) equals
JAX's ``packed_ltl.box_counts_packed`` bit for bit at every radius, under
TORUS and DEAD, for segments that do not divide the rows and for grids
shorter and narrower than the window; and the kernel's rule encoding
(distinct boundaries with birth and survival toggles) equals the interval
test on every count. Integers throughout: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import generations as t_gen
from gameoflifewithactors_torch.models.ltl import LtLRule
from gameoflifewithactors_torch.ops import cuda_stencil as cs
from gameoflifewithactors_torch.ops import packed_ltl as t_pl
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.ops import packed_ltl as j_pl
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop


def _words(h, wp, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=(h, wp),
                                             dtype=np.uint32)
    return jnp.asarray(w), torch.from_numpy(w.view(np.int32).copy())


@pytest.mark.parametrize("topology", ["torus", "dead"])
@pytest.mark.parametrize("radius", range(1, 8))
def test_sliding_box_counts_match_jax(radius, topology):
    planes = ((2 * radius + 1) ** 2).bit_length()
    # (37, 3) in segments of 8 and 5 rows (neither divides 37); (5, 1) and
    # (2, 1): shorter than the window and one word wide
    for h, wp, segment in [(37, 3, 8), (37, 3, 5), (5, 1, 3), (2, 1, 64)]:
        jp, tp = _words(h, wp, seed=100 * radius + h + segment)
        got = t_pl.box_counts_sliding(tp, radius, segment, TTop(topology))
        want = [np.asarray(w) for w in j_pl.box_counts_packed(
            jp, radius, JTop(topology))]
        assert len(got) == planes
        for i, plane in enumerate(want):   # JAX's planes past ours are zero
            have = got[i].numpy().view(np.uint32) if i < planes else \
                np.zeros_like(plane)
            np.testing.assert_array_equal(have, plane,
                                          err_msg=f"{(h, wp, segment)} plane {i}")


def test_rule_encoding_matches_the_interval_test():
    rules = [t_gen.parse_any(name) for name in [
        "bosco", "majority", "R2,C2,S6-9,12-14,B7-8,11", "R1,C2,S,B1-8",
        "R3,C0,M0,S10..20,B12..16,NN", "R2,C0,M0,S0..24,B0..0"]] + [
        LtLRule(radius=2, born=((0, 3), (9, 12)), survive=((0, 0), (5, 25))),
        LtLRule(radius=7, born=tuple((2 * k, 2 * k) for k in range(16)),
                survive=(3, 225))]
    for rule in rules:
        bounds, born, keep = cs._ltl_rule_encoding(rule)
        assert bounds == sorted(set(bounds))
        radius, diamond, n, c_bounds, c_born, c_keep = cs._ltl_rule_args(rule)
        assert (radius, diamond) == (rule.radius, rule.neighborhood == "N")
        assert n == len(bounds) and list(c_bounds)[:n] == bounds
        assert list(c_born)[:n] == born and list(c_keep)[:n] == keep
        # the kernel tests the window count, centre included: a dead cell's
        # count is the rule's, a live cell's one more under M0
        for window in range(rule.window_size + 1):
            for toggles, intervals, count in [
                    (born, rule.born_intervals, window),
                    (keep, rule.survive_intervals,
                     window - (0 if rule.middle else 1))]:
                inside = sum(t for t, b in zip(toggles, bounds) if window >= b) % 2
                assert inside == any(lo <= count <= hi for lo, hi in intervals), \
                    (rule.notation, window)
