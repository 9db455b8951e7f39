"""The batch-of-universes runners and the lanes built on them, against the
JAX package on a (1, 1, 1) mesh: the plain masked runner against
``make_multi_step_packed_batched``, the B2 runner (its plain version on
the CPU) against ``make_multi_step_pallas_batched(interpret=True)``, and
a ``"cuda"`` lane stepping ``n`` generations, ``n`` not a multiple of
``g``, against the JAX ``"packed"`` lane. Integers: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import rules as t_rules
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_torch.parallel import batched as t_batched
from gameoflifewithactors_torch.parallel.halo import (band_edge_code,
                                                      exchange_halo_stack,
                                                      exchange_rows_stack)
from gameoflifewithactors_torch.serve import lanes as t_lanes
from gameoflifewithactors_tpu.models import rules as j_rules
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.parallel import batched as j_batched
from gameoflifewithactors_tpu.serve import lanes as j_lanes

B0_RULE = "B0123478/S01234678"
MASK = np.array([1, 0, 1], np.uint32)


def _mesh():
    return j_batched.make_batch_mesh((1, 1, 1), jax.devices()[:1])


def _batch(shape, seed):
    words = np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return words, torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("topology", ["torus", "dead"])
@pytest.mark.parametrize("masked", [False, True])
def test_packed_batched_matches_jax(topology, masked):
    words, t = _batch((3, 16, 2), seed=21)
    for rule in ("conway", B0_RULE):
        j_run = j_batched.make_multi_step_packed_batched(
            _mesh(), j_rules.parse_rule(rule), JTop(topology), masked=masked)
        t_run = t_batched.make_multi_step_packed_batched(
            t_rules.parse_rule(rule), TTop(topology), masked=masked)
        extra = (MASK,) if masked else ()
        want = j_run(jnp.asarray(words), 5, *(jnp.asarray(m) for m in extra))
        np.testing.assert_array_equal(_u32(t_run(t, 5, *extra)), np.asarray(want),
                                      err_msg=rule)


@pytest.mark.parametrize("topology", ["torus", "dead"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_batched_matches_pallas_batched(topology, masked):
    """Chunk counts 1-3 at g = 4 on 24-row universes, B3/S23 and a B0 rule."""
    words, t = _batch((3, 24, 2), seed=22)
    extra = (MASK,) if masked else ()
    for rule, chunks in [("conway", 1), (B0_RULE, 2), ("conway", 3)]:
        j_run = j_batched.make_multi_step_pallas_batched(
            _mesh(), j_rules.parse_rule(rule), JTop(topology),
            gens_per_exchange=4, interpret=True, masked=masked)
        t_run = t_batched.make_multi_step_kernel_batched(
            t_rules.parse_rule(rule), TTop(topology), gens_per_exchange=4,
            masked=masked)
        want = j_run(jnp.asarray(words), chunks, *(jnp.asarray(m) for m in extra))
        np.testing.assert_array_equal(_u32(t_run(t, chunks, *extra)),
                                      np.asarray(want),
                                      err_msg=f"{rule} chunks={chunks}")


def test_kernel_batched_steps_any_n_and_refuses_deep_exchanges():
    """n = 0..11 at g = 4 (remainder chunks of 1-3) equals the plain
    runner; an exchange deeper than the universe is refused, as in JAX."""
    words, t = _batch((2, 8, 1), seed=23)
    rule = t_rules.parse_rule("highlife")
    for topology in TTop:
        plain = t_batched.make_multi_step_packed_batched(rule, topology,
                                                         masked=True)
        for n in range(12):
            got = t_batched.multi_step_kernel_batched(
                t, n, np.array([1, 1]), rule=rule, topology=topology,
                gens_per_exchange=4)
            assert torch.equal(got, plain(t, n, np.array([1, 1]))), (topology, n)
    with pytest.raises(ValueError, match="exceeds the band height"):
        t_batched.multi_step_kernel_batched(t, 9, rule=rule,
                                            gens_per_exchange=9)
    with pytest.raises(ValueError, match="mask"):
        t_batched.multi_step_kernel_batched(t, 4, np.ones(3), rule=rule)


def test_one_device_halo_exchange():
    _, t = _batch((2, 5, 3), seed=24)
    ext = exchange_rows_stack(t, TTop.TORUS, 2)
    assert torch.equal(ext[:, :2], t[:, -2:]) and torch.equal(ext[:, -2:], t[:, :2])
    assert torch.equal(ext[:, 2:-2], t)
    ext = exchange_rows_stack(t, TTop.DEAD, 2)
    assert not ext[:, :2].any() and not ext[:, -2:].any()
    ext = exchange_halo_stack(t, TTop.TORUS)
    assert ext.shape == (2, 7, 5)
    assert torch.equal(ext[:, 0, 0], t[:, -1, -1])   # the corner rides along
    assert not exchange_halo_stack(t, TTop.DEAD)[:, :, 0].any()
    assert band_edge_code() == 3
    assert [band_edge_code(3, i) for i in range(3)] == [1, 0, 2]


def _lane_pair(backend, topology):
    spec = {"rule": "B36/S23", "height": 16, "width": 64,
            "topology": topology}
    t_lane = t_lanes.Lane("t", t_lanes.SpecFamily.from_spec(
        dict(spec, backend=backend), "cpu"), 4, "cpu")
    j_lane = j_lanes.Lane("j", j_lanes.SpecFamily.from_spec(
        dict(spec, backend="packed")), 4)
    words = np.random.default_rng(25).integers(
        0, 2 ** 32, size=(4, 16, 2), dtype=np.uint64).astype(np.uint32)
    for slot in range(3):
        t_lane.place(f"s{slot}", words[slot])
        j_lane.place(f"s{slot}", words[slot])
    return t_lane, j_lane


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_cuda_lane_matches_the_jax_packed_lane(topology):
    """A "cuda" lane (B2's plain version here) steps exactly n generations,
    n not a multiple of g = 8, with a slot frozen by the mask."""
    t_lane, j_lane = _lane_pair("cuda", topology)
    for n, mask in [(11, [1, 1, 0, 0]), (3, [0, 1, 1, 0]), (16, [1, 1, 1, 0])]:
        t_lane.step(n, np.array(mask, np.uint32))
        j_lane.step(n, np.array(mask, np.uint32))
        for slot in range(4):
            np.testing.assert_array_equal(t_lane.read(slot), j_lane.read(slot),
                                          err_msg=f"n={n} slot={slot}")
    assert t_lane.read(0).dtype == np.dtype("<u4")
    assert t_lane.state.device.type == "cpu" and t_lane.steps_dispatched == 30
