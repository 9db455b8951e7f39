"""``SessionService(paged=True)`` of the port against the JAX package's, on
the CPU: sessions of one rule in two geometries and a DEAD family page onto
one shared tile pool per rule; the same request sequence (creates, mixed
cursors, closes, more steps) gives equal grids, generations, placements,
lane statistics and pool statistics; pool pressure queues a create and
drains it after a close; a dispatch the pool cannot fully provision stalls
only the starved session; a paged lane's crash restores bit for bit.
"""

import numpy as np
import pytest

from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.serve import (AdmissionController,
                                              SessionService)
from gameoflifewithactors_torch.serve import lanes as t_lanes
from gameoflifewithactors_tpu.obs.registry import \
    MetricsRegistry as JMetricsRegistry
from gameoflifewithactors_tpu.serve import \
    AdmissionController as JAdmissionController
from gameoflifewithactors_tpu.serve import SessionService as JSessionService
from gameoflifewithactors_tpu.serve import lanes as j_lanes

SPEC = {"rule": "B3/S23", "height": 32, "width": 64, "topology": "torus"}
WIDE = {"rule": "B3/S23", "height": 48, "width": 96, "topology": "dead"}
DEAD = {"rule": "B36/S23", "height": 32, "width": 32, "topology": "dead"}
GLIDER = ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2))


def _glider_hex(spec, at):
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.serve import encode_words

    cells = np.zeros((spec["height"], spec["width"]), np.uint8)
    for y, x in GLIDER:
        cells[at[0] + y, at[1] + x] = 1
    return encode_words(bitpack.pack_np(cells))


def _services(paged_opts=None, queue_limit=8):
    reg, j_reg = MetricsRegistry(), JMetricsRegistry()
    port = SessionService(
        ladder=(1, 2, 4), registry=reg, paged=True, paged_opts=paged_opts,
        admission=AdmissionController(registry=reg, queue_limit=queue_limit),
        sleep_fn=lambda s: None, device="cpu")
    ref = JSessionService(
        ladder=(1, 2, 4), registry=j_reg, paged=True, paged_opts=paged_opts,
        admission=JAdmissionController(registry=j_reg,
                                       queue_limit=queue_limit),
        sleep_fn=lambda s: None)
    return port, ref


def _create(port, ref, spec, **kw):
    a, b = port.create("t", spec, **kw), ref.create("t", spec, **kw)
    assert (a["state"], a["lane"], a["slot"]) == \
        (b["state"], b["lane"], b["slot"])
    return a["sid"], b["sid"]


def _agree(port, ref, pairs):
    for sa, sb in pairs:
        a, b = port.info(sa), ref.info(sb)
        assert {k: a[k] for k in ("state", "generation", "pending_steps",
                                  "lane", "slot", "family")} == \
            {k: b[k] for k in ("state", "generation", "pending_steps",
                               "lane", "slot", "family")}
        if a["state"] not in ("closed", "evicted"):
            np.testing.assert_array_equal(port.grid(sa), ref.grid(sb))
    assert port.lane_stats() == ref.lane_stats()
    for key, pool in port._tile_pools.items():
        assert pool.stats() == ref._tile_pools[key].stats()
        np.testing.assert_array_equal(pool.neighbors,
                                      ref._tile_pools[key].neighbors)


def test_paged_service_matches_the_jax_service():
    """Two geometries of B3/S23 share one pool; B36/S23 gets its own.
    Soups and gliders on mixed cursors, closes, then more steps."""
    port, ref = _services()
    pairs = []
    for i in range(6):
        spec = (SPEC, WIDE, DEAD)[i % 3]
        if i % 2:
            pairs.append(_create(port, ref, spec, fill=0.3, rng_seed=i))
        else:
            pairs.append(_create(port, ref, spec,
                                 cells_hex=_glider_hex(spec, (3 + i, 5))))
    assert len(port._tile_pools) == len(ref._tile_pools) == 2
    for k, (sa, sb) in enumerate(pairs):
        port.step(sa, 3 + 7 * (k % 3), pump=False)
        ref.step(sb, 3 + 7 * (k % 3), pump=False)
    assert port.pump() == ref.pump()
    _agree(port, ref, pairs)
    for k in (1, 4):
        port.close(pairs[k][0])
        ref.close(pairs[k][1])
    _agree(port, ref, pairs)
    for k, (sa, sb) in enumerate(pairs):
        if k not in (1, 4):
            port.step(sa, 20 + k)
            ref.step(sb, 20 + k)
    _agree(port, ref, pairs)
    assert port.counts() == ref.counts()


def test_pool_pressure_queues_then_drains_like_jax():
    """A pool too small for a second soup: its create queues (pool
    pressure is a scheduling verdict), the close of the first frees the
    tiles and the drain places it; both services agree at every point."""
    port, ref = _services(paged_opts={"capacity": 6})
    first = _create(port, ref, SPEC, fill=0.4, rng_seed=1)
    second = _create(port, ref, SPEC, fill=0.4, rng_seed=2)
    assert port.info(second[0])["state"] == "pending"
    port.step(second[0], 5)
    ref.step(second[1], 5)
    _agree(port, ref, [first, second])
    port.close(first[0])
    ref.close(first[1])
    assert port.info(second[0])["state"] != "pending"
    port.pump()
    ref.pump()
    _agree(port, ref, [first, second])


def test_partial_provision_stalls_only_the_starved_session():
    """Two gliders on a pool with room for one wake ring: the dispatch
    steps the session it could provision, the other keeps its debt, in
    both packages."""
    port, ref = _services(paged_opts={"capacity": 6, "chunk_gens": 4})
    a = _create(port, ref, SPEC, cells_hex=_glider_hex(SPEC, (2, 2)))
    b = _create(port, ref, SPEC, cells_hex=_glider_hex(SPEC, (18, 40)))
    for sid_port, sid_ref in (a, b):
        port.step(sid_port, 12, pump=False)
        ref.step(sid_ref, 12, pump=False)
    assert port.pump() == ref.pump()
    _agree(port, ref, [a, b])
    assert {port.info(s)["pending_steps"] for s, _ in (a, b)} != {0}


@pytest.mark.parametrize("fault", [False, True])
def test_paged_lane_crash_and_checkpoint_restore(tmp_path, fault):
    """A paged lane that raises restores every session from its snapshot
    and replays the lost generations; a checkpoint of a paged service
    resumes into a new one with equal grids."""
    port, ref = _services()
    pairs = [_create(port, ref, SPEC, fill=0.3, rng_seed=s) for s in (4, 5)]
    for sa, sb in pairs:
        port.step(sa, 6)
        ref.step(sb, 6)
    path = str(tmp_path / "serve.npz")
    port.checkpoint(path)
    if fault:
        next(iter(port.pools.values())).lanes[
            f"{port.info(pairs[0][0])['family']}#paged"].fail_next = True
    for sa, sb in pairs:
        port.step(sa, 9)
        ref.step(sb, 9)
    _agree(port, ref, pairs)
    again, _ = _services()
    assert again.resume(path) == 2
    for sa, sb in pairs:
        again.step(sa, 9)
        np.testing.assert_array_equal(again.grid(sa), ref.grid(sb))


def test_pool_sizing_and_fallbacks_match_jax():
    """The ladder maps to the JAX pool capacity; an unknown paged option is
    refused with JAX's message; a shape that does not divide the tiles
    keeps a ladder lane; an explicit "cuda" family is never paged."""
    for ladder in ((1, 8, 64, 256), (1, 2, 4)):
        assert t_lanes.pool_capacity_for_ladder(ladder) == \
            j_lanes.pool_capacity_for_ladder(ladder)
    with pytest.raises(ValueError) as got:
        SessionService(paged=True, paged_opts={"pages": 3}, device="cpu")
    with pytest.raises(ValueError) as want:
        JSessionService(paged=True, paged_opts={"pages": 3})
    assert str(got.value) == str(want.value)
    port, ref = _services(paged_opts={"tile_rows": 32})
    odd = {"rule": "B3/S23", "height": 48, "width": 64, "topology": "torus"}
    pair = _create(port, ref, odd, fill=0.3, rng_seed=3)
    assert not port.lane_stats()[0].get("paged")
    port.step(pair[0], 4)
    ref.step(pair[1], 4)
    _agree(port, ref, [pair])
    info = port.create("t", dict(SPEC, backend="cuda"), fill=0.3)
    assert info["family"].endswith("|cuda") and not port._tile_pools
