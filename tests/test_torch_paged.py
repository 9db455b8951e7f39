"""The paged tile pool (memory/, ``Engine(backend="paged")``) and the
paged runner (parallel/batched.make_multi_step_paged) of the port against
the JAX package's, on the CPU, bit for bit (tolerance 0): words, slot ids,
page tables, population, ``live_tile_bbox`` and pool statistics, mid-flight
on the unbounded plane and on bounded grids; pool exhaustion stalling one
grid; ``paged1`` files loaded across the two packages; a grid handed over
from the JAX package; allocation churn after ``warm()`` building nothing.
"""

import numpy as np
import pytest

from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch.engine import Engine
from gameoflifewithactors_torch.memory import (DEAD_SLOT, PagedGrid,
                                               PagedUniverse, PoolExhausted,
                                               TilePool, step_grids)
from gameoflifewithactors_torch.obs.registry import MetricsRegistry
from gameoflifewithactors_torch.ops import bitpack
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.parallel.batched import make_multi_step_paged
from gameoflifewithactors_torch.utils import checkpoint as ckpt
from gameoflifewithactors_torch.utils.interop import (paged_grid_from_numpy,
                                                      state_from_numpy,
                                                      state_to_numpy)
from gameoflifewithactors_tpu import memory as j_memory
from gameoflifewithactors_tpu.engine import Engine as JEngine
from gameoflifewithactors_tpu.obs.registry import \
    MetricsRegistry as JMetricsRegistry
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import batched as j_batched
from gameoflifewithactors_tpu.utils import checkpoint as j_ckpt

GLIDER = ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2))  # flies down-right


def glider_cells(h=8, w=8, at=(0, 0)):
    cells = np.zeros((h, w), np.uint8)
    for y, x in GLIDER:
        cells[at[0] + y, at[1] + x] = 1
    return cells


def soup(h, w, fill=0.35, seed=0):
    return (np.random.default_rng(seed).random((h, w)) < fill).astype(np.uint8)


def _pools(capacity, **kw):
    """(JAX pool, port pool on the CPU) of one geometry, own registries."""
    j = j_memory.TilePool("B3/S23", capacity, registry=JMetricsRegistry(), **kw)
    t = TilePool("B3/S23", capacity, registry=MetricsRegistry(), device="cpu",
                 **kw)
    return j, t


def _same_pool(j, t):
    np.testing.assert_array_equal(t.tiles_host(), np.asarray(j.tiles))
    np.testing.assert_array_equal(t.neighbors, j.neighbors)
    assert t.stats() == j.stats() and t._free == j._free


def _same_grid(j, t):
    assert t.pages == j.pages and t.active == j.active
    assert t.generation == j.generation
    assert t.population() == j.population()
    assert t.live_tile_bbox() == j.live_tile_bbox()


@pytest.mark.parametrize("rule,shape,opts,topology", [
    ("B3/S23", (64, 128), {"tile_rows": 16, "tile_words": 1}, "torus"),
    ("B3/S23", (96, 128), {"tile_rows": 32, "tile_words": 2}, "dead"),
    ("B2/S/C3", (64, 64), {"tile_rows": 16, "tile_words": 1}, "torus"),
    ("R5,C0,M1,S34..58,B34..45", (64, 128), {"tile_rows": 16, "tile_words": 2},
     "dead"),
])
def test_paged_engine_matches_jax(rule, shape, opts, topology):
    """The Engine's paged backend: snapshot, population, active tiles,
    pages, slot ids and the neighbour table after each step."""
    from gameoflifewithactors_tpu.models.generations import parse_any

    rng = np.random.default_rng(7)
    states = getattr(parse_any(rule), "states", 2)
    grid = np.zeros(shape, np.uint8)
    grid[8:40, 16:56] = (rng.random((32, 40)) < 0.4) * rng.integers(
        1, states, (32, 40))
    j = JEngine(grid, rule, topology=JTopology(topology), backend="paged",
                sparse_opts=opts)
    t = Engine(grid, rule, topology=Topology(topology), backend="paged",
               sparse_opts=opts, device="cpu")
    assert t.backend == "paged"
    for n in (1, 5, 13):
        j.step(n)
        t.step(n)
        np.testing.assert_array_equal(t.snapshot(), j.snapshot())
        assert (t.population(), t.active_tiles()) == \
            (j.population(), j.active_tiles())
        assert t._sparse.grid.pages == j._sparse.grid.pages
        np.testing.assert_array_equal(t._sparse.pool.neighbors,
                                      j._sparse.pool.neighbors)


def test_paged_runner_matches_jax():
    """The runner alone on a random slab and random page tables: masked
    slots step, unmasked ones (slot 0 among them) pass through bit for bit,
    and ``changed``/``occupied`` are JAX's, over chunks of 1 and 5."""
    rng = np.random.default_rng(2)
    B = 24
    slab = rng.integers(0, 1 << 32, size=(B, 1, 16, 2), dtype=np.uint64
                        ).astype(np.uint32) & rng.integers(
        0, 1 << 32, size=(B, 1, 16, 2), dtype=np.uint64).astype(np.uint32)
    slab[0] = 0
    slab[5] = 0                                    # a dead, masked page
    neighbors = rng.integers(0, B, size=(B, 8)).astype(np.int32)
    mask = (rng.random(B) < 0.6).astype(np.uint32)
    mask[0] = 0
    mask[5] = 1
    j_run = j_batched.make_multi_step_paged(
        _jrule("B3/S23"), 16, 2, donate=False)
    t_run = make_multi_step_paged(_trule("B3/S23"), 16, 2)
    for n in (1, 5):
        import jax.numpy as jnp

        j_tiles, j_ch, j_occ = j_run(jnp.asarray(slab), n,
                                     jnp.asarray(neighbors), jnp.asarray(mask))
        tiles = state_from_numpy(slab.reshape(B, 16, 2)).reshape(B, 1, 16, 2)
        t_tiles, t_ch, t_occ = t_run(tiles, n, neighbors, mask)
        np.testing.assert_array_equal(
            state_to_numpy(t_tiles.reshape(B, 16, 2)).reshape(B, 1, 16, 2),
            np.asarray(j_tiles))
        np.testing.assert_array_equal(t_ch.numpy(), np.asarray(j_ch))
        np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))
        unmasked = mask == 0
        np.testing.assert_array_equal(np.asarray(j_tiles)[unmasked],
                                      slab[unmasked])


def _jrule(spec):
    from gameoflifewithactors_tpu.models.generations import parse_any

    return parse_any(spec)


def _trule(spec):
    from gameoflifewithactors_torch.models.generations import parse_any

    return parse_any(spec)


def test_unbounded_universe_mid_flight_matches_jax():
    """A glider and a soup on the unbounded plane, checked every 24
    generations: words of the live window, population, ``live_tile_bbox``,
    slot ids, the neighbour table and the pool's statistics; the trail
    retires, so the footprint stays small."""
    j_pool, t_pool = _pools(96, tile_rows=16, tile_words=1)
    j = j_memory.PagedUniverse(j_pool.rule, pool=j_pool)
    t = PagedUniverse(t_pool.rule, pool=t_pool)
    patch = np.zeros((32, 64), np.uint8)
    patch[1:9, 1:9] = glider_cells()
    patch[16:30, 36:60] = soup(14, 24, seed=4)
    for u in (j, t):
        u.seed_cells(patch, origin=(1, 1))
    t_pool.warm()
    j_pool.warm()
    for _ in range(6):
        j.step(24)
        t.step(24)
        _same_grid(j.grid, t.grid)
        _same_pool(j_pool, t_pool)
        jo, jc = j.snapshot_cells()
        to, tc = t.snapshot_cells()
        assert jo == to and np.array_equal(jc, tc)
        assert t.live_bbox_cells() == j.live_bbox_cells()
    assert t_pool.in_use() < 40


def test_pool_exhaustion_stalls_only_the_starved_grid():
    """Two grids on a small pool: the one that cannot bind its wake ring
    stalls for the rest of the call, the co-tenant keeps stepping, as in
    the JAX package; the OOM counter and gauges agree."""
    j_pool, t_pool = _pools(12, tile_rows=16, tile_words=1)
    grids = {}
    for name, pool, mod in (("j", j_pool, j_memory), ("t", t_pool, None)):
        grid_cls = mod.PagedGrid if mod else PagedGrid
        a = grid_cls(pool, topology=(JTopology if mod else Topology).TORUS,
                     bounds=(2, 1))
        b = grid_cls(pool, topology=(JTopology if mod else Topology).DEAD,
                     bounds=None)
        a.seed_words(bitpack.pack_np(soup(32, 32, seed=3))[None])
        b.seed_words(bitpack.pack_np(glider_cells(16, 32, at=(6, 14)))[None])
        hoard = [pool.alloc() for _ in range(pool.free_count())]
        grids[name] = (a, b, hoard)
    j_a, j_b, j_hoard = grids["j"]
    t_a, t_b, t_hoard = grids["t"]
    j_done = j_memory.step_grids(j_pool, [j_a, j_b], 8)
    t_done = step_grids(t_pool, [t_a, t_b], 8)
    np.testing.assert_array_equal(t_done, j_done)
    assert t_done[0] == 8 and t_done[1] < 8
    with pytest.raises(PoolExhausted):
        t_pool.alloc()
    for pool, hoard in ((j_pool, j_hoard), (t_pool, t_hoard)):
        for s in hoard:
            pool.release(s)
    np.testing.assert_array_equal(step_grids(t_pool, [t_b], 8),
                                  j_memory.step_grids(j_pool, [j_b], 8))
    for jg, tg in ((j_a, t_a), (j_b, t_b)):
        _same_grid(jg, tg)
    _same_pool(j_pool, t_pool)
    with pytest.raises(ValueError):
        t_pool.release(DEAD_SLOT)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_paged1_cross_loads(tmp_path, direction):
    """A ``paged1`` file of either package loads in the other with equal
    slot ids and pages, and the two continue identically; both packages
    write the same members and metadata for the same grid."""
    j_u = j_memory.PagedUniverse("B3/S23", capacity=64, tile_rows=16,
                                 tile_words=1, registry=JMetricsRegistry())
    t_u = PagedUniverse("B3/S23", capacity=64, tile_rows=16, tile_words=1,
                        registry=MetricsRegistry(), device="cpu")
    patch = np.zeros((16, 32), np.uint8)
    patch[1:9, 1:9] = glider_cells()
    for u in (j_u, t_u):
        u.seed_cells(patch, origin=(2, 3))
        u.step(70)
    j_path = j_ckpt.save_paged(j_u, tmp_path / "j.npz")
    t_path = ckpt.save_paged(t_u, tmp_path / "t.npz")
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    if direction == "jax_to_torch":
        t_grid, t_meta = ckpt.load_paged(j_path, device="cpu",
                                         registry=MetricsRegistry())
        j_grid, j_meta = j_ckpt.load_paged(j_path, registry=JMetricsRegistry())
    else:
        j_grid, j_meta = j_ckpt.load_paged(t_path, registry=JMetricsRegistry())
        t_grid, t_meta = ckpt.load_paged(t_path, device="cpu",
                                         registry=MetricsRegistry())
    assert t_meta == j_meta and t_meta["format"] == "paged1"
    _same_grid(j_grid, t_grid)
    for _ in range(2):
        j_memory.step_grids(j_grid.pool, [j_grid], 30)
        step_grids(t_grid.pool, [t_grid], 30)
        _same_grid(j_grid, t_grid)
        _same_pool(j_grid.pool, t_grid.pool)


def test_load_paged_refuses_garbage_and_mismatched_pool(tmp_path):
    u = PagedUniverse("B3/S23", capacity=16, tile_rows=16, tile_words=1,
                      registry=MetricsRegistry(), device="cpu")
    u.seed_cells(glider_cells())
    path = ckpt.save_paged(u, tmp_path / "u.npz")
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_paged(path, pool=TilePool("B3/S23", 16, tile_rows=32,
                                            tile_words=1, device="cpu",
                                            registry=MetricsRegistry()))
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_paged(bad)
    with pytest.raises(ckpt.CheckpointCorruptError, match="not a paged"):
        ckpt.load_paged(ckpt.save(Engine(np.zeros((32, 32), np.uint8),
                                         "B3/S23", device="cpu"),
                                  tmp_path / "e.npz"))


def test_interop_hand_over_continues_a_jax_grid():
    """n1 generations on a JAX paged grid, its pages handed to the port
    (:func:`paged_grid_from_numpy`), n2 more there: the same universe as
    JAX's n1 + n2 run."""
    j_pool = j_memory.TilePool("B3/S23", 64, tile_rows=16, tile_words=1,
                               registry=JMetricsRegistry())
    j_grid = j_memory.PagedGrid(j_pool, topology=JTopology.TORUS,
                                bounds=(4, 3))
    j_grid.seed_words(bitpack.pack_np(soup(64, 96, seed=9))[None])
    j_memory.step_grids(j_pool, [j_grid], 11)
    coords = sorted(j_grid.pages)
    host = np.asarray(j_pool.tiles)
    t_grid = paged_grid_from_numpy(
        coords, host[[j_grid.pages[c] for c in coords]], _trule("B3/S23"),
        topology=Topology.TORUS, bounds=j_grid.bounds, tile_rows=16,
        tile_words=1, active=j_grid.active, generation=j_grid.generation,
        capacity=64, registry=MetricsRegistry(), device="cpu")
    for _ in range(2):
        j_memory.step_grids(j_pool, [j_grid], 9)
        step_grids(t_grid.pool, [t_grid], 9)
        np.testing.assert_array_equal(t_grid.to_words(), j_grid.to_words())
        assert t_grid.active == j_grid.active
        assert t_grid.population() == j_grid.population()


def test_allocation_churn_after_warm_builds_nothing(monkeypatch):
    """After ``warm()``, a page-crossing glider (allocating at the front,
    retiring behind) and a drop and reseed build no kernel: the paged path
    is plain torch. Released slots are zero again, rows severed."""
    def refuse(*args, **kwargs):
        raise AssertionError("the paged path built a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    pool = TilePool("B3/S23", 64, tile_rows=16, tile_words=1, device="cpu",
                    registry=MetricsRegistry())
    u = PagedUniverse(pool.rule, pool=pool)
    u.seed_cells(glider_cells(), origin=(1, 1))
    pool.warm()
    for _ in range(12):
        u.step(16)
    u.grid.drop()
    slot = pool.alloc()
    pool.write(slot, np.full((1, 16, 1), 0xFFFFFFFF, np.uint32))
    pool.release(slot)
    assert pool.in_use() == 0 and not pool.tiles_host().any()
    assert (pool.neighbors == DEAD_SLOT).all()
    u.seed_cells(glider_cells(), origin=(5, 5))
    u.step(64)
    assert u.population() == 5


def test_mostly_empty_universe_binds_few_tiles_like_jax():
    """A 1024² DEAD universe with one 128² soup binds a small share of the
    dense tile count, the same pages as the JAX engine, and equals the
    dense packed engine."""
    side = 1024
    grid = np.zeros((side, side), np.uint8)
    grid[448:576, 448:576] = soup(128, 128, seed=5)
    opts = {"tile_rows": 32, "tile_words": 4}
    t = Engine(grid, "B3/S23", topology=Topology.DEAD, backend="paged",
               sparse_opts=opts, device="cpu")
    j = JEngine(grid, "B3/S23", topology=JTopology.DEAD, backend="paged",
                sparse_opts=opts)
    t.step(3)
    j.step(3)
    assert t.active_tiles() == j.active_tiles() < (side // 32) ** 2 // 4 // 10
    ref = Engine(grid, "B3/S23", topology=Topology.DEAD, backend="packed",
                 device="cpu")
    ref.step(3)
    np.testing.assert_array_equal(t.snapshot(), ref.snapshot())
