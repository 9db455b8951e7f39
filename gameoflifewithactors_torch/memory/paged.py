"""Page-table grids over the tile pool: logical universes, physical slots.

Counterpart of ``gameoflifewithactors_tpu.memory.paged``. A
:class:`PagedGrid` is one logical universe, bounded (TORUS or DEAD) or an
unbounded plane (``bounds=None``), held as a sparse map ``tile coord ->
pool slot``. Pages exist only where the universe is interesting;
everywhere else *is* the pool's dead tile, by aliasing. The host keeps
the coordinate map and the pool's ``(B, 8)`` neighbour table, which this
module maintains as pages come and go.

Activation and retirement ride :mod:`..ops.sparse`'s wake machinery on a
sparse coordinate set (:func:`~..ops.sparse.dilate_coords`):

- before a chunk of ``g`` generations, every page within
  ``wake_dilation(rule, ·, ·, g)`` tile rings of a changed page is
  ensured, so a would-birth front never abuts an unallocated page;
- after the chunk, pages that hold no live bit AND sit outside the wake
  ring of any changed page retire to the free list.

:func:`step_grids` is the multi-tenant pump: one pool dispatch advances
every prepared grid's pages together, whichever session owns them. Page
order, slot ids and flags follow the JAX package step for step, so page
tables and ``paged1`` files are the same in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..analysis import sanitizers
from ..obs.registry import REGISTRY, MetricsRegistry
from ..ops import bitpack
from ..ops import sparse as _sparse
from ..ops.stencil import Topology
from ..parallel.batched import PAGED_NEIGHBORS
from ..utils.interop import state_from_numpy
from .pool import DEAD_SLOT, PoolExhausted, TilePool

Coord = Tuple[int, int]


def default_chunk_gens(rule, tile_rows: int, tile_words: int) -> int:
    """The deepest chunk whose wake ring is one tile thick: g·r bounded by
    the smaller tile extent."""
    r, _ = _sparse.rule_halo(rule)
    return max(1, min(tile_rows, tile_words * bitpack.WORD) // r)


class PagedGrid:
    """One logical universe mapped onto pool pages.

    ``bounds`` is the logical extent in TILE units, ``(nty, ntx)``;
    ``None`` is the unbounded plane (DEAD closure at infinity). TORUS
    needs bounds: page-table wraparound is how the torus closes.
    """

    def __init__(self, pool: TilePool, *,
                 topology: Topology = Topology.DEAD,
                 bounds: Optional[Tuple[int, int]] = None):
        if topology is Topology.TORUS and bounds is None:
            raise ValueError("a TORUS universe needs bounds: the wrap IS "
                             "the page table's edge closure")
        if bounds is not None and (bounds[0] < 1 or bounds[1] < 1):
            raise ValueError(f"bounds must be positive tile counts, "
                             f"got {bounds}")
        self.pool = pool
        self.topology = topology
        self.bounds = tuple(bounds) if bounds is not None else None
        self.pages: Dict[Coord, int] = {}
        self.active: Set[Coord] = set()
        self.generation = 0

    # -- page-table maintenance ----------------------------------------------

    def _neighbor_coord(self, c: Coord, off: Coord) -> Optional[Coord]:
        y, x = c[0] + off[0], c[1] + off[1]
        if self.bounds is not None:
            nty, ntx = self.bounds
            if self.topology is Topology.TORUS:
                return (y % nty, x % ntx)
            if not (0 <= y < nty and 0 <= x < ntx):
                return None  # beyond the DEAD edge
        return (y, x)

    def _link(self, c: Coord, slot: int) -> None:
        nbr = self.pool.neighbors
        for i, off in enumerate(PAGED_NEIGHBORS):
            c2 = self._neighbor_coord(c, off)
            s2 = DEAD_SLOT if c2 is None else self.pages.get(c2, DEAD_SLOT)
            nbr[slot, i] = s2
            if s2 != DEAD_SLOT:
                nbr[s2, 7 - i] = slot  # reciprocal direction

    def _unlink(self, c: Coord) -> None:
        # incoming edges only; pool.release zeroes the outgoing row
        nbr = self.pool.neighbors
        for i, off in enumerate(PAGED_NEIGHBORS):
            c2 = self._neighbor_coord(c, off)
            s2 = None if c2 is None else self.pages.get(c2)
            if s2 is not None:
                nbr[s2, 7 - i] = DEAD_SLOT

    def ensure(self, coords: Iterable[Coord]) -> None:
        """Allocate any missing pages (zero content: no device work).
        Raises :class:`PoolExhausted` mid-way on an empty free list; pages
        already bound stay bound (dead tiles the next retirement pass
        reclaims if they sit outside the wake ring)."""
        for c in coords:
            if c in self.pages:
                continue
            slot = self.pool.alloc()
            self.pages[c] = slot
            self._link(c, slot)

    def _wrap(self) -> bool:
        return self.topology is Topology.TORUS

    def prepare(self, gens: int) -> None:
        """Pre-chunk soundness: bind every page influence could reach
        within ``gens`` generations of the changed set."""
        dy, dx = _sparse.wake_dilation(
            self.pool.rule, self.pool.tile_rows, self.pool.tile_words, gens)
        need = _sparse.dilate_coords(self.active, dy, dx,
                                     bounds=self.bounds, wrap=self._wrap())
        self.ensure(need)

    def apply_flags(self, changed: np.ndarray, occupied: np.ndarray) -> None:
        """Post-chunk bookkeeping from the dispatch's flag vectors: the
        changed pages become the new wake set; pages with no live bit
        outside the wake ring retire to the free list."""
        self.active = {c for c, s in self.pages.items() if changed[s]}
        dy, dx = _sparse.wake_dilation(
            self.pool.rule, self.pool.tile_rows, self.pool.tile_words, 1)
        keep = _sparse.dilate_coords(self.active, dy, dx,
                                     bounds=self.bounds, wrap=self._wrap())
        dead = [c for c, s in self.pages.items()
                if not occupied[s] and c not in keep]
        for c in dead:
            slot = self.pages.pop(c)
            self._unlink(c)
            self.pool.release(slot)

    # -- content --------------------------------------------------------------

    def seed_words(self, words, origin: Coord = (0, 0)) -> None:
        """Place packed content: ``words`` is ``(planes, H, Wq)`` (host
        uint32, or an int32 tensor, which stays on its device until the
        pool's), tile-divisible, laid down with its (0, 0) tile at tile
        coord ``origin``. Only nonzero tiles bind pages, in row-major
        order."""
        pool = self.pool
        if not isinstance(words, torch.Tensor):
            words = np.asarray(words, np.uint32)
        if words.ndim != 3 or words.shape[0] != pool.planes:
            raise ValueError(
                f"seed words must be (planes={pool.planes}, H, Wq), "
                f"got shape {tuple(words.shape)}")
        _, H, Wq = words.shape
        tr, tw = pool.tile_rows, pool.tile_words
        if H % tr or Wq % tw:
            raise ValueError(
                f"seed of {H} x {Wq} words does not divide into "
                f"{tr} x {tw}-word tiles")
        nty, ntx = H // tr, Wq // tw
        if self.bounds is not None:
            bty, btx = self.bounds
            oy, ox = origin
            if oy < 0 or ox < 0 or oy + nty > bty or ox + ntx > btx:
                raise ValueError(
                    f"seed of {nty} x {ntx} tiles at {origin} exceeds "
                    f"bounds {self.bounds}")
        if not isinstance(words, torch.Tensor):
            words = state_from_numpy(words)
        # (nty, ntx, planes, tr, tw) view: one tile per (ty, tx)
        tiles = words.reshape(pool.planes, nty, tr, ntx, tw).permute(1, 3, 0, 2, 4)
        with sanitizers.allow_host_transfers(
                "seeding reads which tiles hold a live bit: only those "
                "bind pages"):
            live = torch.nonzero(
                (tiles != 0).flatten(2).any(-1)).cpu().tolist()
        placed = [(origin[0] + ty, origin[1] + tx) for ty, tx in live]
        self.ensure(placed)
        if live:
            ys, xs = torch.as_tensor(live, device=words.device).unbind(1)
            pool.write_many([self.pages[c] for c in placed], tiles[ys, xs])
        self.active |= set(placed)

    def to_tensor(self, origin: Optional[Coord] = None,
                  shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Dense ``(planes, H, Wq)`` int32 words of the tile window
        ``shape`` (tile units) at ``origin``, assembled on the pool's
        device (default: the full bounds of a bounded grid)."""
        origin, shape = self._window(origin, shape)
        pool = self.pool
        tr, tw = pool.tile_rows, pool.tile_words
        nty, ntx = shape
        out = torch.zeros((pool.planes, nty * tr, ntx * tw), dtype=torch.int32,
                          device=pool.device)
        inside = [((ty - origin[0], tx - origin[1]), s)
                  for (ty, tx), s in self.pages.items()
                  if 0 <= ty - origin[0] < nty and 0 <= tx - origin[1] < ntx]
        if inside:
            coords = torch.as_tensor([c for c, _ in inside], device=pool.device)
            slots = torch.as_tensor([s for _, s in inside], device=pool.device)
            view = out.view(pool.planes, nty, tr, ntx, tw).permute(1, 3, 0, 2, 4)
            view[coords[:, 0], coords[:, 1]] = pool.tiles[slots]
        return out

    def _window(self, origin, shape):
        if shape is None:
            if self.bounds is None:
                raise ValueError("an unbounded grid has no default window; "
                                 "pass origin and shape in tile units")
            return (0, 0), self.bounds
        return origin or (0, 0), shape

    def to_words(self, origin: Optional[Coord] = None,
                 shape: Optional[Tuple[int, int]] = None,
                 host: Optional[np.ndarray] = None) -> np.ndarray:
        """Host uint32 ``(planes, H, Wq)`` of :meth:`to_tensor`'s window;
        ``host`` reuses a prior :meth:`TilePool.tiles_host` fetch."""
        if host is None:
            return self.to_tensor(origin, shape).cpu().numpy().view(np.uint32)
        origin, shape = self._window(origin, shape)
        pool = self.pool
        tr, tw = pool.tile_rows, pool.tile_words
        nty, ntx = shape
        out = np.zeros((pool.planes, nty * tr, ntx * tw), np.uint32)
        for (ty, tx), s in self.pages.items():
            oy, ox = ty - origin[0], tx - origin[1]
            if 0 <= oy < nty and 0 <= ox < ntx:
                out[:, oy * tr:(oy + 1) * tr, ox * tw:(ox + 1) * tw] = host[s]
        return out

    def live_tile_bbox(self, host: Optional[np.ndarray] = None
                       ) -> Optional[Tuple[Coord, Coord]]:
        """((ty0, tx0), (ty1, tx1)) inclusive over pages holding any live
        bit, or None for an all-dead universe."""
        if host is None:
            host = self.pool.tiles_host()
        live = [c for c, s in self.pages.items() if host[s].any()]
        if not live:
            return None
        ys = [c[0] for c in live]
        xs = [c[1] for c in live]
        return (min(ys), min(xs)), (max(ys), max(xs))

    def population(self, host: Optional[np.ndarray] = None) -> int:
        """Live cells (cells of nonzero state for plane stacks)."""
        if host is None:
            host = self.pool.tiles_host()
        total = 0
        for _, s in self.pages.items():
            nonzero = np.bitwise_or.reduce(host[s], axis=0)
            total += int(np.unpackbits(nonzero.view(np.uint8)).sum())
        return total

    def drop(self) -> None:
        """Release every page (session close / reseed)."""
        for c in list(self.pages):
            slot = self.pages.pop(c)
            self._unlink(c)
            self.pool.release(slot)
        self.active = set()


def step_grids(pool: TilePool, grids: Sequence[PagedGrid], n: int,
               chunk_gens: Optional[int] = None) -> np.ndarray:
    """Advance every grid ``n`` generations in shared chunks: ONE pool
    dispatch per chunk steps the union of all grids' pages. Returns
    per-grid generations completed (int64), short of ``n`` only for grids
    the pool could not provision (:class:`PoolExhausted` stalls that grid
    for the rest of the call; co-tenants keep stepping)."""
    if chunk_gens is None:
        chunk_gens = default_chunk_gens(pool.rule, pool.tile_rows,
                                        pool.tile_words)
    done = np.zeros(len(grids), np.int64)
    stalled = [False] * len(grids)
    remaining = int(n)
    while remaining > 0:
        g = min(int(chunk_gens), remaining)
        ready: List[int] = []
        for i, grid in enumerate(grids):
            if stalled[i]:
                continue
            try:
                grid.prepare(g)
                ready.append(i)
            except PoolExhausted:
                stalled[i] = True
        if not ready:
            break
        mask = np.zeros((pool.capacity,), np.uint32)
        for i in ready:
            for s in grids[i].pages.values():
                mask[s] = 1
        mask[DEAD_SLOT] = 0
        if mask.any():
            changed, occupied = pool.dispatch(g, mask)
        else:
            # every ready universe is empty: dead stays dead, no device work
            changed = np.zeros((pool.capacity,), bool)
            occupied = changed
        for i in ready:
            grids[i].apply_flags(changed, occupied)
            grids[i].generation += g
            done[i] += g
        remaining -= g
    return done


# -- packing helpers ----------------------------------------------------------


def pack_state(rule, grid: np.ndarray) -> np.ndarray:
    """(H, W) uint8 cells -> (planes, H, W/32) uint32 words for ``rule``
    (binary rules get a single plane; Generations / C >= 3 LtL the
    bit-plane stack)."""
    from ..ops.packed_generations import pack_generations_for

    planes, _ = _sparse.rule_layout(rule)
    grid = np.asarray(grid, np.uint8)
    if planes == 1:
        return bitpack.pack_np(grid)[None]
    return pack_generations_for(torch.from_numpy(grid.copy()), rule
                                ).numpy().view(np.uint32)


def unpack_state(words: np.ndarray) -> np.ndarray:
    """(planes, H, Wq) words -> (H, W) uint8 cells (host-side)."""
    out = None
    for p in range(words.shape[0]):
        part = (bitpack.unpack_np(np.asarray(words[p])) << p).astype(np.uint8)
        out = part if out is None else out | part
    return out


class PagedUniverse:
    """An unbounded plane over a (private or shared) tile pool: seed
    anywhere, step forever; pages allocate at the advancing front and
    retire behind it, so a glider's footprint is a constant handful of
    tiles however far it flies. A private pool lives on ``device``."""

    def __init__(self, rule, capacity: int = 1024, *,
                 tile_rows: Optional[int] = None,
                 tile_words: Optional[int] = None,
                 pool: Optional[TilePool] = None,
                 chunk_gens: Optional[int] = None,
                 name: str = "universe",
                 registry: MetricsRegistry = REGISTRY,
                 device=None):
        self.pool = pool if pool is not None else TilePool(
            rule, capacity, tile_rows=tile_rows, tile_words=tile_words,
            name=name, registry=registry, device=device)
        self.grid = PagedGrid(self.pool, topology=Topology.DEAD, bounds=None)
        self.chunk_gens = chunk_gens

    @property
    def generation(self) -> int:
        return self.grid.generation

    def seed_cells(self, cells: np.ndarray, origin: Tuple[int, int] = (0, 0)
                   ) -> None:
        """Place an (h, w) uint8 patch with its top-left at TILE coord
        ``origin``, padded up to tile multiples."""
        tr, tcols = self.pool.tile_cells()
        cells = np.asarray(cells, np.uint8)
        h, w = cells.shape
        ph = -h % tr
        pw = -w % tcols
        if ph or pw:
            cells = np.pad(cells, ((0, ph), (0, pw)))
        self.grid.seed_words(pack_state(self.pool.rule, cells), origin)

    def step(self, n: int) -> None:
        done = step_grids(self.pool, [self.grid], n, self.chunk_gens)
        if int(done[0]) != int(n):
            raise PoolExhausted(
                f"universe stalled at generation {self.grid.generation} "
                f"({int(done[0])}/{n} requested gens): pool "
                f"{self.pool.name!r} has no free tiles")

    def population(self) -> int:
        return self.grid.population()

    def snapshot_cells(self) -> Tuple[Tuple[int, int], np.ndarray]:
        """((y0, x0) global CELL coord of the window origin, cells) over
        the live tile bbox; a dead universe returns ((0, 0), empty)."""
        host = self.pool.tiles_host()
        bbox = self.grid.live_tile_bbox(host)
        tr, tcols = self.pool.tile_cells()
        if bbox is None:
            return (0, 0), np.zeros((0, 0), np.uint8)
        (ty0, tx0), (ty1, tx1) = bbox
        words = self.grid.to_words(
            (ty0, tx0), (ty1 - ty0 + 1, tx1 - tx0 + 1), host=host)
        return (ty0 * tr, tx0 * tcols), unpack_state(words)

    def live_bbox_cells(self) -> Optional[Tuple[int, int, int, int]]:
        """(y0, x0, y1, x1) inclusive global cell bbox of live cells."""
        origin, cells = self.snapshot_cells()
        if cells.size == 0 or not cells.any():
            return None
        ys, xs = np.nonzero(cells)
        return (origin[0] + int(ys.min()), origin[1] + int(xs.min()),
                origin[0] + int(ys.max()), origin[1] + int(xs.max()))


class PagedEngineState:
    """The Engine-facing face of a paged bounded universe, duck-typing
    :class:`..ops.sparse.SparseEngineState` (``step``, ``packed``,
    ``padded``, ``reseed``, ``active_tiles``). ``packed`` is an int32
    tensor (its device is the pool's) or host uint32 words (placed on
    ``device``). The default pool capacity is the dense tile count plus
    the dead slot, so a private paged engine never sees
    :class:`PoolExhausted`; pass ``capacity`` (or a shared ``pool``) to cap
    it and let the exception surface."""

    def __init__(self, packed, rule, *,
                 topology: Topology = Topology.DEAD,
                 tile_rows: Optional[int] = None,
                 tile_words: Optional[int] = None,
                 capacity: Optional[int] = None,
                 chunk_gens: Optional[int] = None,
                 pool: Optional[TilePool] = None,
                 registry: MetricsRegistry = REGISTRY,
                 device=None):
        if isinstance(packed, torch.Tensor):
            words, device = packed, packed.device
        else:
            words = np.asarray(packed, np.uint32)
        self._flat_packed = words.ndim == 2
        if self._flat_packed:
            words = words[None]
        planes, _ = _sparse.rule_layout(rule)
        if words.ndim != 3 or words.shape[0] != planes:
            raise ValueError(
                f"paged state for {rule.notation} must be "
                f"(planes={planes}, H, W/32) words (or 2D for one plane), "
                f"got shape {tuple(packed.shape)}")
        _, H, Wq = words.shape
        tr = int(tile_rows or min(_sparse.DEFAULT_TILE_ROWS, H))
        tw = int(tile_words or min(_sparse.DEFAULT_TILE_WORDS, Wq))
        if H % tr or Wq % tw:
            raise ValueError(
                f"grid of {H} x {Wq} words does not divide into "
                f"{tr} x {tw}-word tiles; pass tile_rows/tile_words "
                "that divide it")
        nty, ntx = H // tr, Wq // tw
        if pool is None:
            pool = TilePool(rule, int(capacity or nty * ntx + 1),
                            tile_rows=tr, tile_words=tw, registry=registry,
                            device=device)
        elif (pool.tile_rows != tr or pool.tile_words != tw
                or pool.planes != planes):
            raise ValueError(
                f"shared pool slab ({pool.planes}, {pool.tile_rows}, "
                f"{pool.tile_words}) does not match this grid's "
                f"({planes}, {tr}, {tw})")
        self.rule = rule
        self.pool = pool
        self.topology = topology
        self.chunk_gens = chunk_gens
        self.grid = PagedGrid(pool, topology=topology, bounds=(nty, ntx))
        self.grid.seed_words(words)

    def step(self, n: int = 1) -> None:
        done = step_grids(self.pool, [self.grid], int(n), self.chunk_gens)
        if int(done[0]) != int(n):
            raise PoolExhausted(
                f"paged engine stalled at generation {self.grid.generation}"
                f" ({int(done[0])}/{n} requested gens): no free tiles")

    @property
    def padded(self) -> torch.Tensor:
        """The device-resident state: the pool slab."""
        return self.pool.tiles

    @property
    def packed(self) -> torch.Tensor:
        words = self.grid.to_tensor()
        return words[0] if self._flat_packed else words

    def active_tiles(self) -> int:
        return len(self.grid.pages)

    def reseed(self, packed) -> "PagedEngineState":
        """Fresh state over ``packed`` reusing this state's pool and
        configuration (Engine.set_grid's seam)."""
        self.grid.drop()
        return PagedEngineState(
            packed, self.rule, topology=self.topology,
            tile_rows=self.pool.tile_rows, tile_words=self.pool.tile_words,
            chunk_gens=self.chunk_gens, pool=self.pool)
