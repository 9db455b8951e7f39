"""The fixed-slab tile pool: B physical tiles, one device tensor, one free
list, one runner.

Counterpart of ``gameoflifewithactors_tpu.memory.pool``. A
:class:`TilePool` owns a ``(B, planes, tile_rows, tile_words)`` int32 slab
on its device (the bits of the JAX package's uint32 words, layout of
:mod:`..ops.bitpack`) plus the host table of the page tables: a ``(B, 8)``
int32 neighbour matrix in
:data:`~gameoflifewithactors_torch.parallel.batched.PAGED_NEIGHBORS`
order. Slot :data:`DEAD_SLOT` is the canonical dead tile: every
unallocated page of every tenant aliases it, which is what makes a sparse
region cost nothing.

Invariants the allocator keeps:

- free slots are all zero on the device (zeroed at release, zeros at
  init), so :meth:`alloc` is host bookkeeping only;
- slots come off the free list in the JAX package's order (``cap-1 ..
  1``, popped from the end), so page tables, slot ids and ``paged1``
  files equal the JAX package's;
- pool exhaustion raises :class:`PoolExhausted` here and is a
  scheduling event upstream (admission queues, the paged step loop
  stalls the starved grid), never a crash of co-tenants.

Each :meth:`dispatch` steps only the masked slots and reads two ``(B,)``
flag vectors back to the host (``dispatches`` and ``syncs`` count them).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..analysis import sanitizers
from ..engine import resolve_device
from ..obs.registry import REGISTRY, MetricsRegistry
from ..ops import bitpack
from ..ops import sparse as _sparse
from ..ops._builders import BuiltRunner, register_builder, steps_in_place
from ..parallel.batched import make_multi_step_paged
from ..utils.interop import state_from_numpy

DEAD_SLOT = 0


# -- slot surgery ---------------------------------------------------------------
#
# In place on the pool's own slab (the counterpart of the JAX package's
# donated programs): the pool rebinds nothing, and no caller holds the
# slab.


@steps_in_place
def _write_slot(tiles: torch.Tensor, slot,
                content: torch.Tensor) -> torch.Tensor:
    """``content`` into ``slot``: one slot and its (planes, tile_rows,
    tile_words) words, or an index tensor of k slots and their (k, ...)."""
    tiles[slot] = content.to(tiles.device, tiles.dtype)
    return tiles


@steps_in_place
def _zero_slot(tiles: torch.Tensor, slot: int) -> torch.Tensor:
    tiles[slot] = 0
    return tiles


class PoolExhausted(RuntimeError):
    """The free list is empty. Catchers decide policy: serve queues the
    session through admission, step_grids stalls the starved grid, the
    Engine path (which sizes its private pool to the dense tile count)
    never sees it."""


class TilePool:
    """B physical tiles for one rule family, shared by any number of
    logical grids (see :mod:`.paged` for the page-table layer). The slab
    lives on ``device`` (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, rule, capacity: int, *,
                 tile_rows: Optional[int] = None,
                 tile_words: Optional[int] = None,
                 name: str = "pool",
                 registry: MetricsRegistry = REGISTRY,
                 runner=None,
                 device=None):
        from ..models.generations import parse_any

        rule = parse_any(rule)
        if _sparse.births_from_nothing(rule):
            raise ValueError(
                f"paged memory cannot serve birth-from-nothing rules "
                f"({rule.notation}): the canonical dead tile would birth "
                "cells, so 'missing page = dead' stops being a closure — "
                "use the packed backend")
        if capacity < 2:
            raise ValueError(
                f"pool capacity must be >= 2 (slot {DEAD_SLOT} is the "
                f"reserved dead tile), got {capacity}")
        self.rule = rule
        self.capacity = int(capacity)
        self.tile_rows = int(tile_rows or _sparse.DEFAULT_TILE_ROWS)
        self.tile_words = int(tile_words or _sparse.DEFAULT_TILE_WORDS)
        self.planes, _ = _sparse.rule_layout(rule)
        self.name = name
        self.device = resolve_device(device)
        self.tiles = torch.zeros(
            (self.capacity, self.planes, self.tile_rows, self.tile_words),
            dtype=torch.int32, device=self.device)
        # host table of the page tables; row DEAD_SLOT stays self-dead
        self.neighbors = np.zeros((self.capacity, 8), np.int32)
        self._free: List[int] = list(range(self.capacity - 1, 0, -1))
        # pass a shared runner (serve/lanes.paged_lane_runner) so pools of
        # one geometry share it
        self._runner = runner if runner is not None else make_multi_step_paged(
            rule, self.tile_rows, self.tile_words)
        self.dispatches = 0
        self.syncs = 0
        self._in_use_g = registry.gauge(
            "pool_tiles_in_use", "physical tiles allocated to pages")
        self._free_g = registry.gauge(
            "pool_tiles_free", "physical tiles on the free list")
        self._alloc_c = registry.counter(
            "pool_alloc_total", "page-to-tile allocations")
        self._reclaim_c = registry.counter(
            "pool_reclaim_total", "dead pages reclaimed to the free list")
        self._oom_c = registry.counter(
            "pool_oom_total", "allocations refused on an empty free list")
        self._set_gauges()

    # -- accounting -----------------------------------------------------------

    def _set_gauges(self) -> None:
        self._in_use_g.set(self.in_use(), pool=self.name)
        self._free_g.set(self.free_count(), pool=self.name)

    def free_count(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        """Tiles bound to pages (the dead slot is neither free nor in use)."""
        return self.capacity - 1 - len(self._free)

    def tile_bytes(self) -> int:
        return self.planes * self.tile_rows * self.tile_words * 4

    def tile_cells(self) -> Tuple[int, int]:
        """(rows, cols) of one tile in cell units."""
        return self.tile_rows, self.tile_words * bitpack.WORD

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "in_use": self.in_use(),
            "free": self.free_count(),
            "tile_bytes": self.tile_bytes(),
            "planes": self.planes,
            "tile_rows": self.tile_rows,
            "tile_words": self.tile_words,
        }

    # -- allocator ------------------------------------------------------------

    def alloc(self) -> int:
        """Bind a free slot: host bookkeeping only (the slot is already
        zero on the device)."""
        if not self._free:
            self._oom_c.inc(pool=self.name)
            raise PoolExhausted(
                f"pool {self.name!r} exhausted: {self.capacity - 1} tiles "
                "all bound")
        slot = self._free.pop()
        self._alloc_c.inc(pool=self.name)
        self._set_gauges()
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list, zeroing it on the device and
        severing its page-table row. Callers (PagedGrid._unlink) sever the
        *incoming* edges."""
        if slot == DEAD_SLOT:
            raise ValueError("the dead slot is not allocatable or freeable")
        _zero_slot(self.tiles, slot)
        self.neighbors[slot] = DEAD_SLOT
        self._free.append(slot)
        self._reclaim_c.inc(pool=self.name)
        self._set_gauges()

    # -- slab access ----------------------------------------------------------

    def write(self, slot: int, content) -> None:
        """Seed one tile's (planes, tile_rows, tile_words) words: a host
        uint32 array or an int32 tensor."""
        self.write_many([slot], content[None])

    def write_many(self, slots, contents) -> None:
        """Seed several tiles at once: ``contents`` is ``(len(slots),
        planes, tile_rows, tile_words)``, host uint32 or an int32 tensor."""
        if not isinstance(contents, torch.Tensor):
            contents = state_from_numpy(
                np.asarray(contents, np.uint32).reshape(
                    len(slots) * self.planes, self.tile_rows,
                    self.tile_words)).reshape(
                len(slots), self.planes, self.tile_rows, self.tile_words)
        index = torch.as_tensor(list(slots), dtype=torch.int64,
                                device=self.device)
        _write_slot(self.tiles, index, contents)

    def tiles_host(self) -> np.ndarray:
        """The whole slab on the host as uint32: checkpoint and readback
        granularity; the step path never calls this."""
        with sanitizers.allow_host_transfers(
                "pool slab readback: checkpoint/snapshot reconstruction "
                "is host-side by design"):
            return self.tiles.cpu().numpy().copy().view(np.uint32)

    # -- stepping -------------------------------------------------------------

    def dispatch(self, n: int, mask: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Advance every masked slot ``n`` generations; returns host
        (changed, occupied) bool vectors, the per-chunk wake and retire
        evidence (one readback of both)."""
        self.tiles, changed, occupied = self._runner(
            self.tiles, int(n), self.neighbors, mask)
        with sanitizers.allow_host_transfers(
                "paged pool reads per-slot changed/occupied flags between "
                "chunks: page activation/retirement is host bookkeeping"):
            flags = torch.stack([changed, occupied]).cpu().numpy()
        self.dispatches += 1
        self.syncs += 1
        return flags[0], flags[1]

    def warm(self) -> None:
        """One all-dead dispatch at the pool's only shape. There is nothing
        to compile (the runner is plain torch), so allocation churn after
        ``warm`` is host bookkeeping, as in the JAX package."""
        self.dispatch(1, np.zeros((self.capacity,), np.uint32))


# -- contract-gate registrations (ops/_builders.py BUILDERS) -------------------


def _contract_pool_slab(device, B=16, planes=1, tr=32, tw=4, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 1 << 32, size=(B, planes, tr, tw), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(device)


@register_builder("memory.pool_write_slot", tags=("memory", "paged"))
def _contract_pool_write_slot(device):
    tiles = _contract_pool_slab(device)
    content = torch.ones(tiles.shape[1:], dtype=torch.int32, device=device)
    # the measured call writes the next slot (the first one wrote slot 3)
    return BuiltRunner(_write_slot, (tiles, 3, content),
                       chain=lambda out, a: (out, a[1] + 1, a[2]))


@register_builder("memory.pool_zero_slot", tags=("memory", "paged"))
def _contract_pool_zero_slot(device):
    return BuiltRunner(_zero_slot, (_contract_pool_slab(device), 3),
                       chain=lambda out, a: (out, a[1] + 1))
