"""Paged tile-pool grid memory.

Counterpart of ``gameoflifewithactors_tpu.memory``: the paged-KV-cache
idea applied to CA grids. A fixed slab of physical tiles
(:class:`TilePool`, one device tensor) backs any number of logical
universes (:class:`PagedGrid`) through per-grid page tables. Missing pages
alias one dead tile, so a 4096² universe with 2% live cells costs a few
dozen physical tiles instead of 4096 dense ones, and a universe with no
bounds at all (:class:`PagedUniverse`) costs only its live front.

Everything the pool steps goes through one runner
(:func:`..parallel.batched.make_multi_step_paged`, plain torch: the JAX
package leaves this path to XLA): geometry, topology and occupancy are
runtime operands (page table and mask), so tenants of different logical
shapes share it.
"""

from .pool import DEAD_SLOT, PoolExhausted, TilePool
from .paged import (
    PagedEngineState,
    PagedGrid,
    PagedUniverse,
    default_chunk_gens,
    step_grids,
)

__all__ = [
    "DEAD_SLOT",
    "PoolExhausted",
    "TilePool",
    "PagedEngineState",
    "PagedGrid",
    "PagedUniverse",
    "default_chunk_gens",
    "step_grids",
]
