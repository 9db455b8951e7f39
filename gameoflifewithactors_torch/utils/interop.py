"""Carrying grid state between the JAX package and this one.

A packed grid is the whole state of a run (with its rule and topology):
``(H, W/32)`` words for binary rules, a ``(b, H, W/32)`` bit-plane stack
for multi-state rules (Generations, Larger than Life with C >= 3); this
system has no weights. The JAX package stores packed words as uint32,
this package as int32 with the same bits (see ``ops/bitpack.py``), so the
hand-over is a reinterpreting view on the host:

    words = np.asarray(jax_engine.state)              # uint32 words or stack
    engine = Engine.from_packed(words, rule, topology=..., device=...)
    back = state_to_numpy(engine.state)               # uint32 again

The activity-tiled engines carry more than the grid: the sparse engine
its padded buffer, activity map and capacity policy
(:func:`sparse_state_from_numpy`), a paged grid its pages
(:func:`paged_grid_from_numpy`, also the loader of ``paged1`` files).
"""

from __future__ import annotations

import numpy as np
import torch


def host_to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device`` without a host sync. On a card it is
    staged through pinned memory and copied asynchronously on the current
    stream: a blocking copy would first wait for every kernel queued on
    the stream (and trips the transfer guard,
    :func:`..analysis.sanitizers.no_implicit_host_transfers`)."""
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def state_from_numpy(words_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """(H, W/32) words or a (b, H, W/32) stack, uint32 -> a new int32
    tensor on ``device``, bit for bit (the tensor never aliases the
    caller's buffer)."""
    words = np.asarray(words_u32)
    if words.ndim not in (2, 3):
        raise ValueError(
            f"packed words must be (H, W/32) or (b, H, W/32), got {words.shape}")
    if words.dtype not in (np.dtype("<u4"), np.dtype("<i4")):
        raise TypeError(f"packed words must be uint32 or int32, got {words.dtype}")
    host = np.ascontiguousarray(words).view(np.int32)
    return torch.from_numpy(host.copy()).to(device)


def state_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 packed words or plane stack (any device) -> a new host
    ``'<u4'`` array."""
    if t.dtype != torch.int32 or t.dim() not in (2, 3):
        raise TypeError(
            f"expected a 2D or 3D int32 packed tensor, got {t.dtype} "
            f"{tuple(t.shape)}")
    return t.detach().cpu().numpy().copy().view(np.dtype("<u4"))


def sparse_state_from_numpy(padded_u32: np.ndarray, active: np.ndarray, rule,
                            *, topology, tile_rows: int, tile_words: int,
                            capacity: int, adaptive: bool,
                            chunk_gens: int = 1, device=None):
    """A :class:`..ops.sparse.SparseEngineState` continuing a JAX one bit
    for bit from its host arrays: ``padded`` (words with their ring),
    ``active`` (the ``(nty, ntx)`` map), ``capacity``, whether it is
    adaptive (the JAX state's ``_adaptive``), the tiles and the chunk
    depth. Lives on ``device`` (``"cuda"`` unless the caller asks for
    the CPU)."""
    from ..engine import resolve_device
    from ..ops.sparse import SparseEngineState, _rule_halo

    dev = resolve_device(device)
    padded = state_from_numpy(padded_u32, dev)
    r, rw = _rule_halo(rule)
    ring = r * chunk_gens
    state = SparseEngineState(
        padded[..., ring:-ring, rw:-rw], rule, tile_rows=tile_rows,
        tile_words=tile_words, capacity=None if adaptive else capacity,
        topology=topology, chunk_gens=chunk_gens)
    state.padded = padded
    state.active = torch.from_numpy(np.asarray(active, bool).copy()).to(dev)
    state._set_capacity(capacity)
    return state


def paged_grid_from_numpy(coords, tiles_u32: np.ndarray, rule, *, topology,
                          bounds, tile_rows: int, tile_words: int,
                          active=(), generation: int = 0, pool=None,
                          capacity=None, registry=None, device=None):
    """A :class:`..memory.PagedGrid` holding the given pages: ``coords``
    (tile coordinates) and ``tiles`` (their ``(len(coords), planes,
    tile_rows, tile_words)`` words, such as a JAX pool's slab indexed by
    its grid's slots), with the wake set ``active`` and ``generation``.
    Pages allocate in ``coords`` order, into ``pool`` or a new pool on
    ``device`` of ``capacity`` slots (default: twice the pages plus one, at
    least 16) -- the order and sizes of the ``paged1`` loader, so slot ids
    match the JAX package's loader."""
    from ..memory import PagedGrid, TilePool

    if pool is None:
        kwargs = {} if registry is None else {"registry": registry}
        pool = TilePool(rule, int(capacity or max(2 * len(coords) + 1, 16)),
                        tile_rows=tile_rows, tile_words=tile_words,
                        device=device, **kwargs)
    grid = PagedGrid(pool, topology=topology,
                     bounds=tuple(bounds) if bounds is not None else None)
    cs = [tuple(int(v) for v in c) for c in coords]
    grid.ensure(cs)
    if cs:
        pool.write_many([grid.pages[c] for c in cs],
                        np.asarray(tiles_u32, np.uint32))
    grid.active = {tuple(int(v) for v in c) for c in active}
    grid.generation = int(generation)
    return grid
