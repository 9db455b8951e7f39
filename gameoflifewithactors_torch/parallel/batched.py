"""Batch-of-universes runners on one device: the serving lanes' steppers.

Counterpart of ``gameoflifewithactors_tpu.parallel.batched`` on a
(1, 1, 1) mesh. The batch is the leading dimension of a ``(B, H, W/32)``
int32 tensor of packed words; every universe steps at once and none
exchanges anything with another. With a ``mask`` (a ``(B,)`` vector,
nonzero = live), universes whose entry is 0 come out bit-identical to
their input: the serving layer's lane contract, which lets a lane freeze
the slots that owe no generations.

- :func:`make_multi_step_packed_batched` — plain torch: a one-deep halo
  exchange and :func:`..ops.packed.step_packed_ext` per generation.
- :func:`multi_step_kernel_batched` / :func:`make_multi_step_kernel_batched`
  — the counterpart of ``make_multi_step_pallas_batched``: per chunk of
  ``g`` generations, ONE launch of B2's lane form over the whole batch
  (:func:`..ops.cuda_stencil.multi_step_lane_kernel`), which reads the rows
  beyond each universe from the universe itself and copies the frozen
  ones; for a CPU tensor its plain version, the JAX runner's chunk: a
  depth-``g`` row exchange, the slab step, a crop of ``g`` rows per side
  and the mask's select.
- :func:`make_multi_step_paged` — the paged tile pool's runner
  (:mod:`..memory`): a batch of physical tiles whose halos are gathered
  through a ``(B, 8)`` neighbour-slot table, plain torch (the JAX runner
  is XLA's gather and step; no TPU kernel serves it).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.rules import Rule
from ..ops import cuda_stencil
from ..ops.packed import step_packed_ext
from ..ops.stencil import Topology
from .halo import exchange_halo_stack


def _live(mask, grids: torch.Tensor) -> torch.Tensor:
    """The ``(B, 1, 1)`` bool select of a ``(B,)`` mask (numpy or tensor)."""
    if isinstance(mask, torch.Tensor):
        live = mask != 0
    else:
        live = torch.from_numpy(np.asarray(mask) != 0)
    if live.shape != grids.shape[:1]:
        raise ValueError(
            f"mask of shape {tuple(live.shape)} for a batch of {grids.shape[0]}")
    return live.to(grids.device)[:, None, None]


def make_multi_step_packed_batched(rule: Rule,
                                   topology: Topology = Topology.TORUS,
                                   masked: bool = False) -> Callable:
    """``(grids, n) -> grids`` advancing a ``(B, H, W/32)`` packed batch
    ``n`` generations in plain torch; with ``masked=True``
    ``(grids, n, mask)``, mask-0 universes frozen."""

    def run(grids: torch.Tensor, n: int, mask=None) -> torch.Tensor:
        live = None if mask is None else _live(mask, grids)
        for _ in range(int(n)):
            out = step_packed_ext(exchange_halo_stack(grids, topology), rule)
            # frozen slots still pay the stencil; the select keeps their words
            grids = out if live is None else torch.where(live, out, grids)
        return grids

    if masked:
        return lambda grids, n, mask: run(grids, n, mask)
    return lambda grids, n: run(grids, n)


def multi_step_kernel_batched(
    grids: torch.Tensor,
    n: int,
    mask=None,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_BAND_GENS_PER_CALL,
) -> torch.Tensor:
    """Advance a ``(B, H, W/32)`` packed batch exactly ``n`` generations
    through B2's lane form: ``n // g`` launches of ``g =
    gens_per_exchange`` generations (at most ``H``), then one of ``n %
    g``. ``topology`` closes both axes of every universe: under
    TORUS the rows beyond a universe are its own rows modulo ``H``, under
    DEAD they are dead (the slab form's edge code 3). ``mask`` (optional,
    ``(B,)``) freezes the universes whose entry is 0. On a CUDA tensor
    the launches ping-pong between two new buffers
    (:func:`..ops.cuda_stencil.multi_step_lane_kernel`); on a CPU tensor
    each chunk is the lane form's plain version, the JAX runner's
    exchange, slab step, crop and select. Returns a new contiguous
    tensor."""
    if grids.dim() != 3:
        raise ValueError(f"expected a (B, H, W/32) batch, got {tuple(grids.shape)}")
    return cuda_stencil.multi_step_lane_kernel(
        grids.contiguous(), n, mask, rule=rule, topology=topology,
        gens_per_call=gens_per_exchange).contiguous()


def make_multi_step_kernel_batched(
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_BAND_GENS_PER_CALL,
    masked: bool = False,
) -> Callable:
    """The counterpart of ``make_multi_step_pallas_batched``:
    ``(grids, chunks) -> grids`` advancing ``chunks * gens_per_exchange``
    generations through the B2 kernel (``(grids, chunks, mask)`` with
    ``masked=True``). :func:`multi_step_kernel_batched` steps any ``n``."""
    g = int(gens_per_exchange)

    def run(grids: torch.Tensor, chunks: int, mask=None) -> torch.Tensor:
        return multi_step_kernel_batched(
            grids, int(chunks) * g, mask, rule=rule, topology=topology,
            gens_per_exchange=g)

    if masked:
        return lambda grids, chunks, mask: run(grids, chunks, mask)
    return lambda grids, chunks: run(grids, chunks)


# the paged runner's neighbour-gather order: the 8 tile neighbours of a
# pool slot, row-major. OPPOSITE[i] == 7 - i (the reciprocal direction):
# memory/paged.py leans on that symmetry when it back-links a freshly
# allocated page into its neighbours' rows.
PAGED_NEIGHBORS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_multi_step_paged(rule, tile_rows: Optional[int] = None,
                          tile_words: Optional[int] = None) -> Callable:
    """The paged tile-pool runner: ``(tiles, n, neighbors, mask) -> (tiles,
    changed, occupied)``, stepping one batch of physical tiles per
    generation whichever logical grid owns them.

    - ``tiles`` is the pool's ``(B, planes, tile_rows, tile_words)`` int32
      slab (planes = ``ops.sparse.rule_layout(rule)[0]``), advanced in
      place and returned. Slot 0 is the dead tile: all zero, never masked
      live.
    - ``neighbors`` is the page tables' ``(B, 8)`` slot ids in
      :data:`PAGED_NEIGHBORS` order (host array or tensor). Each tile's
      halo is gathered from its 8 neighbours' edges; a missing page points
      at slot 0, whose zeros are the DEAD closure, and a TORUS grid wraps
      its coordinates when it builds the table.
    - ``mask`` is the ``(B,)`` occupancy vector: only the masked slots
      step (the JAX runner steps every slot and selects; the results and
      flags are the same), the others pass through bit for bit.

    Returns the slab and two ``(B,)`` bool tensors on its device:
    ``changed`` (the slot differed from its input at ANY generation: the
    wake flag) and ``occupied`` (the slot holds a live bit at exit)."""
    from ..ops import sparse as _sp

    tile_rows = int(tile_rows or _sp.DEFAULT_TILE_ROWS)
    tile_words = int(tile_words or _sp.DEFAULT_TILE_WORDS)
    _, ndim = _sp.rule_layout(rule)
    r, rw = _sp.rule_halo(rule)
    if r > tile_rows or rw > tile_words:
        raise ValueError(
            f"rule halo ({r} rows, {rw} words) exceeds the slab geometry "
            f"({tile_rows} rows, {tile_words} words): a neighbor gather "
            "can reach one tile ring, no further — grow the slab")
    ext_step = _sp._step_fns(rule, ndim == 3)[0]

    def window(t, nb9):
        # the centre tile (column 4 of nb9) and its 8 neighbours, gathered
        # whole, then cut to their edge strips around the centre
        g = t[nb9]                                   # (M, 9, P, tr, tw)
        top = torch.cat([g[:, 0, ..., -r:, -rw:], g[:, 1, ..., -r:, :],
                         g[:, 2, ..., -r:, :rw]], dim=-1)
        mid = torch.cat([g[:, 3, ..., -rw:], g[:, 4], g[:, 5, ..., :rw]],
                        dim=-1)
        bot = torch.cat([g[:, 6, ..., :r, -rw:], g[:, 7, ..., :r, :],
                         g[:, 8, ..., :r, :rw]], dim=-1)
        return torch.cat([top, mid, bot], dim=-2)

    def gen(t, nb9):
        w = window(t, nb9)
        if ndim == 2:
            return ext_step(w[:, 0])[:, None]
        return ext_step(w.transpose(0, 1)).transpose(0, 1)

    def run(tiles: torch.Tensor, n: int, neighbors, mask):
        dev = tiles.device
        sel = np.flatnonzero(_host(mask))
        changed = torch.zeros(tiles.shape[0], dtype=torch.bool, device=dev)
        if len(sel) and int(n) > 0:
            nb = _host(neighbors)[sel]
            nb9 = torch.from_numpy(np.concatenate(
                [nb[:, :4], sel[:, None], nb[:, 4:]], axis=1).astype(np.int64)
            ).to(dev)
            idx = nb9[:, 4]
            ch = torch.zeros(len(sel), dtype=torch.bool, device=dev)
            for _ in range(int(n)):
                out = gen(tiles, nb9)
                ch |= (out != tiles[idx]).flatten(1).any(1)
                tiles[idx] = out
            changed[idx] = ch
        occupied = (tiles != 0).flatten(1).any(1)
        return tiles, changed, occupied

    return run
