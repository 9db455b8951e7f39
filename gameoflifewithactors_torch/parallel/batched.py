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
  ``g`` generations, a depth-``g`` row exchange, ONE launch of the B2
  kernel over the whole batch (:func:`..ops.cuda_stencil.slab_step_kernel`;
  its plain version for a CPU tensor), a crop of ``g`` rows per side and
  the mask's select. The paged runner waits for ROADMAP A10.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.rules import Rule
from ..ops import cuda_stencil
from ..ops.packed import step_packed_ext
from ..ops.stencil import Topology
from .halo import band_edge_code, exchange_halo_stack, exchange_rows_stack


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
    gens_per_exchange: int = cuda_stencil.DEFAULT_GENS_PER_CALL,
) -> torch.Tensor:
    """Advance a ``(B, H, W/32)`` packed batch exactly ``n`` generations
    through the B2 kernel: ``n // g`` chunks of ``g = gens_per_exchange``
    generations, then one of ``n % g`` (its exchange and crop as deep as
    the chunk). Under DEAD each band is the whole grid, so the edge code is
    3 and the kernel keeps the rows beyond the grid dead; under TORUS it is
    0 and the exchanged rows evolve freely. ``mask`` (optional, ``(B,)``)
    freezes the universes whose entry is 0. Returns a new contiguous
    tensor."""
    if grids.dim() != 3:
        raise ValueError(f"expected a (B, H, W/32) batch, got {tuple(grids.shape)}")
    g = cuda_stencil._depth(gens_per_exchange, cuda_stencil.DEFAULT_GENS_PER_CALL)
    if g > grids.shape[1]:
        raise ValueError(
            f"gens_per_exchange={g} exceeds the band height {grids.shape[1]}")
    live = None if mask is None else _live(mask, grids)
    edge = band_edge_code() if topology is Topology.DEAD else 0
    for depth in cuda_stencil._launch_plan(n, g):
        ext = exchange_rows_stack(grids, topology, depth)
        out = cuda_stencil.slab_step_kernel(
            ext, depth, rule=rule, topology=topology, edge_code=edge,
        )[:, depth:-depth]
        grids = out if live is None else torch.where(live, out, grids)
    return grids.contiguous()


def make_multi_step_kernel_batched(
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_GENS_PER_CALL,
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
