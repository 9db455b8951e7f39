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
  and the mask's select. The paged runner waits for ROADMAP A10.
"""

from __future__ import annotations

from typing import Callable

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
