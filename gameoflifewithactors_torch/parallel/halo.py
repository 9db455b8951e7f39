"""The one-device halo exchange of a batch of row bands.

Counterpart of ``gameoflifewithactors_tpu.parallel.halo`` on a mesh of
one band: a band's neighbours above and below are itself, so TORUS wraps
the band's own rows and DEAD, where the reference's ``ppermute`` finds no
source, puts zeros. Multi-device exchange (``torch.distributed``) waits
for ROADMAP A12.
"""

from __future__ import annotations

import torch

from ..ops.stencil import Topology


def band_edge_code(nbands: int = 1, index: int = 0) -> int:
    """The global-edge code of band ``index`` of ``nbands`` row bands, as
    the B2 kernel takes it (``cuda_stencil.slab_step_kernel``): bit 0 =
    the band holds the grid's top rows, bit 1 = its bottom rows. One band
    is both: 3."""
    return (1 if index == 0 else 0) | (2 if index == nbands - 1 else 0)


def exchange_rows_stack(stack: torch.Tensor, topology: Topology,
                        depth: int = 1) -> torch.Tensor:
    """``(b, h, w)`` -> ``(b, h + 2*depth, w)``: ``depth`` halo rows above
    and below each band (``depth <= h``), the band's own last and first
    rows under TORUS, zeros under DEAD."""
    if topology is Topology.TORUS:
        north, south = stack[:, -depth:], stack[:, :depth]
    else:
        north = south = stack.new_zeros(
            (stack.shape[0], depth) + tuple(stack.shape[2:]))
    return torch.cat([north, stack, south], dim=1)


def exchange_halo_stack(stack: torch.Tensor, topology: Topology,
                        depth: int = 1) -> torch.Tensor:
    """``(b, h, w)`` -> ``(b, h + 2*depth, w + 2*depth)``: rows first, then
    the columns of the row-extended stack, so the corner blocks ride
    along (the reference's two-phase exchange on one device)."""
    ext = exchange_rows_stack(stack, topology, depth)
    if topology is Topology.TORUS:
        west, east = ext[:, :, -depth:], ext[:, :, :depth]
    else:
        west = east = ext.new_zeros(tuple(ext.shape[:2]) + (depth,))
    return torch.cat([west, ext, east], dim=2)
