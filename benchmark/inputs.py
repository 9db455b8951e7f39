"""The inputs a cell hands to the program, made from ``--seed`` on the device.

A soup is a grid of independent cells, each alive with the traffic's
fill, drawn by a ``torch.Generator`` on the card seeded with ``--seed``:
the same seed gives the same soup, so the reference draws it again
instead of keeping it. A batch of soups is one draw of shape
``(count, H, W)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

ROWS_PER_DRAW = 2048   # rows of uniforms drawn at once (bounds the float temp)


def soup(shape: Sequence[int], fill: float, seed: int,
         device: torch.device) -> torch.Tensor:
    """``shape`` uint8 cells, 1 with probability ``fill``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    out = torch.empty(tuple(shape), dtype=torch.uint8, device=device)
    rows = out.view(-1, shape[-1])
    for r0 in range(0, rows.shape[0], ROWS_PER_DRAW):
        block = rows[r0:r0 + ROWS_PER_DRAW]
        u = torch.rand(block.shape, generator=gen, device=device)
        torch.lt(u, fill, out=block)
    return out
