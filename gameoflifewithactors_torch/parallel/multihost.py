"""Multi-process layer: what one process writes of a sharded grid.

Counterpart of ``gameoflifewithactors_tpu.parallel.multihost``, for now
only :func:`local_shards`, the per-process write set of a sharded v2
checkpoint (:func:`..utils.checkpoint.write_shards`). A
:class:`.mesh.ShardedGrid` is single-controller: this process holds every
position, so its shards tile the whole grid. The rest of the module
(``initialize``, the global meshes, ``put_global_grid``,
``gather_global``) waits for the multi-host port (ROADMAP A12).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .mesh import COL_AXIS, ShardedGrid


def _host(block: torch.Tensor) -> np.ndarray:
    """A new host copy of a block; int32 words and plane stacks come back
    as the uint32 words the checkpoint format stores, by a view."""
    host = block.detach().cpu().numpy().copy()
    return host.view(np.dtype("<u4")) if host.dtype == np.int32 else host


def local_shards(grid: ShardedGrid) -> List[Tuple[tuple, np.ndarray]]:
    """``[(global_index, host_data), ...]`` for every position's block:
    ``global_index`` a tuple of slices into the global array (the plane
    axis of a ``(b, H, W/32)`` stack whole), ``host_data`` the block on
    the host (uint32 for packed words). Positions holding the same global
    index are dropped after the first, so the shards tile the global array
    exactly once (what ``commit_manifest`` verifies). Each block moves
    device->host on its own."""
    mesh = grid.mesh
    ny = mesh.shape[COL_AXIS]
    out: List[Tuple[tuple, np.ndarray]] = []
    seen = set()
    for p, block in enumerate(grid.blocks()):
        *lead, h, w = block.shape
        if grid.banded:
            rows, cols = slice(p * h, (p + 1) * h), slice(0, w)
        else:
            i, j = divmod(p, ny)
            rows, cols = slice(i * h, (i + 1) * h), slice(j * w, (j + 1) * w)
        index = tuple(slice(0, n) for n in lead) + (rows, cols)
        key = tuple((sl.start, sl.stop) for sl in index)
        if key in seen:
            continue
        seen.add(key)
        out.append((index, _host(block)))
    return out
