"""The device mesh and the sharded grid, single-controller.

Counterpart of ``gameoflifewithactors_tpu.parallel.mesh``. JAX's ``Mesh``
and ``shard_map`` are one process holding arrays placed on many devices;
so is this module: a :class:`Mesh` is an ``(nx, ny)`` array of
``torch.device``s with axes ``(ROW_AXIS, COL_AXIS)``, and a
:class:`ShardedGrid` holds one tensor per distinct device, stacking the
mesh positions that device holds in x-major order. One device may stand
for several positions (the tests use eight CPU positions, a one-card
machine four positions on ``cuda:0``), so one launch per device steps all
of its positions. Halo strips cross positions with
``Tensor.to(device, non_blocking=True)`` (:mod:`.halo`): a peer copy on a
multi-GPU node, nothing at all between positions of one device.

Two layouts, as in JAX:

- tiled (``banded=False``, ``P('x', 'y')``): position ``(i, j)`` holds the
  ``(H/nx, W/ny)`` tile ``(i, j)``, leading plane axis replicated;
- banded (``banded=True``, ``P(('x', 'y'), None)``): the mesh flattens
  x-major into ``nx*ny`` full-width row bands, band ``i*ny + j`` on
  position ``(i, j)`` -- the layout of the band-kernel runners.

A :class:`BatchMesh` is the ``(nb, nx, ny)`` form with a leading batch
axis (``BATCH_AXIS``): ``nb`` replicas of an ``(nx, ny)`` spatial mesh,
each holding a slice of a batch of universes (``parallel.batched``).
Its flat positions are ``b``-major, then x-major, and the halo exchange
finds neighbours within a replica.

Left out: the multi-slice device ordering (``factor2d_sliced``,
``order_devices_for_slices``), which the multi-process layer takes with
``multihost`` (ROADMAP A12, multi-host).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bitpack import WORD

ROW_AXIS = "x"  # shards grid rows
COL_AXIS = "y"  # shards grid columns (packed: word columns)
BATCH_AXIS = "b"  # a batch mesh's replicas (universes, no exchange)


def factor2d(n: int) -> Tuple[int, int]:
    """Factor n devices into the most-square (nx, ny) grid, nx <= ny:
    near-square tiles have the least halo perimeter."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


class Mesh:
    """An ``(nx, ny)`` array of ``torch.device``s, axes ``(ROW_AXIS,
    COL_AXIS)``. ``shape`` is a dict keyed by axis name, as JAX's
    ``mesh.shape[ROW_AXIS]`` is. Every device is of one type (all CUDA or
    all CPU); a device may repeat."""

    axis_names = (ROW_AXIS, COL_AXIS)

    def __init__(self, devices):
        given = np.asarray(devices, dtype=object)
        if given.ndim != len(self.axis_names) or given.size == 0:
            raise ValueError(
                f"a mesh is a non-empty {len(self.axis_names)}D array of "
                f"devices, got shape {given.shape}")
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _normalise(given[idx])
        types = {d.type for d in arr.flat}
        if len(types) != 1 or not types <= {"cuda", "cpu"}:
            raise ValueError(
                f"a mesh holds CUDA devices or CPU devices, not {sorted(types)}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))
        groups: dict = {}
        for p, d in enumerate(arr.flat):   # x-major flat positions
            groups.setdefault(d, []).append(p)
        # (device, its flat positions ascending), in order of first position
        self.groups: Tuple[Tuple[torch.device, Tuple[int, ...]], ...] = tuple(
            (d, tuple(ps)) for d, ps in groups.items())
        # flat position -> (group index, slot in that group's stack)
        self.slot_of = {p: (g, s) for g, (_, ps) in enumerate(self.groups)
                        for s, p in enumerate(ps)}

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        dims = "x".join(str(n) for n in self.shape.values())
        return (f"{type(self).__name__}({dims}, "
                f"{[str(d) for d in self.devices.flat]})")


class BatchMesh(Mesh):
    """An ``(nb, nx, ny)`` array of devices, axes ``(BATCH_AXIS,
    ROW_AXIS, COL_AXIS)``: ``nb`` replicas of an ``(nx, ny)`` spatial
    mesh. Flat positions run b-major, then x-major."""

    axis_names = (BATCH_AXIS, ROW_AXIS, COL_AXIS)


def _normalise(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2D mesh with axes (ROW_AXIS, COL_AXIS) over ``devices`` (x-major),
    by default every CUDA device; without CUDA that default raises, as
    ``engine.resolve_device`` does. ``shape`` defaults to
    :func:`factor2d` of the device count and must use every device. An
    explicit list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; make_mesh places a mesh on the "
                "GPUs unless given devices -- pass devices=['cpu'] * n for a "
                "mesh of CPU positions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = factor2d(len(devices))
    nx, ny = shape
    if nx * ny != len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {nx * ny} devices, have {len(devices)}")
    arr = np.empty((nx, ny), dtype=object)
    for p, d in enumerate(devices):
        arr[p // ny, p % ny] = d
    return Mesh(arr)


def band_axis(mesh: Mesh):
    """The band runners' logical band axis: ROW_AXIS on an (nx, 1) mesh,
    the flattened (ROW_AXIS, COL_AXIS) tuple otherwise -- nx*ny full-width
    bands in x-major position order. Returns (axis, n_bands)."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    axis = ROW_AXIS if ny == 1 else (ROW_AXIS, COL_AXIS)
    return axis, nx * ny


def ghost_halo_words(gens_per_exchange: int) -> int:
    """East/west ghost-zone depth in packed words for a width-k pipeline:
    ``ceil(k / 32)``."""
    return -(-int(gens_per_exchange) // WORD)


def ghost_fits(tile_rows: int, tile_words: int,
               gens_per_exchange: int) -> bool:
    """Whether a (tile_rows, tile_words) per-device packed tile can run
    the width-k ghost-zone pipeline: the boundary rings consumed per block
    are 2k rows and 2*ceil(k/32) words deep, and both must fit inside the
    tile."""
    k = int(gens_per_exchange)
    if k < 1:
        return False
    hw = ghost_halo_words(k)
    return 2 * k <= int(tile_rows) and 2 * hw <= int(tile_words)


def best_mesh_shape(n: int, rows: int, words: int, *,
                    gens_per_exchange: int = 1) -> Optional[Tuple[int, int]]:
    """Most-square (nx, ny) factorization of ``n`` devices that divides a
    packed (rows, words) grid and leaves tiles deep and wide enough for a
    width-``gens_per_exchange`` ghost-zone pipeline (0 skips that
    constraint). None when no factorization fits."""
    best = None
    for nx in range(1, n + 1):
        if n % nx:
            continue
        ny = n // nx
        if rows % nx or words % ny:
            continue
        if (gens_per_exchange >= 1
                and not ghost_fits(rows // nx, words // ny,
                                   gens_per_exchange)):
            continue
        if best is None or abs(nx - ny) < abs(best[0] - best[1]):
            best = (nx, ny)
    return best


def check_divisible(shape: Tuple[int, int], mesh: Mesh) -> None:
    h, w = shape
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    if h % nx or w % ny:
        raise ValueError(
            f"grid {shape} not divisible by mesh ({nx}, {ny}); "
            f"pad the grid or pick a different mesh shape"
        )


@dataclasses.dataclass(frozen=True)
class ShardedGrid:
    """A grid placed on a mesh: ``parts[g]`` lives on ``mesh.groups[g]``'s
    device and stacks that device's positions, ``(k, *lead, rows, cols)``
    with ``lead`` empty for words or bytes and ``(b,)`` for a plane stack.
    Banded: each position holds a full-width row band; tiled: a 2D tile."""

    mesh: Mesh
    parts: Tuple[torch.Tensor, ...]
    banded: bool

    def with_parts(self, parts) -> "ShardedGrid":
        return ShardedGrid(self.mesh, tuple(parts), self.banded)

    def blocks(self) -> List[torch.Tensor]:
        """Every position's block, in flat x-major position order."""
        return [self.parts[g][s] for g, s in
                (self.mesh.slot_of[p] for p in range(self.mesh.size))]

    def gather(self) -> torch.Tensor:
        """The inverse of :func:`device_put_sharded_grid` (and of
        ``batched.device_put``): the global tensor, rebuilt on the mesh's
        first device."""
        home = self.mesh.groups[0][0]
        blocks = [b.to(home) for b in self.blocks()]
        ny = self.mesh.shape[COL_AXIS]
        per = self.mesh.shape[ROW_AXIS] * ny   # positions of one replica

        def spatial(bl):
            if self.banded:
                return torch.cat(bl, dim=-2)
            rows = [torch.cat(bl[i:i + ny], dim=-1)
                    for i in range(0, len(bl), ny)]
            return torch.cat(rows, dim=-2)

        if BATCH_AXIS not in self.mesh.shape:
            return spatial(blocks)
        return torch.cat([spatial(blocks[i:i + per])
                          for i in range(0, len(blocks), per)])


def device_put_sharded_grid(grid: torch.Tensor, mesh: Mesh,
                            banded: bool = False) -> ShardedGrid:
    """Place a grid onto the mesh: ``(H, W)`` cells, ``(H, W/32)`` words
    or a ``(b, H, W/32)`` plane stack (the plane axis replicated).
    ``banded=True`` places full-width row bands over the flattened mesh
    (rows must divide by nx*ny); otherwise 2D tiles (both axes must
    divide). Each device's positions are copied into one new tensor on
    that device."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    H, W = grid.shape[-2:]
    if banded:
        nb = nx * ny
        if H % nb:
            raise ValueError(
                f"grid rows {H} not divisible into {nb} full-width bands "
                f"over the flattened mesh")
        h = H // nb

        def block(p):
            return grid[..., p * h:(p + 1) * h, :]
    else:
        check_divisible((H, W), mesh)
        h, w = H // nx, W // ny

        def block(p):
            i, j = divmod(p, ny)
            return grid[..., i * h:(i + 1) * h, j * w:(j + 1) * w]
    parts = [torch.stack([block(p) for p in positions]).to(device)
             for device, positions in mesh.groups]
    return ShardedGrid(mesh, tuple(parts), banded)
