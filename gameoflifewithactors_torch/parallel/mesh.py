"""The device mesh and the sharded grid.

Counterpart of ``gameoflifewithactors_tpu.parallel.mesh``. JAX's ``Mesh``
and ``shard_map`` are one process holding arrays placed on many devices;
so is this module, per process: a :class:`Mesh` is an ``(nx, ny)`` array of
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

A mesh may span processes (:func:`.multihost.global_mesh`): every
position has an owner rank (``Mesh.owner_of``), and ``Mesh.groups``,
``Mesh.slot_of`` and a :class:`ShardedGrid`'s ``parts`` cover only the
positions of this process (``Mesh.rank``). Strips from positions of
another process arrive by point-to-point messages (:mod:`.halo`). A
single-process mesh has rank 0 everywhere.

The multi-slice device order (:func:`factor2d_sliced`,
:func:`order_devices_for_slices`, ``make_mesh(slice_ids=)``) lays slices
out as contiguous bands of mesh rows, so that only north/south halos
cross a slice boundary. Torch devices carry no slice index: slice ids
come from the caller, and :func:`.multihost.global_mesh` makes each
process's devices one slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
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


def factor2d_sliced(n: int, n_slices: int) -> Tuple[int, int]:
    """Most-square (nx, ny) such that slices can band into whole mesh rows:
    ny must divide the per-slice device count (so each slice fills complete
    rows and only N/S halos cross a slice boundary)."""
    if n % n_slices:
        raise ValueError(f"{n} devices do not split over {n_slices} slices")
    per = n // n_slices
    best = None
    for ny in range(1, per + 1):
        if per % ny == 0:
            nx = n // ny
            if best is None or abs(nx - ny) <= abs(best[0] - best[1]):
                best = (nx, ny)  # ties resolve to nx <= ny, like factor2d
    return best


def slice_ids_of(devices: Sequence) -> list:
    """Per-device slice index; a device without one (every torch device)
    reports 0."""
    return [getattr(d, "slice_index", 0) or 0 for d in devices]


def order_devices_for_slices(devices: Sequence, shape: Tuple[int, int],
                             slice_ids: Optional[Sequence[int]] = None
                             ) -> np.ndarray:
    """Arrange ``devices`` into an ``(nx, ny)`` array so that each mesh row
    holds devices of exactly one slice, slices in ascending id owning
    contiguous row bands: per generation only one north and one south
    strip per slice boundary crosses it. One slice is a plain reshape."""
    nx, ny = shape
    devices = list(devices)
    ids = list(slice_ids) if slice_ids is not None else slice_ids_of(devices)
    if len(ids) != len(devices):
        raise ValueError(f"{len(ids)} slice ids for {len(devices)} devices")
    groups: dict = {}
    for d, s in zip(devices, ids):
        groups.setdefault(s, []).append(d)
    if len(groups) == 1:
        return _object_array(devices).reshape(nx, ny)
    sizes = {s: len(g) for s, g in groups.items()}
    per = next(iter(sizes.values()))
    if any(v != per for v in sizes.values()):
        raise ValueError(f"uneven devices per slice: {sizes}")
    rows_per_slice, rem = divmod(per, ny)
    if rem or rows_per_slice == 0:
        raise ValueError(
            f"mesh shape {shape}: each slice's {per} devices must fill whole "
            f"mesh rows (need {ny} per row) so slice boundaries align with "
            f"row bands and only N/S halos cross a slice boundary")
    if rows_per_slice * len(groups) != nx:
        raise ValueError(
            f"mesh shape {shape} incompatible with {len(groups)} slices of "
            f"{per}")
    return np.vstack([_object_array(groups[s]).reshape(rows_per_slice, ny)
                      for s in sorted(groups)])


def _object_array(items: Sequence) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr


def arrange(shape: Optional[Tuple[int, int]], n: int,
            slice_ids: Sequence[int], *, explicit: bool) -> np.ndarray:
    """The ``(nx, ny)`` array of indices into a list of ``n`` devices whose
    slice ids are ``slice_ids``: :func:`make_mesh`'s layout decision.
    ``shape`` defaults to :func:`factor2d_sliced` over several slices,
    else :func:`factor2d`. Where no slice-banded layout fits, ``explicit``
    ids raise, and ids the devices carry fall back to a plain reshape with
    a warning."""
    ids = list(slice_ids)
    n_slices = len(set(ids))
    if shape is None:
        shape = (factor2d_sliced(n, n_slices)
                 if n_slices > 1 and n % n_slices == 0 else factor2d(n))
    nx, ny = shape
    if nx * ny != n:
        raise ValueError(
            f"mesh shape {shape} needs {nx * ny} devices, have {n}")
    try:
        return order_devices_for_slices(range(n), (nx, ny), ids)
    except ValueError as e:
        if explicit:
            raise  # the caller asked for this exact banding
        warnings.warn(
            f"slice-banded layout impossible for mesh {tuple(shape)} "
            f"({n_slices} slices): {e}; falling back to unordered layout "
            "(halo exchange may cross slices on both axes)", stacklevel=3)
        return _object_array(range(n)).reshape(nx, ny)


class Mesh:
    """An ``(nx, ny)`` array of ``torch.device``s, axes ``(ROW_AXIS,
    COL_AXIS)``. ``shape`` is a dict keyed by axis name, as JAX's
    ``mesh.shape[ROW_AXIS]`` is. Every device is of one type (all CUDA or
    all CPU); a device may repeat. ``owners`` (same shape, default all 0)
    names the process rank holding each position; this process is
    ``rank``, and ``groups`` and ``slot_of`` cover its positions only."""

    axis_names = (ROW_AXIS, COL_AXIS)

    def __init__(self, devices, owners=None, rank: int = 0):
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
        owned = (np.zeros(arr.shape, dtype=np.int64) if owners is None
                 else np.asarray(owners, dtype=np.int64))
        if owned.shape != arr.shape:
            raise ValueError(
                f"owners of shape {owned.shape} for a mesh of shape "
                f"{arr.shape}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.rank = int(rank)
        # flat position -> the rank of the process holding it
        self.owner_of: Tuple[int, ...] = tuple(int(r) for r in owned.flat)
        # this process's flat positions, ascending (x-major)
        self.positions: Tuple[int, ...] = tuple(
            p for p, r in enumerate(self.owner_of) if r == self.rank)
        if not self.positions:
            raise ValueError(f"rank {self.rank} holds no position of the mesh")
        groups: dict = {}
        for p in self.positions:
            groups.setdefault(arr.flat[p], []).append(p)
        # (device, its flat positions ascending), in order of first position
        self.groups: Tuple[Tuple[torch.device, Tuple[int, ...]], ...] = tuple(
            (d, tuple(ps)) for d, ps in groups.items())
        # flat position -> (group index, slot in that group's stack)
        self.slot_of = {p: (g, s) for g, (_, ps) in enumerate(self.groups)
                        for s, p in enumerate(ps)}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def spans_processes(self) -> bool:
        return len(self.positions) < self.size

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


def add_positions_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--positions", type=int, default=None, metavar="N",
                    help="mesh positions, every one on --device (default: "
                         "every device of --device's type); the counterpart "
                         "of the JAX rig's "
                         "--xla_force_host_platform_device_count")


def mesh_devices(device: str, positions: Optional[int]) -> List[torch.device]:
    """The devices a mesh demo or the weak-scaling sweep spreads over:
    ``positions`` times ``device``, or every device of its type (every
    CUDA device, or the one CPU), as ``config.build_mesh`` takes them.
    Raises without a card when ``device`` is ``"cuda"``."""
    from ..engine import resolve_device

    dev = resolve_device(device)
    if positions is not None:
        if positions < 1:
            raise ValueError(f"--positions must be >= 1, got {positions}")
        return [dev] * positions
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None, *,
              slice_ids: Optional[Sequence[int]] = None) -> Mesh:
    """A 2D mesh with axes (ROW_AXIS, COL_AXIS) over ``devices``, by
    default every CUDA device; without CUDA that default raises, as
    ``engine.resolve_device`` does. An explicit list may repeat a device.
    ``shape`` defaults to the most-square factorization (over several
    slices, one whose rows each slice fills) and must use every device.
    With ``slice_ids`` (one per device) the slices own contiguous row
    bands (:func:`order_devices_for_slices`), or the call raises; without
    them every torch device is slice 0 and the layout is x-major."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; make_mesh places a mesh on the "
                "GPUs unless given devices -- pass devices=['cpu'] * n for a "
                "mesh of CPU positions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    ids = (list(slice_ids) if slice_ids is not None
           else slice_ids_of(devices))
    order = arrange(shape, len(devices), ids, explicit=slice_ids is not None)
    arr = np.empty(order.shape, dtype=object)
    for idx in np.ndindex(order.shape):
        arr[idx] = devices[order[idx]]
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
        """The block of every position this process holds
        (``mesh.positions``: on a single-process mesh every position), in
        flat x-major position order."""
        return [self.parts[g][s] for g, s in
                (self.mesh.slot_of[p] for p in self.mesh.positions)]

    def gather(self) -> torch.Tensor:
        """The inverse of :func:`device_put_sharded_grid` (and of
        ``batched.device_put``): the global tensor, rebuilt on the mesh's
        first device. A mesh spanning processes holds only some blocks
        here: :func:`.multihost.gather_global` gathers those."""
        if self.mesh.spans_processes:
            raise ValueError(
                "this process holds only its own positions of a mesh that "
                "spans processes; use parallel.multihost.gather_global")
        home = self.mesh.groups[0][0]
        return assemble([b.to(home) for b in self.blocks()], self.mesh,
                        self.banded)


def assemble(blocks: Sequence[torch.Tensor], mesh: Mesh,
             banded: bool) -> torch.Tensor:
    """The global tensor from every position's block (flat x-major order,
    all on one device): bands stacked down the rows, or tiles row by row;
    on a batch mesh one such grid per replica, stacked."""
    ny = mesh.shape[COL_AXIS]
    per = mesh.shape[ROW_AXIS] * ny   # positions of one replica

    def spatial(bl):
        if banded:
            return torch.cat(bl, dim=-2)
        rows = [torch.cat(bl[i:i + ny], dim=-1)
                for i in range(0, len(bl), ny)]
        return torch.cat(rows, dim=-2)

    if BATCH_AXIS not in mesh.shape:
        return spatial(list(blocks))
    return torch.cat([spatial(list(blocks[i:i + per]))
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
