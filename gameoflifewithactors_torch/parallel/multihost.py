"""Multi-process layer on ``torch.distributed``: one process group, meshes
whose positions span processes, placing and gathering grids on them, and
what one process writes of a sharded grid.

Counterpart of ``gameoflifewithactors_tpu.parallel.multihost``:

- :func:`initialize` / :func:`shutdown` -- the process group (idempotent
  both), over an explicit ``tcp://`` address, world size, rank, timeout
  and backend: ``"gloo"`` for CPU positions and wherever two ranks share
  one card (CUDA strips then go through host memory), ``"nccl"`` where
  each rank has a card of its own;
- :func:`global_mesh` -- a 2D mesh over the positions of every process,
  each process bringing its own devices (the roster is exchanged once,
  with ``all_gather_object``); by default each process's positions are
  one slice, laid out as whole mesh rows (:func:`.mesh.make_mesh`'s
  multi-slice order), so that only north/south strips cross processes;
- :func:`global_mesh_for_grid` -- the elastic runtime's re-tiling
  decision (:func:`mesh_shape_for_grid`, the JAX package's rule);
- :func:`put_global_grid` -- each process copies only its own positions'
  blocks of a host grid it holds whole;
- :func:`gather_global` -- the full grid on every process, as numpy;
- :func:`local_shards` -- this process's write set of a sharded v2
  checkpoint (:func:`..utils.checkpoint.write_shards`).

The runners of :mod:`.sharded` take a global mesh as they take a
single-process one: every process runs the same runner on its own
positions and :func:`.halo.transfer` carries the strips between them.
"""

from __future__ import annotations

import datetime
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import (
    COL_AXIS,
    Mesh,
    ShardedGrid,
    _normalise,
    arrange,
    assemble,
    best_mesh_shape,
    device_put_sharded_grid,
    ghost_fits,
)

DEFAULT_TIMEOUT_SECONDS = 300.0
BACKENDS = ("gloo", "nccl")


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    backend: str,
    initialization_timeout: Optional[float] = None,
    device=None,
) -> None:
    """Join the process group (a no-op when this process already has one).

    ``coordinator_address`` is ``host:port`` of rank 0's store;
    ``initialization_timeout`` (seconds, default
    :data:`DEFAULT_TIMEOUT_SECONDS`) bounds the rendezvous and every
    collective and message after it. Under ``"nccl"`` the rank's card is
    ``device`` (default the current CUDA device); NCCL refuses two ranks
    on one card, so such a layout raises :class:`ValueError` naming gloo
    (checked through the group's store, before any NCCL call). The
    backend is never switched behind the caller's back."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    card = None
    if backend == "nccl":
        card = _normalise(device if device is not None else "cuda")
        if card.type != "cuda":
            raise ValueError(
                f"backend 'nccl' runs ranks on CUDA devices, not {card}; use "
                "backend='gloo' for CPU positions")
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(
            seconds=initialization_timeout or DEFAULT_TIMEOUT_SECONDS))
    if card is not None:
        _refuse_shared_cards(card)


def _refuse_shared_cards(card: torch.device) -> None:
    """Under NCCL, every rank publishes its card's identity in the group's
    store and reads the others'; two ranks on one card tear the group
    down and raise."""
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    props = torch.cuda.get_device_properties(card)
    me = f"{socket.gethostname()}/{getattr(props, 'uuid', card.index)}"
    rank, world = dist.get_rank(), dist.get_world_size()
    store.set(f"goltpu_card_{rank}", me)
    cards = [store.get(f"goltpu_card_{r}").decode() for r in range(world)]
    shared = sorted(r for r in range(world) if cards[r] == me and r != rank)
    if shared:
        dist.destroy_process_group()
        raise ValueError(
            f"backend 'nccl' refuses two ranks on one card: rank {rank} and "
            f"rank(s) {shared} use {card} ({me}); use backend='gloo', which "
            "stages CUDA strips through host memory")


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _local_devices(devices: Optional[Sequence]) -> List[torch.device]:
    """This process's positions: ``devices``, by default its current CUDA
    device (raising without CUDA, as :func:`.mesh.make_mesh` does)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; a global mesh places this "
                "process's positions on its card unless given devices -- "
                "pass devices=['cpu'] * n for CPU positions")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    return [_normalise(d) for d in devices]


def _roster(devices: Sequence[torch.device]
            ) -> Tuple[List[torch.device], List[int]]:
    """Every process's positions in rank order, and the rank of each: one
    ``all_gather_object`` of the device names."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return list(devices), [0] * len(devices)
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in devices])
    roster, owners = [], []
    for rank, names in enumerate(gathered):
        roster += [torch.device(n) for n in names]
        owners += [rank] * len(names)
    return roster, owners


def _mesh(shape, roster, owners, slice_ids) -> Mesh:
    order = arrange(shape, len(roster), list(slice_ids)
                    if slice_ids is not None else owners,
                    explicit=slice_ids is not None)
    devices = np.empty(order.shape, dtype=object)
    ranks = np.empty(order.shape, dtype=np.int64)
    for idx in np.ndindex(order.shape):
        devices[idx] = roster[order[idx]]
        ranks[idx] = owners[order[idx]]
    return Mesh(devices, ranks, process_index())


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                devices: Optional[Sequence] = None, *,
                slice_ids: Optional[Sequence[int]] = None) -> Mesh:
    """A 2D mesh over the positions of every process of the group (this
    process's own on ``devices``, default its card). Each process's
    positions are one slice unless ``slice_ids`` (one per global position,
    rank-major) says otherwise; ``shape`` defaults as in
    :func:`.mesh.make_mesh`. Every process must call it alike. Without a
    process group it is this process's mesh."""
    roster, owners = _roster(_local_devices(devices))
    return _mesh(shape, roster, owners, slice_ids)


def mesh_shape_for_grid(n: int, grid_shape: Tuple[int, int],
                        preferred: Optional[Tuple[int, int]] = None, *,
                        gens_per_exchange: int = 1) -> Tuple[int, int]:
    """The mesh shape for a packed (rows, words) grid over ``n``
    positions: ``preferred`` when it fits (position count, divisibility
    and, for a width-k ghost pipeline, tile capacity), else the
    most-square valid factorization (ghost-capable first when k > 1),
    else (n, 1) bands. The JAX package's ``global_mesh_for_grid``
    decision."""
    k = int(gens_per_exchange)
    rows, words = int(grid_shape[0]), int(grid_shape[1])
    if preferred is not None:
        mx, my = preferred
        if (mx * my == n and rows % mx == 0 and words % my == 0
                and (k <= 1 or ghost_fits(rows // mx, words // my, k))):
            return (mx, my)
    shape = None
    if k > 1:
        shape = best_mesh_shape(n, rows, words, gens_per_exchange=k)
    if shape is None:
        shape = best_mesh_shape(n, rows, words, gens_per_exchange=0)
    return shape if shape is not None else (n, 1)


def global_mesh_for_grid(
    grid_shape: Tuple[int, int],
    preferred: Optional[Tuple[int, int]] = None,
    *,
    gens_per_exchange: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The fleet's mesh for a packed (rows, words) grid, shaped by
    :func:`mesh_shape_for_grid` over the global roster: every surviving
    process calls it with the same inputs after a shrink or replace
    epoch, so all of them agree on where the tiles land."""
    roster, owners = _roster(_local_devices(devices))
    shape = mesh_shape_for_grid(len(roster), grid_shape, preferred,
                                gens_per_exchange=gens_per_exchange)
    return _mesh(shape, roster, owners, None)


def put_global_grid(grid: np.ndarray, mesh: Mesh,
                    banded: bool = False) -> ShardedGrid:
    """Place a host grid (the same full copy on every process) onto
    ``mesh``: this process copies only its own positions' blocks. Cells,
    uint32 words (held as int32, bit for bit) or a ``(b, H, W/32)`` plane
    stack, tiled or ``banded`` as :func:`.mesh.device_put_sharded_grid`
    places them."""
    grid = np.ascontiguousarray(grid)
    if grid.dtype == np.uint32:
        grid = grid.view(np.int32)
    return device_put_sharded_grid(torch.from_numpy(grid), mesh, banded)


def _host(block: torch.Tensor) -> np.ndarray:
    """A new host copy of a block; int32 words and plane stacks come back
    as the uint32 words the checkpoint format stores, by a view."""
    host = block.detach().cpu().numpy().copy()
    return host.view(np.dtype("<u4")) if host.dtype == np.int32 else host


def gather_global(state: ShardedGrid) -> np.ndarray:
    """The full grid on every process, as numpy (int32 words as uint32):
    one ``all_gather`` of every process's stacked blocks (through host
    memory under gloo), assembled in position order."""
    import torch.distributed as dist

    mesh = state.mesh
    if not mesh.spans_processes:
        return _host(state.gather())
    home = mesh.groups[0][0]
    mine = torch.stack([b.to(home) for b in state.blocks()])
    if dist.get_backend() == "gloo":
        mine = mine.cpu()
    held = [[p for p in range(mesh.size) if mesh.owner_of[p] == r]
            for r in range(dist.get_world_size())]
    most = max(len(ps) for ps in held)
    if mine.shape[0] < most:
        mine = torch.cat([mine, mine.new_zeros(
            (most - mine.shape[0],) + tuple(mine.shape[1:]))])
    stacks = [torch.empty_like(mine) for _ in held]
    dist.all_gather(stacks, mine)
    blocks: list = [None] * mesh.size
    for stack, positions in zip(stacks, held):
        for i, p in enumerate(positions):
            blocks[p] = stack[i]
    return _host(assemble(blocks, mesh, state.banded))


def local_shards(grid: ShardedGrid) -> List[Tuple[tuple, np.ndarray]]:
    """``[(global_index, host_data), ...]`` for every position this
    process holds: ``global_index`` a tuple of slices into the global
    array (the plane axis of a ``(b, H, W/32)`` stack whole),
    ``host_data`` the block on the host (uint32 for packed words).
    Positions holding the same global index are dropped after the first,
    so the shards of all processes tile the global array exactly once
    (what ``commit_manifest`` verifies). Each block moves device->host on
    its own."""
    mesh = grid.mesh
    ny = mesh.shape[COL_AXIS]
    out: List[Tuple[tuple, np.ndarray]] = []
    seen = set()
    for p, block in zip(mesh.positions, grid.blocks()):
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
