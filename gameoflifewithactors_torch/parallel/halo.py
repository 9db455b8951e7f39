"""Halo exchange between the positions of a mesh, rows first.

Counterpart of ``gameoflifewithactors_tpu.parallel.halo``, where each
device ``ppermute``s strips of its tile to its mesh neighbours inside
``shard_map``. Here a process holds its positions' blocks
(:class:`.mesh.ShardedGrid`: one stacked tensor per device), and a
position's halo is its neighbour's edge strip, taken from whichever
device's stack holds that neighbour, or sent by the process that holds
it (:func:`transfer`):

- :func:`exchange_rows` -- ``depth`` rows above and below each block,
  along ROW_AXIS or the flattened band axis ``(ROW_AXIS, COL_AXIS)``;
- :func:`exchange_cols` -- ``depth`` columns (words, when packed) left and
  right of the row-extended blocks, along COL_AXIS, so the corner blocks
  ride along with no diagonal transfer;
- :func:`exchange_halo` -- both, the two-phase exchange.

Under TORUS the neighbour order wraps; under DEAD the blocks at the edge
get zeros where ``ppermute`` finds no source, which is the all-dead
boundary. A block is ``(..., rows, cols)``: words, cells or a ``(b, rows,
cols)`` plane stack alike, so the JAX ``*_stack`` forms are these same
functions. The exchange depth must not exceed a block's height.

The split forms :func:`exchange_rows_parts` and
:func:`exchange_cols_parts` take the strips to send instead of the
blocks (the ghost-zone runner sends freshly stepped boundary rings).
On a batch mesh (:class:`.mesh.BatchMesh`) every batch replica is its
own spatial mesh: neighbours are found within it.

Every exchange adds the bytes of the strips that this process's
positions receive from *distinct* mesh positions to this thread's
running total, :func:`exchanged_bytes`: a self-send on a size-1 TORUS
axis and the zeros at a DEAD edge count nothing, as the JAX package's
``collective_permute_bytes`` counts pairs of positions (not devices: two
positions on one device still count). Summed over the processes of a
mesh it is the single-process count. The share of it that came from
another process is :func:`crossed_bytes` (the JAX package's per-process
``local_frac`` of the wire bytes).

The one-band helpers :func:`exchange_rows_stack` and
:func:`exchange_halo_stack` serve the batched serving lanes, whose batch
members are independent universes, each its own single-band mesh.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.stencil import Topology
from .mesh import COL_AXIS, ROW_AXIS, Mesh

_MOVED = threading.local()


def exchanged_bytes() -> int:
    """This thread's running total of halo bytes its process's positions
    received from distinct mesh positions; a measurement reads it before
    and after."""
    return getattr(_MOVED, "total", 0)


def crossed_bytes() -> int:
    """The part of :func:`exchanged_bytes` that arrived from another
    process."""
    return getattr(_MOVED, "crossed", 0)


def _moved(nbytes: int, crossed: bool = False) -> None:
    _MOVED.total = exchanged_bytes() + nbytes
    if crossed:
        _MOVED.crossed = crossed_bytes() + nbytes


def transfer(mesh: Mesh, moves: Sequence[Tuple[int, int, int]],
             take: Callable[[int, int], torch.Tensor]
             ) -> Dict[Tuple[int, int], torch.Tensor]:
    """The strips of one exchange: ``moves`` lists every ``(source,
    destination, direction)`` of the exchange, mesh-wide and alike on
    every process; ``take(q, d)`` is the strip this process's position
    ``q`` sends in direction ``d`` (every position's strip of one
    direction has one shape). Returns ``{(p, d): strip}`` for every
    destination ``p`` of this process, on ``p``'s device.

    Between positions of this process a strip moves by ``.to(device,
    non_blocking=True)`` (a peer copy between two GPUs, nothing between
    positions of one device). A strip between processes is one message:
    every process posts its sends and receives in the order of ``moves``
    sorted by (source, destination, direction), tagged by that triple,
    in one ``torch.distributed.batch_isend_irecv``, and waits for all of
    them, so no two processes can wait on each other. Under gloo, whose
    send and receive take CPU tensors only, a CUDA strip is staged
    through host memory; under NCCL it goes from the device."""
    import torch.distributed as dist

    rank, n, owner = mesh.rank, mesh.size, mesh.owner_of
    got: Dict[Tuple[int, int], torch.Tensor] = {}
    ops, landed = [], []
    host = None
    for q, p, d in sorted(moves):
        src, dst = owner[q], owner[p]
        if rank not in (src, dst):
            continue
        if src == dst:
            strip = take(q, d)
            if q != p:
                _moved(strip.numel() * strip.element_size())
            got[(p, d)] = strip.to(mesh.groups[mesh.slot_of[p][0]][0],
                                   non_blocking=True)
            continue
        if host is None:
            host = dist.get_backend() == "gloo"
        tag = (d * n + q) * n + p
        if src == rank:
            strip = take(q, d).contiguous()
            ops.append(dist.P2POp(dist.isend,
                                  strip.cpu() if host else strip, dst,
                                  tag=tag))
        else:
            device = mesh.groups[mesh.slot_of[p][0]][0]
            like = take(mesh.positions[0], d)
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if host else device)
            ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
            landed.append((p, d, buf, device))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for p, d, buf, device in landed:
        _moved(buf.numel() * buf.element_size(), crossed=True)
        got[(p, d)] = buf.to(device, non_blocking=True)
    return got


def band_edge_code(nbands: int = 1, index: int = 0) -> int:
    """The global-edge code of band ``index`` of ``nbands`` row bands, as
    the slab kernels take it (``cuda_stencil.slab_step_kernel``): bit 0 =
    the band holds the grid's top rows, bit 1 = its bottom rows. One band
    is both: 3."""
    return (1 if index == 0 else 0) | (2 if index == nbands - 1 else 0)


def band_edge_codes(mesh: Mesh, repeat: int = 1) -> List[torch.Tensor]:
    """Per device of ``mesh``, the ``(k * repeat,)`` int32 edge codes of
    the bands it holds (flattened band axis, x-major; on a batch mesh the
    bands of each replica), each repeated ``repeat`` times (a batch
    mesh's universes per position), on that device: the slab kernels'
    per-band operand. Built once per runner, so stepping reads no code
    back to the host."""
    nb = mesh.shape[ROW_AXIS] * mesh.shape[COL_AXIS]
    return [torch.tensor([band_edge_code(nb, p % nb) for p in positions
                          for _ in range(repeat)],
                         dtype=torch.int32, device=device)
            for device, positions in mesh.groups]


def _sources(mesh: Mesh, axis, step: int, wrap: bool) -> List[Optional[int]]:
    """For every flat position, the flat position whose block sits
    ``step`` places before it along ``axis`` within its batch replica
    (None past a DEAD edge)."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    out: List[Optional[int]] = []
    for flat in range(mesh.size):
        base, p = divmod(flat, nx * ny)
        base *= nx * ny
        i, j = divmod(p, ny)
        if axis == ROW_AXIS:
            k, n = i - step, nx
        elif axis == COL_AXIS:
            k, n = j - step, ny
        elif tuple(axis) == (ROW_AXIS, COL_AXIS):
            k, n = p - step, nx * ny
        else:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if not 0 <= k < n:
            if not wrap:
                out.append(None)
                continue
            k %= n
        out.append(base + (k * ny + j if axis == ROW_AXIS
                           else i * ny + k if axis == COL_AXIS else k))
    return out


def _neighbour_strips(mesh: Mesh, directions: Sequence[tuple]
                      ) -> List[List[torch.Tensor]]:
    """For each direction ``(parts, sources, strip)``, per device the
    stacked ``strip`` of each of its positions' source blocks, zeros where
    a source is None; every direction's strips in one :func:`transfer`."""
    moves = [(q, p, d) for d, (_, sources, _) in enumerate(directions)
             for p, q in enumerate(sources) if q is not None]

    def take(q, d):
        parts, _, strip = directions[d]
        g, s = mesh.slot_of[q]
        return strip(parts[g][s:s + 1])

    got = transfer(mesh, moves, take)
    out = []
    for d, (parts, sources, strip) in enumerate(directions):
        out.append([torch.cat([
            got[(p, d)] if sources[p] is not None
            else torch.zeros_like(strip(own[:1])) for p in positions])
            for (_, positions), own in zip(mesh.groups, parts)])
    return out


def _parts_exchange(first: Sequence[torch.Tensor],
                    second: Sequence[torch.Tensor], mesh: Mesh,
                    topology: Topology, axis
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per device, the strips the neighbours along ``axis`` send: the
    ``second`` strips of the positions before (my north or west halo),
    the ``first`` strips of the positions after (my south or east
    halo)."""
    wrap = topology is Topology.TORUS
    before, after = _neighbour_strips(mesh, [
        (second, _sources(mesh, axis, 1, wrap), lambda t: t),
        (first, _sources(mesh, axis, -1, wrap), lambda t: t)])
    return before, after


def exchange_rows_parts(top: Sequence[torch.Tensor],
                        bottom: Sequence[torch.Tensor], mesh: Mesh,
                        topology: Topology, axis=ROW_AXIS
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Row phase of a split two-phase exchange: given, per device, MY top
    and bottom strips ``(k, ..., d, w)``, return ``(north_halo,
    south_halo)``, the strips my neighbours sent me. The traffic and
    direction of :func:`exchange_rows` (my north halo is my north
    neighbour's bottom strip), from strips the caller supplies."""
    return _parts_exchange(top, bottom, mesh, topology, axis)


def exchange_cols_parts(west_cols: Sequence[torch.Tensor],
                        east_cols: Sequence[torch.Tensor], mesh: Mesh,
                        topology: Topology
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Column phase of a split two-phase exchange: given, per device, MY
    west and east columns ``(k, ..., h', d)`` of the row-extended tile
    (so the corner blocks ride along, as in :func:`exchange_cols`),
    return ``(west_halo, east_halo)``."""
    return _parts_exchange(west_cols, east_cols, mesh, topology, COL_AXIS)


def exchange_rows(parts: Sequence[torch.Tensor], mesh: Mesh,
                  topology: Topology, axis=ROW_AXIS,
                  depth: int = 1) -> List[torch.Tensor]:
    """Per device, ``(k, ..., h, w)`` -> ``(k, ..., h + 2*depth, w)``:
    north and south halos of ``depth`` rows from the neighbours along
    ``axis`` (ROW_AXIS of a tiled grid, or the flattened band axis
    ``(ROW_AXIS, COL_AXIS)`` of a banded one); ``depth <= h``."""
    h = parts[0].shape[-2]
    if depth > h:
        raise ValueError(
            f"halo depth {depth} exceeds the band height {h} (the exchange "
            "needs depth <= band rows)")
    wrap = topology is Topology.TORUS
    # my north halo is my north neighbour's bottom strip: data flows +1
    north, south = _neighbour_strips(mesh, [
        (parts, _sources(mesh, axis, 1, wrap),
         lambda t: t[..., h - depth:, :]),
        (parts, _sources(mesh, axis, -1, wrap), lambda t: t[..., :depth, :])])
    return [torch.cat([n, t, s], dim=-2)
            for n, t, s in zip(north, parts, south)]


def exchange_cols(ext: Sequence[torch.Tensor], mesh: Mesh,
                  topology: Topology, depth: int = 1) -> List[torch.Tensor]:
    """Per device, row-extended ``(k, ..., h', w)`` -> ``(k, ..., h', w +
    2*depth)``: west and east halo columns from the neighbours along
    COL_AXIS (the diagonal corners ride in the already-extended rows)."""
    w = ext[0].shape[-1]
    if depth > w:
        raise ValueError(
            f"halo depth {depth} exceeds the tile width {w}")
    wrap = topology is Topology.TORUS
    west, east = _neighbour_strips(mesh, [
        (ext, _sources(mesh, COL_AXIS, 1, wrap), lambda t: t[..., w - depth:]),
        (ext, _sources(mesh, COL_AXIS, -1, wrap), lambda t: t[..., :depth])])
    return [torch.cat([a, t, b], dim=-1) for a, t, b in zip(west, ext, east)]


# a block's leading dimensions are free, so the stacked plane form is the
# same function
exchange_cols_stack = exchange_cols


def exchange_halo(parts: Sequence[torch.Tensor], mesh: Mesh,
                  topology: Topology, depth: int = 1) -> List[torch.Tensor]:
    """The full two-phase exchange of a tiled grid: per device, ``(k, ...,
    h, w)`` -> ``(k, ..., h + 2*depth, w + 2*depth)``."""
    return exchange_cols(exchange_rows(parts, mesh, topology, depth=depth),
                         mesh, topology, depth=depth)


def exchange_rows_stack(stack: torch.Tensor, topology: Topology,
                        depth: int = 1) -> torch.Tensor:
    """``(b, h, w)`` -> ``(b, h + 2*depth, w)``: ``depth`` halo rows above
    and below each band (``depth <= h``), the band's own last and first
    rows under TORUS, zeros under DEAD -- every batch member a mesh of one
    band (the serving lanes)."""
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
    along (the two-phase exchange of a one-position mesh per member)."""
    ext = exchange_rows_stack(stack, topology, depth)
    if topology is Topology.TORUS:
        west, east = ext[:, :, -depth:], ext[:, :, :depth]
    else:
        west = east = ext.new_zeros(tuple(ext.shape[:2]) + (depth,))
    return torch.cat([west, ext, east], dim=2)
