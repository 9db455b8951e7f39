"""Batch-of-universes runners: the serving lanes' steppers, and the batch
mesh.

Counterpart of ``gameoflifewithactors_tpu.parallel.batched``. On one
device (a (1, 1, 1) mesh): The batch is the leading dimension of a ``(B, H, W/32)``
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

On a batch mesh (:func:`make_batch_mesh`, an ``(nb, nx, ny)``
:class:`.mesh.BatchMesh`): every batch replica holds ``B / nb``
universes, each split over its ``(nx, ny)`` spatial mesh, as 2D tiles
(:func:`batch_sharding`) or as ``nx*ny`` full-width row bands
(:func:`batch_band_sharding`); universes never exchange with each other.

- :func:`make_multi_step_packed_batched_mesh` — plain torch on 2D tiles,
  a one-deep two-phase exchange per generation;
- :func:`make_multi_step_kernel_batched_mesh` — the counterpart of the
  multi-device ``make_multi_step_pallas_batched``: per chunk of ``g``
  generations a depth-``g`` row exchange and ONE launch of B2's slab form
  per device over all of its (universe, band) pairs, each band with its
  edge code, then the crop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.rules import Rule
from ..ops import cuda_stencil
from ..ops._builders import BuiltRunner, register_builder, steps_in_place
from ..ops.packed import step_packed_ext
from ..ops.stencil import Topology
from ..utils.interop import host_to_device
from .halo import band_edge_codes, exchange_halo, exchange_halo_stack, exchange_rows
from .mesh import (
    BATCH_AXIS,
    COL_AXIS,
    ROW_AXIS,
    BatchMesh,
    ShardedGrid,
    band_axis,
)


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

    @steps_in_place
    def run(tiles: torch.Tensor, n: int, neighbors, mask):
        dev = tiles.device
        sel = np.flatnonzero(_host(mask))
        changed = torch.zeros(tiles.shape[0], dtype=torch.bool, device=dev)
        if len(sel) and int(n) > 0:
            nb = _host(neighbors)[sel]
            nb9 = host_to_device(torch.from_numpy(np.concatenate(
                [nb[:, :4], sel[:, None], nb[:, 4:]], axis=1).astype(np.int64)
            ), dev)
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


# -- the batch mesh -----------------------------------------------------------


def make_batch_mesh(shape: Tuple[int, int, int],
                    devices: Optional[Sequence] = None) -> BatchMesh:
    """A (b, x, y) mesh: ``nb`` batch replicas of an ``(nx, ny)`` spatial
    mesh over ``devices`` (b-major, then x-major), by default every CUDA
    device; without CUDA that default raises. A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; make_batch_mesh places a mesh "
                "on the GPUs unless given devices -- pass devices=['cpu'] * n "
                "for a mesh of CPU positions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    nb, nx, ny = shape
    if nb * nx * ny != len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {nb * nx * ny} devices, have "
            f"{len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return BatchMesh(arr.reshape(nb, nx, ny))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Where a ``(B, H, W/32)`` batch goes on a batch mesh: 2D tiles of
    every universe (``banded=False``, JAX ``P('b', 'x', 'y')``) or
    ``nx*ny`` full-width row bands (``banded=True``, JAX ``P('b', ('x',
    'y'), None)``). :func:`device_put` places a batch by it."""

    mesh: BatchMesh
    banded: bool


def batch_sharding(mesh: BatchMesh) -> BatchSharding:
    return BatchSharding(mesh, False)


def batch_band_sharding(mesh: BatchMesh) -> BatchSharding:
    """Placement for the batch x band-kernel runner on an ``(nb, nx, ny >
    1)`` mesh: the rows of every universe split into nx*ny full-width
    bands over the flattened spatial axes (the banded layout of
    :func:`.mesh.device_put_sharded_grid`, batch axis in front)."""
    return BatchSharding(mesh, True)


def device_put(grids: torch.Tensor, sharding: BatchSharding) -> ShardedGrid:
    """Place a ``(B, H, W/32)`` batch on a batch mesh: position ``(b, i,
    j)`` holds universes ``[b*B/nb, (b+1)*B/nb)``, each cut to its tile or
    band; each device's positions are stacked into one ``(k, B/nb, h,
    w)`` tensor on that device. ``.gather()`` is the inverse."""
    mesh = sharding.mesh
    nb, nx, ny = (mesh.shape[a] for a in (BATCH_AXIS, ROW_AXIS, COL_AXIS))
    B, H, W = grids.shape
    per = nx * ny
    if B % nb:
        raise ValueError(f"batch {B} not divisible over {nb} replicas")
    if sharding.banded:
        if H % per:
            raise ValueError(
                f"grid rows {H} not divisible into {per} full-width bands "
                f"over the flattened mesh")
        h, w = H // per, W
    else:
        if H % nx or W % ny:
            raise ValueError(
                f"grid {(H, W)} not divisible by mesh ({nx}, {ny}); pad the "
                "grid or pick a different mesh shape")
        h, w = H // nx, W // ny
    bl = B // nb

    def block(p):
        b, q = divmod(p, per)
        if sharding.banded:
            i, j = q, 0
        else:
            i, j = divmod(q, ny)
        return grids[b * bl:(b + 1) * bl, i * h:(i + 1) * h,
                     j * w:(j + 1) * w]

    parts = [torch.stack([block(p) for p in positions]).to(device)
             for device, positions in mesh.groups]
    return ShardedGrid(mesh, tuple(parts), sharding.banded)


def _mesh_live(mesh: BatchMesh, mask, batch: int) -> List[torch.Tensor]:
    """Per device, the ``(k, B/nb, 1, 1)`` bool select of its universes
    from a ``(B,)`` mask (numpy or tensor)."""
    live = mask != 0 if isinstance(mask, torch.Tensor) else \
        torch.from_numpy(np.asarray(mask) != 0)
    nb = mesh.shape[BATCH_AXIS]
    per = mesh.size // nb
    if live.shape != (batch,):
        raise ValueError(
            f"mask of shape {tuple(live.shape)} for a batch of {batch}")
    bl = batch // nb
    return [torch.stack([live[(p // per) * bl:(p // per + 1) * bl]
                         for p in positions]).to(device)[..., None, None]
            for device, positions in mesh.groups]


def _batch_of(state: ShardedGrid) -> int:
    return state.parts[0].shape[1] * state.mesh.shape[BATCH_AXIS]


def make_multi_step_packed_batched_mesh(
    mesh: BatchMesh, rule: Rule, topology: Topology = Topology.TORUS,
    masked: bool = False,
) -> Callable:
    """``(state, n) -> state`` over a batch placed by
    :func:`batch_sharding` (2D tiles): per generation a one-deep
    two-phase exchange within every replica and
    :func:`..ops.packed.step_packed_ext` on every tile of every universe;
    the multi-device ``make_multi_step_packed_batched``. With
    ``masked=True``: ``(state, n, mask)``, mask-0 universes frozen."""

    def run(state: ShardedGrid, n: int, mask=None) -> ShardedGrid:
        if state.banded and mesh.shape[COL_AXIS] > 1:
            raise ValueError("this runner takes 2D tiles (batch_sharding)")
        live = None if mask is None else _mesh_live(mesh, mask,
                                                    _batch_of(state))
        parts = state.parts
        for _ in range(int(n)):
            out = [step_packed_ext(e, rule)
                   for e in exchange_halo(parts, mesh, topology)]
            parts = out if live is None else [
                torch.where(lv, o, p) for lv, o, p in zip(live, out, parts)]
        return state.with_parts(parts)

    if masked:
        return lambda state, n, mask: run(state, n, mask)
    return lambda state, n: run(state, n)


def make_multi_step_kernel_batched_mesh(
    mesh: BatchMesh,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_BAND_GENS_PER_CALL,
    masked: bool = False,
) -> Callable:
    """``(state, chunks) -> state`` advancing ``chunks * g`` generations
    of a batch placed in row bands (:func:`batch_band_sharding`; on an
    ``(nb, nx, 1)`` mesh :func:`batch_sharding` is the same layout): the
    counterpart of the multi-device JAX ``make_multi_step_pallas_batched``.
    Per chunk a depth-``g`` row exchange along the (flattened) band axis
    of every replica carries all of a position's universes, then ONE
    launch of B2's slab form per device over all of its (universe, band)
    pairs (:func:`..ops.cuda_stencil.slab_step_kernel`; each band with
    its edge code under DEAD, :func:`.halo.band_edge_codes`), then the
    crop of ``g`` rows per side. On CPU tensors the slab form's plain
    version runs. With ``masked=True``: ``(state, chunks, mask)``; the
    select after every chunk keeps mask-0 universes bit-identical."""
    g = cuda_stencil._depth(gens_per_exchange,
                            cuda_stencil.DEFAULT_BAND_GENS_PER_CALL)
    axis, _ = band_axis(mesh)
    codes: dict = {}

    def edge_codes(bl: int) -> Sequence:
        if topology is not Topology.DEAD:
            return [0] * len(mesh.groups)
        if bl not in codes:
            codes[bl] = band_edge_codes(mesh, repeat=bl)
        return codes[bl]

    def run(state: ShardedGrid, chunks: int, mask=None) -> ShardedGrid:
        if not state.banded and mesh.shape[COL_AXIS] > 1:
            raise ValueError(
                "this runner takes full-width row bands "
                "(batch_band_sharding)")
        rows = state.parts[0].shape[-2]
        if g > rows:
            raise ValueError(
                f"gens_per_exchange={g} exceeds the per-device band height "
                f"{rows}")
        live = None if mask is None else _mesh_live(mesh, mask,
                                                    _batch_of(state))
        parts = state.parts
        bl = parts[0].shape[1]
        for _ in range(int(chunks)):
            out = []
            for e, code in zip(exchange_rows(parts, mesh, topology,
                                             axis=axis, depth=g),
                               edge_codes(bl)):
                k = e.shape[0]
                stepped = cuda_stencil.slab_step_kernel(
                    e.reshape(k * bl, *e.shape[2:]).contiguous(), g,
                    rule=rule, topology=topology, edge_code=code)
                out.append(stepped[:, g:-g].reshape(k, bl, rows, -1))
            parts = out if live is None else [
                torch.where(lv, o, p) for lv, o, p in zip(live, out, parts)]
        return state.with_parts(p.contiguous() for p in parts)

    if masked:
        return lambda state, chunks, mask: run(state, chunks, mask)
    return lambda state, chunks: run(state, chunks)


# -- contract-gate registrations (ops/_builders.py BUILDERS) -------------------


def _contract_batch_example(device, mesh_shape=(2, 2, 2), grid=(64, 128),
                            seed=7):
    """The JAX package's example: a seeded soup per universe on a (2, 2,
    2) batch mesh of one device."""
    from ..ops import bitpack

    nb, nx, ny = mesh_shape
    m = make_batch_mesh(mesh_shape, [device] * (nb * nx * ny))
    rng = np.random.default_rng(seed)
    soup = rng.integers(0, 2, size=(nb,) + grid, dtype=np.uint8)
    packed = torch.stack([bitpack.pack(torch.from_numpy(u)) for u in soup])
    return m, device_put(packed.to(device), batch_sharding(m))


@register_builder("batched.multi_step_packed_batched",
                  tags=("batched", "packed"))
def _contract_multi_step_packed_batched(device):
    from ..models.rules import CONWAY

    m, grids = _contract_batch_example(device)
    return BuiltRunner(
        make_multi_step_packed_batched_mesh(m, CONWAY, Topology.TORUS),
        (grids, 8))


@register_builder("batched.multi_step_packed_batched_masked",
                  tags=("batched", "packed", "serving"))
def _contract_multi_step_packed_batched_masked(device):
    from ..models.rules import CONWAY

    m, grids = _contract_batch_example(device)
    mask = np.ones((_batch_of(grids),), np.uint32)
    return BuiltRunner(
        make_multi_step_packed_batched_mesh(m, CONWAY, Topology.TORUS,
                                            masked=True),
        (grids, 8, mask))


@register_builder("batched.multi_step_paged",
                  tags=("batched", "paged", "serving"))
def _contract_multi_step_paged(device):
    from ..models.rules import CONWAY

    # a 64-slot pool of Conway tiles with a scrambled page table: the
    # contract is about the runner's shape (the slab stepped in place,
    # halos gathered through the table, no host reads), not a universe
    B, tr, tw = 64, 32, 4
    rng = np.random.default_rng(11)
    tiles = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(B, 1, tr, tw), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(device)
    nbr = rng.integers(0, B, size=(B, 8), dtype=np.int32)
    mask = np.ones((B,), np.uint32)
    mask[0] = 0                                  # slot 0 stays dead
    return BuiltRunner(
        make_multi_step_paged(CONWAY, tr, tw), (tiles, 8, nbr, mask),
        chain=lambda out, args: (out[0],) + tuple(args[1:]),
        require_gather=True)
