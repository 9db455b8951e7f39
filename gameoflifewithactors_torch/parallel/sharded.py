"""Sharded stepping over a mesh: halo exchange, then the stencil of every
position.

Counterpart of ``gameoflifewithactors_tpu.parallel.sharded``. The state is
a :class:`.mesh.ShardedGrid` (one stacked tensor per device); a runner
takes it and a number of generations and returns the stepped grid. On a
mesh spanning processes (:func:`.multihost.global_mesh`) every process
runs the same runner on its own positions, and the exchanges carry the
strips between processes (:func:`.halo.transfer`).

- Band runners, on full-width row bands over the flattened mesh axis
  (``banded=True``), one chunk of ``g`` generations per exchange: a
  depth-``g`` row exchange (``r*g`` for Larger than Life), ONE slab-kernel
  launch per device over all of its bands, each band with its own edge
  code under DEAD (bit 0 = the grid's top band, bit 1 = its bottom band),
  and a crop of the exchanged rows. :func:`make_multi_step_kernel` (B2),
  :func:`make_multi_step_generations_kernel` (B3 slab) and
  :func:`make_multi_step_ltl_kernel` (B4 slab), the counterparts of the
  JAX ``make_multi_step_pallas``, ``make_multi_step_generations_pallas``
  and ``make_multi_step_ltl_pallas``. On CPU tensors the kernel wrappers
  run their plain versions, so the same runner serves the CPU tests.
  Each steps exactly ``n`` generations: ``n // g`` chunks, then one chunk
  of depth ``n % g`` (JAX hands that remainder to a per-generation
  runner).
- :func:`make_multi_step_banded`: per-generation plain torch on the same
  bands.
- 2D-tile runners (``banded=False``), one exchange per generation, plain
  torch: :func:`make_step_packed` / :func:`make_multi_step_packed`,
  :func:`make_multi_step_generations_packed`,
  :func:`make_multi_step_ltl_packed`, :func:`make_multi_step_ltl_planes`,
  :func:`make_multi_step_generations`, :func:`make_multi_step_ltl`,
  :func:`make_step_dense` / :func:`make_multi_step_dense`.

- :func:`make_multi_step_elementary_sharded`: 1D elementary rules on 2D
  tiles, rows independent universes, the width sharded over COL_AXIS, one
  halo word per side per chunk of ``g`` generations.
- Communication-avoiding B/S runners on 2D packed tiles, one exchange per
  ``g`` generations: :func:`make_multi_step_packed_deep` (g <= 32) and the
  ghost-zone pipeline :func:`make_multi_step_packed_ghost` (boundary
  rings first, the exchange fed by them alone, then the interior), with
  their byte models :func:`deep_exchange_bytes` and
  :func:`ghost_exchange_bytes`.
- Sharded sparse runners: per position (:func:`initial_flags`,
  :func:`make_multi_step_packed_sparse`,
  :func:`make_multi_step_generations_packed_sparse`) and per tile inside
  every shard (:func:`initial_tile_activity`,
  :func:`make_multi_step_packed_sparse_tiled`,
  :func:`make_multi_step_generations_packed_sparse_tiled`), built on the
  single-device sparse engine's helpers (:mod:`..ops.sparse`).

These runners are plain torch: the JAX package runs them as XLA ops, and
no TPU kernel serves them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..models.elementary import ElementaryRule
from ..models.generations import GenRule
from ..models.ltl import LtLRule
from ..models.rules import Rule
from ..ops import cuda_stencil
from ..ops import stencil as stencil_ops
from ..ops.elementary import step_elementary
from ..ops.generations import step_generations_ext
from ..ops.ltl import step_ltl_ext
from ..ops.packed import step_packed_ext, step_packed_slab
from ..ops.packed_generations import step_planes_ext, step_planes_slab
from ..ops.packed_ltl import (
    step_ltl_packed_ext,
    step_ltl_packed_slab,
    step_ltl_planes_ext,
)
from ..ops.sparse import (
    _births_from_nothing,
    _dilate,
    _rule_halo,
    _step_fns,
    _step_window,
    _tile_grid_shape,
    _wake_dilation,
    rule_layout,
    tile_activity,
)
from ..ops.stencil import Topology
from .halo import (
    _moved,
    _sources,
    transfer,
    band_edge_code,
    band_edge_codes,
    exchange_cols,
    exchange_cols_parts,
    exchange_halo,
    exchange_rows,
    exchange_rows_parts,
)
from .mesh import (
    COL_AXIS,
    ROW_AXIS,
    Mesh,
    ShardedGrid,
    band_axis,
    device_put_sharded_grid,
    ghost_halo_words,
)

Runner = Callable[[ShardedGrid, int], ShardedGrid]


def _band_runner(mesh: Mesh, topology: Topology, g: int, radius: int,
                 launch, too_deep: Callable[[int, int, int], str]) -> Runner:
    """The chunked band runner: per chunk of ``gens`` generations, a row
    exchange ``radius * gens`` deep along the flattened band axis, one
    ``launch(ext, gens, edge_code)`` per device and the crop."""
    axis, _ = band_axis(mesh)
    codes = (band_edge_codes(mesh) if topology is Topology.DEAD
             else [0] * len(mesh.groups))

    def run(state: ShardedGrid, n: int) -> ShardedGrid:
        parts: Sequence[torch.Tensor] = state.parts
        rows = parts[0].shape[-2]
        for gens in cuda_stencil._launch_plan(n, g):
            d = radius * gens
            if d > rows:
                raise ValueError(too_deep(gens, d, rows))
            ext = exchange_rows(parts, mesh, topology, axis=axis, depth=d)
            parts = [launch(e, gens, code)[..., d:-d, :]
                     for e, code in zip(ext, codes)]
        return state.with_parts(p.contiguous() for p in parts)

    return run


def make_multi_step_kernel(
    mesh: Mesh,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_BAND_GENS_PER_CALL,
) -> Runner:
    """``(grid, n) -> grid`` on full-width row bands of packed B/S words
    through kernel B2 (:func:`..ops.cuda_stencil.slab_step_kernel`): the
    counterpart of JAX ``make_multi_step_pallas``. A 2D mesh flattens into
    ``nx*ny`` bands, x-major. ``gens_per_exchange`` is 1..32 (one halo
    word per tile side holds 32 generations) and at most the band
    height."""
    g = cuda_stencil._depth(gens_per_exchange,
                            cuda_stencil.DEFAULT_BAND_GENS_PER_CALL)
    return _band_runner(
        mesh, topology, g, 1,
        lambda ext, gens, code: cuda_stencil.slab_step_kernel(
            ext, gens, rule=rule, topology=topology, edge_code=code),
        lambda gens, d, rows: (
            f"gens_per_exchange={gens} exceeds the per-device band height "
            f"{rows} (exchange_rows needs depth <= band rows)"))


def make_multi_step_generations_kernel(
    mesh: Mesh,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_GENERATIONS_GENS_PER_CALL,
) -> Runner:
    """``(planes, n) -> planes`` on full-width row bands of a Generations
    ``(b, H, W/32)`` plane stack through the slab form of kernel B3
    (:func:`..ops.cuda_stencil.slab_step_generations_kernel`): the
    counterpart of JAX ``make_multi_step_generations_pallas``. One row
    exchange per chunk carries all b planes."""
    g = cuda_stencil._depth(gens_per_exchange,
                            cuda_stencil.DEFAULT_GENERATIONS_GENS_PER_CALL)
    return _band_runner(
        mesh, topology, g, 1,
        lambda ext, gens, code: cuda_stencil.slab_step_generations_kernel(
            ext, gens, rule=rule, topology=topology, edge_code=code),
        lambda gens, d, rows: (
            f"gens_per_exchange={gens} exceeds the per-device band height "
            f"{rows}"))


def make_multi_step_ltl_kernel(
    mesh: Mesh,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = cuda_stencil.DEFAULT_LTL_GENS_PER_CALL,
) -> Runner:
    """``(grid, n) -> grid`` on full-width row bands of a binary radius-r
    LtL grid through the slab form of kernel B4
    (:func:`..ops.cuda_stencil.slab_step_ltl_kernel`): the counterpart of
    JAX ``make_multi_step_ltl_pallas``, with the exchange and the crop
    ``r*g`` rows deep."""
    g = cuda_stencil._depth(gens_per_exchange,
                            cuda_stencil.DEFAULT_LTL_GENS_PER_CALL)
    return _band_runner(
        mesh, topology, g, rule.radius,
        lambda ext, gens, code: cuda_stencil.slab_step_ltl_kernel(
            ext, gens, rule=rule, topology=topology, edge_code=code),
        lambda gens, d, rows: (
            f"radius*gens_per_exchange={d} exceeds the per-device band "
            f"height {rows} (exchange_rows needs depth <= band rows)"))


def make_multi_step_banded(mesh: Mesh, rule,
                           topology: Topology = Topology.TORUS) -> Runner:
    """``(state, n) -> state``: per-generation plain torch on full-width row
    bands over the flattened mesh axis, for all three families (words,
    Generations plane stack, binary LtL words). Per generation one row
    exchange of depth r (the rule's radius; 1 for 3x3 rules), then one
    shrinking-slab step of every band, the horizontal closure being the
    global topology: the band spans the full width."""
    axis, _ = band_axis(mesh)
    if isinstance(rule, LtLRule):
        depth = rule.radius

        def slab_step(ext):
            return step_ltl_packed_slab(ext, rule, topology)
    elif isinstance(rule, GenRule):
        depth = 1

        def slab_step(ext):
            return torch.stack(step_planes_slab(
                tuple(ext[:, j] for j in range(ext.shape[1])), rule,
                topology), dim=1)
    else:
        depth = 1

        def slab_step(ext):
            return step_packed_slab(ext, rule, topology)

    def run(state: ShardedGrid, n: int) -> ShardedGrid:
        parts = state.parts
        rows = parts[0].shape[-2]
        if int(n) and depth > rows:
            raise ValueError(
                f"band height {rows} smaller than the exchange depth "
                f"{depth}; use fewer devices")
        for _ in range(int(n)):
            parts = [slab_step(e) for e in exchange_rows(
                parts, mesh, topology, axis=axis, depth=depth)]
        return state.with_parts(parts)

    return run


# -- 2D-tile runners ----------------------------------------------------------


def _make_runner(mesh: Mesh, topology: Topology, exchange,
                 step_block: Callable[[torch.Tensor], torch.Tensor]) -> Runner:
    """``(state, n) -> state`` on 2D tiles: per generation
    ``exchange(parts)`` and ``step_block`` on every position's extended
    block."""
    def generation(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.stack([step_block(e[s]) for s in range(e.shape[0])])
                for e in exchange(parts)]

    def run(state: ShardedGrid, n: int) -> ShardedGrid:
        parts = state.parts
        for _ in range(int(n)):
            parts = generation(parts)
        return state.with_parts(parts)

    return run


def _two_phase(mesh: Mesh, topology: Topology, rows: int = 1, cols: int = 1):
    """The exchange of ``rows`` halo rows, then ``cols`` halo columns of the
    row-extended tiles."""
    def exchange(parts):
        if rows == cols:
            return exchange_halo(parts, mesh, topology, depth=rows)
        return exchange_cols(exchange_rows(parts, mesh, topology, depth=rows),
                             mesh, topology, depth=cols)
    return exchange


def _dense_ext_step(ext: torch.Tensor, rule: Rule) -> torch.Tensor:
    """One generation from a halo-extended unpacked tile."""
    return stencil_ops.apply_rule(ext[1:-1, 1:-1],
                                  stencil_ops.neighbor_counts_ext(ext), rule)


def _single(run: Runner) -> Callable[[ShardedGrid], ShardedGrid]:
    return lambda state: run(state, 1)


def make_multi_step_packed(mesh: Mesh, rule: Rule,
                           topology: Topology = Topology.TORUS) -> Runner:
    """``(grid, n) -> grid`` on a 2D-tiled packed B/S grid: one 1-deep
    exchange per generation (one halo word per side), then
    :func:`..ops.packed.step_packed_ext` on every tile."""
    return _make_runner(mesh, topology, _two_phase(mesh, topology),
                        lambda ext: step_packed_ext(ext, rule))


def make_step_packed(mesh: Mesh, rule: Rule,
                     topology: Topology = Topology.TORUS):
    """``grid -> grid``: one generation of :func:`make_multi_step_packed`."""
    return _single(make_multi_step_packed(mesh, rule, topology))


def make_multi_step_dense(mesh: Mesh, rule: Rule,
                          topology: Topology = Topology.TORUS) -> Runner:
    """``(grid, n) -> grid`` on a 2D-tiled ``(H, W)`` uint8 grid (the debug
    path)."""
    return _make_runner(mesh, topology, _two_phase(mesh, topology),
                        lambda ext: _dense_ext_step(ext, rule))


def make_step_dense(mesh: Mesh, rule: Rule,
                    topology: Topology = Topology.TORUS):
    """``grid -> grid``: one generation of :func:`make_multi_step_dense`."""
    return _single(make_multi_step_dense(mesh, rule, topology))


def make_multi_step_generations(mesh: Mesh, rule: GenRule,
                                topology: Topology = Topology.TORUS) -> Runner:
    """``(grid, n) -> grid`` for a Generations rule on 2D-tiled uint8
    states (:func:`..ops.generations.step_generations_ext`)."""
    return _make_runner(mesh, topology, _two_phase(mesh, topology),
                        lambda ext: step_generations_ext(ext, rule))


def make_multi_step_generations_packed(mesh: Mesh, rule: GenRule,
                                       topology: Topology = Topology.TORUS
                                       ) -> Runner:
    """``(planes, n) -> planes`` on a 2D-tiled ``(b, H, W/32)`` plane stack:
    one exchange carries all b planes, then
    :func:`..ops.packed_generations.step_planes_ext`."""
    return _make_runner(
        mesh, topology, _two_phase(mesh, topology),
        lambda ext: torch.stack(step_planes_ext(
            [ext[j] for j in range(ext.shape[0])], rule)))


def make_multi_step_ltl(mesh: Mesh, rule: LtLRule,
                        topology: Topology = Topology.TORUS) -> Runner:
    """``(grid, n) -> grid`` for radius-r LtL on 2D-tiled uint8 states: a
    depth-r exchange on both axes, then :func:`..ops.ltl.step_ltl_ext`.
    Tiles must be at least r cells in each dimension."""
    r = rule.radius
    return _make_runner(mesh, topology, _two_phase(mesh, topology, r, r),
                        lambda ext: step_ltl_ext(ext, rule))


def make_multi_step_ltl_packed(mesh: Mesh, rule: LtLRule,
                               topology: Topology = Topology.TORUS) -> Runner:
    """``(grid, n) -> grid`` for binary LtL on a 2D-tiled packed grid: r
    halo rows and one halo word (32 >= r cells) per side, then
    :func:`..ops.packed_ltl.step_ltl_packed_ext`."""
    return _make_runner(mesh, topology,
                        _two_phase(mesh, topology, rule.radius, 1),
                        lambda ext: step_ltl_packed_ext(ext, rule))


def make_multi_step_ltl_planes(mesh: Mesh, rule: LtLRule,
                               topology: Topology = Topology.TORUS) -> Runner:
    """``(planes, n) -> planes`` for multi-state (C >= 3) LtL on a 2D-tiled
    plane stack: r halo rows and one halo word per side, one exchange for
    all planes, then :func:`..ops.packed_ltl.step_ltl_planes_ext`."""
    return _make_runner(
        mesh, topology, _two_phase(mesh, topology, rule.radius, 1),
        lambda ext: torch.stack(step_ltl_planes_ext(
            tuple(ext[j] for j in range(ext.shape[0])), rule)))


def make_multi_step_elementary_sharded(
    mesh: Mesh,
    rule: ElementaryRule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = 8,
) -> Runner:
    """Sharded 1D (elementary Wolfram) stepping: the counterpart of JAX
    ``make_multi_step_elementary_sharded``.

    Layout: a 2D-tiled (H, W/32) packed grid, rows = independent
    universes (data parallelism over the mesh's row axis, no
    communication), width sharded over the column axis. Per chunk each
    position takes ONE halo word (32 cells) per side from its column
    neighbours (:func:`.halo.exchange_cols`), then advances ``g =
    gens_per_exchange`` generations with open (DEAD) closure at the slab
    ends: corruption creeps inward 1 cell per generation from the cropped
    slab edge, so the 32-cell halo word absorbs it exactly for g <= 32.

    Global DEAD topology: the leftmost/rightmost positions' halo words are
    permanently-dead exterior, re-zeroed before every in-slab generation
    (a birth just outside the edge would otherwise feed back from the 2nd
    generation on), chosen by the column-axis edge code of each position
    (:func:`.halo.band_edge_code` over the column positions).

    Returns ``(grid, chunks) -> grid`` advancing ``chunks * g``
    generations.
    """
    g = int(gens_per_exchange)
    if not 1 <= g <= 32:
        raise ValueError(
            f"gens_per_exchange must be in [1, 32] (the 32-cell halo word "
            f"bounds how far edge corruption may creep), got {g}")
    ny = mesh.shape[COL_AXIS]
    keep = None
    if topology is Topology.DEAD:
        # per device and exterior side, a (k, 1) int32 mask over its k
        # positions: all ones, 0 where the position's column edge code says
        # that side is the grid's edge
        keep = []
        for device, positions in mesh.groups:
            codes = [band_edge_code(ny, p % ny) for p in positions]
            west = torch.tensor([0 if c & 1 else -1 for c in codes],
                                dtype=torch.int32, device=device)
            east = torch.tensor([0 if c & 2 else -1 for c in codes],
                                dtype=torch.int32, device=device)
            keep.append((west.view(-1, 1), east.view(-1, 1)))

    def chunk(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i, ext in enumerate(exchange_cols(parts, mesh, topology)):
            for _ in range(g):
                if keep is not None:
                    # ext is this runner's own tensor (a cat, then a step)
                    west, east = keep[i]
                    ext[..., 0] &= west
                    ext[..., -1] &= east
                ext = step_elementary(ext, rule=rule, topology=Topology.DEAD)
            out.append(ext[..., 1:-1].contiguous())
        return out

    def run(state: ShardedGrid, chunks: int) -> ShardedGrid:
        parts = state.parts
        for _ in range(int(chunks)):
            parts = chunk(parts)
        return state.with_parts(parts)

    return run


# -- communication-avoiding packed runners ------------------------------------


def _edge_slots(mesh: Mesh) -> List[tuple]:
    """Per device, the ``(top, bottom, left, right)`` int64 slot indices
    (on that device, None where empty) of its positions on the grid's
    north, south, west and east edges: the positions whose halos beyond
    that edge are the permanently dead exterior under DEAD."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    out = []
    for device, positions in mesh.groups:
        ij = [divmod(p % (nx * ny), ny) for p in positions]
        sides = []
        for on_edge in (lambda i, j: i == 0, lambda i, j: i == nx - 1,
                        lambda i, j: j == 0, lambda i, j: j == ny - 1):
            slots = [s for s, (i, j) in enumerate(ij) if on_edge(i, j)]
            sides.append(torch.tensor(slots, dtype=torch.int64, device=device)
                         if slots else None)
        out.append(tuple(sides))
    return out


def _zero_exterior(slab: torch.Tensor, edges, *, top: int = 0,
                   bottom: int = 0, left: int = 0, right: int = 0) -> None:
    """DEAD: zero, in place, the exterior rows and words still present at
    each edge of a ``(k, L, W)`` slab stack, in the slots on that edge of
    the grid (``edges`` from :func:`_edge_slots`). A slab advance would
    otherwise evolve the dead exterior: a birth just outside the edge
    feeds back from the second generation on."""
    t, b, lft, rgt = edges
    L, W = slab.shape[-2:]
    if top and t is not None:
        slab[t, :top] = 0
    if bottom and b is not None:
        slab[b, L - bottom:] = 0
    if left and lft is not None:
        slab[lft, :, :left] = 0
    if right and rgt is not None:
        slab[rgt, :, W - right:] = 0


def _advance(slab: torch.Tensor, rule: Rule, gens: int, edges, *,
             vtop: bool = False, vbot: bool = False,
             left: int = 0, right: int = 0) -> torch.Tensor:
    """``gens`` shrinking-slab generations of a ``(k, L, W)`` stack under
    DEAD closure. With ``edges`` (global DEAD) the exterior is re-zeroed
    before every generation from the second: the vertical depth shrinks
    with the slab (``gens - j`` rows at generation j, on the sides
    ``vtop``/``vbot``), the word depth ``left``/``right`` is constant.
    Before the first the exterior is zero already: an exchange fills a
    DEAD edge's halo with zeros."""
    for j in range(gens):
        if edges is not None and j:
            depth = gens - j
            _zero_exterior(slab, edges, top=depth if vtop else 0,
                           bottom=depth if vbot else 0, left=left,
                           right=right)
        slab = step_packed_slab(slab, rule, Topology.DEAD)
    return slab


def _tile_of(mesh: Mesh, grid_shape) -> tuple:
    """(rows, words) of one position's tile of a packed (H, Wp) grid."""
    return (int(grid_shape[-2]) // mesh.shape[ROW_AXIS],
            int(grid_shape[-1]) // mesh.shape[COL_AXIS])


def halo_sends(mesh: Mesh, topology: Topology) -> tuple:
    """(row sends, column sends) of one two-phase exchange fleet-wide: two
    per neighbour pair, none along a size-1 axis (a TORUS self-send stays
    on its position), no wrap send under DEAD."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    wrap = topology is Topology.TORUS
    row_sends = (2 * ny * (nx if wrap else nx - 1)) if nx > 1 else 0
    col_sends = (2 * nx * (ny if wrap else ny - 1)) if ny > 1 else 0
    return row_sends, col_sends


def deep_exchange_bytes(grid_shape, mesh: Mesh, topology: Topology,
                        gens_per_exchange: int) -> int:
    """Bytes ONE deep-chunk exchange moves between mesh positions for a
    packed (H, Wp) grid: depth-g row strips (g rows x tile words) per
    row-neighbour pair, then 1-word column strips of the row-extended tile
    (h + 2g rows) per column-neighbour pair, the
    ``exchange_cols(exchange_rows(tile, depth=g), depth=1)`` trip of
    :func:`make_multi_step_packed_deep`'s chunk. The JAX package's
    ``deep_exchange_bytes``; :func:`.halo.exchanged_bytes` counts the
    same strips."""
    g = int(gens_per_exchange)
    h, wq = _tile_of(mesh, grid_shape)
    row_sends, col_sends = halo_sends(mesh, topology)
    return row_sends * g * wq * 4 + col_sends * (h + 2 * g) * 4


def ghost_exchange_bytes(grid_shape, mesh: Mesh, topology: Topology,
                         gens_per_exchange: int) -> int:
    """Bytes ONE ghost-zone exchange moves between mesh positions for a
    packed (H, Wp) grid: 2 row strips of k rows per row-neighbour pair
    plus 2 column strips of ceil(k/32) words (of the row-extended tile)
    per column-neighbour pair. The JAX package's
    ``ghost_exchange_bytes``, the ``halo_bytes_total`` counter's model."""
    k = int(gens_per_exchange)
    hw = ghost_halo_words(k)
    h, wq = _tile_of(mesh, grid_shape)
    row_sends, col_sends = halo_sends(mesh, topology)
    return row_sends * k * wq * 4 + col_sends * hw * (h + 2 * k) * 4


def _global_shape(state: ShardedGrid) -> tuple:
    nx, ny = state.mesh.shape[ROW_AXIS], state.mesh.shape[COL_AXIS]
    h, w = state.parts[0].shape[-2:]
    return h * nx, w * ny


def make_multi_step_packed_deep(
    mesh: Mesh,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = 8,
) -> Runner:
    """Communication-avoiding stepping on 2D packed tiles: one halo
    exchange per ``g = gens_per_exchange`` generations, the counterpart of
    JAX ``make_multi_step_packed_deep``.

    Each chunk exchanges a g-row-deep north/south halo and a 1-word
    east/west halo (two-phase, corners correct), then advances every
    tile's slab g generations under DEAD closure
    (:func:`..ops.packed.step_packed_slab`) and crops the halo words. The
    slab shrinks 2 rows per generation, consuming the row halos exactly;
    horizontally the edge corruption creeps 1 cell per generation into
    the 32-cell halo word, so the interior stays exact for g <= 32. Under
    global DEAD the exterior of the tiles on the grid's edge is re-zeroed
    before every generation.

    Returns ``(grid, chunks) -> grid`` advancing ``chunks * g``
    generations."""
    g = int(gens_per_exchange)
    if not 1 <= g <= 32:
        raise ValueError(
            f"gens_per_exchange must be in [1, 32] (the 32-cell halo word "
            f"bounds how far edge corruption may creep), got {g}")
    edges = (_edge_slots(mesh) if topology is Topology.DEAD
             else [None] * len(mesh.groups))

    def chunk(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        ext = exchange_cols(exchange_rows(parts, mesh, topology, depth=g),
                            mesh, topology, depth=1)
        return [_advance(e, rule, g, edge, vtop=True, vbot=True, left=1,
                         right=1)[..., 1:-1].contiguous()
                for e, edge in zip(ext, edges)]

    def run(state: ShardedGrid, chunks: int) -> ShardedGrid:
        rows = state.parts[0].shape[-2]
        if rows < g:
            raise ValueError(
                f"gens_per_exchange={g} exceeds the per-device tile height "
                f"{rows} (exchange_rows needs depth <= tile rows); use a "
                "deeper tile or a smaller G")
        parts = state.parts
        for _ in range(int(chunks)):
            parts = chunk(parts)
        return state.with_parts(parts)

    return run


def make_multi_step_packed_ghost(
    mesh: Mesh,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_exchange: int = 8,
    *,
    unroll_chunks: Optional[int] = None,
) -> Callable:
    """Width-k ghost-zone pipeline on 2D packed tiles: one halo exchange
    per k generations, the counterpart of JAX
    ``make_multi_step_packed_ghost``.

    Each k-generation block works boundary first:

    1. the four boundary rings of the NEXT tile advance k generations
       (shrinking slabs over the halo-extended edges, cropped to their
       exact cores);
    2. the next block's exchange is fed by those rings alone
       (:func:`.halo.exchange_rows_parts`, :func:`.halo.exchange_cols_parts`;
       the column strips are assembled from the row-extended edges, so
       the corners ride the second phase);
    3. then the interior advances k generations, independent of the
       exchange.

    Halos are k rows and ``ceil(k/32)`` words deep, so k is bounded by
    the tile alone: 2k rows and 2*ceil(k/32) words must fit
    (:func:`.mesh.ghost_fits`). Under DEAD the exterior of the tiles on
    the grid's edge is re-zeroed before every generation, as in the deep
    runner. A run of ``chunks`` blocks makes exactly ``chunks``
    exchanges: a prologue and one per block but the last.

    Each call adds to ``obs.registry.REGISTRY``: ``halo_exchanges_total``
    (the exchanges), ``halo_bytes_total`` (:func:`ghost_exchange_bytes`
    per exchange, this process's share of it on a mesh spanning
    processes) and the gauge ``halo_overlap_ratio`` (the share of a
    block's stencil work that is interior, which may overlap the
    exchange).

    Returns ``(grid, chunks) -> grid`` advancing ``chunks * k``
    generations (``chunks >= 1``); with ``unroll_chunks=c``, ``grid ->
    grid`` advancing ``c`` blocks, without the registry accounting (the
    JAX package's countable build)."""
    from ..obs.registry import REGISTRY

    k = int(gens_per_exchange)
    if k < 1:
        raise ValueError(f"gens_per_exchange must be >= 1, got {k}")
    hw = ghost_halo_words(k)
    edges = (_edge_slots(mesh) if topology is Topology.DEAD
             else [None] * len(mesh.groups))

    def block(ext: Sequence[torch.Tensor], exchange: bool
              ) -> List[torch.Tensor]:
        rings = []
        for e, edge in zip(ext, edges):
            eh, ew = e.shape[-2:]
            h, w = eh - 2 * k, ew - 2 * hw
            rings.append((
                _advance(e[..., :3 * k, :], rule, k, edge, vtop=True,
                         left=hw, right=hw)[..., hw:hw + w],
                _advance(e[..., eh - 3 * k:, :], rule, k, edge, vbot=True,
                         left=hw, right=hw)[..., hw:hw + w],
                _advance(e[..., k:k + h, :3 * hw], rule, k, edge,
                         left=hw)[..., hw:2 * hw],
                _advance(e[..., k:k + h, ew - 3 * hw:], rule, k, edge,
                         right=hw)[..., hw:2 * hw]))
        if exchange:
            north, south = exchange_rows_parts(
                [r[0] for r in rings], [r[1] for r in rings], mesh, topology)
            w = rings[0][0].shape[-1]
            wcol = [torch.cat([n[..., :hw], rn[..., :hw], rw, rs[..., :hw],
                               s[..., :hw]], dim=-2)
                    for n, s, (rn, rs, rw, _) in zip(north, south, rings)]
            ecol = [torch.cat([n[..., w - hw:], rn[..., w - hw:], re,
                               rs[..., w - hw:], s[..., w - hw:]], dim=-2)
                    for n, s, (rn, rs, _, re) in zip(north, south, rings)]
            west, east = exchange_cols_parts(wcol, ecol, mesh, topology)
        out = []
        for i, (e, (rn, rs, rw, re)) in enumerate(zip(ext, rings)):
            h, w = e.shape[-2] - 2 * k, e.shape[-1] - 2 * hw
            interior = _advance(e[..., k:k + h, hw:hw + w], rule, k,
                                None)[..., hw:w - hw]
            tile = torch.cat([rn, torch.cat([rw, interior, re], dim=-1), rs],
                             dim=-2)
            if exchange:
                tile = torch.cat([
                    west[i], torch.cat([north[i], tile, south[i]], dim=-2),
                    east[i]], dim=-1)
            out.append(tile)
        return out

    def prologue(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        h, w = parts[0].shape[-2:]
        if 2 * k > h or 2 * hw > w:
            raise ValueError(
                f"gens_per_exchange={k} needs a per-device tile of at "
                f"least ({2 * k} rows, {2 * hw} words); tile is ({h}, {w})"
                " — use a smaller k, a coarser mesh, or a bigger grid")
        return exchange_cols(exchange_rows(parts, mesh, topology, depth=k),
                             mesh, topology, depth=hw)

    def blocks(state: ShardedGrid, c: int) -> ShardedGrid:
        ext = prologue(state.parts)
        for _ in range(c - 1):
            ext = block(ext, exchange=True)
        return state.with_parts(block(ext, exchange=False))

    if unroll_chunks is not None:
        c = int(unroll_chunks)
        if c < 1:
            raise ValueError(f"unroll_chunks must be >= 1, got {c}")
        return lambda state: blocks(state, c)

    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    # this process's share of the fleet's bytes, so that the processes'
    # counters sum to the model once (the JAX package's local_frac)
    local_frac = len(mesh.positions) / mesh.size

    def run(state: ShardedGrid, chunks: int) -> ShardedGrid:
        c = int(chunks)
        if c < 1:
            # chunks=0 would still run the prologue and a final block
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        shape = _global_shape(state)
        out = blocks(state, c)
        REGISTRY.counter(
            "halo_exchanges_total",
            "ghost-zone halo exchanges performed (one per k-generation "
            "block)").inc(c)
        REGISTRY.counter(
            "halo_bytes_total",
            "modeled interconnect bytes moved by ghost-zone halo "
            "exchanges").inc(c * ghost_exchange_bytes(shape, mesh, topology,
                                                      k) * local_frac)
        h, w = shape[-2] // nx, shape[-1] // ny
        interior = sum((h - 2 * j) * w for j in range(k))
        boundary = sum(2 * (3 * k - 2 * j) * (w + 2 * hw)
                       + 2 * (h - 2 * j) * 3 * hw for j in range(k))
        REGISTRY.gauge(
            "halo_overlap_ratio",
            "fraction of each ghost block's stencil work that is "
            "interior (overlappable with the in-flight exchange); "
            "per-chip").set(interior / (interior + boundary))
        return out

    return run


# -- sharded sparse runners ---------------------------------------------------


def _stack_step(rule):
    """One generation of a ``(K, *lead, R, C)`` stack of halo-extended
    windows (``lead`` = the plane axis of a plane-stack layout) -> the
    ``(K, *lead, r, c)`` interiors, by the sparse engine's batched
    window step."""
    planes = rule_layout(rule)[1] == 3
    ext_step = _step_fns(rule, planes)[0]
    if not planes:
        return ext_step
    return lambda w: ext_step(w.transpose(0, 1)).transpose(0, 1)


def initial_flags(mesh: Mesh) -> ShardedGrid:
    """The all-active per-position flags of the device-granular sparse
    runners: an ``(nx, ny)`` int32 map of ones placed one flag per
    position (the JAX package's uint32 flags)."""
    nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    return device_put_sharded_grid(
        torch.ones((nx, ny), dtype=torch.int32), mesh)


def _make_flagged_sparse(mesh: Mesh, topology: Topology, rule) -> Callable:
    """The per-position activity-skipping runner of both layouts: per
    generation the halo exchange of the state runs for every position
    (as a collective must), the flags make their own two-phase trip, and
    only the positions whose 3x3 flag neighbourhood is awake step. The
    flags of every position come back to the host in one transfer per
    generation: the skip is a host decision, where JAX's is a
    ``lax.cond``. On a mesh spanning processes each process decides for
    its own positions alone (a position's decision reads only its own
    exchanged flags), and every position takes part in every exchange."""
    step = _stack_step(rule)
    home = mesh.groups[0][0]

    def gen(parts, flags):
        ext = exchange_halo(parts, mesh, topology)
        fext = exchange_halo(flags, mesh, topology)
        awake = torch.cat([f.flatten(1).sum(1).to(home) for f in fext]
                          ).tolist()
        new_parts, new_flags = [], []
        base = 0
        for e, own in zip(ext, parts):
            slots = [s for s in range(own.shape[0]) if awake[base + s] > 0]
            base += own.shape[0]
            flag = torch.zeros((own.shape[0], 1, 1), dtype=torch.int32,
                               device=own.device)
            if slots:
                idx = torch.tensor(slots, dtype=torch.int64,
                                   device=own.device)
                stepped = step(e[idx])
                changed = (stepped != own[idx]).flatten(1).any(1)
                own = own.clone()
                own[idx] = stepped
                flag[idx] = changed.to(torch.int32).view(-1, 1, 1)
            new_parts.append(own)
            new_flags.append(flag)
        return new_parts, new_flags

    def run(state: ShardedGrid, flags: ShardedGrid, n: int):
        parts, fparts = state.parts, flags.parts
        for _ in range(int(n)):
            parts, fparts = gen(parts, fparts)
        return state.with_parts(parts), flags.with_parts(fparts)

    return run


def make_multi_step_packed_sparse(mesh: Mesh, rule: Rule,
                                  topology: Topology = Topology.TORUS
                                  ) -> Callable:
    """Sharded stepping with per-position activity skipping, the
    counterpart of JAX ``make_multi_step_packed_sparse``: each position
    carries a changed-last-generation flag (:func:`initial_flags`), the
    flags make the grid's two-phase halo trip, and a position whose 3x3
    flag neighbourhood is quiet skips its stencil (exact by locality).
    Returns ``(grid, flags, n) -> (grid, flags)``."""
    return _make_flagged_sparse(mesh, topology, rule)


def make_multi_step_generations_packed_sparse(
        mesh: Mesh, rule: GenRule,
        topology: Topology = Topology.TORUS) -> Callable:
    """Per-position activity skipping for the Generations ``(b, H, W/32)``
    plane stack, the counterpart of JAX
    ``make_multi_step_generations_packed_sparse`` (one exchange carries
    all planes; decaying tiles keep themselves awake by changing).
    Returns ``(planes, flags, n) -> (planes, flags)``."""
    return _make_flagged_sparse(mesh, topology, rule)


def initial_tile_activity(packed, mesh: Mesh, tile_rows: int,
                          tile_words: int) -> ShardedGrid:
    """The changed-flag map of the per-tile sharded sparse runners, placed
    like the grid: every tile holding a live cell starts changed. Int32
    0/1 (the JAX package's uint32 map), ``(k, nty, ntx)`` per device for
    the local tile maps. ``packed`` is the placed state (a
    :class:`.mesh.ShardedGrid` of 2D tiles) or a global tensor, which is
    placed first."""
    if not isinstance(packed, ShardedGrid):
        packed = device_put_sharded_grid(packed, mesh)
    return ShardedGrid(mesh, tuple(
        torch.stack([tile_activity(block, tile_rows, tile_words)
                     for block in part]).to(torch.int32)
        for part in packed.parts), False)


class _Rings:
    """Persistent halo-extended buffers of a tiled sharded state: per
    device a ``(k, *lead, h + 2r, w + 2rw)`` tensor whose interior is the
    state and whose ring :meth:`fill` writes from the neighbours' edges
    (rows first, then the full-height columns, so the corners ride along:
    the two-phase exchange of :func:`.halo.exchange_halo`, without
    copying the interior). Strips between positions of this process are
    indexed copies; those from or to another process go through
    :func:`.halo.transfer`. The strips from other positions count in
    :func:`.halo.exchanged_bytes`."""

    def __init__(self, mesh: Mesh, topology: Topology, r: int, rw: int):
        self.mesh, self.r, self.rw = mesh, r, rw
        wrap = topology is Topology.TORUS
        self.plans = [self._plan(_sources(mesh, axis, step, wrap))
                      for axis, step in ((ROW_AXIS, 1), (ROW_AXIS, -1),
                                         (COL_AXIS, 1), (COL_AXIS, -1))]
        self.bufs: List[torch.Tensor] = []

    def _plan(self, sources):
        """For one direction: per destination device, ``[(dst slots, src
        group, src slots, moved positions)]`` over the sources this
        process holds (no entry where a DEAD edge leaves the ring zero),
        and the ``(source, destination)`` pairs of the direction that
        cross a process boundary."""
        mesh = self.mesh
        plans = []
        for device, positions in mesh.groups:
            by_src: dict = {}
            for s, p in enumerate(positions):
                q = sources[p]
                if q is None or mesh.owner_of[q] != mesh.rank:
                    continue
                g, t = mesh.slot_of[q]
                d, sl, moved = by_src.setdefault(g, ([], [], [0]))
                d.append(s)
                sl.append(t)
                moved[0] += q != p
            plans.append([(torch.tensor(d, dtype=torch.int64, device=device),
                           g,
                           torch.tensor(sl, dtype=torch.int64,
                                        device=mesh.groups[g][0]),
                           moved[0])
                          for g, (d, sl, moved) in by_src.items()])
        remote = [(q, p) for p, q in enumerate(sources)
                  if q is not None and mesh.owner_of[q] != mesh.owner_of[p]]
        return plans, remote

    def adopt(self, parts: Sequence[torch.Tensor]) -> None:
        """New buffers holding ``parts`` inside a zero ring."""
        r, rw = self.r, self.rw
        self.bufs = []
        for p in parts:
            buf = p.new_zeros(*p.shape[:-2], p.shape[-2] + 2 * r,
                              p.shape[-1] + 2 * rw)
            buf[..., r:r + p.shape[-2], rw:rw + p.shape[-1]] = p
            self.bufs.append(buf)

    def interiors(self) -> List[torch.Tensor]:
        r, rw = self.r, self.rw
        return [b[..., r:b.shape[-2] - r, rw:b.shape[-1] - rw]
                for b in self.bufs]

    def _copy(self, directions) -> None:
        """Each ``(plan, dst_view, src_view)`` direction's strips: the
        indexed copies first, then every crossing strip in one
        :func:`.halo.transfer`."""
        mesh = self.mesh
        moves = []
        for d, ((plans, remote), dst_view, src_view) in enumerate(directions):
            for (device, _), buf, plan in zip(mesh.groups, self.bufs, plans):
                for dst, g, src, moved in plan:
                    strip = src_view(self.bufs[g])[src]
                    if moved:
                        _moved(moved * strip[0].numel() * strip.element_size())
                    dst_view(buf)[dst] = strip.to(device, non_blocking=True)
            moves += [(q, p, d) for q, p in remote]
        if not moves:
            return

        def take(q, d):
            g, s = mesh.slot_of[q]
            return directions[d][2](self.bufs[g])[s]

        for (p, d), strip in transfer(mesh, moves, take).items():
            g, s = mesh.slot_of[p]
            directions[d][1](self.bufs[g])[s] = strip

    def fill(self) -> None:
        r, rw = self.r, self.rw
        H, W = self.bufs[0].shape[-2:]
        h = H - 2 * r
        north, south, west, east = self.plans
        # my north ring is my north neighbour's bottom interior rows
        self._copy([(north, lambda b: b[..., :r, rw:W - rw],
                     lambda b: b[..., h:h + r, rw:W - rw]),
                    (south, lambda b: b[..., h + r:, rw:W - rw],
                     lambda b: b[..., r:2 * r, rw:W - rw])])
        w = W - 2 * rw
        self._copy([(west, lambda b: b[..., :rw], lambda b: b[..., w:w + rw]),
                    (east, lambda b: b[..., w + rw:],
                     lambda b: b[..., rw:2 * rw])])


def make_multi_step_packed_sparse_tiled(
    mesh: Mesh,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    *,
    tile_rows: int,
    tile_words: int,
    capacity: Optional[int] = None,
) -> Callable:
    """Sharded stepping with per-tile activity skipping inside every
    shard, the counterpart of JAX ``make_multi_step_packed_sparse_tiled``:
    per generation every position

    1. fills the halo ring of its shard from its neighbours (every
       position, as a collective must) and takes a tile-ring halo of its
       neighbours' activity maps (a neighbour's edge-tile change must wake
       this shard's edge tile);
    2. dilates the extended map into the candidate tiles (exact by rule
       locality, :func:`..ops.sparse._wake_dilation`);
    3. steps the candidates' halo-extended windows as one batch and writes
       their interiors back; a shard with more candidates than
       ``capacity`` takes one whole-shard generation instead.

    ``tile_rows``/``tile_words`` are per-shard tile dims
    (:func:`..ops.sparse.auto_tile` of the LOCAL shard); ``capacity``
    defaults to a quarter of the local tile count, clamped to [32, 1024].
    Serves binary B/S and radius-r binary LtL.

    Each shard lives in a persistent buffer with its halo ring (the
    exchange writes only the ring, no extended copy per generation), and
    the candidate counts of all this process's shards come back in one
    host transfer per generation. A shard's choice between its windows
    and the whole-shard step reads only its own count, so on a mesh
    spanning processes each process decides for its own shards, with no
    collective, and every shard takes part in every exchange. The runner
    steps the state it returned last in place, as the JAX engine's
    donated runner consumes its input.

    Returns ``(grid, act, n) -> (grid, act)``; ``act`` is the placed tile
    map from :func:`initial_tile_activity`. Its ``stats`` dict counts the
    host reads (``syncs``) and holds the per-shard ``capacity`` of the
    last call."""
    return _make_tiled_sparse(mesh, rule, topology, tile_rows, tile_words,
                              capacity)


def make_multi_step_generations_packed_sparse_tiled(
    mesh: Mesh,
    rule,
    topology: Topology = Topology.TORUS,
    *,
    tile_rows: int,
    tile_words: int,
    capacity: Optional[int] = None,
) -> Callable:
    """Per-tile sharded sparse for ``(b, H, W/32)`` plane stacks
    (Generations, multi-state LtL), the counterpart of JAX
    ``make_multi_step_generations_packed_sparse_tiled``: windows carry all
    b planes, one ring fill per generation. Returns ``(planes, act, n) ->
    (planes, act)``."""
    return _make_tiled_sparse(mesh, rule, topology, tile_rows, tile_words,
                              capacity)


def _make_tiled_sparse(mesh: Mesh, rule, topology: Topology,
                       tile_rows: int, tile_words: int,
                       capacity: Optional[int]) -> Callable:
    """The per-tile sharded sparse runner of both layouts: the state is
    ``(k, h, w)`` or ``(k, b, h, w)`` per device, the activity map ``(k,
    nty, ntx)``."""
    if _births_from_nothing(rule):
        raise ValueError(
            f"sparse backends cannot run birth-from-nothing rules "
            f"({rule.notation}): nothing ever sleeps — use the packed "
            "backend")
    r, rw = _rule_halo(rule)
    dy, dx = _wake_dilation(rule, tile_rows, tile_words)
    step = _step_fns(rule, rule_layout(rule)[1] == 3)[0]
    rings = _Rings(mesh, topology, r, rw)
    home = mesh.groups[0][0]
    last: List[Optional[ShardedGrid]] = [None]
    stats = {"syncs": 0, "capacity": capacity}

    def windows_step(buf, slot, ty, tx):
        """Gather, step and write back the candidate windows ``(slot, ty,
        tx)`` of one device's buffer; returns their changed flags."""
        dev = buf.device
        rows = (ty * tile_rows)[:, None] + torch.arange(
            tile_rows + 2 * r, device=dev)
        cols = (tx * tile_words)[:, None] + torch.arange(
            tile_words + 2 * rw, device=dev)
        plane_first = buf.dim() == 4
        view = buf.transpose(0, 1) if plane_first else buf
        sl = slot[:, None, None]
        if plane_first:
            windows = view[:, sl, rows[:, :, None], cols[:, None, :]]
        else:
            windows = view[sl, rows[:, :, None], cols[:, None, :]]
        stepped = step(windows)
        changed = (stepped != windows[..., r:-r, rw:-rw]).flatten(-2).any(-1)
        if plane_first:
            changed = changed.any(0)
        rows = rows[:, r:r + tile_rows, None]
        cols = cols[:, None, rw:rw + tile_words]
        if plane_first:
            view[:, sl, rows, cols] = stepped
        else:
            view[sl, rows, cols] = stepped
        return changed

    def gen(act_parts, nty, ntx, cap):
        rings.fill()
        aext = exchange_cols(
            exchange_rows(act_parts, mesh, topology, depth=dy), mesh,
            topology, depth=dx)
        cands = [_dilate(a != 0, wrap=False, dy=dy, dx=dx)[
            ..., dy:a.shape[-2] - dy, dx:a.shape[-1] - dx] for a in aext]
        counts = torch.cat([c.flatten(1).sum(1).to(home) for c in cands]
                           ).tolist()                   # the host transfer
        stats["syncs"] += 1
        out, base = [], 0
        for buf, cand in zip(rings.bufs, cands):
            k = cand.shape[0]
            mine = counts[base:base + k]
            base += k
            act = torch.zeros((k, nty, ntx), dtype=torch.int32,
                              device=buf.device)
            sparse = [s for s in range(k) if mine[s] <= cap]
            total = sum(mine[s] for s in sparse)
            if total:
                sel = cand if len(sparse) == k else cand[sparse]
                key = (~sel).flatten().to(torch.int8)
                flat = torch.argsort(key, stable=True)[:total]
                which, rest = flat // (nty * ntx), flat % (nty * ntx)
                slot = which if len(sparse) == k else torch.tensor(
                    sparse, dtype=torch.int64, device=buf.device)[which]
                ty, tx = rest // ntx, rest % ntx
                changed = windows_step(buf, slot, ty, tx)
                act[slot, ty, tx] = changed.to(torch.int32)
            for s in range(k):
                if mine[s] > cap:
                    # one whole-shard generation: the overflow branch
                    new = _step_window(buf[s], rule)
                    old = buf[s, ..., r:r + nty * tile_rows,
                              rw:rw + ntx * tile_words]
                    lead = old.shape[:-2]
                    t_old = old.reshape(*lead, nty, tile_rows, ntx, tile_words)
                    t_new = new.reshape(*lead, nty, tile_rows, ntx, tile_words)
                    ch = (t_old != t_new).any(-1).any(-2)
                    if lead:
                        ch = ch.any(0)
                    act[s] = ch.to(torch.int32)
                    old.copy_(new)
            out.append(act)
        return out

    def run(state: ShardedGrid, act: ShardedGrid, n: int):
        h, w = state.parts[0].shape[-2:]
        nty, ntx = _tile_grid_shape(h, w, tile_rows, tile_words)
        cap = stats["capacity"] = capacity or max(
            32, min(1024, (nty * ntx) // 4 or 32))
        if state is not last[0]:
            rings.adopt(state.parts)
        act_parts = act.parts
        for _ in range(int(n)):
            act_parts = gen(act_parts, nty, ntx, cap)
        out = state.with_parts(rings.interiors())
        last[0] = out
        return out, act.with_parts(act_parts)

    run.stats = stats
    return run
