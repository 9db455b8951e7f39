"""Sharded stepping over a single-controller mesh: halo exchange, then the
stencil of every position.

Counterpart of ``gameoflifewithactors_tpu.parallel.sharded``. The state is
a :class:`.mesh.ShardedGrid` (one stacked tensor per device); a runner
takes it and a number of generations and returns the stepped grid.

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

Not ported (ROADMAP A12): the communication-avoiding deep and ghost-zone
packed runners and the sharded sparse runners (the single-device sparse
engine is :mod:`..ops.sparse`).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

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
from ..ops.stencil import Topology
from .halo import (
    band_edge_code,
    band_edge_codes,
    exchange_cols,
    exchange_halo,
    exchange_rows,
)
from .mesh import COL_AXIS, Mesh, ShardedGrid, band_axis

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
