"""Temporal-blocked packed stencils: the hand-written Hopper kernels and
their plain PyTorch versions.

Counterpart of the full-grid kernels of
``gameoflifewithactors_tpu.ops.pallas_stencil``:

- B1, ``_make_kernel`` / ``multi_step_pallas``: a 3x3 B/S rule on a
  packed ``(H, W/32)`` int32 grid (:func:`multi_step_kernel`,
  ``csrc/life_packed.cu``);
- B3, ``_make_gen_kernel`` / ``multi_step_pallas_generations``: a
  Generations rule on a ``(b, H, W/32)`` bit-plane stack
  (:func:`multi_step_generations_kernel`, ``csrc/life_generations.cu``);
- B4, ``_make_ltl_kernel`` / ``multi_step_ltl_pallas``: a binary
  radius-r Larger-than-Life rule on a packed grid
  (:func:`multi_step_ltl_kernel`, ``csrc/life_ltl.cu``);

and of their slab modes with ``dead_band``: one launch of ``g``
generations on a batch of halo-extended full-width row bands, each with
its own edge code where the caller gives one per band --

- B2, ``_make_kernel`` / ``make_pallas_slab_step``: B/S words
  (:func:`slab_step_kernel`, ``csrc/life_slab.cu``), the step of the
  sharded band runner in :mod:`..parallel.sharded`; and its lane form
  (:func:`multi_step_lane_kernel`), which steps a batch of whole grids and a
  mask with no extended copy, the step of the batched lane runner in
  :mod:`..parallel.batched` (its plain version,
  :func:`lane_step_reference`, is the row exchange, the slab form's plain
  version, the crop and the mask's select);
- B3 slab, ``_make_gen_kernel`` / ``make_pallas_gen_slab_step``:
  Generations plane stacks (:func:`slab_step_generations_kernel`, the
  slab instantiations of ``csrc/life_generations.cu``);
- B4 slab, ``_make_ltl_kernel`` / ``make_ltl_pallas_slab_step``: binary
  LtL words with ``r*g``-row halos (:func:`slab_step_ltl_kernel`, the slab
  instantiation of ``csrc/life_ltl.cu``).

One launch advances ``g`` generations: each CUDA block loads its tile plus
a halo (``g`` rows and one word per side for the 3x3 kernels, ``r*g`` rows
and ``ceil(r*g/32)`` words for LtL) into shared memory, steps it ``g``
times and writes back its interior. The ``n % g`` remainder is one more,
shorter launch. ``_build`` compiles each source with ``nvcc`` at first use.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version -- the kernel's own algorithm (same tiles, modulo-wrapped halo
gather, DEAD re-zero every generation or the dead band of a slab,
shrinking slab steps of :mod:`.packed`, :mod:`.packed_generations` or
:mod:`.packed_ltl`, shorter last launch) in plain torch -- only for a CPU
tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generations import GenRule
from ..models.ltl import LtLRule
from ..models.rules import Rule
from ..parallel.halo import exchange_rows_stack
from ..utils.interop import host_to_device
from ._builders import BuiltRunner, register_builder
from .packed import step_packed_slab
from .packed_generations import n_planes, step_planes_slab
from .packed_ltl import step_ltl_packed_slab
from .stencil import Topology

# B1's depth and tile from the sweep on the card (PERF.md): a warp writes
# 30 words of a row, so 58 words (60 computed with the halo) fill two
# warps, and the tallest such tile whose slabs leave room for a second
# block on the SM spends the fewest rows on the halo
DEFAULT_GENS_PER_CALL = 16
DEFAULT_TILE = (192, 58)   # (rows, words) each B1/B2 block owns
# B2's chunk on a serving lane and a mesh band: the band must hold at least
# this many rows, so it decides which lanes and bands the kernels take
DEFAULT_BAND_GENS_PER_CALL = 8
MAX_GENS_PER_CALL = 32    # one halo word per side covers 32 generations
ROW_WORDS = 32            # a tile spanning a row of at most this many words
                          # takes the row form: one warp, no halo word
# Generations and Larger than Life: depth and tile from the sweeps on the
# card (PERF.md)
DEFAULT_GENERATIONS_GENS_PER_CALL = 16
# B3's tiles, the first that lets two blocks share an SM (else the first
# that fits) being the default: a warp writes 30 words of a row, so 28
# words (30 computed with the halo) fill one warp, and tall tiles spend
# the fewest rows on the halo
_GENERATIONS_TILES = ((192, 28), (160, 28), (128, 28), (96, 28), (64, 28),
                      (32, 28), (16, 28), (16, 13), (8, 13), (8, 6), (4, 6),
                      (2, 6), (1, 6), (1, 1))
MAX_GENERATIONS_COUNTS = 4   # counts the equality path of B1-B3 tests
DEFAULT_LTL_GENS_PER_CALL = 4
DEFAULT_LTL_TILE = (256, 32)
DEFAULT_LTL_SEGMENT = 64  # most rows one LtL thread walks down a column
MAX_LTL_BOUNDS = 32       # interval boundaries per set the LtL kernel takes
_SMEM_LIMIT = 232448      # bytes of shared memory one Hopper block may use
_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535

# Launches of each CUDA kernel in this process: its wrapper adds one per
# launch, nothing else touches them except a caller resetting them to 0.
KERNEL_LAUNCHES = 0             # B1, life_packed
GENERATIONS_LAUNCHES = 0        # B3, life_generations, full grid
LTL_LAUNCHES = 0                # B4, life_ltl, full grid
SLAB_LAUNCHES = 0               # B2, life_slab, slab and lane forms
GENERATIONS_SLAB_LAUNCHES = 0   # B3, life_generations, slab mode
LTL_SLAB_LAUNCHES = 0           # B4, life_ltl, slab mode
# each counter by the name of the kernel form it counts
LAUNCH_COUNTERS = {"life_packed": "KERNEL_LAUNCHES",
                   "life_slab": "SLAB_LAUNCHES",
                   "life_generations": "GENERATIONS_LAUNCHES",
                   "life_ltl": "LTL_LAUNCHES",
                   "life_generations_slab": "GENERATIONS_SLAB_LAUNCHES",
                   "life_ltl_slab": "LTL_SLAB_LAUNCHES"}

_libs: dict = {}


def launch_counts() -> Dict[str, int]:
    """Every kernel form's launches so far, by its name in
    ``LAUNCH_COUNTERS``."""
    counts = globals()
    return {name: counts[c] for name, c in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every launch counter to 0."""
    counts = globals()
    for c in LAUNCH_COUNTERS.values():
        counts[c] = 0


def _launch_plan(n: int, g: int) -> List[int]:
    """Generations per launch for ``n`` generations: ``n // g`` launches of
    ``g``, then one of ``n % g``."""
    n = int(n)
    if n < 0:
        raise ValueError(f"cannot step a negative number of generations: {n}")
    chunks, rem = divmod(n, g)
    return [g] * chunks + ([rem] if rem else [])


def _depth(gens_per_call: Optional[int], default: int) -> int:
    g = default if gens_per_call is None else int(gens_per_call)
    if not 1 <= g <= MAX_GENS_PER_CALL:
        raise ValueError(
            f"gens_per_call must be in 1..{MAX_GENS_PER_CALL}, got {g}")
    return g


def _fit_tile(tile: Tuple[int, int], smem) -> Tuple[int, int]:
    """``tile`` halved (the longer side first) until ``smem(th, tw)`` bytes
    fit in a block's shared memory."""
    th, tw = tile
    while smem(th, tw) > _SMEM_LIMIT and (th > 1 or tw > 1):
        if th >= tw:
            th = max(1, th // 2)
        else:
            tw = max(1, tw // 2)
    return th, tw


def _checked_tile(tile, smem, what: str) -> Tuple[int, int]:
    th, tw = int(tile[0]), int(tile[1])
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be positive (rows, words), got {(th, tw)}")
    if smem(th, tw) > _SMEM_LIMIT:
        raise ValueError(
            f"tile {(th, tw)} needs {smem(th, tw)} bytes of shared memory "
            f"for {what}; a Hopper block has {_SMEM_LIMIT}")
    return th, tw


def _packed_smem(g: int):
    """Shared memory of the B1/B2 tile: two buffers of padded slab rows,
    ``tw + 4`` words each, or :data:`ROW_WORDS` where a row form holds a
    whole row in a warp (counted for every tile narrower than that, which
    the launch may put in a row form)."""
    return lambda th, tw: 2 * (th + 2 * g) * max(tw + 4, ROW_WORDS) * 4


def _resolve(gens_per_call: Optional[int], tile: Optional[Tuple[int, int]]
             ) -> Tuple[int, int, int]:
    """(g, th, tw) of the binary 3x3 kernel."""
    g = _depth(gens_per_call, DEFAULT_GENS_PER_CALL)
    th, tw = _checked_tile(tile or DEFAULT_TILE, _packed_smem(g),
                           f"{g} generations per call")
    return g, th, tw


def _generations_smem(planes: int, g: int):
    """Shared memory of the B3 kernel's tile: two buffers of b planes of
    padded slab rows."""
    return lambda th, tw: 2 * planes * (th + 2 * g) * (tw + 4) * 4


def _generations_tile(smem) -> Tuple[int, int]:
    """B3's default tile: the first of :data:`_GENERATIONS_TILES` whose
    slabs leave room for a second block on the SM, else the first that
    fits."""
    for limit in (_SMEM_LIMIT // 2, _SMEM_LIMIT):
        for th, tw in _GENERATIONS_TILES:
            if smem(th, tw) <= limit:
                return th, tw
    return _GENERATIONS_TILES[-1]


def _resolve_generations(planes: int, gens_per_call: Optional[int],
                         tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the Generations kernel for ``planes`` bit-planes."""
    g = _depth(gens_per_call, DEFAULT_GENERATIONS_GENS_PER_CALL)
    smem = _generations_smem(planes, g)
    th, tw = _checked_tile(tile or _generations_tile(smem), smem,
                           f"{planes} planes at {g} generations per call")
    return g, th, tw


def _halo_words(radius: int, g: int) -> int:
    return -(-radius * g // 32)


def _resolve_ltl(rule: LtLRule, gens_per_call: Optional[int],
                 tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the LtL kernel: halo ``r*g`` rows and
    ``ceil(r*g/32)`` words per side."""
    g = _depth(gens_per_call, DEFAULT_LTL_GENS_PER_CALL)
    smem = _ltl_smem(rule.radius, g)
    th, tw = _checked_tile(tile or _fit_tile(DEFAULT_LTL_TILE, smem), smem,
                           f"radius {rule.radius} at {g} generations per call")
    return g, th, tw


def _even_rows(He: int, tile: Tuple[int, int], smem) -> Tuple[int, int]:
    """``tile`` narrowed to a ``Wp``-word band by the caller, its rows
    evened out over the ``He`` extended rows: as many row tiles as
    ``He / th`` rounds to, or, where those no longer fit in shared memory,
    as many as it rounds up to."""
    th, tw = tile
    for n in (max(1, round(He / th)), -(-He // th)):
        even = -(-He // n)
        if smem(even, tw) <= _SMEM_LIMIT:
            return even, tw
    return th, tw


def _resolve_slab(gens: int, He: int, Wp: int,
                  tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the B2 slab form for ``(He, Wp)`` bands: B1's default
    tile, no wider than the band, its rows evened out over the band (a
    4112-row band takes 21 tiles of 196 rows, not 22 of 192 with 112 rows
    computed beyond it)."""
    g = _depth(gens, DEFAULT_BAND_GENS_PER_CALL)
    smem = _packed_smem(g)
    if tile is None:
        tile = _even_rows(He, (DEFAULT_TILE[0], max(1, min(DEFAULT_TILE[1], Wp))),
                          smem)
    th, tw = _checked_tile(tile, smem, f"{g} generations per call")
    return g, th, tw


def _resolve_lane(gens: int, H: int, Wp: int,
                  tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the B2 lane form for ``(H, Wp)`` grids: B1's default
    tile, as wide as the grid where its rows are at most
    :data:`ROW_WORDS` words (the row form: one warp a row, no halo word),
    else no wider than the grid, its rows evened out over the grid."""
    g = _depth(gens, DEFAULT_BAND_GENS_PER_CALL)
    smem = _packed_smem(g)
    if tile is None:
        tw = Wp if Wp <= ROW_WORDS else min(DEFAULT_TILE[1], Wp)
        tile = _even_rows(H, (DEFAULT_TILE[0], max(1, tw)), smem)
    th, tw = _checked_tile(tile, smem, f"{g} generations per call")
    return g, th, tw


def supported_slab(shape, gens: int, *, batch: int = 1,
                   tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B2 slab form takes ``batch`` halo-extended ``(He, Wp)``
    bands at ``gens`` generations per launch: 1..32 generations, a tile
    that fits in shared memory, and a launch grid of at most 65535 row
    tiles and 65535 bands."""
    He, Wp = shape
    if He < 1 or Wp < 1 or not 1 <= batch <= _MAX_GRID_Z:
        return False
    try:
        _, th, _ = _resolve_slab(gens, He, Wp, tile)
    except ValueError:
        return False
    return -(-He // th) <= _MAX_GRID_Y


def supported_lane(shape, gens: int, *, batch: int = 1,
                   tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B2 lane form takes ``batch`` whole ``(H, Wp)`` grids at
    ``gens`` generations per launch: 1..32 generations, no more than ``H``
    (the depth of the row exchange its plain version makes), a tile that
    fits in shared memory, and a launch grid of at most 65535 row tiles
    and 65535 grids."""
    H, Wp = shape
    if H < 1 or Wp < 1 or not 1 <= batch <= _MAX_GRID_Z or gens > H:
        return False
    try:
        _, th, _ = _resolve_lane(gens, H, Wp, tile)
    except ValueError:
        return False
    return -(-H // th) <= _MAX_GRID_Y


def _resolve_generations_slab(planes: int, gens: int, He: int, Wp: int,
                              tile: Optional[Tuple[int, int]]
                              ) -> Tuple[int, int, int]:
    """(g, th, tw) of the B3 slab kernel for ``(planes, He, Wp)`` bands:
    the full-grid kernel's default tile, no wider than the band, its rows
    evened out over the band."""
    g = _depth(gens, DEFAULT_GENERATIONS_GENS_PER_CALL)
    smem = _generations_smem(planes, g)
    if tile is None:
        th, tw = _generations_tile(smem)
        tile = _even_rows(He, (th, max(1, min(tw, Wp))), smem)
    th, tw = _checked_tile(tile, smem,
                           f"{planes} planes at {g} generations per call")
    return g, th, tw


def _ltl_smem(radius: int, g: int):
    """Shared memory of the LtL kernel's tile: two padded slabs (one when a
    launch advances one generation) and a row for the box's look-ahead."""
    hw, buffers = _halo_words(radius, g), 2 if g > 1 else 1
    return lambda th, tw: (buffers * (th + 2 * radius * g) + 1) * \
        (tw + 2 * hw + 2) * 4


def _resolve_ltl_slab(rule: LtLRule, gens: int, He: int, Wp: int,
                      tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the B4 slab kernel for ``(He, Wp)`` bands: the
    full-grid kernel's tile, no wider than the band, its rows evened out
    over the band."""
    g = _depth(gens, DEFAULT_LTL_GENS_PER_CALL)
    smem = _ltl_smem(rule.radius, g)
    if tile is None:
        th, tw = _fit_tile(DEFAULT_LTL_TILE, smem)
        tile = _even_rows(He, (th, max(1, min(tw, Wp))), smem)
    th, tw = _checked_tile(tile, smem,
                           f"radius {rule.radius} at {g} generations per call")
    return g, th, tw


def supported_generations_slab(shape, planes: int, gens: int, *,
                               batch: int = 1,
                               tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B3 slab kernel takes ``batch`` halo-extended ``(He,
    Wp)`` bands of ``planes`` bit-planes at ``gens`` generations per
    launch: 2..8 planes, 1..32 generations, a tile whose 2*b slabs fit in
    shared memory, and a launch grid of at most 65535 row tiles and 65535
    bands."""
    He, Wp = shape
    if (not 2 <= planes <= 8 or He < 1 or Wp < 1
            or not 1 <= batch <= _MAX_GRID_Z):
        return False
    try:
        _, th, _ = _resolve_generations_slab(planes, gens, He, Wp, tile)
    except ValueError:
        return False
    return -(-He // th) <= _MAX_GRID_Y


def supported_ltl_slab(shape, rule, gens: int, *, batch: int = 1,
                       tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B4 slab kernel takes ``rule`` on ``batch``
    halo-extended ``(He, Wp)`` bands at ``gens`` generations per launch:
    what :func:`supported_ltl` asks of the rule and the tile, and a launch
    grid of at most 65535 row tiles and 65535 bands."""
    He, Wp = shape
    if (not _ltl_rule_fits(rule) or He < 1 or Wp < 1
            or not 1 <= batch <= _MAX_GRID_Z):
        return False
    try:
        _, th, _ = _resolve_ltl_slab(rule, gens, He, Wp, tile)
    except ValueError:
        return False
    return -(-He // th) <= _MAX_GRID_Y


def supported(shape, *, tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B/S kernel takes a packed ``(H, Wp)`` grid: any non-empty
    shape whose row tiles fit the launch grid (modulo indexing handles
    every torus, and tiles need not divide the grid)."""
    H, Wp = shape
    th = (tile or DEFAULT_TILE)[0]
    return H >= 1 and Wp >= 1 and -(-H // th) <= _MAX_GRID_Y


def supported_generations(shape, planes: int, *,
                          tile: Optional[Tuple[int, int]] = None,
                          gens_per_call: Optional[int] = None) -> bool:
    """Whether the Generations kernel takes ``planes`` bit-planes of a
    packed ``(H, Wp)`` grid: 2..8 planes (C = 3..256), a tile that fits in
    shared memory, and row tiles that fit the launch grid."""
    H, Wp = shape
    if not 2 <= planes <= 8 or H < 1 or Wp < 1:
        return False
    try:
        _, th, _ = _resolve_generations(planes, gens_per_call, tile)
    except ValueError:
        return False
    return -(-H // th) <= _MAX_GRID_Y


def _boundaries(intervals) -> List[int]:
    """Sorted interval boundaries lo, hi+1, ...: a count lies in the set
    iff an odd number of them are <= it."""
    return [b for lo, hi in intervals for b in (lo, hi + 1)]


def _ltl_rule_fits(rule) -> bool:
    """Binary LtL (C >= 3 has no kernel) with at most ``MAX_LTL_BOUNDS //
    2`` intervals per set."""
    return (isinstance(rule, LtLRule) and rule.states == 2
            and len(_boundaries(rule.born_intervals)) <= MAX_LTL_BOUNDS
            and len(_boundaries(rule.survive_intervals)) <= MAX_LTL_BOUNDS)


def supported_ltl(shape, rule, *, tile: Optional[Tuple[int, int]] = None,
                  gens_per_call: Optional[int] = None) -> bool:
    """Whether the LtL kernel takes ``rule`` on a packed ``(H, Wp)`` grid:
    binary rules (C >= 3 has no kernel) with at most
    ``MAX_LTL_BOUNDS // 2`` intervals per set, a tile that fits in shared
    memory, and row tiles that fit the launch grid."""
    H, Wp = shape
    if not _ltl_rule_fits(rule) or H < 1 or Wp < 1:
        return False
    try:
        _, th, _ = _resolve_ltl(rule, gens_per_call, tile)
    except ValueError:
        return False
    return -(-H // th) <= _MAX_GRID_Y


def _check(p: torch.Tensor, dims: int = 2) -> None:
    if not isinstance(p, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(p).__name__}")
    if p.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {p.dtype}")
    if p.dim() != dims:
        want = {2: "(H, W/32)", 3: "(b, H, W/32)", 4: "(B, b, He, W/32)"}[dims]
        raise ValueError(f"packed grid must be {dims}D {want}, got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("packed grid must be contiguous")


# -- plain versions ----------------------------------------------------------


def _tile_index(n: int, t: int, halo: int, device) -> torch.Tensor:
    """``(ceil(n/t), t + 2*halo)``: the grid index of every slab position of
    every tile along one axis (negative or past ``n`` in the halo)."""
    return (torch.arange(-(-n // t), device=device) * t)[:, None] - halo \
        + torch.arange(t + 2 * halo, device=device)


def _tiles(p: torch.Tensor, hr: int, hw: int, th: int, tw: int,
           topology: Topology, rows: Optional[Topology] = None):
    """Every block's slab at once: ``(..., nty, ntx, th + 2*hr, tw + 2*hw)``
    words gathered with the kernel's indexing (modulo the grid along an axis
    that wraps; zeros outside it along a DEAD one), with the in-grid
    ``(row, word)`` masks (None for an axis that wraps). ``topology`` closes
    both axes unless ``rows`` closes the row axis (the B2 band reads zeros
    above and below itself whatever its horizontal closure)."""
    H, Wp = p.shape[-2:]
    r = _tile_index(H, th, hr, p.device)      # (nty, L) grid rows
    c = _tile_index(Wp, tw, hw, p.device)     # (ntx, ww) grid words
    row_in = (r >= 0) & (r < H) if (rows or topology) is Topology.DEAD else None
    col_in = (c >= 0) & (c < Wp) if topology is Topology.DEAD else None
    slab = p[..., (r % H)[:, None, :, None], (c % Wp)[None, :, None, :]]
    return _rezero(slab, (row_in, col_in), 0), (row_in, col_in)


def _rezero(slab: torch.Tensor, masks, shrunk: int) -> torch.Tensor:
    """Zero the slab's rows and words outside their ``(row, word)`` masks
    (None: keep the axis), ``shrunk`` rows per side having been consumed
    so far."""
    row_in, col_in = masks
    if row_in is not None:   # (..., nty, L): leading dimensions per band
        L = row_in.shape[-1]
        slab = torch.where(row_in[..., None, shrunk:L - shrunk, None], slab, 0)
    if col_in is not None:
        slab = torch.where(col_in[None, :, None, :], slab, 0)
    return slab


def _untile(slab: torch.Tensor, hw: int, tw: int, H: int, Wp: int) -> torch.Tensor:
    """The blocks' ``(..., nty, ntx, th, ww)`` results cropped to their
    ``tw`` interior words and laid back into ``(..., H, Wp)``."""
    out = slab[..., hw:hw + tw]
    *lead, nty, ntx, th, _ = out.shape
    out = out.transpose(-3, -2).reshape(*lead, nty * th, ntx * tw)
    return out[..., :H, :Wp].contiguous()


def _launch_reference(p: torch.Tensor, gens: int, rule: Rule,
                      topology: Topology, th: int, tw: int) -> torch.Tensor:
    """One B1 launch in plain torch: every tile at once as a batch."""
    H, Wp = p.shape
    slab, masks = _tiles(p, gens, 1, th, tw, topology)
    encoding = _generations_rule_encoding(rule)
    for k in range(gens):
        slab = step_packed_slab(_rezero(slab, masks, k), rule, Topology.DEAD,
                                encoding)
    return _untile(slab, 1, tw, H, Wp)


def multi_step_reference(
    p: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B1 kernel's algorithm in plain torch, on any
    device: ``n // g`` launches of ``g`` generations, then one of ``n % g``."""
    _check(p)
    g, th, tw = _resolve(gens_per_call, tile)
    for gens in _launch_plan(n, g):
        p = _launch_reference(p, gens, rule, topology, th, tw)
    return p


def _generations_launch_reference(planes: torch.Tensor, gens: int,
                                  rule: GenRule, topology: Topology,
                                  th: int, tw: int) -> torch.Tensor:
    """One B3 launch in plain torch: every tile of every plane at once."""
    b, H, Wp = planes.shape
    slab, masks = _tiles(planes, gens, 1, th, tw, topology)
    for k in range(gens):
        slab = _rezero(slab, masks, k)
        slab = torch.stack(step_planes_slab(
            tuple(slab[j] for j in range(b)), rule, Topology.DEAD,
            encoding=_generations_rule_encoding(rule)))
    return _untile(slab, 1, tw, H, Wp)


def multi_step_generations_reference(
    planes: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B3 kernel's algorithm in plain torch on a
    ``(b, H, W/32)`` stack, on any device."""
    _check_generations(planes, rule)
    g, th, tw = _resolve_generations(planes.shape[0], gens_per_call, tile)
    for gens in _launch_plan(n, g):
        planes = _generations_launch_reference(planes, gens, rule, topology,
                                               th, tw)
    return planes


def _ltl_launch_reference(p: torch.Tensor, gens: int, rule: LtLRule,
                          topology: Topology, th: int, tw: int) -> torch.Tensor:
    """One B4 launch in plain torch: every tile at once as a batch."""
    H, Wp = p.shape
    r, hw = rule.radius, _halo_words(rule.radius, gens)
    slab, masks = _tiles(p, r * gens, hw, th, tw, topology)
    for k in range(gens):
        slab = step_ltl_packed_slab(_rezero(slab, masks, r * k), rule,
                                    Topology.DEAD)
    return _untile(slab, hw, tw, H, Wp)


def multi_step_ltl_reference(
    p: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B4 kernel's algorithm in plain torch, on
    any device."""
    _check_ltl(p, rule)
    g, th, tw = _resolve_ltl(rule, gens_per_call, tile)
    for gens in _launch_plan(n, g):
        p = _ltl_launch_reference(p, gens, rule, topology, th, tw)
    return p


def _live_rows(He: int, th: int, halo: int, edge_code,
               device) -> Optional[torch.Tensor]:
    """The extended rows a slab keeps live before each generation, outside
    its dead band (rows < ``halo`` under edge-code bit 0, >= ``He - halo``
    under bit 1): None for code 0, an ``(nty, L)`` mask for one code, a
    ``(B, nty, L)`` mask for a ``(B,)`` tensor of codes, one per band."""
    r = _tile_index(He, th, halo, device)
    if isinstance(edge_code, torch.Tensor):
        code = edge_code.to(device=device, dtype=torch.int64)[:, None, None]
        top = torch.where(code & 1 != 0, halo, -He - halo)
        bottom = torch.where(code & 2 != 0, He - halo, 2 * He + halo)
        return (r >= top) & (r < bottom)
    if not edge_code:
        return None
    top = halo if edge_code & 1 else -He - halo
    bottom = He - halo if edge_code & 2 else 2 * He + halo
    return (r >= top) & (r < bottom)


def _slab_launch_reference(ext: torch.Tensor, gens: int, rule: Rule,
                           topology: Topology, edge_code, th: int,
                           tw: int) -> torch.Tensor:
    """One B2 launch in plain torch: every tile of every band at once. Rows
    outside the band load as zeros and then evolve freely; the dead band
    (extended rows < ``gens`` under edge-code bit 0, >= ``He - gens``
    under bit 1) and, for DEAD, the words outside the grid are zeroed
    before every generation."""
    He, Wp = ext.shape[-2:]
    slab, (_, col_in) = _tiles(ext, gens, 1, th, tw, topology,
                               rows=Topology.DEAD)
    live_rows = _live_rows(He, th, gens, edge_code, ext.device)
    encoding = _generations_rule_encoding(rule)
    for k in range(gens):
        slab = step_packed_slab(_rezero(slab, (live_rows, col_in), k), rule,
                                Topology.DEAD, encoding)
    return _untile(slab, 1, tw, He, Wp)


def _generations_slab_launch_reference(ext: torch.Tensor, gens: int,
                                       rule: GenRule, topology: Topology,
                                       edge_code, th: int,
                                       tw: int) -> torch.Tensor:
    """One B3 slab launch in plain torch on a ``(B, b, He, Wp)`` batch:
    B2's closure (zero rows beyond the band at load, the dead band before
    every generation) in every plane."""
    B, b, He, Wp = ext.shape
    slab, (_, col_in) = _tiles(ext, gens, 1, th, tw, topology,
                               rows=Topology.DEAD)
    live_rows = _live_rows(He, th, gens, edge_code, ext.device)
    if live_rows is not None and live_rows.dim() == 3:
        live_rows = live_rows[:, None]    # the same rows in every plane
    for k in range(gens):
        slab = _rezero(slab, (live_rows, col_in), k)
        slab = torch.stack(step_planes_slab(
            tuple(slab[:, j] for j in range(b)), rule, Topology.DEAD,
            encoding=_generations_rule_encoding(rule)), dim=1)
    return _untile(slab, 1, tw, He, Wp)


def _ltl_slab_launch_reference(ext: torch.Tensor, gens: int, rule: LtLRule,
                               topology: Topology, edge_code, th: int,
                               tw: int) -> torch.Tensor:
    """One B4 slab launch in plain torch on a ``(B, He, Wp)`` batch: halo
    and dead band ``r*gens`` rows deep, the slab shrinking ``r`` rows per
    side and generation."""
    He, Wp = ext.shape[-2:]
    r, hw = rule.radius, _halo_words(rule.radius, gens)
    slab, (_, col_in) = _tiles(ext, r * gens, hw, th, tw, topology,
                               rows=Topology.DEAD)
    live_rows = _live_rows(He, th, r * gens, edge_code, ext.device)
    for k in range(gens):
        slab = step_ltl_packed_slab(_rezero(slab, (live_rows, col_in), r * k),
                                    rule, Topology.DEAD)
    return _untile(slab, hw, tw, He, Wp)


def _check_slab(ext: torch.Tensor, edge_code, dims: int = 3) -> None:
    """A ``dims``-D int32 band batch and its edge code: an int 0..3 for
    every band, or a ``(B,)`` int32 tensor of codes on the batch's device
    (bits above bit 1 are ignored; the values are not read here, so a
    device tensor costs no host sync)."""
    _check(ext, dims=dims)
    if isinstance(edge_code, torch.Tensor):
        if (edge_code.dtype != torch.int32 or edge_code.dim() != 1
                or edge_code.shape[0] != ext.shape[0]
                or edge_code.device != ext.device
                or not edge_code.is_contiguous()):
            raise ValueError(
                f"per-band edge codes must be a contiguous ({ext.shape[0]},) "
                f"int32 tensor on {ext.device}, got {edge_code.dtype} "
                f"{tuple(edge_code.shape)} on {edge_code.device}")
    elif int(edge_code) not in (0, 1, 2, 3):
        raise ValueError(
            f"edge_code is bit 0 (top band) | bit 1 (bottom band), got {edge_code}")


def _edge(edge_code):
    """An edge code as the plain versions take it: the tensor, or an int."""
    return edge_code if isinstance(edge_code, torch.Tensor) else int(edge_code)


def slab_step_reference(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One B2 launch, ``gens`` generations of the ``(B, He, W/32)`` batch of
    halo-extended bands, by the kernel's algorithm in plain torch on any
    device (see :func:`slab_step_kernel`)."""
    _check_slab(ext, edge_code)
    g, th, tw = _resolve_slab(gens, ext.shape[1], ext.shape[2], tile)
    return _slab_launch_reference(ext, g, rule, topology, _edge(edge_code),
                                  th, tw)


def _lane_mask(mask, grids: torch.Tensor) -> Optional[torch.Tensor]:
    """The ``(B,)`` nonzero-means-live mask of a lane (numpy, a sequence or
    a tensor) as the lane form takes it: a contiguous int32 tensor on the
    grids' device (``mask`` itself if it is one), or None for all live."""
    if mask is None:
        return None
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.asarray(mask))
    if mask.shape != grids.shape[:1]:
        raise ValueError(
            f"mask of shape {tuple(mask.shape)} for a batch of {grids.shape[0]}")
    if (mask.dtype == torch.int32 and mask.device == grids.device
            and mask.is_contiguous()):
        return mask
    live = (mask != 0).to(torch.int32)
    if live.device.type == "cpu":
        return host_to_device(live, grids.device)
    return live.to(grids.device)


def _check_lane(grids: torch.Tensor, gens: Optional[int]) -> int:
    """A ``(B, H, W/32)`` int32 lane and a depth (default: the bands') no
    deeper than its grids; returns the depth."""
    _check(grids, dims=3)
    g = _depth(gens, DEFAULT_BAND_GENS_PER_CALL)
    if g > grids.shape[1]:
        raise ValueError(
            f"gens_per_exchange={g} exceeds the band height {grids.shape[1]}")
    return g


def _lane_launch_reference(grids: torch.Tensor, gens: int, rule: Rule,
                           topology: Topology,
                           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One B2 lane-form launch in plain torch: the row exchange (each grid
    a mesh of one band), the slab form's plain version (edge code 3 under
    DEAD), the crop of ``gens`` rows per side and the mask's select."""
    ext = exchange_rows_stack(grids, topology, gens)
    _, th, tw = _resolve_slab(gens, ext.shape[1], ext.shape[2], None)
    out = _slab_launch_reference(ext, gens, rule, topology,
                                 3 if topology is Topology.DEAD else 0,
                                 th, tw)[:, gens:-gens]
    if mask is not None:
        out = torch.where(mask[:, None, None] != 0, out, grids)
    return out.contiguous()


def lane_step_reference(
    grids: torch.Tensor,
    gens: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    mask=None,
) -> torch.Tensor:
    """One B2 lane-form launch, ``gens`` generations of the ``(B, H, W/32)``
    batch of whole grids, in plain torch on any device (see
    :func:`multi_step_lane_kernel`)."""
    g = _check_lane(grids, gens)
    return _lane_launch_reference(grids, g, rule, topology,
                                  _lane_mask(mask, grids))


def slab_step_generations_reference(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One B3 slab launch, ``gens`` generations of the ``(B, b, He, W/32)``
    batch of halo-extended plane stacks, by the kernel's algorithm in
    plain torch on any device (see :func:`slab_step_generations_kernel`)."""
    _check_generations_slab(ext, rule, edge_code)
    g, th, tw = _resolve_generations_slab(ext.shape[1], gens, ext.shape[2],
                                          ext.shape[3], tile)
    return _generations_slab_launch_reference(ext, g, rule, topology,
                                              _edge(edge_code), th, tw)


def slab_step_ltl_reference(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One B4 slab launch, ``gens`` generations of the ``(B, He, W/32)``
    batch of halo-extended bands, by the kernel's algorithm in plain torch
    on any device (see :func:`slab_step_ltl_kernel`)."""
    _check_ltl_slab(ext, rule, edge_code)
    g, th, tw = _resolve_ltl_slab(rule, gens, ext.shape[1], ext.shape[2], tile)
    return _ltl_slab_launch_reference(ext, g, rule, topology,
                                      _edge(edge_code), th, tw)


def _check_generations(planes: torch.Tensor, rule: GenRule) -> None:
    _check(planes, dims=3)
    if planes.shape[0] != n_planes(rule.states):
        raise ValueError(
            f"{rule.notation} needs {n_planes(rule.states)} bit-planes, got "
            f"a stack of {planes.shape[0]}")


def _check_ltl(p: torch.Tensor, rule: LtLRule) -> None:
    _check(p)
    _check_binary_ltl(rule)


def _check_binary_ltl(rule: LtLRule) -> None:
    if rule.states != 2:
        raise ValueError(
            f"the LtL kernel is binary (1 bit/cell); {rule.notation} has "
            f"{rule.states} states")


def _check_generations_slab(ext: torch.Tensor, rule: GenRule,
                            edge_code) -> None:
    _check_slab(ext, edge_code, dims=4)
    if ext.shape[1] != n_planes(rule.states):
        raise ValueError(
            f"{rule.notation} needs {n_planes(rule.states)} bit-planes, got "
            f"stacks of {ext.shape[1]}")


def _check_ltl_slab(ext: torch.Tensor, rule: LtLRule, edge_code) -> None:
    _check_slab(ext, edge_code)
    _check_binary_ltl(rule)


# -- kernels -----------------------------------------------------------------

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

# The launch functions of each csrc/<name>.cu and their C argument types.
_SIGNATURES = {
    "life_packed": {
        "life_packed_launch": [_P, _P, _I, _I, _I, _I, _I, _U, _U, _I, _P],
        "life_packed_rule_path": [_U, _U]},
    "life_slab": {
        "life_slab_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _I, _I,
                             _P, _P],
        "life_slab_lane_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _I,
                                  _P, _P]},
    "life_generations": {
        "life_generations_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U,
                                    _U, _I, _P],
        "life_generations_slab_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         _U, _U, _U, _I, _I, _P, _P],
        "life_generations_rule_path": [_U, _U]},
    "life_ltl": {
        "life_ltl_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _I, _P],
        "life_ltl_slab_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P, _P, _P, _I, _I, _P, _P]},
}


def _library(name: str):
    """The built ``csrc/<name>.cu`` with its launch functions typed."""
    lib = _libs.get(name)
    if lib is None:
        from .. import _build

        lib = _build.load(name).lib
        for fn, argtypes in _SIGNATURES[name].items():
            launch = getattr(lib, fn)
            launch.argtypes = argtypes
            launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _edge_args(edge_code) -> Tuple[int, Optional[int]]:
    """(the code for every band, the device pointer of per-band codes or
    None) as the slab launch functions take them."""
    if isinstance(edge_code, torch.Tensor):
        return 0, edge_code.data_ptr()
    return int(edge_code), None


def _ltl_rule_encoding(rule: LtLRule) -> Tuple[List[int], List[int], List[int]]:
    """The interval sets as the LtL kernel takes them: the distinct
    boundaries of both sets, sorted, and for each whether it toggles the
    birth set and the survival set (0 or 1). A window count (centre
    included) lies in a set iff it is >= an odd number of the boundaries
    that toggle it. Under M0 a live cell's count excludes itself, one less
    than its window count, so its survival boundaries move up by one; a
    dead cell's two counts are equal."""
    born = set(_boundaries(rule.born_intervals))
    keep = {b + (0 if rule.middle else 1)
            for b in _boundaries(rule.survive_intervals)}
    bounds = sorted(born | keep)
    return (bounds, [int(b in born) for b in bounds],
            [int(b in keep) for b in bounds])


def _generations_rule_encoding(rule) -> Tuple[Tuple[int, int, int], ...]:
    """The rule as the 3x3 kernels look it up (``csrc/life_rule.cuh``): a
    Generations rule for B3, a B/S rule (C = 2) for B1 and B2. A rule whose
    born and survive sets together name 1..``MAX_GENERATIONS_COUNTS``
    counts, all in 1..7, takes the equality path: each count ascending,
    with whether it is a birth and a survival count (1 or 0); the kernel
    tests a count's equality plane on the three low count bit-planes
    alone, which count 8 (low bits 000) never matches. Any other rule is
    ``()``: the 9-entry table. ``life_rule.cuh``'s ``rule_path`` makes the
    same choice (the C functions ``life_generations_rule_path`` and
    ``life_packed_rule_path``); ``packed_generations.encoded_rule_planes``
    and ``packed.encoded_next_plane`` are the plain twins of the
    lookup."""
    counts = sorted(rule.born | rule.survive)
    if (not counts or len(counts) > MAX_GENERATIONS_COUNTS or counts[0] == 0
            or counts[-1] == 8):
        return ()
    return tuple((n, int(n in rule.born), int(n in rule.survive))
                 for n in counts)


def _ltl_rule_args(rule: LtLRule):
    bounds, born, keep = _ltl_rule_encoding(rule)

    def ints(values):
        return (ctypes.c_int * max(1, len(values)))(*values)

    return (rule.radius, int(rule.neighborhood == "N"), len(bounds),
            ints(bounds), ints(born), ints(keep))


def _launch(lib, src: torch.Tensor, dst: torch.Tensor, gens: int, rule: Rule,
            topology: Topology, th: int, tw: int) -> None:
    global KERNEL_LAUNCHES
    H, Wp = src.shape
    err = lib.life_packed_launch(
        src.data_ptr(), dst.data_ptr(), H, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, int(topology is Topology.DEAD),
        _stream(src))
    _raise_on(lib, "life_packed", err)
    KERNEL_LAUNCHES += 1


def _launch_lane(lib, src, dst, gens, rule: Rule, topology, mask, th, tw):
    global SLAB_LAUNCHES
    B, H, Wp = src.shape
    err = lib.life_slab_lane_launch(
        src.data_ptr(), dst.data_ptr(), B, H, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, int(topology is Topology.DEAD),
        None if mask is None else mask.data_ptr(), _stream(src))
    _raise_on(lib, "life_slab", err)
    SLAB_LAUNCHES += 1


def _launch_generations(lib, src, dst, gens, rule: GenRule, topology, th, tw):
    global GENERATIONS_LAUNCHES
    b, H, Wp = src.shape
    err = lib.life_generations_launch(
        src.data_ptr(), dst.data_ptr(), b, H, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, rule.states,
        int(topology is Topology.DEAD), _stream(src))
    _raise_on(lib, "life_generations", err)
    GENERATIONS_LAUNCHES += 1


def _launch_ltl(lib, src, dst, gens, rule: LtLRule, topology, th, tw):
    global LTL_LAUNCHES
    H, Wp = src.shape
    err = lib.life_ltl_launch(
        src.data_ptr(), dst.data_ptr(), H, Wp, gens, th, tw,
        _halo_words(rule.radius, gens), DEFAULT_LTL_SEGMENT,
        *_ltl_rule_args(rule),
        int(topology is Topology.DEAD), _stream(src))
    _raise_on(lib, "life_ltl", err)
    LTL_LAUNCHES += 1


def _launch_slab(lib, src, dst, gens, rule: Rule, topology, edge_code, th, tw):
    global SLAB_LAUNCHES
    B, He, Wp = src.shape
    err = lib.life_slab_launch(
        src.data_ptr(), dst.data_ptr(), B, He, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, int(topology is Topology.DEAD),
        *_edge_args(edge_code), _stream(src))
    _raise_on(lib, "life_slab", err)
    SLAB_LAUNCHES += 1


def _launch_generations_slab(lib, src, dst, gens, rule: GenRule, topology,
                             edge_code, th, tw):
    global GENERATIONS_SLAB_LAUNCHES
    B, b, He, Wp = src.shape
    err = lib.life_generations_slab_launch(
        src.data_ptr(), dst.data_ptr(), B, b, He, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, rule.states,
        int(topology is Topology.DEAD), *_edge_args(edge_code), _stream(src))
    _raise_on(lib, "life_generations", err)
    GENERATIONS_SLAB_LAUNCHES += 1


def _launch_ltl_slab(lib, src, dst, gens, rule: LtLRule, topology, edge_code,
                     th, tw):
    global LTL_SLAB_LAUNCHES
    B, He, Wp = src.shape
    err = lib.life_ltl_slab_launch(
        src.data_ptr(), dst.data_ptr(), B, He, Wp, gens, th, tw,
        _halo_words(rule.radius, gens), DEFAULT_LTL_SEGMENT,
        *_ltl_rule_args(rule),
        int(topology is Topology.DEAD), *_edge_args(edge_code), _stream(src))
    _raise_on(lib, "life_ltl", err)
    LTL_SLAB_LAUNCHES += 1


def _run(p: torch.Tensor, plan: List[int], launch) -> torch.Tensor:
    """The launches of ``plan``, ping-ponging between two new buffers on
    the current stream (``p`` itself is left as it was)."""
    if not plan:
        return p
    bufs = (torch.empty_like(p), torch.empty_like(p))
    src = p
    with torch.cuda.device(p.device):
        for i, gens in enumerate(plan):
            dst = bufs[i % 2]
            launch(src, dst, gens)
            src = dst
    return src


def _run_once(ext: torch.Tensor, launch) -> torch.Tensor:
    """One slab launch from ``ext`` into a new tensor on the current
    stream."""
    out = torch.empty_like(ext)
    with torch.cuda.device(ext.device):
        launch(ext, out)
    return out


def _on_card(p: torch.Tensor, ok: bool, why: str) -> None:
    """A wrapper's device test after its CPU branch: CUDA and a shape the
    kernel takes, or raise."""
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    if not ok:
        raise ValueError(why)


def multi_step_kernel(
    p: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the packed int32 grid ``p`` by ``n`` generations of a B/S
    rule.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations, ping-ponging between two new buffers on the
    current stream (``p`` itself is left as it was). On a CPU tensor: the
    plain version, :func:`multi_step_reference`. Any other device raises."""
    _check(p)
    g, th, tw = _resolve(gens_per_call, tile)
    if p.device.type == "cpu":
        return multi_step_reference(p, n, rule=rule, topology=topology,
                                    gens_per_call=g, tile=(th, tw))
    _on_card(p, supported(p.shape, tile=(th, tw)),
             f"packed shape {tuple(p.shape)} exceeds the kernel's launch grid "
             f"at tile {(th, tw)}")
    plan = _launch_plan(n, g)
    lib = _library("life_packed") if plan else None
    return _run(p, plan, lambda src, dst, gens: _launch(
        lib, src, dst, gens, rule, topology, th, tw))


def multi_step_generations_kernel(
    planes: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the ``(b, H, W/32)`` int32 bit-plane stack of a Generations
    rule by ``n`` generations: the counterpart of
    ``multi_step_pallas_generations``.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations (``planes`` itself is left as it was). On a CPU
    tensor: the plain version, :func:`multi_step_generations_reference`.
    Any other device raises."""
    _check_generations(planes, rule)
    b = planes.shape[0]
    g, th, tw = _resolve_generations(b, gens_per_call, tile)
    if planes.device.type == "cpu":
        return multi_step_generations_reference(
            planes, n, rule=rule, topology=topology, gens_per_call=g,
            tile=(th, tw))
    _on_card(planes, supported_generations(planes.shape[1:], b, tile=(th, tw),
                                           gens_per_call=g),
             f"plane stack {tuple(planes.shape)} exceeds the Generations "
             f"kernel's launch grid at tile {(th, tw)}")
    plan = _launch_plan(n, g)
    lib = _library("life_generations") if plan else None
    return _run(planes, plan, lambda src, dst, gens: _launch_generations(
        lib, src, dst, gens, rule, topology, th, tw))


def multi_step_ltl_kernel(
    p: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the packed int32 grid ``p`` by ``n`` generations of a binary
    Larger-than-Life rule: the counterpart of ``multi_step_ltl_pallas``.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations (``p`` itself is left as it was). On a CPU
    tensor: the plain version, :func:`multi_step_ltl_reference`. Any other
    device raises."""
    _check_ltl(p, rule)
    g, th, tw = _resolve_ltl(rule, gens_per_call, tile)
    if p.device.type == "cpu":
        return multi_step_ltl_reference(p, n, rule=rule, topology=topology,
                                        gens_per_call=g, tile=(th, tw))
    _on_card(p, supported_ltl(p.shape, rule, tile=(th, tw), gens_per_call=g),
             f"the LtL kernel cannot take {rule.notation} on packed shape "
             f"{tuple(p.shape)} at tile {(th, tw)} (at most "
             f"{MAX_LTL_BOUNDS // 2} intervals per set)")
    plan = _launch_plan(n, g)
    lib = _library("life_ltl") if plan else None
    return _run(p, plan, lambda src, dst, gens: _launch_ltl(
        lib, src, dst, gens, rule, topology, th, tw))


def load_slab_kernel():
    """The B2 kernel's library, built by ``nvcc`` first if needed."""
    return _library("life_slab")


def slab_step_kernel(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance a ``(B, He, W/32)`` int32 batch of halo-extended full-width
    row bands by ``gens`` generations of a B/S rule: the counterpart of
    ``make_pallas_slab_step`` (``dead_band`` is ``edge_code != 0``).

    Rows outside ``[0, He)`` are zero at the start and evolve freely;
    ``edge_code`` bit 0 (bit 1) zeroes the extended rows ``< gens`` (``>=
    He - gens``) before every generation, the dead exterior of a band at
    the grid's top (bottom) edge. ``edge_code`` is an int for every band
    or a ``(B,)`` int32 tensor on the batch's device, one code per band
    (the bands of a mesh: 1 for the top one, 2 for the bottom one, 0
    between). ``topology`` is the horizontal closure. The caller keeps
    rows ``[gens, He - gens)``.

    On a CUDA tensor: one launch of the Hopper kernel over the whole batch
    into a new tensor on the current stream. On a CPU tensor: the plain
    version, :func:`slab_step_reference`. Any other device raises."""
    _check_slab(ext, edge_code)
    g, th, tw = _resolve_slab(gens, ext.shape[1], ext.shape[2], tile)
    if ext.device.type == "cpu":
        return _slab_launch_reference(ext, g, rule, topology, _edge(edge_code),
                                      th, tw)
    _on_card(ext, supported_slab(ext.shape[1:], g, batch=ext.shape[0],
                                 tile=(th, tw)),
             f"band batch {tuple(ext.shape)} exceeds the slab kernel's launch "
             f"grid at tile {(th, tw)}")
    lib = load_slab_kernel()
    return _run_once(ext, lambda src, dst: _launch_slab(
        lib, src, dst, g, rule, topology, edge_code, th, tw))


def multi_step_lane_kernel(
    grids: torch.Tensor,
    n: int,
    mask=None,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance a ``(B, H, W/32)`` int32 batch of whole grids (a serving
    lane) by ``n`` generations of a B/S rule, ``topology`` closing both
    axes of every grid, through B2's lane form: ``n // g`` launches of
    ``g`` generations, then one of ``n % g``, the counterpart of
    ``make_multi_step_pallas_batched``'s chunks (row exchange, slab step,
    crop, select). ``mask`` (optional, ``(B,)``, nonzero = live) freezes
    the grids whose entry is 0: they come out bit-identical. ``g`` is at
    most ``H``, the depth of the exchange. A launch reads the rows beyond
    each grid from the grid itself (no extended copy).

    On a CUDA tensor: the launches ping-pong between two new buffers on
    the current stream (``grids`` itself is left as it was). On a CPU
    tensor: each launch by the plain version, :func:`lane_step_reference`.
    Any other device raises."""
    g = _check_lane(grids, gens_per_call)
    mask = _lane_mask(mask, grids)
    plan = _launch_plan(n, g)
    if grids.device.type == "cpu":
        for gens in plan:
            grids = _lane_launch_reference(grids, gens, rule, topology, mask)
        return grids
    B, H, Wp = grids.shape
    _, th, tw = _resolve_lane(g, H, Wp, tile)
    _on_card(grids, supported_lane((H, Wp), g, batch=B, tile=(th, tw)),
             f"lane {tuple(grids.shape)} exceeds the lane kernel's launch "
             f"grid at tile {(th, tw)}")
    lib = load_slab_kernel() if plan else None
    return _run(grids, plan, lambda src, dst, gens: _launch_lane(
        lib, src, dst, gens, rule, topology, mask, th, tw))


def slab_step_generations_kernel(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance a ``(B, b, He, W/32)`` int32 batch of halo-extended
    full-width bit-plane stacks by ``gens`` generations of a Generations
    rule: the counterpart of ``make_pallas_gen_slab_step`` (``dead_band``
    is ``edge_code != 0``). The closure is :func:`slab_step_kernel`'s in
    every plane; the caller keeps rows ``[gens, He - gens)``.

    On a CUDA tensor: one launch of the Hopper kernel over the whole batch
    into a new tensor on the current stream. On a CPU tensor: the plain
    version, :func:`slab_step_generations_reference`. Any other device
    raises."""
    _check_generations_slab(ext, rule, edge_code)
    B, b, He, Wp = ext.shape
    g, th, tw = _resolve_generations_slab(b, gens, He, Wp, tile)
    if ext.device.type == "cpu":
        return _generations_slab_launch_reference(
            ext, g, rule, topology, _edge(edge_code), th, tw)
    _on_card(ext, supported_generations_slab((He, Wp), b, g, batch=B,
                                             tile=(th, tw)),
             f"plane-stack batch {tuple(ext.shape)} exceeds the Generations "
             f"slab kernel's launch grid at tile {(th, tw)}")
    lib = _library("life_generations")
    return _run_once(ext, lambda src, dst: _launch_generations_slab(
        lib, src, dst, g, rule, topology, edge_code, th, tw))


def slab_step_ltl_kernel(
    ext: torch.Tensor,
    gens: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    edge_code=0,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance a ``(B, He, W/32)`` int32 batch of halo-extended full-width
    bands by ``gens`` generations of a binary Larger-than-Life rule of
    radius ``r``: the counterpart of ``make_ltl_pallas_slab_step``
    (``dead_band`` is ``edge_code != 0``). Halo and dead band are ``r *
    gens`` rows deep; otherwise the closure is :func:`slab_step_kernel`'s.
    The caller keeps rows ``[r*gens, He - r*gens)``.

    On a CUDA tensor: one launch of the Hopper kernel over the whole batch
    into a new tensor on the current stream. On a CPU tensor: the plain
    version, :func:`slab_step_ltl_reference`. Any other device raises."""
    _check_ltl_slab(ext, rule, edge_code)
    B, He, Wp = ext.shape
    g, th, tw = _resolve_ltl_slab(rule, gens, He, Wp, tile)
    if ext.device.type == "cpu":
        return _ltl_slab_launch_reference(ext, g, rule, topology,
                                          _edge(edge_code), th, tw)
    _on_card(ext, supported_ltl_slab((He, Wp), rule, g, batch=B,
                                     tile=(th, tw)),
             f"the LtL slab kernel cannot take {rule.notation} on band batch "
             f"{tuple(ext.shape)} at tile {(th, tw)} (at most "
             f"{MAX_LTL_BOUNDS // 2} intervals per set, 65535 bands and "
             "65535 row tiles)")
    lib = _library("life_ltl")
    return _run_once(ext, lambda src, dst: _launch_ltl_slab(
        lib, src, dst, g, rule, topology, edge_code, th, tw))


# -- contract-gate registrations (ops/_builders.py BUILDERS) -------------------
#
# The kernel runners the engine's ``auto`` picks on the card, each on a
# small example: one call of ``n`` generations launches ceil(n/g) of its
# own kernel and no other kernel. Tagged ``cuda``: the gate holds them on
# the card only (on the CPU they read "needs CUDA").

_CONTRACT_SHAPE = (256, 1024)


def _contract_words(device, shape=_CONTRACT_SHAPE, seed=7) -> torch.Tensor:
    from . import bitpack
    from .packed import _contract_soup

    return bitpack.pack(_contract_soup(device, shape, seed))


def _contract_planes(device, rule) -> torch.Tensor:
    from .packed_generations import pack_generations_for

    rng = np.random.default_rng(7)
    cells = rng.integers(0, rule.states, size=_CONTRACT_SHAPE, dtype=np.uint8)
    return pack_generations_for(torch.from_numpy(cells).to(device), rule)


def _slab_batch(t: torch.Tensor, bands: int, depth: int) -> torch.Tensor:
    """``bands`` halo-extended row bands of ``t`` (TORUS wrap), stacked."""
    rows = t.shape[-2] // bands
    return torch.stack([
        torch.roll(t, depth - b * rows, dims=-2)[..., :rows + 2 * depth, :]
        for b in range(bands)]).contiguous()


def _contract_kernel_runner(device, step, state, g: int, counter: str,
                            n: Optional[int] = None) -> BuiltRunner:
    n = 2 * g + 3 if n is None else n    # two full launches and a shorter
    return BuiltRunner(lambda s: step(s, n), (state,), kernel=counter,
                       launches=-(-n // g))


@register_builder("cuda.multi_step_kernel", tags=("cuda", "packed"))
def _contract_b1(device):
    from ..models.rules import CONWAY

    return _contract_kernel_runner(
        device, lambda p, n: multi_step_kernel(p, n, rule=CONWAY),
        _contract_words(device), DEFAULT_GENS_PER_CALL, "KERNEL_LAUNCHES")


@register_builder("cuda.multi_step_lane_kernel",
                  tags=("cuda", "packed", "serving"))
def _contract_b2_lane(device):
    from ..models.rules import CONWAY

    lane = torch.stack([_contract_words(device, (128, 1024), seed)
                        for seed in range(8)])
    mask = np.ones((8,), np.uint32)
    mask[3] = 0
    return _contract_kernel_runner(
        device, lambda grids, n: multi_step_lane_kernel(grids, n, mask,
                                                        rule=CONWAY),
        lane, DEFAULT_BAND_GENS_PER_CALL, "SLAB_LAUNCHES")


@register_builder("cuda.slab_step_kernel", tags=("cuda", "packed", "mesh"))
def _contract_b2_slab(device):
    from ..models.rules import CONWAY

    g = DEFAULT_BAND_GENS_PER_CALL
    return _contract_kernel_runner(
        device, lambda ext, n: slab_step_kernel(ext, n, rule=CONWAY),
        _slab_batch(_contract_words(device), 4, g), g, "SLAB_LAUNCHES", n=g)


@register_builder("cuda.multi_step_generations_kernel",
                  tags=("cuda", "generations"))
def _contract_b3(device):
    from ..models.generations import parse_any

    brain = parse_any("brain")
    return _contract_kernel_runner(
        device, lambda p, n: multi_step_generations_kernel(p, n, rule=brain),
        _contract_planes(device, brain), DEFAULT_GENERATIONS_GENS_PER_CALL,
        "GENERATIONS_LAUNCHES")


@register_builder("cuda.slab_step_generations_kernel",
                  tags=("cuda", "generations", "mesh"))
def _contract_b3_slab(device):
    from ..models.generations import parse_any

    brain = parse_any("brain")
    g = DEFAULT_GENERATIONS_GENS_PER_CALL
    return _contract_kernel_runner(
        device, lambda ext, n: slab_step_generations_kernel(ext, n,
                                                            rule=brain),
        _slab_batch(_contract_planes(device, brain), 4, g), g,
        "GENERATIONS_SLAB_LAUNCHES", n=g)


@register_builder("cuda.multi_step_ltl_kernel", tags=("cuda", "ltl"))
def _contract_b4(device):
    from ..models.generations import parse_any

    bosco = parse_any("bosco")
    return _contract_kernel_runner(
        device, lambda p, n: multi_step_ltl_kernel(p, n, rule=bosco),
        _contract_words(device), DEFAULT_LTL_GENS_PER_CALL, "LTL_LAUNCHES")


@register_builder("cuda.slab_step_ltl_kernel", tags=("cuda", "ltl", "mesh"))
def _contract_b4_slab(device):
    from ..models.generations import parse_any

    bosco = parse_any("bosco")
    g = DEFAULT_LTL_GENS_PER_CALL
    return _contract_kernel_runner(
        device, lambda ext, n: slab_step_ltl_kernel(ext, n, rule=bosco),
        _slab_batch(_contract_words(device), 4, bosco.radius * g), g,
        "LTL_SLAB_LAUNCHES", n=g)
