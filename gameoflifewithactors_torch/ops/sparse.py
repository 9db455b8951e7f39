"""Activity-tiled sparse stepping: compute in proportion to the active
area, not the grid area, in plain PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.sparse`` (BASELINE.json
config #5 is a Gosper gun in a 65536² field: about 10² live tiles out of
10⁵). The engine keeps a per-tile *changed-last-chunk* map and steps only
the tiles whose wake neighbourhood changed. Rule locality makes that
exact: a cell can only change if something within its rule's radius r
changed, so a tile can only change if a tile within ceil(r·g /
tile_extent) tile rings did (:func:`_wake_dilation`).

- State is the packed grid (``(H, W/32)`` int32 words, or a ``(b, H,
  W/32)`` plane stack) with a zero ring of (r·g rows, 1 word) sized by the
  rule and the chunk depth g (:func:`_rule_halo`). Under DEAD the ring
  *is* the boundary; under TORUS it is refreshed with the wrapped
  interior edges, corners included, before every chunk, and the
  activity dilation wraps.
- Each chunk dilates the map into the candidate tiles and reads their
  indices back to the host (``torch.nonzero``: the one host sync of a
  chunk). More candidates than ``capacity`` stops the run *before* the
  chunk, state untouched, exactly where the JAX package's on-device loop
  stops. Otherwise the candidates' halo-extended windows are gathered as
  one batch, stepped ``g`` generations (:func:`_step_window_chunk`) and
  their interiors scattered back in one indexed write. The batch holds
  exactly the candidates, so no fill slot is stepped or written.
- :class:`SparseEngineState` keeps the JAX package's capacity policy
  (adaptive start, escalation, the dense fallback of one full-grid
  generation), so ``capacity`` and ``active_tiles()`` equal the JAX
  engine's after every ``step``.

No TPU kernel serves this path (XLA fuses it in the JAX package); it runs
as plain torch on the tensor's device. ``memory/`` (the paged tile pool)
shares the public face at the end of this module.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..analysis import sanitizers
from ..models.generations import GenRule
from ..models.ltl import LtLRule
from . import bitpack
from ._builders import steps_in_place
from .packed import step_packed_ext, step_packed_slab
from .packed_generations import n_planes, step_planes_ext, step_planes_slab
from .packed_ltl import (
    step_ltl_packed_ext,
    step_ltl_packed_slab,
    step_ltl_planes_ext,
    step_ltl_planes_slab,
)
from .stencil import Topology

DEFAULT_TILE_ROWS = 32
DEFAULT_TILE_WORDS = 4
_MAX_ADAPTIVE_CAPACITY = 4096
MAX_MAP_ENTRIES = 65536


def _step_fns(rule, planes: bool):
    """The ``(ext_step, slab_step)`` pair of a rule's layout, for a batch
    of windows: ``(K, R, C)`` words, or ``(b, K, R, C)`` with the plane
    axis first when ``planes``. ``ext`` consumes fixed (r, rw) halos and
    returns the interior; ``slab`` shrinks 2r rows with vertical-DEAD
    closure and DEAD closure across the window's own width."""

    def stacked(fn, *extra):
        return lambda w: torch.stack(fn(
            tuple(w[i] for i in range(w.shape[0])), rule, *extra))

    if isinstance(rule, LtLRule):
        if planes:
            return (stacked(step_ltl_planes_ext),
                    stacked(step_ltl_planes_slab, Topology.DEAD))
        return (lambda w: step_ltl_packed_ext(w, rule),
                lambda w: step_ltl_packed_slab(w, rule, Topology.DEAD))
    if not planes:
        return (lambda w: step_packed_ext(w, rule),
                lambda w: step_packed_slab(w, rule, Topology.DEAD))
    return (stacked(step_planes_ext),
            stacked(step_planes_slab, Topology.DEAD))


def _step_window(window: torch.Tensor, rule) -> torch.Tensor:
    """One generation of a halo-extended window in any layout: a
    ``(..., tr+2r, tw+2)`` packed bitboard (binary 3x3 or radius-r LtL) or
    a ``(b, ..., tr+2r, tw+2)`` plane stack (Generations, multi-state LtL:
    leading plane axis, as the rule's layout says)."""
    return _step_fns(rule, rule_layout(rule)[1] == 3)[0](window)


def _rule_halo(rule) -> Tuple[int, int]:
    """The zero-ring depth a rule's windowed step needs: (rows, words).
    3x3 families use (1, 1); radius-r LtL uses (r, 1): its packed step
    reads r halo rows but one 32-cell halo word (r <= 7)."""
    if isinstance(rule, LtLRule):
        return rule.radius, 1
    return 1, 1


def _wake_dilation(rule, tile_rows: int, tile_words: int,
                   gens: int = 1) -> Tuple[int, int]:
    """Wake radius in TILE units, (dy, dx): influence travels r cells per
    generation, so over a ``gens``-generation chunk a tile wakes when
    anything within ceil(r·gens / tile_extent) tile rings changed. The one
    definition the candidate dilation and the capacity estimate share."""
    r, _ = _rule_halo(rule)
    hr = r * gens
    return -(-hr // tile_rows), -(-hr // (tile_words * bitpack.WORD))


def max_chunk_gens(rule) -> int:
    """The deepest legal temporal chunk for a rule: g·r <= 32 keeps the
    horizontal DEAD-closure creep inside the one halo word; capped at 8."""
    r, _ = _rule_halo(rule)
    return max(1, min(8, 32 // r))


def _births_from_nothing(rule) -> bool:
    """True when an all-dead neighbourhood births a cell: nothing would
    ever sleep, so activity tiling is unsound."""
    if isinstance(rule, LtLRule):
        return any(lo == 0 for lo, _ in rule.born_intervals)
    return 0 in rule.born


def _pad_ring(packed: torch.Tensor, r: int = 1, rw: int = 1) -> torch.Tensor:
    """A new tensor: ``packed`` inside a zero ring of (r rows, rw words)
    around the spatial dims."""
    lead, (h, wp) = packed.shape[:-2], packed.shape[-2:]
    out = packed.new_zeros(*lead, h + 2 * r, wp + 2 * rw)
    out[..., r:r + h, rw:rw + wp] = packed
    return out


def _step_window_chunk(windows: torch.Tensor, rule, gens: int, planes: bool,
                       exterior=None):
    """Advance a batch of halo-extended windows ``gens`` generations
    locally: the (r·gens)-row vertical halos are consumed slab-style (2r
    rows per generation), and the horizontal DEAD-closure creep (r cells
    per generation into the halo word) is absorbed for r·gens <= 32.

    ``windows`` is ``(K, tr + 2·r·gens, tw + 2rw)`` (``(b, K, ...)`` with
    ``planes``). Returns ``(interiors, changed)``: the exact ``(..., K, tr,
    tw)`` interiors after ``gens`` generations and a ``(K,)`` bool that is
    True where the interior changed at ANY generation of the chunk, not
    only between its endpoints (a period-p oscillator with p | gens must
    still wake its neighbours).

    ``exterior`` (global DEAD): ``(row0, col0, ring, H, rw, Wp)``, the
    windows' origins (``(K,)`` tensors) in padded coordinates and the grid
    bounds. Window cells beyond the grid are permanently dead, but the free
    slab evolution would birth cells there and feed them back from the
    second in-slab generation on, so they are re-zeroed before each
    generation from the second. TORUS needs no mask: the ring holds real
    wrapped data."""
    r, rw = _rule_halo(rule)
    hr = r * gens
    step1 = _step_fns(rule, planes)[1]

    def interior(w, k):
        off = hr - k * r            # halo rows remaining per side
        return w[..., off:w.shape[-2] - off, rw:w.shape[-1] - rw]

    def zero_exterior(w, k):
        row0, col0, ring, h, rw_, wp = exterior
        rows = torch.arange(w.shape[-2], device=w.device)
        cols = torch.arange(w.shape[-1], device=w.device)
        # padded coordinates of window cell (row, col) after k shrinks
        grow = row0[:, None] + k * r + rows[None, :]
        gcol = col0[:, None] + cols[None, :]
        ext = (((grow < ring) | (grow >= ring + h))[:, :, None]
               | ((gcol < rw_) | (gcol >= rw_ + wp))[:, None, :])
        return w.masked_fill(ext, 0)

    prev = interior(windows, 0)
    changed = torch.zeros(windows.shape[-3], dtype=torch.bool,
                          device=windows.device)
    for k in range(1, gens + 1):
        if exterior is not None and k >= 2:
            # before the FIRST step the exterior is already zero (the ring
            # is never scattered into)
            windows = zero_exterior(windows, k - 1)
        windows = step1(windows)
        cur = interior(windows, k)
        diff = (cur != prev).flatten(-2).any(-1)
        changed |= diff.any(0) if planes else diff
        prev = cur
    return prev, changed


def auto_tile(H: int, Wp: int, max_map: int = MAX_MAP_ENTRIES) -> Tuple[int, int]:
    """Tile shape whose activity map stays <= ``max_map`` entries: the
    defaults for small grids, rows and words doubled alternately (keeping
    the grid divisible) until the map fits (65536² -> 128x16-word tiles,
    a 2^16-entry map)."""
    tr, tw = min(DEFAULT_TILE_ROWS, H), min(DEFAULT_TILE_WORDS, Wp)
    while tr > 1 and H % tr:
        tr -= 1
    while tw > 1 and Wp % tw:
        tw -= 1
    grow_rows = True
    while (H // tr) * (Wp // tw) > max_map:
        if grow_rows and H % (2 * tr) == 0 and 2 * tr <= H:
            tr *= 2
        elif Wp % (2 * tw) == 0 and 2 * tw <= Wp:
            tw *= 2
        elif H % (2 * tr) == 0 and 2 * tr <= H:
            tr *= 2
        else:
            break  # no divisible doubling left; keep the best we found
        grow_rows = not grow_rows
    return tr, tw


def _tile_grid_shape(H: int, Wp: int, tile_rows: int, tile_words: int) -> Tuple[int, int]:
    if H % tile_rows or Wp % tile_words:
        raise ValueError(
            f"packed grid ({H}, {Wp}) not divisible into ({tile_rows}, {tile_words}) tiles"
        )
    return H // tile_rows, Wp // tile_words


def tile_activity(packed: torch.Tensor, tile_rows: int, tile_words: int) -> torch.Tensor:
    """Per-tile any-live ``(nty, ntx)`` bool map of an UNPADDED packed grid
    (every plane of a stack counts)."""
    H, Wp = packed.shape[-2:]
    nty, ntx = _tile_grid_shape(H, Wp, tile_rows, tile_words)
    tiles = packed.reshape(-1, nty, tile_rows, ntx, tile_words)
    return (tiles != 0).any(dim=-1).any(dim=-2).any(dim=0)


def initial_activity(padded: torch.Tensor, tile_rows: int, tile_words: int,
                     r: int = 1, rw: int = 1) -> torch.Tensor:
    """All tiles containing any live cell are initially 'changed'."""
    return tile_activity(padded[..., r:-r, rw:-rw], tile_rows, tile_words)


def _dilate(active: torch.Tensor, wrap: bool = False, dy: int = 1,
            dx: int = 1) -> torch.Tensor:
    """(2dy+1)×(2dx+1) tile-neighbourhood OR over the last two dims (a
    leading dim is a stack of maps): which tiles must be stepped.
    ``wrap`` makes it toroidal (a glider crossing the seam finds its
    destination awake)."""
    a = active
    for _ in range(dy):
        if wrap:
            a = a | torch.roll(a, 1, -2) | torch.roll(a, -1, -2)
        else:
            b = a.clone()
            b[..., 1:, :] |= a[..., :-1, :]
            b[..., :-1, :] |= a[..., 1:, :]
            a = b
    for _ in range(dx):
        if wrap:
            a = a | torch.roll(a, 1, -1) | torch.roll(a, -1, -1)
        else:
            b = a.clone()
            b[..., 1:] |= a[..., :-1]
            b[..., :-1] |= a[..., 1:]
            a = b
    return a


def _refresh_ring(padded: torch.Tensor, r: int = 1, rw: int = 1) -> torch.Tensor:
    """Torus: write into the (r rows, rw words) ring the wrapped copies of
    the opposite interior edges, corners included (in place; returns
    ``padded``). O(r·(H + Wp)) words."""
    inter = padded[..., r:-r, rw:-rw]
    padded[..., :r, rw:-rw] = inter[..., -r:, :]
    padded[..., -r:, rw:-rw] = inter[..., :r, :]
    padded[..., r:-r, :rw] = inter[..., :, -rw:]
    padded[..., r:-r, -rw:] = inter[..., :, :rw]
    padded[..., :r, :rw] = inter[..., -r:, -rw:]
    padded[..., :r, -rw:] = inter[..., -r:, :rw]
    padded[..., -r:, :rw] = inter[..., :r, -rw:]
    padded[..., -r:, -rw:] = inter[..., :r, :rw]
    return padded


def _build_sparse_step(
    rule,
    shape: Tuple[int, ...],
    tile_rows: int,
    tile_words: int,
    capacity: int,
    topology: Topology = Topology.DEAD,
    gens: int = 1,
    ring_rows: int = 0,
):
    """The ``sparse_many(padded, active, n) -> (padded, active, done,
    syncs)`` runner for a configuration: up to ``n`` CHUNKS of ``gens``
    generations, stopping before the first chunk whose candidate set
    exceeds ``capacity`` (``done`` chunks ran; ``syncs`` host reads were
    made). ``padded`` is updated in place. ``ring_rows`` is the buffer's
    ring depth (>= r·gens; the engine sizes it once for its chunk depth,
    and the 1-generation remainder program gathers offset inside it)."""
    lead, (H, Wp) = shape[:-2], shape[-2:]
    if len(lead) > 1:
        raise ValueError(f"at most one leading plane axis, got shape {shape}")
    planes = bool(lead)
    nty, ntx = _tile_grid_shape(H, Wp, tile_rows, tile_words)
    wrap = topology is Topology.TORUS
    r, rw = _rule_halo(rule)
    hr = r * gens                       # this program's window halo rows
    ring = ring_rows or hr              # the buffer's ring depth
    off = ring - hr                     # window gather offset inside it
    dy, dx = _wake_dilation(rule, tile_rows, tile_words, gens)

    def sparse_gen(padded, idx):
        if wrap:
            _refresh_ring(padded, ring, rw)
        dev = padded.device
        tys, txs = idx // ntx, idx % ntx
        row0 = off + tys * tile_rows
        col0 = txs * tile_words
        rows = row0[:, None] + torch.arange(tile_rows + 2 * hr, device=dev)
        cols = col0[:, None] + torch.arange(tile_words + 2 * rw, device=dev)
        windows = padded[..., rows[:, :, None], cols[:, None, :]]
        exterior = None
        if not (wrap or gens == 1):
            # global DEAD: the window's beyond-the-grid cells stay dead
            exterior = (row0, col0, ring, H, rw, Wp)
        stepped, changed = _step_window_chunk(windows, rule, gens, planes,
                                              exterior)
        # one indexed write for every tile (distinct tiles: no overlap)
        rows = (tys * tile_rows + ring)[:, None] + torch.arange(tile_rows, device=dev)
        cols = (txs * tile_words + rw)[:, None] + torch.arange(tile_words, device=dev)
        padded[..., rows[:, :, None], cols[:, None, :]] = stepped
        active = torch.zeros(nty * ntx, dtype=torch.bool, device=dev)
        active[idx] = changed
        return active.view(nty, ntx)

    @steps_in_place
    def sparse_many(padded, active, n):
        for i in range(int(n)):
            cand = _dilate(active, wrap, dy=dy, dx=dx)
            with sanitizers.allow_host_transfers(
                    "the sparse step reads its candidate tiles back once "
                    "per chunk: the window count sizes the gather"):
                idx = torch.nonzero(cand.flatten()).squeeze(1)
            if idx.numel() > capacity:
                return padded, active, i, i + 1
            active = sparse_gen(padded, idx)
        return padded, active, int(n), int(n)

    return sparse_many


def _build_dense_once(
    rule,
    shape: Tuple[int, ...],
    tile_rows: int,
    tile_words: int,
    topology: Topology = Topology.DEAD,
    ring_rows: int = 0,
):
    """One full-grid generation (the overflow fallback), ``dense_once(padded)
    -> (padded, changed)`` with ``padded`` updated in place.
    ``ring_rows`` is the buffer's ring depth (>= the rule's r; this
    per-generation step reads the inner (r, rw) sub-ring of it)."""
    lead, (H, Wp) = shape[:-2], shape[-2:]
    nty, ntx = _tile_grid_shape(H, Wp, tile_rows, tile_words)
    wrap = topology is Topology.TORUS
    r, rw = _rule_halo(rule)
    ring = ring_rows or r

    @steps_in_place
    def dense_once(padded):
        if wrap:
            _refresh_ring(padded, ring, rw)
        old = padded[..., ring:-ring, rw:-rw]
        # step the interior against the ring (zero = DEAD boundary;
        # wrapped copies = torus), reading the inner (r, rw) sub-ring
        sub = padded[..., ring - r:padded.shape[-2] - (ring - r), :]
        new = _step_window(sub, rule)
        tiles_old = old.reshape(*lead, nty, tile_rows, ntx, tile_words)
        tiles_new = new.reshape(*lead, nty, tile_rows, ntx, tile_words)
        changed = (tiles_old != tiles_new).any(dim=-1).any(dim=-2)
        if lead:
            changed = changed.any(0)
        old.copy_(new)
        return padded, changed

    return dense_once


class SparseEngineState:
    """Holds (padded grid, activity map) on the grid's device and steps
    them. ``packed`` is an int32 ``(H, W/32)`` tensor, or a ``(b, H, W/32)``
    plane stack (Generations, multi-state LtL).

    ``capacity`` None is adaptive: start near the seeded activity and
    escalate on overflow up to 4096 tiles, then fall back to a dense
    generation; an explicit capacity is fixed, and each overflow runs one
    dense full-grid generation. ``chunk_gens`` (default 1) is the temporal
    chunk: windows carry (r·g)-row halos and advance g generations per
    gather. ``dispatches`` counts chunk runs and dense generations,
    ``syncs`` the host reads of device values in :meth:`step`."""

    def __init__(
        self,
        packed: torch.Tensor,
        rule,
        *,
        tile_rows: int | None = None,
        tile_words: int | None = None,
        capacity: int | None = None,
        topology: Topology = Topology.DEAD,
        chunk_gens: int | None = None,
    ):
        H, Wp = packed.shape[-2:]
        if tile_rows is None and tile_words is None:
            tile_rows, tile_words = auto_tile(H, Wp)
        tile_rows = tile_rows or DEFAULT_TILE_ROWS
        tile_words = tile_words or DEFAULT_TILE_WORDS
        _tile_grid_shape(H, Wp, tile_rows, tile_words)  # validate
        r0, _ = _rule_halo(rule)
        if chunk_gens is None:
            # the JAX package's default: temporal chunking stays off until
            # a measurement on the device says otherwise
            chunk_gens = 1
        if chunk_gens < 1 or chunk_gens * r0 > 32:
            raise ValueError(
                f"chunk_gens must satisfy 1 <= g and g*radius <= 32 (the "
                f"halo word bounds horizontal creep), got g={chunk_gens} "
                f"for radius {r0}")
        if chunk_gens * r0 > H:
            raise ValueError(
                f"chunk_gens={chunk_gens} needs a ring of {chunk_gens * r0} "
                f"rows > the grid's {H}; use a smaller chunk")
        self.chunk_gens = chunk_gens
        self._adaptive = capacity is None
        if isinstance(rule, LtLRule) and rule.states != 2 and packed.dim() != 3:
            raise ValueError(
                f"sparse multi-state LtL ({rule.notation}, "
                f"{rule.states} states) takes a (b, H, W/32) bit-plane "
                "stack, not a 2D bitboard — pack with "
                "ops.packed_generations.pack_generations_for")
        if _births_from_nothing(rule):
            raise ValueError(
                f"sparse backend cannot run birth-from-nothing rules "
                f"({rule.notation}): every quiescent region births cells "
                "each generation, so nothing ever sleeps — use the packed "
                "backend"
            )
        self.rule = rule
        self.tile_rows = tile_rows
        self.tile_words = tile_words
        self.topology = topology
        self.shape = tuple(packed.shape)
        self.dispatches = 0
        self.syncs = 0
        r, rw = _rule_halo(rule)
        self._halo = (r * chunk_gens, rw)   # (rows, words) ring depth
        ring, _ = self._halo
        self.padded = _pad_ring(packed, ring, rw)
        self.active = initial_activity(self.padded, tile_rows, tile_words,
                                       ring, rw)
        nty, ntx = _tile_grid_shape(H, Wp, tile_rows, tile_words)
        self._cap_ceiling = min(_MAX_ADAPTIVE_CAPACITY,
                                1 << (nty * ntx - 1).bit_length())
        if self._adaptive:
            # one dilation factor's worth of headroom over the seeded tiles
            # covers the first chunk; pow2, and never more windows than
            # tiles exist
            dy, dx = _wake_dilation(rule, tile_rows, tile_words, chunk_gens)
            factor = (2 * dy + 1) * (2 * dx + 1)
            with sanitizers.allow_host_transfers(
                    "the adaptive capacity starts from the seeded tile "
                    "count, read once at construction"):
                want = max(32, factor * int(self.active.sum()))
            capacity = min(1 << (want - 1).bit_length(), self._cap_ceiling)
        self._set_capacity(capacity)

    def _set_capacity(self, capacity: int) -> None:
        self.capacity = capacity
        ring, _ = self._halo
        self._sparse_many = _build_sparse_step(
            self.rule, self.shape, self.tile_rows, self.tile_words,
            capacity, self.topology, gens=self.chunk_gens, ring_rows=ring)
        # the n % chunk_gens remainder program: same buffer, 1-gen windows
        self._sparse_many_1 = self._sparse_many if self.chunk_gens == 1 \
            else _build_sparse_step(
                self.rule, self.shape, self.tile_rows, self.tile_words,
                capacity, self.topology, gens=1, ring_rows=ring)
        self._dense_once = _build_dense_once(
            self.rule, self.shape, self.tile_rows, self.tile_words,
            self.topology, ring_rows=ring)

    def step(self, n: int = 1) -> None:
        """Advance ``n`` generations: sparse CHUNKS (chunk_gens generations
        per gathered window; the n % chunk_gens remainder takes the
        1-generation program over the same ring buffer) until done or a
        capacity overflow. An adaptive capacity below its ceiling jumps to
        ``max(2·capacity, need)`` (rounded up to a power of 2) and retries
        (the state is untouched: the check runs before the over-capacity
        chunk); otherwise one dense full-grid generation runs and the
        sparse chunks resume. One host read per chunk (its candidate
        count), one per escalation."""
        g = self.chunk_gens
        remaining = int(n)
        while remaining > 0:
            chunks = remaining // g
            self.dispatches += 1
            if chunks:
                self.padded, self.active, done, syncs = self._sparse_many(
                    self.padded, self.active, chunks)
                self.syncs += syncs
                remaining -= done * g
                if done == chunks:
                    continue            # bulk complete; loop for remainder
            else:
                self.padded, self.active, done, syncs = self._sparse_many_1(
                    self.padded, self.active, remaining)
                self.syncs += syncs
                remaining -= done
                if remaining == 0:
                    return
            # overflow: the next chunk/generation exceeds capacity
            if self._adaptive and self.capacity < self._cap_ceiling:
                dy, dx = _wake_dilation(self.rule, self.tile_rows,
                                        self.tile_words,
                                        g if remaining >= g else 1)
                with sanitizers.allow_host_transfers(
                        "an overflow reads the candidate count once to "
                        "size the escalated capacity"):
                    need = int(_dilate(self.active,
                                       self.topology is Topology.TORUS,
                                       dy=dy, dx=dx).sum())
                self.syncs += 1
                want = max(2 * self.capacity, need)
                self._set_capacity(
                    min(1 << (want - 1).bit_length(), self._cap_ceiling))
                continue
            self.dispatches += 1
            self.padded, self.active = self._dense_once(self.padded)
            remaining -= 1

    def reseed(self, packed: torch.Tensor) -> "SparseEngineState":
        """A fresh state over ``packed`` with this state's configuration,
        including whether capacity is adaptive (Engine.set_grid's seam)."""
        return SparseEngineState(
            packed, self.rule,
            tile_rows=self.tile_rows, tile_words=self.tile_words,
            capacity=None if self._adaptive else self.capacity,
            topology=self.topology,
            chunk_gens=self.chunk_gens,
        )

    @property
    def packed(self) -> torch.Tensor:
        """The interior: a view of the padded buffer (a step writes it)."""
        r, rw = self._halo
        return self.padded[..., r:-r, rw:-rw]

    def active_tiles(self) -> int:
        return int(self.active.sum())


# -- the paged-memory face -----------------------------------------------------
#
# memory/ (the paged tile pool) drives page activation and retirement with
# the same changed-last-chunk machinery: one definition of a rule's halo
# depth, its packed layout and how far influence travels per chunk for
# both consumers.

rule_halo = _rule_halo
wake_dilation = _wake_dilation
births_from_nothing = _births_from_nothing


def rule_layout(rule) -> Tuple[int, int]:
    """``(planes, window_ndim)`` of a rule's packed layout: binary
    life-like families and 2-state LtL run 2D bitboards ``(1, 2)``;
    Generations and C >= 3 LtL run ``(b, H, W/32)`` bit-plane stacks
    ``(n_planes(states), 3)``."""
    if isinstance(rule, LtLRule):
        if rule.states == 2:
            return 1, 2
        return n_planes(rule.states), 3
    if isinstance(rule, GenRule):
        return n_planes(rule.states), 3
    return 1, 2


def dilate_coords(coords, dy: int = 1, dx: int = 1, *, bounds=None,
                  wrap: bool = False):
    """Host-side tile-coordinate dilation: every (ty, tx) within a
    (2dy+1) x (2dx+1) tile neighbourhood of the input set (:func:`_dilate`
    on a sparse coordinate set). ``bounds`` = (nty, ntx) clips
    out-of-range coords (DEAD) or wraps them with ``wrap`` (TORUS);
    ``bounds=None`` is the unbounded plane."""
    out = set()
    for ty, tx in coords:
        for oy in range(-dy, dy + 1):
            for ox in range(-dx, dx + 1):
                y, x = ty + oy, tx + ox
                if bounds is not None:
                    nty, ntx = bounds
                    if wrap:
                        y, x = y % nty, x % ntx
                    elif not (0 <= y < nty and 0 <= x < ntx):
                        continue
                out.add((y, x))
    return out
