"""Bit-packed Larger-than-Life: bit-sliced window sums, 32 cells per word,
in plain PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.packed_ltl``, operation for
operation. The grid stays a packed binary bitboard and the counts live in
*bit-sliced* form — q int32 planes holding bit q of every cell's count —
so one bitwise op advances 32 cells:

- the vertical (2r+1)-row window reuses the carry-save adder network of
  the 3x3 path (:func:`.packed.bit_sliced_sum`) over row-shifted planes;
- the horizontal window is a doubling tree of shifted adds, each "add" a
  plane-wise ripple adder over bit-sliced numbers and each "shift" a cell
  shift with cross-word bit carries;
- von Neumann (diamond) neighbourhoods are per-row separable: r+1
  shrinking sliding sums over pre-added ±d row pairs;
- the B/S interval tests are bit-sliced subtract-borrow comparators
  against the constant bounds.

Counts reach (2r+1)^2 <= 225 for r <= 7, so numbers stay within 8 planes.
Cell shifts honour the topology like the dense pad: TORUS wraps (word
rolls + bit carries), DEAD shifts in zeros. Rows are the second-to-last
axis and words the last, so a batch of slabs (the CUDA kernel's tiles, in
its plain version) steps at once. Planes are int32, so every right shift
is masked.

The C >= 3 family rides the Generations plane stack
(:mod:`.packed_generations`) with these window counts over the alive
plane: :func:`step_ltl_planes` and its slab/ext forms.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..models.ltl import LtLRule
from .packed import bit_sliced_sum
from .stencil import Topology

_WORD = 32


def _zero_cols(p: torch.Tensor, n: int, side: str) -> torch.Tensor:
    """Zero the first/last ``n`` whole word-columns (DEAD shift fill)."""
    p = p.clone()
    if side == "lo":
        p[..., :n] = 0
    else:
        p[..., p.shape[-1] - min(n, p.shape[-1]):] = 0
    return p


def _zero_rows(p: torch.Tensor, n: int, side: str) -> torch.Tensor:
    p = p.clone()
    if side == "lo":
        p[..., :n, :] = 0
    else:
        p[..., p.shape[-2] - min(n, p.shape[-2]):, :] = 0
    return p


def vshift(p: torch.Tensor, d: int, topology: Topology) -> torch.Tensor:
    """Plane whose row r holds the cells of row r - d (d may be negative)."""
    if d == 0:
        return p
    out = torch.roll(p, d, dims=-2)
    if topology is not Topology.TORUS:
        out = _zero_rows(out, abs(d), "lo" if d > 0 else "hi")
    return out


def hshift_west(p: torch.Tensor, d: int, topology: Topology) -> torch.Tensor:
    """Plane whose column c holds the cell at column c - d (d >= 0): the
    value ``d`` cells to the west, with cross-word bit carries."""
    q, s = divmod(d, _WORD)
    if q:
        p = torch.roll(p, q, dims=-1)
        if topology is not Topology.TORUS:
            p = _zero_cols(p, q, "lo")
    if s:
        left = torch.roll(p, 1, dims=-1)
        if topology is not Topology.TORUS:
            left = _zero_cols(left, 1, "lo")
        p = (p << s) | ((left >> (_WORD - s)) & ((1 << s) - 1))
    return p


def hshift_east(p: torch.Tensor, d: int, topology: Topology) -> torch.Tensor:
    """Plane whose column c holds the cell at column c + d (d >= 0)."""
    q, s = divmod(d, _WORD)
    if q:
        p = torch.roll(p, -q, dims=-1)
        if topology is not Topology.TORUS:
            p = _zero_cols(p, q, "hi")
    if s:
        right = torch.roll(p, -1, dims=-1)
        if topology is not Topology.TORUS:
            right = _zero_cols(right, 1, "hi")
        p = ((p >> s) & ((1 << (_WORD - s)) - 1)) | (right << (_WORD - s))
    return p


def bs_add(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Ripple add of two bit-sliced numbers (lists of planes, LSB first)."""
    zero = torch.zeros_like(a[0] if len(a) else b[0])
    n = max(len(a), len(b))
    out: List[torch.Tensor] = []
    carry = zero
    for i in range(n):
        x = a[i] if i < len(a) else zero
        y = b[i] if i < len(b) else zero
        s = x ^ y
        out.append(s ^ carry)
        carry = (x & y) | (s & carry)
    out.append(carry)
    return out


def bs_sub_bit(a: Sequence[torch.Tensor], bit: torch.Tensor) -> List[torch.Tensor]:
    """a - bit for a one-plane subtrahend; caller guarantees no underflow."""
    out = [a[0] ^ bit]
    borrow = ~a[0] & bit
    for i in range(1, len(a)):
        out.append(a[i] ^ borrow)
        borrow = ~a[i] & borrow
    return out


def bs_ge(a: Sequence[torch.Tensor], c: int) -> torch.Tensor:
    """Plane set where the bit-sliced number a >= the Python constant c."""
    if c <= 0:
        return ~torch.zeros_like(a[0])
    if c >= (1 << len(a)):
        return torch.zeros_like(a[0])
    borrow = torch.zeros_like(a[0])
    for i, p in enumerate(a):  # compute a - c; a >= c iff no final borrow
        if (c >> i) & 1:
            borrow = ~p | borrow
        else:
            borrow = ~p & borrow
    return ~borrow


def _one_sided_sum_bs(num: List[torch.Tensor], r: int, topology: Topology,
                      shift) -> List[torch.Tensor]:
    """sum_{d=1..r} shift(num, d): a doubling tree that only ever shifts in
    ONE direction, so DEAD topology stays exact: the zero fill of a shift
    always coincides with a genuinely beyond-edge (all-dead) contribution."""
    pows = {1: [shift(p, 1, topology) for p in num]}
    m = 1
    while 2 * m <= r:
        cur = pows[m]
        pows[2 * m] = bs_add(cur, [shift(p, m, topology) for p in cur])
        m *= 2
    acc = None
    offset = 0
    for p2 in sorted(pows, reverse=True):  # greedy binary decomposition of r
        while r - offset >= p2:
            piece = ([shift(pl, offset, topology) for pl in pows[p2]]
                     if offset else pows[p2])
            acc = piece if acc is None else bs_add(acc, piece)
            offset += p2
    return acc


def _sliding_sum_bs(num: List[torch.Tensor], k: int,
                    topology: Topology) -> List[torch.Tensor]:
    """Width-``k`` horizontal sliding sum of a bit-sliced number, centred:
    output(c) = sum_{d=-r..r} num(c+d) for k = 2r+1."""
    r = (k - 1) // 2
    if r == 0:
        return list(num)
    west = _one_sided_sum_bs(num, r, topology, hshift_west)
    east = _one_sided_sum_bs(num, r, topology, hshift_east)
    return bs_add(bs_add(west, east), num)


def box_counts_packed(p: torch.Tensor, radius: int, topology: Topology,
                      h_topo: "Topology | None" = None) -> List[torch.Tensor]:
    """Bit-sliced (2r+1)^2 box sums (centre included) of a packed plane.
    ``h_topo`` splits the horizontal closure off the vertical one (the
    slab form passes vertical DEAD + global horizontal); default equal."""
    k = 2 * radius + 1
    col = bit_sliced_sum([vshift(p, d, topology) for d in range(-radius, radius + 1)])
    return _sliding_sum_bs(col, k, topology if h_topo is None else h_topo)


def _add_mod(a: List[torch.Tensor], b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """a + b modulo 2^len(a), both bit-sliced (b may have fewer planes)."""
    out, carry = [], torch.zeros_like(a[0])
    for i, x in enumerate(a):
        y = b[i] if i < len(b) else torch.zeros_like(x)
        out.append(x ^ y ^ carry)
        carry = (x & y) | (carry & (x ^ y))
    return out


def _sub_mod(a: List[torch.Tensor], b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """a - b modulo 2^len(a), both bit-sliced (b may have fewer planes)."""
    out, borrow = [], torch.zeros_like(a[0])
    for i, x in enumerate(a):
        y = b[i] if i < len(b) else torch.zeros_like(x)
        out.append(x ^ y ^ borrow)
        borrow = (~x & (y | borrow)) | (y & borrow)
    return out


def box_counts_sliding(p: torch.Tensor, radius: int, segment: int,
                       topology: Topology = Topology.TORUS) -> List[torch.Tensor]:
    """The (2r+1)^2 box sums of :func:`box_counts_packed`, counted in the
    order of the LtL kernel (``csrc/life_ltl.cu``): each row's horizontal
    window once, as a carry-save sum of its 2r+1 shifted planes
    (bit_length(2r+1) planes), then down column segments of ``segment``
    rows a running count of exactly bit_length((2r+1)^2) planes, modulo
    2^planes: a segment starts from the sum of the 2r+1 windows around its
    first row, and each next row adds the entering row's window and
    subtracts the leaving one's, kept from 2r+1 rows before in a ring. Rows
    wrap under TORUS and are zero outside the grid under DEAD; ``topology``
    closes both axes. Returns the count planes, LSB first."""
    r, k = radius, 2 * radius + 1
    planes = (k * k).bit_length()
    H = p.shape[-2]
    win = bit_sliced_sum([p] + [hshift_west(p, d, topology) for d in range(1, r + 1)]
                         + [hshift_east(p, d, topology) for d in range(1, r + 1)])

    def window(y: int) -> List[torch.Tensor]:
        if topology is Topology.TORUS:
            y %= H
        elif not 0 <= y < H:
            return [torch.zeros_like(p[..., 0, :])]
        return [w[..., y, :] for w in win]

    counts = [torch.empty_like(p) for _ in range(planes)]
    for rs in range(0, H, segment):
        re = min(rs + segment, H)
        ring = [window(y) for y in range(rs - r, rs + r + 1)]
        cnt = [torch.zeros_like(p[..., 0, :]) for _ in range(planes)]
        for w in ring:
            cnt = _add_mod(cnt, w)
        for i, y in enumerate(range(rs, re)):
            for plane, c in zip(counts, cnt):
                plane[..., y, :] = c
            if y + 1 < re:   # row y+1+r enters, row y-r leaves: one ring slot
                entering = window(y + 1 + r)
                cnt = _sub_mod(_add_mod(cnt, entering), ring[i % k])
                ring[i % k] = entering
    return counts


def diamond_counts_packed(p: torch.Tensor, radius: int, v_topo: Topology,
                          h_topo: Topology) -> List[torch.Tensor]:
    """Bit-sliced von Neumann (diamond) sums: |dx| + |dy| <= radius.

    Per-row separable: the rows at vertical offsets ±d contribute a centred
    horizontal window of width 2·(radius-d)+1, so the whole sum is r+1
    shrinking sliding sums (the ±d row pair is pre-added into one 2-plane
    number so each width is swept once) accumulated with bit-sliced adds."""
    # counts never exceed the diamond's cell count, so planes past its bit
    # length are identically zero: truncate after every add
    nbits = (2 * radius * radius + 2 * radius + 1).bit_length()
    acc = None
    for d in range(radius + 1):
        if d == 0:
            planes: List[torch.Tensor] = [p]
        else:
            planes = bit_sliced_sum([vshift(p, -d, v_topo),
                                     vshift(p, d, v_topo)])
        term = _sliding_sum_bs(planes, 2 * (radius - d) + 1, h_topo)
        acc = term if acc is None else bs_add(acc, term)[:nbits]
    return acc


def neighborhood_counts_packed(p: torch.Tensor, rule: LtLRule, v_topo: Topology,
                               h_topo: Topology) -> List[torch.Tensor]:
    """The rule's neighbourhood sum in bit-sliced form, with independent
    vertical/horizontal closures."""
    if rule.neighborhood == "M":
        return box_counts_packed(p, rule.radius, v_topo, h_topo)
    return diamond_counts_packed(p, rule.radius, v_topo, h_topo)


def _in_any(counts: List[torch.Tensor], intervals, like: torch.Tensor) -> torch.Tensor:
    """OR-fold of the bit-sliced comparator pairs; an empty interval list
    (Golly allows e.g. an empty survival list) is 'never'."""
    hit = torch.zeros_like(like)
    for lo, hi in intervals:
        hit = hit | (bs_ge(counts, lo) & ~bs_ge(counts, hi + 1))
    return hit


def _apply_intervals(p: torch.Tensor, counts: List[torch.Tensor],
                     rule: LtLRule) -> torch.Tensor:
    """Next-generation plane from the alive plane + bit-sliced window
    counts; born/survive may be HROT interval lists."""
    if not rule.middle:
        counts = bs_sub_bit(counts, p)  # window sum >= p, no underflow
    born = ~p & _in_any(counts, rule.born_intervals, p)
    keep = p & _in_any(counts, rule.survive_intervals, p)
    return born | keep


def _require_binary(rule: LtLRule) -> None:
    """The packed layout is one bit per cell: multi-state (C >= 3) LtL
    takes the plane stack (:func:`step_ltl_planes`) or the byte path."""
    if rule.states != 2:
        raise ValueError(
            f"the packed LtL path is binary (1 bit/cell); {rule.notation} "
            f"has {rule.states} states — use backend='dense'")


def step_ltl_packed(p: torch.Tensor, rule: LtLRule, topology: Topology) -> torch.Tensor:
    """One generation on a (H, W/32) packed binary grid (box or diamond)."""
    _require_binary(rule)
    return _apply_intervals(
        p, neighborhood_counts_packed(p, rule, topology, topology), rule)


def step_ltl_packed_slab(slab: torch.Tensor, rule: LtLRule,
                         topology: Topology) -> torch.Tensor:
    """(..., L, Wp) slab -> (..., L - 2r, Wp): one generation with vertical
    DEAD closure (the outer r rows are halo, consumed and cropped — the
    radius-r face of :func:`.packed.step_packed_slab`) and horizontal
    closure ``topology`` across the slab's own width."""
    _require_binary(rule)
    r = rule.radius
    counts = neighborhood_counts_packed(slab, rule, Topology.DEAD, topology)
    return _apply_intervals(slab[..., r:-r, :],
                            [c[..., r:-r, :] for c in counts], rule)


def step_ltl_packed_ext(ext: torch.Tensor, rule: LtLRule) -> torch.Tensor:
    """One generation from a halo-extended packed tile -> (h, wp) interior.

    ``ext`` is (..., h + 2r, wp + 2): r halo *rows* top/bottom and one halo
    *word* (32 >= r cells) left/right, materialised by the caller (leading
    dimensions are a batch). Counts
    use DEAD closure on the tile — every interior cell's neighbourhood
    lies inside it."""
    _require_binary(rule)
    r = rule.radius
    counts = [c[..., r:-r, 1:-1] for c in neighborhood_counts_packed(
        ext, rule, Topology.DEAD, Topology.DEAD)]
    return _apply_intervals(ext[..., r:-r, 1:-1], counts, rule)


def multi_step_ltl_packed(
    p: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations of :func:`step_ltl_packed`."""
    for _ in range(int(n)):
        p = step_ltl_packed(p, rule, topology)
    return p


# ---------------------------------------------------------------------------
# multi-state (C >= 3) LtL on a bit-plane stack: the Generations decay
# state machine (packed_generations.transition_planes) driven by the
# radius-r bit-sliced window counts of the ALIVE plane — the dense byte
# path's multi-state branch (ops/ltl.py step_ltl_ext), bit-sliced.
# ---------------------------------------------------------------------------


def _interval_masks(alive, counts, rule: LtLRule):
    """Raw (born_p, keep_p) predicate planes over the bit-sliced window
    counts; masking to dead/alive cells happens inside transition_planes."""
    if not rule.middle:
        counts = bs_sub_bit(counts, alive)
    return (_in_any(counts, rule.born_intervals, alive),
            _in_any(counts, rule.survive_intervals, alive))


def _require_multistate(rule: LtLRule) -> None:
    if rule.states < 3:
        raise ValueError(
            f"the plane-stack LtL path serves C >= 3 decay rules; "
            f"{rule.notation} is binary — use the 1-bit packed path "
            "(step_ltl_packed)")


def step_ltl_planes(plist, rule: LtLRule, topology: Topology):
    """One generation on a tuple of b (H, W/32) state planes (the
    Generations plane encoding with this rule): only state 1 excites, so
    the window counts run over the alive plane; decay rides
    transition_planes."""
    from .packed_generations import _alive_of, transition_planes

    _require_multistate(rule)
    alive = _alive_of(plist)
    counts = neighborhood_counts_packed(alive, rule, topology, topology)
    born_p, keep_p = _interval_masks(alive, counts, rule)
    return transition_planes(plist, alive, born_p, keep_p, rule.states)


def step_ltl_planes_slab(plist, rule: LtLRule, topology: Topology):
    """b (..., L, Wp) planes -> b (..., L - 2r, Wp): one generation of a
    multi-state slab (vertical DEAD closure consuming r halo rows per
    side, horizontal closure ``topology`` across the slab's own width)."""
    from .packed_generations import _alive_of, transition_planes

    _require_multistate(rule)
    r = rule.radius
    alive = _alive_of(plist)
    counts = [c[..., r:-r, :] for c in neighborhood_counts_packed(
        alive, rule, Topology.DEAD, topology)]
    interior = tuple(p[..., r:-r, :] for p in plist)
    born_p, keep_p = _interval_masks(alive[..., r:-r, :], counts, rule)
    return transition_planes(interior, alive[..., r:-r, :], born_p, keep_p,
                             rule.states)


def step_ltl_planes_ext(ext_list, rule: LtLRule):
    """One generation from b halo-extended (..., h + 2r, wp + 2) planes ->
    interior (..., h, wp) plane tuple — r halo rows and one halo word per side,
    same contract as :func:`step_ltl_packed_ext`."""
    from .packed_generations import _alive_of, transition_planes

    _require_multistate(rule)
    r = rule.radius
    alive_ext = _alive_of(ext_list)
    counts = [c[..., r:-r, 1:-1] for c in neighborhood_counts_packed(
        alive_ext, rule, Topology.DEAD, Topology.DEAD)]
    interior = tuple(p[..., r:-r, 1:-1] for p in ext_list)
    born_p, keep_p = _interval_masks(alive_ext[..., r:-r, 1:-1], counts, rule)
    return transition_planes(interior, alive_ext[..., r:-r, 1:-1], born_p,
                             keep_p, rule.states)


def multi_step_ltl_planes(
    planes: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations on a (b, H, W/32) plane stack."""
    plist = tuple(planes[i] for i in range(planes.shape[0]))
    for _ in range(int(n)):
        plist = step_ltl_planes(plist, rule, topology)
    return torch.stack(plist)
