"""Bit-parallel (SWAR) Game-of-Life step on 32-cells-per-word grids, in
plain PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.packed``, operation for
operation. Each row's horizontal 2-bit sums (``T = w+c+e``, ``S = w+e``)
are computed once and the neighbor count assembled as ``T_north + S +
T_south``; the B/S rule is then a boolean function of the 4 count
bit-planes. It is the ``backend="packed"`` path and the arithmetic the CUDA
kernel in :mod:`.cuda_stencil` runs per word.

Words are int32 (see :mod:`.bitpack`): every right shift is masked, since
int32 ``>>`` is arithmetic.

Two entry points, as in the reference:

- :func:`step_packed` — whole-grid step with TORUS or DEAD boundary.
- :func:`step_packed_ext` — step on a halo-extended ``(h+2, wp+2)`` tile
  (or a batch of them) with no boundary logic.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..models.rules import Rule
from .stencil import Topology

_TOP_BIT = 31  # bit index holding the highest column of a word
_LOW31 = 0x7FFFFFFF  # clears the sign bits an arithmetic >> 1 drags in


def _csa(a, b, c):
    """Carry-save full adder on bit-planes: returns (sum, carry)."""
    s = a ^ b
    return s ^ c, (a & b) | (c & s)


def bit_sliced_sum(planes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum N one-bit planes into LSB-first count bit-planes (CSA network)."""
    level = list(planes)
    out: List[torch.Tensor] = []
    while level:
        carries: List[torch.Tensor] = []
        while len(level) >= 3:
            s, c = _csa(level.pop(), level.pop(), level.pop())
            level.append(s)
            carries.append(c)
        if len(level) == 2:
            a, b = level.pop(), level.pop()
            level.append(a ^ b)
            carries.append(a & b)
        out.append(level[0])
        level = carries
    return out


def _count_eq(bits: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Plane that is all-ones where the bit-sliced count equals ``n``."""
    acc = None
    for k, b in enumerate(bits):
        term = b if (n >> k) & 1 else ~b
        acc = term if acc is None else acc & term
    return acc


def apply_rule_planes(alive: torch.Tensor, bits: Sequence[torch.Tensor],
                      rule: Rule) -> torch.Tensor:
    """Next-generation plane from the alive plane + count bit-planes.
    Counts shared between the born and survive sets are materialised once."""
    eq = {n: _count_eq(bits, n) for n in set(rule.born) | set(rule.survive)}
    zero = torch.zeros_like(alive)
    born = zero
    for n in sorted(rule.born):
        born = born | eq[n]
    keep = zero
    for n in sorted(rule.survive):
        keep = keep | eq[n]
    return (alive & keep) | (~alive & born)


def _shift_west(p: torch.Tensor, left_word: torch.Tensor) -> torch.Tensor:
    """Plane of west neighbors: bit i <- bit i-1, borrowing bit 31 of the
    word to the left (``left_word``) at each word boundary."""
    return (p << 1) | ((left_word >> _TOP_BIT) & 1)


def _shift_east(p: torch.Tensor, right_word: torch.Tensor) -> torch.Tensor:
    """Plane of east neighbors: bit i <- bit i+1, borrowing bit 0 of the
    word to the right."""
    return ((p >> 1) & _LOW31) | (right_word << _TOP_BIT)


def _row_triplet(p: torch.Tensor, topology: Topology
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(north, self, south) row-aligned views of the packed grid."""
    if topology is Topology.DEAD:
        zero_row = torch.zeros_like(p[:1])
        north = torch.cat([zero_row, p[:-1]], dim=0)
        south = torch.cat([p[1:], zero_row], dim=0)
        return north, p, south
    return torch.roll(p, 1, dims=0), p, torch.roll(p, -1, dims=0)


def horizontal_planes(slab: torch.Tensor, topology: Topology
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(west, center, east) planes along the packed LAST axis, with
    cross-word carries; word columns wrap for TORUS and see zeros for DEAD
    (a roll plus an edge-column mask, as in the reference)."""
    left = torch.roll(slab, 1, dims=-1)
    right = torch.roll(slab, -1, dims=-1)
    if topology is not Topology.TORUS:
        left[..., 0] = 0
        right[..., -1] = 0
    return _shift_west(slab, left), slab, _shift_east(slab, right)


def neighbor_planes(p: torch.Tensor, topology: Topology) -> List[torch.Tensor]:
    """The 8 Moore-neighbor indicator planes of a packed grid (reference
    formulation; the steppers use :func:`_row_sum_bits`)."""
    planes: List[torch.Tensor] = []
    for dv, slab in zip((-1, 0, 1), _row_triplet(p, topology)):
        w, c, e = horizontal_planes(slab, topology)
        planes.extend([w, e] if dv == 0 else [w, c, e])
    return planes


def _row_sum_bits(w, c, e, north_south, center_rows):
    """Neighbor-count bit-planes via shared per-row horizontal sums:
    ``T = w + c + e`` and ``S = w + e`` once per row, then the three 2-bit
    numbers ``T_north + S + T_south`` into 4 LSB-first count planes.

    ``north_south(plane) -> (north_view, south_view)`` supplies the
    vertical alignment; ``center_rows(plane)`` selects the center-row
    window of a full-height plane."""
    t0, t1 = _csa(w, c, e)               # T = w + c + e in 2 bits
    s0, s1 = w ^ e, w & e                # S = w + e
    tn0, ts0 = north_south(t0)
    tn1, ts1 = north_south(t1)
    s0, s1 = center_rows(s0), center_rows(s1)
    r0, k1 = _csa(tn0, s0, ts0)
    s, k2 = _csa(tn1, s1, ts1)
    r1 = s ^ k1
    k2b = s & k1
    return [r0, r1, k2 ^ k2b, k2 & k2b]


def count_bits(p: torch.Tensor, topology: Topology) -> List[torch.Tensor]:
    """Moore-neighbor count of a packed plane as 4 LSB-first bit-planes."""
    def north_south(plane):
        n, _, s = _row_triplet(plane, topology)
        return n, s

    w, c, e = horizontal_planes(p, topology)
    return _row_sum_bits(w, c, e, north_south, lambda plane: plane)


def count_bits_ext(ext: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(interior alive plane, count bit-planes) from a halo-extended
    (..., h+2, wp+2) plane (leading dimensions are a batch)."""
    h = ext.shape[-2] - 2
    mid = ext[..., 1:-1]
    w = _shift_west(mid, ext[..., :-2])
    e = _shift_east(mid, ext[..., 2:])
    bits = _row_sum_bits(
        w, mid, e,
        lambda plane: (plane[..., :h, :], plane[..., 2:h + 2, :]),
        lambda plane: plane[..., 1:h + 1, :])
    return mid[..., 1:h + 1, :], bits


def step_packed(p: torch.Tensor, *, rule: Rule,
                topology: Topology = Topology.TORUS) -> torch.Tensor:
    """One generation on a (H, W/32) int32 packed grid."""
    return apply_rule_planes(p, count_bits(p, topology), rule)


def multi_step_packed(
    p: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations of :func:`step_packed`."""
    for _ in range(int(n)):
        p = step_packed(p, rule=rule, topology=topology)
    return p


def step_packed_slab(slab: torch.Tensor, rule: Rule, topology: Topology) -> torch.Tensor:
    """One generation for the interior rows of a (..., L, Wp) slab ->
    (..., L-2, Wp).

    Rows shrink (vertical halos consumed); columns use ``topology`` across
    the slab's own width. Rows are the second-to-last axis, so a batch of
    slabs (the CUDA kernel's tiles, in its plain version) steps at once."""
    h = slab.shape[-2] - 2
    w, c, e = horizontal_planes(slab, topology)
    bits = _row_sum_bits(
        w, c, e,
        lambda plane: (plane[..., 0:h, :], plane[..., 2:h + 2, :]),
        lambda plane: plane[..., 1:h + 1, :])
    return apply_rule_planes(slab[..., 1:h + 1, :], bits, rule)


def neighbor_planes_ext(ext: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(alive, 8 neighbor planes) from a halo-extended (h+2, wp+2) tile
    (reference formulation, like :func:`neighbor_planes`)."""
    h = ext.shape[0] - 2
    planes: List[torch.Tensor] = []
    center = None
    for dv in (0, 1, 2):
        slab = ext[dv:dv + h, :]
        left = slab[:, :-2]
        mid = slab[:, 1:-1]
        right = slab[:, 2:]
        w = _shift_west(mid, left)
        e = _shift_east(mid, right)
        if dv == 1:
            center = mid
            planes.extend([w, e])
        else:
            planes.extend([w, mid, e])
    return center, planes


def step_packed_ext(ext: torch.Tensor, rule: Rule) -> torch.Tensor:
    """One generation on a halo-extended (..., h+2, wp+2) tile; returns the
    (..., h, wp) interior."""
    alive, bits = count_bits_ext(ext)
    return apply_rule_planes(alive, bits, rule)
