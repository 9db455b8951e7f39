"""Larger-than-Life dense stepper: log-tree sliding-window sums, in plain
PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.ltl``. A radius-r box count
is a separable (2r+1)-wide window sum per axis, built as a doubling tree
of shifted partial sums (~2·log2(k) adds per axis, exact in int32); the
von Neumann diamond is one prefix sum along the rows and 2r+1 two-slice
differences. One byte per cell; the ``_ext`` variant consumes a
(h+2r, w+2r) tile with its halos already materialised.
"""

from __future__ import annotations

import torch

from ..models.ltl import LtLRule
from .stencil import Topology


def _pad(state: torch.Tensor, r: int, topology: Topology) -> torch.Tensor:
    """``r`` rings of boundary cells around an (H, W) grid: wrapped copies
    for TORUS (by modulo indexing, so exact for grids narrower than
    ``r``), zeros for DEAD."""
    if topology is Topology.TORUS:
        h, w = state.shape
        dev = state.device
        rows = torch.arange(-r, h + r, device=dev) % h
        cols = torch.arange(-r, w + r, device=dev) % w
        return state[rows[:, None], cols[None, :]]
    return torch.nn.functional.pad(state, (r, r, r, r))


def sliding_sum(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Width-``k`` sliding window sum along ``axis`` (VALID: output length
    ``x.shape[axis] - k + 1``) via a doubling tree of shifted adds.

    Builds power-of-two window sums s_{2m}[i] = s_m[i] + s_m[i+m], then
    composes k from its binary expansion — ~2·log2(k) adds total instead
    of k-1, every operand a slice of the same array."""
    n = x.shape[axis]
    if not 1 <= k <= n:
        raise ValueError(f"window {k} outside [1, {n}]")
    pows = {1: x}
    m = 1
    while 2 * m <= k:
        s = pows[m]
        length = s.shape[axis] - m
        pows[2 * m] = s.narrow(axis, 0, length) + s.narrow(axis, m, length)
        m *= 2
    out_len = n - k + 1
    acc = None
    offset = 0
    for p in sorted(pows, reverse=True):  # greedy binary decomposition of k
        while k - offset >= p:
            piece = pows[p].narrow(axis, offset, out_len)
            acc = piece if acc is None else acc + piece
            offset += p
    return acc


def box_sums_ext(ext: torch.Tensor, radius: int) -> torch.Tensor:
    """(h+2r, w+2r) {0,1} tile -> (h, w) int32 window sums (centre
    included): two separable log-tree passes."""
    k = 2 * radius + 1
    x = ext.to(torch.int32)
    return sliding_sum(sliding_sum(x, k, axis=0), k, axis=1)


def diamond_sums_ext(ext: torch.Tensor, radius: int) -> torch.Tensor:
    """(h+2r, w+2r) {0,1} tile -> (h, w) int32 von Neumann (|dx|+|dy| <= r)
    window sums, centre included.

    Per row the diamond is an interval whose half-width a = r - |dv| varies
    with the row offset, so one int32 prefix sum along the rows turns
    every row's contribution into a two-slice difference, and the vertical
    assembly is 2r+1 adds."""
    r = radius
    h, w = ext.shape[0] - 2 * r, ext.shape[1] - 2 * r
    pref = torch.nn.functional.pad(
        torch.cumsum(ext.to(torch.int32), dim=1, dtype=torch.int32), (1, 0))
    total = None
    for dv in range(-r, r + 1):
        a = r - abs(dv)
        rows = pref[r + dv:r + dv + h]
        # interior column j maps to ext column j+r; the width-(2a+1)
        # interval [j+r-a, j+r+a] is pref[j+r+a+1] - pref[j+r-a]
        s = rows[:, r + a + 1:r + a + 1 + w] - rows[:, r - a:r - a + w]
        total = s if total is None else total + s
    return total


def step_ltl_ext(ext: torch.Tensor, rule: LtLRule) -> torch.Tensor:
    """One generation from a halo-extended (h+2r, w+2r) uint8 tile.

    ``states == 2``: the classic binary family, window sums straight over
    the 0/1 grid. ``states >= 3`` (Golly's C parameter): only state 1
    excites, births land on dead (0) cells only, and an alive cell
    failing its survival interval decays through 2..states-1 before dying
    — the Generations select applied to LtL window counts."""
    r = rule.radius
    state = ext[r:-r, r:-r]
    multistate = rule.states > 2
    src = (ext == 1).to(torch.uint8) if multistate else ext
    sums = (box_sums_ext(src, r) if rule.neighborhood == "M"
            else diamond_sums_ext(src, r))
    is_alive = state == 1
    count = sums - (0 if rule.middle else is_alive.to(torch.int32))

    def in_any(intervals):
        hit = torch.zeros_like(state, dtype=torch.bool)
        for lo, hi in intervals:
            hit = hit | ((count >= lo) & (count <= hi))
        # an empty interval list (Golly allows e.g. empty survival) = never
        return hit

    born = (state == 0) & in_any(rule.born_intervals)
    keep = is_alive & in_any(rule.survive_intervals)
    if not multistate:
        return (born | keep).to(torch.uint8)
    from .generations import decay_select

    return decay_select(state, born, keep, rule.states)


def step_ltl(state: torch.Tensor, *, rule: LtLRule,
             topology: Topology = Topology.TORUS) -> torch.Tensor:
    """One generation on an unpacked (H, W) uint8 grid."""
    return step_ltl_ext(_pad(state, rule.radius, topology), rule)


def multi_step_ltl(
    state: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations of :func:`step_ltl`."""
    for _ in range(int(n)):
        state = step_ltl(state, rule=rule, topology=topology)
    return state
