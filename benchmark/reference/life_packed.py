"""The plain reference for life-like rules (radius 1, births and survivals
by the count of the eight neighbours): whole words of 32 cells at once.

Each generation builds the eight neighbour planes of a grid of 32-bit
words (cell (r, 32j+i) is bit i of word (r, j); :mod:`.box_rule` unpacks
the same layout), adds them bit-sliced into a four-bit count, and applies
the rule by testing the count for each birth and survival count. The
torus wraps rows and words; without it the cells beyond the edges are
dead. Written from the rule alone, in plain PyTorch; it imports nothing
of the program. :func:`stepper`, :func:`encode` and :func:`planes` are
what :class:`..check.Reference` asks of a reference.
"""

from __future__ import annotations

from typing import FrozenSet, List, Tuple

import torch

from .box_rule import pack_cells

LOW31 = 0x7FFFFFFF


def counts_of(config: dict) -> Tuple[FrozenSet[int], FrozenSet[int]]:
    """The birth and survival counts of a radius-1 rule without the
    centre, from a configuration file."""
    hood = config["neighbourhood"]
    if hood["radius"] != 1 or hood["include_center"]:
        raise ValueError("life_packed steps radius-1 rules of the eight "
                         "neighbours only")
    return tuple(frozenset(c for lo, hi in config[key]
                           for c in range(lo, hi + 1))
                 for key in ("born", "survive"))


def _roll(x: torch.Tensor, shift: int, dim: int, torus: bool) -> torch.Tensor:
    """``x`` moved ``shift`` (+1 or -1) along ``dim``: wrapped round, or
    with a zero row or word coming in."""
    out = torch.roll(x, shift, dims=dim)
    if not torus:
        out.narrow(dim, 0 if shift > 0 else x.shape[dim] - 1, 1).zero_()
    return out


def _shift_in(x: torch.Tensor, torus: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The planes of each cell's west and east neighbour in its row."""
    prev = _roll(x, 1, -1, torus)       # word j - 1
    nxt = _roll(x, -1, -1, torus)       # word j + 1
    west = (x << 1) | ((prev >> 31) & 1)
    east = ((x >> 1) & LOW31) | (nxt << 31)
    return west, east


def _add(planes: List[torch.Tensor], bit: torch.Tensor) -> List[torch.Tensor]:
    """The bit-sliced number ``planes`` (low bit first) plus a one-bit
    plane; a count of eight neighbours needs four bits at most."""
    out, carry = [], bit
    for p in planes:
        out.append(p ^ carry)
        carry = p & carry
    if len(out) < 4:
        out.append(carry)
    return out


def step(x: torch.Tensor, born: FrozenSet[int], survive: FrozenSet[int],
         torus: bool = True) -> torch.Tensor:
    """One generation of ``(..., H, W/32)`` int32 words."""
    west, east = _shift_in(x, torus)
    neighbours = [west, east]
    for dy in (1, -1):
        for plane in (west, x, east):
            neighbours.append(_roll(plane, dy, -2, torus))
    count = neighbours[:1]
    for plane in neighbours[1:]:
        count = _add(count, plane)
    ones = torch.full_like(x, -1)
    alive = torch.zeros_like(x)
    for n in sorted(born | survive):
        eq = ones
        for i, bit in enumerate(count):
            eq = eq & (bit if (n >> i) & 1 else ~bit)
        if n in born and n in survive:
            alive = alive | eq
        elif n in born:
            alive = alive | (eq & ~x)
        else:
            alive = alive | (eq & x)
    return alive


def run(x: torch.Tensor, born: FrozenSet[int], survive: FrozenSet[int],
        gens: int, torus: bool = True) -> torch.Tensor:
    for _ in range(gens):
        x = step(x, born, survive, torus)
    return x


def stepper(config: dict):
    """``run(words, gens, torus=True)`` under the configuration's rule."""
    born, survive = counts_of(config)
    return lambda words, gens, torus=True: run(words, born, survive, gens,
                                               torus)


def encode(cells: torch.Tensor, config: dict) -> torch.Tensor:
    """``(..., H, W)`` 0/1 cells as ``(..., H, W/32)`` words."""
    return pack_cells(cells)


def planes(config: dict) -> int:
    """One plane of words."""
    return 1
