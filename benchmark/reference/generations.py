"""The plain reference for Generations rules: many states, one byte a cell.

A Generations rule (Golly Help, "Generations") has the states 0..C-1.
Only state 1 counts as a neighbour, over the configuration's Moore box
(the eight neighbours at radius 1). A 0 whose count lies in one of the
birth intervals becomes 1. A 1 whose count lies in one of the survival
intervals stays 1; any other 1 goes to 2, or to 0 where C = 2. A state of
2 or more goes to (s + 1) mod C. On the torus the grid wraps; without it
the cells beyond the edges are dead.

So a generation is the life-like rule of :mod:`.box_rule` applied to the
plane of 1s, which gives, of the cells now 0 or 1, those that are 1
next; every other cell that is not 0 ages by one, mod C.

The layout read and written is the configuration's: for C = 2 one plane of
packed words ``(..., H, W/32)``; for more states a stack of b =
ceil(log2 C) bit-planes ``(..., b, H, W/32)``, plane i holding bit i of
each cell's state, the least significant first, each plane packed as
:mod:`.box_rule` packs (cell (r, 32j+i) in bit i of word (r, j)). A run
decodes the planes to a byte a cell, steps the bytes and encodes them
again. Written from the rule alone, in plain PyTorch; it imports nothing
of the program. :func:`stepper`, :func:`encode` and :func:`planes` are
what :class:`..check.Reference` asks of a reference.
"""

from __future__ import annotations

import torch

from . import box_rule
from .box_rule import BoxRule, pack_cells, unpack_words


def states_of(config: dict) -> int:
    """C, the number of states, from a configuration file."""
    states = int(config["states"])
    if not 2 <= states <= 256:
        raise ValueError(f"a Generations rule has 2 to 256 states, not "
                         f"{states}")
    return states


def planes(config: dict) -> int:
    """b: 1 for C = 2 (one plane of words), else ceil(log2 C)."""
    return max(1, (states_of(config) - 1).bit_length())


def encode_planes(cells: torch.Tensor, b: int) -> torch.Tensor:
    """``(..., H, W)`` uint8 states -> one plane of words (b = 1) or the
    ``(..., b, H, W/32)`` stack, the least significant plane first."""
    if b == 1:
        return pack_cells(cells)
    return torch.stack([pack_cells((cells >> i) & 1) for i in range(b)],
                       dim=-3)


def decode(state: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse of :func:`encode_planes`: ``(..., H, W)`` uint8 states."""
    if b == 1:
        return unpack_words(state)
    cells = unpack_words(state.select(-3, 0))
    for i in range(1, b):
        cells |= unpack_words(state.select(-3, i)) << i
    return cells


def encode(cells: torch.Tensor, config: dict) -> torch.Tensor:
    """``(..., H, W)`` uint8 states in the configuration's layout."""
    return encode_planes(cells, planes(config))


def step(cells: torch.Tensor, rule: BoxRule, states: int, *,
         torus: bool = True) -> torch.Tensor:
    """One generation of ``(..., H, W)`` uint8 states."""
    one = cells == 1
    nxt_one = box_rule.step(one.view(torch.uint8), rule,
                            torus=torus).view(torch.bool)
    out = cells + 1
    out.masked_fill_((cells == 0) | (cells == states - 1), 0)
    return out.masked_fill_(nxt_one & (cells <= 1), 1)


def run(cells: torch.Tensor, rule: BoxRule, states: int, gens: int, *,
        torus: bool = True) -> torch.Tensor:
    """``gens`` generations of :func:`step`."""
    for _ in range(gens):
        cells = step(cells, rule, states, torus=torus)
    return cells


def stepper(config: dict):
    """``run(state, gens, torus=True)`` of the configuration's layout
    under its rule."""
    rule = BoxRule.from_config(config)
    states, b = states_of(config), planes(config)

    def run_planes(state: torch.Tensor, gens: int,
                   torus: bool = True) -> torch.Tensor:
        return encode_planes(run(decode(state, b), rule, states, gens,
                                 torus=torus), b)
    return run_planes
