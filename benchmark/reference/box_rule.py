"""The plain reference: outer-totalistic rules on a Moore box, one byte a cell.

A generation counts, for every cell, the live cells in the (2r+1) x (2r+1)
box around it, itself included, then applies the rule: a dead cell is
born where the count lies in one of the birth intervals, a live cell
survives where it lies in one of the survival intervals. Bosco's Rule is
radius 5 with the centre, births 34..45, survival 34..58; a rule that
leaves the centre out (Conway's Life: radius 1, B3/S23) survives on the
box count less one, so its survival intervals move up by one here.

This module is written from the rules alone, in plain PyTorch on unpacked
cells, and imports nothing of the program under test. Box sums are sums of
consecutive cells along one axis and then the other, each built from
doubling partial sums; counts stay below 256, so ``uint8`` holds them.

The packed layout that the program's outputs are read in, a row of 32
cells per 32-bit word with cell (r, 32j+i) in bit i of word (r, j), is
unpacked and packed here too (:func:`unpack_words`, :func:`pack_cells`),
so that the comparison needs nothing of the program. :func:`stepper`,
:func:`encode` and :func:`planes` are what :class:`..check.Reference`
asks of a reference: the bytes are unpacked from that layout, stepped,
and packed again.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

WORD = 32


@dataclasses.dataclass(frozen=True)
class BoxRule:
    """A rule as a configuration file states it."""

    radius: int
    born: Tuple[Tuple[int, int], ...]       # inclusive intervals of the
    survive: Tuple[Tuple[int, int], ...]    # box count, the cell included

    @classmethod
    def from_config(cls, config: dict) -> "BoxRule":
        hood = config["neighbourhood"]
        if hood["shape"] != "moore":
            raise ValueError(f"the reference steps Moore boxes, not "
                             f"{hood['shape']!r}")
        self_count = 0 if hood["include_center"] else 1
        return cls(radius=int(hood["radius"]),
                   born=tuple((int(a), int(b)) for a, b in config["born"]),
                   survive=tuple((int(a) + self_count, int(b) + self_count)
                                 for a, b in config["survive"]))


def window_sums(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sums of ``k`` consecutive entries along ``dim``: the output is
    ``k - 1`` shorter there. Built from sums of 1, 2, 4, ... entries."""
    pows = {1: x}
    size = 1
    while 2 * size <= k:
        p = pows[size]
        n = p.shape[dim] - size
        pows[2 * size] = p.narrow(dim, 0, n) + p.narrow(dim, size, n)
        size *= 2
    out_len = x.shape[dim] - k + 1
    terms = []
    offset = 0
    for s in sorted(pows, reverse=True):
        while k - offset >= s:
            terms.append(pows[s].narrow(dim, offset, out_len))
            offset += s
    if len(terms) == 1:
        return terms[0]
    out = terms[0] + terms[1]
    for term in terms[2:]:
        out += term
    return out


def _in_intervals(count: torch.Tensor,
                  intervals: Sequence[Tuple[int, int]]) -> torch.Tensor:
    hit = None
    for lo, hi in intervals:
        inside = (count >= lo) & (count <= hi)
        hit = inside if hit is None else hit | inside
    if hit is None:
        return torch.zeros(count.shape, dtype=torch.bool, device=count.device)
    return hit


def _apply(center: torch.Tensor, box: torch.Tensor, rule: BoxRule) -> torch.Tensor:
    alive = center.view(torch.bool)     # cells are 0 or 1
    return torch.where(alive, _in_intervals(box, rule.survive),
                       _in_intervals(box, rule.born)).view(torch.uint8)


def _pad(cells: torch.Tensor, r: int, torus: bool) -> torch.Tensor:
    """The cells with ``r`` more on every side: wrapped round the torus,
    or dead."""
    h, w = cells.shape[-2:]
    out = cells.new_zeros((*cells.shape[:-2], h + 2 * r, w + 2 * r))
    out[..., r:h + r, r:w + r] = cells
    if torus:
        out[..., :r, r:w + r] = cells[..., h - r:, :]
        out[..., h + r:, r:w + r] = cells[..., :r, :]
        out[..., :, :r] = out[..., :, w:w + r]
        out[..., :, w + r:] = out[..., :, r:2 * r]
    return out


def step(cells: torch.Tensor, rule: BoxRule, *, torus: bool = True) -> torch.Tensor:
    """One generation of ``(..., H, W)`` uint8 cells, on the torus or, with
    ``torus=False``, with dead cells all round."""
    r = rule.radius
    padded = _pad(cells, r, torus)
    box = window_sums(window_sums(padded, 2 * r + 1, -1), 2 * r + 1, -2)
    return _apply(cells, box, rule)


def run(cells: torch.Tensor, rule: BoxRule, gens: int, *,
        torus: bool = True) -> torch.Tensor:
    """``gens`` generations of :func:`step`."""
    for _ in range(gens):
        cells = step(cells, rule, torus=torus)
    return cells


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """``(..., H, W/32)`` 32-bit words -> ``(..., H, W)`` uint8 cells, cell
    (r, 32j+i) being bit i of word (r, j). Row blocks keep the
    intermediate small."""
    shifts = torch.arange(WORD, device=words.device, dtype=torch.int32)
    flat = words.reshape(-1, words.shape[-1]).to(torch.int32)
    out = torch.empty((flat.shape[0], flat.shape[1] * WORD),
                      dtype=torch.uint8, device=words.device)
    block = 4096
    for r0 in range(0, flat.shape[0], block):
        rows = flat[r0:r0 + block]
        out[r0:r0 + block] = ((rows.unsqueeze(-1) >> shifts) & 1).to(
            torch.uint8).flatten(-2)
    return out.reshape(*words.shape[:-1], words.shape[-1] * WORD)


def pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """``(..., H, W)`` 0/1 cells -> ``(..., H, W/32)`` int32 words, the
    inverse of :func:`unpack_words`."""
    if cells.shape[-1] % WORD:
        raise ValueError(f"width {cells.shape[-1]} is not a multiple of 32")
    weights = torch.ones(WORD, dtype=torch.int64, device=cells.device) \
        << torch.arange(WORD, device=cells.device, dtype=torch.int64)
    flat = cells.reshape(-1, cells.shape[-1] // WORD, WORD)
    out = torch.empty(flat.shape[:2], dtype=torch.int32, device=cells.device)
    block = 4096
    for r0 in range(0, flat.shape[0], block):
        v = (flat[r0:r0 + block].to(torch.int64) * weights).sum(-1)
        out[r0:r0 + block] = (v - ((v >> 31) << 32)).to(torch.int32)
    return out.reshape(*cells.shape[:-1], cells.shape[-1] // WORD)


def stepper(config: dict):
    """``run(words, gens, torus=True)`` of ``(..., H, W/32)`` words under
    the configuration's rule."""
    rule = BoxRule.from_config(config)

    def run_words(words: torch.Tensor, gens: int,
                  torus: bool = True) -> torch.Tensor:
        return pack_cells(run(unpack_words(words), rule, gens, torus=torus))
    return run_words


def encode(cells: torch.Tensor, config: dict) -> torch.Tensor:
    """``(..., H, W)`` 0/1 cells as ``(..., H, W/32)`` words."""
    return pack_cells(cells)


def planes(config: dict) -> int:
    """One plane of words."""
    return 1
