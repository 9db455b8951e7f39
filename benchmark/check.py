"""The comparison that decides ``correct``: the program's outputs against
the plain reference, cell for cell.

A configuration names its reference (``reference`` in its file):
``life_packed`` (:mod:`.reference.life_packed`, radius-1 rules of the
eight neighbours, a word of 32 cells at a time) or ``box_rule``
(:mod:`.reference.box_rule`, any Moore box, a byte a cell). Both step the
packed words of the configuration's layout, which they read and write
themselves. Every number compared is a count of cells that differ, with
the limit 0: the rules are exact. The reference draws the soup again from
the seed (:mod:`.inputs`) and reads the program's outputs only to judge
them. Where it follows the program from the program's own state (a tick
drawn from the window, a session's later request), the start is checked
apart, from the soup.

A universe over several cards is checked band by band
(:func:`compare_bands`): each card's band, with ``radius x generations``
rows of its neighbours above and below, is stepped on that card, so the
reference never gathers the torus on one card.
"""

from __future__ import annotations

from typing import List

import torch

from .reference import box_rule, life_packed

LIMIT = 0


class Reference:
    """The configuration's plain reference, on packed words."""

    def __init__(self, config: dict):
        self.kind = config["reference"]
        if self.kind == "life_packed":
            self.born, self.survive = life_packed.counts_of(config)
        elif self.kind == "box_rule":
            self.rule = box_rule.BoxRule.from_config(config)
        else:
            raise ValueError(f"no reference named {self.kind!r}")

    def run(self, words: torch.Tensor, gens: int,
            torus: bool = True) -> torch.Tensor:
        """``gens`` generations of ``(..., H, W/32)`` words on the torus
        (``torus=False``: dead beyond the edges, the control's fault)."""
        if self.kind == "life_packed":
            return life_packed.run(words, self.born, self.survive, gens, torus)
        cells = box_rule.run(box_rule.unpack_words(words), self.rule, gens,
                             torus=torus)
        return box_rule.pack_cells(cells)


def mismatched_cells(expected: torch.Tensor, got: torch.Tensor) -> int:
    """Cells that differ between two grids of packed words."""
    diff = expected ^ got.to(expected.device)
    if not bool(diff.any()):
        return 0
    return int(box_rule.unpack_words(diff).sum())


def compare(reference: Reference, before: torch.Tensor, after: torch.Tensor,
            gens: int) -> int:
    """Cells of the program's ``after`` words that differ from the
    reference's ``gens`` generations of ``before`` words."""
    return mismatched_cells(reference.run(before, gens), after)


def compare_each(reference: Reference, befores: List[torch.Tensor],
                 afters: List[torch.Tensor], gens: int,
                 chunk: int = 64) -> List[int]:
    """:func:`compare` of each pair, ``chunk`` pairs stepped together."""
    out: List[int] = []
    for i in range(0, len(befores), chunk):
        want = reference.run(torch.stack(befores[i:i + chunk]), gens)
        for w, a in zip(want, afters[i:i + chunk]):
            out.append(mismatched_cells(w, a))
    return out


# generations a band is stepped before the next band's turn: the cards'
# queues are filled in turn, so they run side by side
BAND_ROUND = 4


def torus_rows(bands: List[torch.Tensor], start: int, count: int,
               device: torch.device) -> torch.Tensor:
    """Rows ``start .. start + count`` of the torus that ``bands`` tile
    from the top down (wrapped round), copied to ``device``."""
    h = bands[0].shape[-2]
    total = h * len(bands)
    pieces, row = [], start % total
    while count:
        i, off = divmod(row, h)
        take = min(count, h - off)
        pieces.append(bands[i][off:off + take].to(device))
        count -= take
        row = (row + take) % total
    return torch.cat(pieces)


def compare_bands(reference: Reference, before: List[torch.Tensor],
                  after: List[torch.Tensor], gens: int,
                  radius: int = 1) -> int:
    """Cells of the program's full-width row bands ``after`` (one torus,
    top band first, each on its card) that differ from the reference's
    ``gens`` generations of the bands ``before``. Each band is stepped on
    its card with ``radius * gens`` rows of the torus above and below it,
    on the torus: what wraps round the extended band reaches no deeper
    than those margin rows, so the band's own rows are exact."""
    h = before[0].shape[-2]
    margin = radius * gens
    ext = [torus_rows(before, i * h - margin, h + 2 * margin, a.device)
           for i, a in enumerate(after)]
    for done in range(0, gens, BAND_ROUND):
        n = min(BAND_ROUND, gens - done)
        ext = [reference.run(e, n) for e in ext]
    return sum(mismatched_cells(e[margin:margin + h], a)
               for e, a in zip(ext, after))
