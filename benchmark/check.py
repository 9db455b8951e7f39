"""The comparison that decides ``correct``: the program's outputs against
the plain reference, cell for cell.

A configuration names its reference (``reference`` in its file), and
:class:`Reference` loads ``reference/<name>.py`` by that name, as
:func:`.manifest.reader` loads a metric's reader: a new reference is a
new file. Each module gives ``stepper(config)`` (a function ``run(state,
gens, torus=True)`` that steps the configuration's layout),
``encode(cells, config)`` (``(..., H, W)`` uint8 states into that layout)
and ``planes(config)``: 1 for one plane of packed words ``(..., H,
W/32)``, b for a stack of b bit-planes ``(..., b, H, W/32)``, least
significant plane first. Every number compared is a count of cells that
differ, a cell counting once however many of its planes differ, with the
limit 0: the rules are exact. The reference draws the soup again from the seed
(:mod:`.inputs`) and reads the program's outputs only to judge them.
Where it follows the program from the program's own state (a tick drawn
from the window, a session's later request), the start is checked apart,
from the soup.

A universe over several cards is checked band by band
(:func:`compare_bands`): each card's band, with ``radius x generations``
rows of its neighbours above and below, is stepped on that card, so the
reference never gathers the torus on one card.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import os
from typing import List

import torch

from .reference import box_rule   # the packed32 layout's unpacking

LIMIT = 0
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "reference")


def reference_module(name: str, reference_dir: str = REFERENCE_DIR):
    """The module ``<reference_dir>/<name>.py``. It is a module of
    :mod:`.reference` wherever it lies, so that its relative imports
    find the benchmark's own references beside it."""
    path = os.path.join(reference_dir, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reference named {name!r}: {path} "
                                f"does not exist")
    module_name = f"{__package__}.reference.{name}"
    if os.path.samefile(reference_dir, REFERENCE_DIR):
        return importlib.import_module(module_name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Reference:
    """The plain reference that the configuration names, on its layout."""

    def __init__(self, config: dict, reference_dir: str = REFERENCE_DIR):
        self.config = config
        self.module = reference_module(config["reference"], reference_dir)
        self.stepper = self.module.stepper(config)
        self.planes = int(self.module.planes(config))

    def encode(self, cells: torch.Tensor) -> torch.Tensor:
        """``(..., H, W)`` uint8 states in the configuration's layout."""
        return self.module.encode(cells, self.config)

    def run(self, state: torch.Tensor, gens: int,
            torus: bool = True) -> torch.Tensor:
        """``gens`` generations of the layout's ``(..., H, W/32)`` words or
        ``(..., b, H, W/32)`` plane stacks on the torus (``torus=False``:
        dead beyond the edges, the control's fault)."""
        return self.stepper(state, gens, torus)


def mismatched_cells(expected: torch.Tensor, got: torch.Tensor,
                     planes: int = 1) -> int:
    """Cells that differ between two grids of packed words, or of stacks
    of ``planes`` bit-planes (axis -3): a cell counts once however many
    of its planes differ."""
    if got.shape != expected.shape:
        raise ValueError(f"the program's state has the shape "
                         f"{tuple(got.shape)}, the reference's "
                         f"{tuple(expected.shape)}")
    diff = expected ^ got.to(expected.device)
    if not bool(diff.any()):
        return 0
    if planes > 1:
        diff = functools.reduce(torch.bitwise_or, diff.unbind(-3))
    return int(box_rule.unpack_words(diff).sum())


def compare(reference: Reference, before: torch.Tensor, after: torch.Tensor,
            gens: int) -> int:
    """Cells of the program's ``after`` state that differ from the
    reference's ``gens`` generations of the ``before`` state."""
    return mismatched_cells(reference.run(before, gens), after,
                            reference.planes)


def compare_each(reference: Reference, befores: List[torch.Tensor],
                 afters: List[torch.Tensor], gens: int,
                 chunk: int = 64) -> List[int]:
    """:func:`compare` of each pair, ``chunk`` pairs stepped together."""
    out: List[int] = []
    for i in range(0, len(befores), chunk):
        want = reference.run(torch.stack(befores[i:i + chunk]), gens)
        for w, a in zip(want, afters[i:i + chunk]):
            out.append(mismatched_cells(w, a, reference.planes))
    return out


# generations a band is stepped before the next band's turn: the cards'
# queues are filled in turn, so they run side by side
BAND_ROUND = 4


def torus_rows(bands: List[torch.Tensor], start: int, count: int,
               device: torch.device) -> torch.Tensor:
    """Rows ``start .. start + count`` (axis -2) of the torus that
    ``bands`` tile from the top down (wrapped round), copied to
    ``device``; the planes of a stack stay whole."""
    h = bands[0].shape[-2]
    total = h * len(bands)
    pieces, row = [], start % total
    while count:
        i, off = divmod(row, h)
        take = min(count, h - off)
        pieces.append(bands[i][..., off:off + take, :].to(device))
        count -= take
        row = (row + take) % total
    return torch.cat(pieces, dim=-2)


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
    return sum(mismatched_cells(e[..., margin:margin + h, :], a,
                                reference.planes)
               for e, a in zip(ext, after))
