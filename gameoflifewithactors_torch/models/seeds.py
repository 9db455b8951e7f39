"""Seed patterns and grid initialisation.

Counterpart of ``gameoflifewithactors_tpu.models.seeds``: classic still
lifes, oscillators and spaceships as plaintext art, a standard RLE decoder
and encoder, placement helpers, and a Bernoulli random fill. Patterns are
host-side NumPy; the random fill draws from a ``torch.Generator``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_ALIVE_CHARS = frozenset("XxOo*1")


def from_plaintext(text: str) -> np.ndarray:
    """Parse ASCII art ('X'/'O'/'*' alive, '.'/space dead) into uint8 (h, w)."""
    lines = [ln.rstrip() for ln in text.strip("\n").splitlines()]
    width = max(len(ln) for ln in lines)
    grid = np.zeros((len(lines), width), dtype=np.uint8)
    for r, ln in enumerate(lines):
        for c, ch in enumerate(ln):
            if ch in _ALIVE_CHARS:
                grid[r, c] = 1
    return grid


_RLE_HEADER = re.compile(r"^\s*x\s*=\s*(\d+)\s*,\s*y\s*=\s*(\d+)", re.IGNORECASE)
_RLE_RULE = re.compile(r"rule\s*=\s*([^\n]+)", re.IGNORECASE)


def _header_states(text: str) -> int:
    """Cell-state count from an RLE header's ``rule =`` clause (2 when the
    rule is binary, absent, unparseable or of a family not ported — the
    legacy decoder then applies)."""
    m = _RLE_RULE.search(text)
    if not m:
        return 2
    try:
        from .generations import parse_any

        return getattr(parse_any(m.group(1).strip()), "states", 2)
    except Exception:
        return 2


def from_rle(text: str, states: "int | None" = None) -> np.ndarray:
    """Decode Game-of-Life RLE (``b``=dead, ``o``=alive, ``$``=EOL,
    ``!``=end, ``#``-comment lines, optional ``x=,y=,rule=`` header).

    Golly's EXTENDED multi-state encoding is applied when the header's
    rule (or an explicit ``states=``) has more than 2 states: ``.`` is
    state 0, ``A``..``X`` are 1..24, and a ``p``..``y`` prefix adds 24·k
    (``pA``=25 … ``yO``=255) — the format Golly writes for Generations and
    multi-state Larger-than-Life patterns. Binary RLE keeps the legacy
    case-insensitive ``b``/``o`` reading."""
    if states is None:
        states = _header_states(text)
    multistate = states > 2
    width = height = None
    body_parts = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _RLE_HEADER.match(ln)
        if m:
            width, height = int(m.group(1)), int(m.group(2))
            continue
        body_parts.append(ln)
    body = "".join(body_parts)
    rows: list[list[int]] = [[]]
    run = ""
    prefix = 0                      # 24·k from a pending p..y prefix char
    for ch in body:
        if ch.isdigit():
            run += ch
            continue
        if multistate and "p" <= ch <= "y":
            if prefix:
                raise ValueError(f"double state prefix before {ch!r}")
            prefix = 24 * (ord(ch) - ord("o"))
            continue
        n = int(run) if run else 1
        run = ""
        if prefix and not ("A" <= ch <= "X"):
            raise ValueError(f"state prefix must be followed by A..X, got {ch!r}")
        if multistate and "A" <= ch <= "X":
            rows[-1].extend([prefix + ord(ch) - ord("A") + 1] * n)
            prefix = 0
        elif ch in ("b", "B") or (multistate and ch == "."):
            rows[-1].extend([0] * n)
        elif ch in ("o", "O"):
            rows[-1].extend([1] * n)
        elif ch == "$":
            for _ in range(n - 1):
                rows.append([])
            rows.append([])
        elif ch == "!":
            break
        elif ch.isspace():
            continue
        else:
            raise ValueError(f"unexpected RLE char {ch!r}")
    w = width if width is not None else max((len(r) for r in rows), default=0)
    h = height if height is not None else len(rows)
    grid = np.zeros((h, w), dtype=np.uint8)
    for r, row in enumerate(rows[:h]):
        grid[r, : len(row)] = row[:w]
    return grid


def _rle_token(state: int) -> str:
    """Golly cell token: ``.`` / ``A``..``X`` / prefixed ``pA``..``yO``."""
    if state == 0:
        return "."
    if state > 255:
        raise ValueError(f"RLE encodes states 0..255, got {state}")
    k, rem = divmod(state - 1, 24)
    return (chr(ord("o") + k) if k else "") + chr(ord("A") + rem)


def to_rle(grid: np.ndarray, rule: str = "B3/S23") -> str:
    """Encode a uint8 grid as RLE (round-trips with from_rle). Grids with
    cells beyond 1 use Golly's extended multi-state tokens; pass the
    matching multi-state ``rule`` string so decoders (including ours)
    pick the extended reading from the header."""
    h, w = grid.shape
    multistate = int(grid.max(initial=0)) > 1
    out = [f"x = {w}, y = {h}, rule = {rule}"]
    lines = []
    for r in range(h):
        runs = []
        row = grid[r]
        c = 0
        while c < w:
            v = int(row[c])
            n = 1
            while c + n < w and row[c + n] == v:
                n += 1
            if multistate:
                tok = _rle_token(v)
            else:
                tok = "o" if v else "b"
            runs.append((n, tok))
            c += n
        if runs and runs[-1][1] in ("b", "."):
            runs.pop()  # trailing dead cells are implicit
        lines.append("".join((str(n) if n > 1 else "") + t for n, t in runs))
    out.append("$".join(lines) + "!")
    return "\n".join(out)


# --- classic patterns (plaintext keeps them reviewable) ---------------------

PATTERNS: Dict[str, np.ndarray] = {}


def _register(name: str, art: str) -> None:
    PATTERNS[name] = from_plaintext(art)


_register("block", "XX\nXX")
_register("blinker", "XXX")
_register("toad", ".XXX\nXXX.")
_register("beacon", "XX..\nXX..\n..XX\n..XX")
_register("glider", ".X.\n..X\nXXX")
_register("lwss", ".X..X\nX....\nX...X\nXXXX.")
_register("r_pentomino", ".XX\nXX.\n.X.")
_register("acorn", ".X.....\n...X...\nXX..XXX")
_register("diehard", "......X.\nXX......\n.X...XXX")       # vanishes at gen 130
_register("pentadecathlon", "..X....X..\nXX.XXXX.XX\n..X....X..")  # period 15
_register("pulsar", """
..XXX...XXX..
.............
X....X.X....X
X....X.X....X
X....X.X....X
..XXX...XXX..
.............
..XXX...XXX..
X....X.X....X
X....X.X....X
X....X.X....X
.............
..XXX...XXX..
""")
_register("gosper_gun", """
........................X...........
......................X.X...........
............XX......XX............XX
...........X...X....XX............XX
XX........X.....X...XX..............
XX........X...X.XX....X.X...........
..........X.....X.......X...........
...........X...X....................
............XX......................
""")


def pattern(name: str) -> np.ndarray:
    try:
        return PATTERNS[name].copy()
    except KeyError:
        raise KeyError(f"unknown pattern {name!r}; known: {sorted(PATTERNS)}") from None


def empty(shape: Tuple[int, int]) -> np.ndarray:
    return np.zeros(shape, dtype=np.uint8)


def place(grid: np.ndarray, pat: "np.ndarray | str", top: int, left: int) -> np.ndarray:
    """Stamp a pattern onto a grid at (top, left); returns the grid."""
    if isinstance(pat, str):
        pat = pattern(pat)
    ph, pw = pat.shape
    if top < 0 or left < 0 or top + ph > grid.shape[0] or left + pw > grid.shape[1]:
        raise ValueError(
            f"pattern {pat.shape} at ({top},{left}) exceeds grid {grid.shape}"
        )
    grid[top : top + ph, left : left + pw] |= pat
    return grid


def seeded(shape: Tuple[int, int], pat: "np.ndarray | str", top: int = 0, left: int = 0) -> np.ndarray:
    """A fresh grid of ``shape`` with ``pat`` stamped at (top, left)."""
    return place(empty(shape), pat, top, left)


def seeded_packed(shape: Tuple[int, int], pat: "np.ndarray | str",
                  top: int = 0, left_word: int = 0) -> np.ndarray:
    """A fresh bit-packed (H, W/32 uint32) grid with ``pat`` stamped at row
    ``top``, word column ``left_word`` — O(pattern) host work regardless of
    grid size, so a 65536² field (512 MB packed; 4.3 GB dense) seeds without
    ever materialising the dense grid. Placement is word-aligned: cell
    column = 32·left_word."""
    from ..ops import bitpack

    if isinstance(pat, str):
        pat = pattern(pat)
    h, w = shape
    if w % bitpack.WORD:
        raise ValueError(f"width {w} not a multiple of {bitpack.WORD}")
    ph, pw = pat.shape
    patch = np.zeros((ph, -(-pw // bitpack.WORD) * bitpack.WORD), dtype=np.uint8)
    patch[:, :pw] = pat
    pp = bitpack.pack_np(patch)
    words = w // bitpack.WORD
    if top < 0 or left_word < 0 or top + ph > h or left_word + pp.shape[1] > words:
        raise ValueError(
            f"pattern {pat.shape} at (row {top}, word {left_word}) exceeds "
            f"packed grid ({h}, {words})")
    grid = np.zeros((h, words), dtype=np.uint32)
    grid[top:top + ph, left_word:left_word + pp.shape[1]] = pp
    return grid


def bernoulli(generator: torch.Generator, shape: Tuple[int, int],
              p: float = 0.5) -> torch.Tensor:
    """Random fill: each cell alive with probability ``p``, drawn on the
    generator's device. Its bits differ from the JAX package's
    ``jax.random`` fill by design."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return (u < p).to(torch.uint8)
