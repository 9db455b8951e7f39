"""Larger-than-Life rule family — radius-r neighbourhoods.

Counterpart of ``gameoflifewithactors_tpu.models.ltl`` (this package's own
copy). Life-like rules look at 8 neighbours; Larger-than-Life (Evans)
counts live cells in a (2r+1)² box (or a von Neumann diamond) and births/
survives on *intervals*.

Notation (Golly's LtL form): ``R5,C0,M1,S34..58,B34..45`` — radius R,
states C (C0/C2 = binary; C>=3 adds Generations-style dying states: alive
cells failing survival decay through 2..C-1 instead of dying outright, and
dying cells neither excite neighbours nor take births), M1 counts the
centre cell itself in the window (M0 excludes it), S/B are inclusive count
intervals. Golly's HROT list form (``R2,C2,S6-9,B7-8[,NM|NN]``) takes
several intervals. Named rules: "bosco" (the classic), "bugs",
"majority" (radius-4 majority vote).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

MAX_RADIUS = 7  # policy cap: counts stay below 256 (8 bit-planes)


def _as_intervals(name, value) -> Tuple[Tuple[int, int], ...]:
    """Normalize born/survive: a bare (lo, hi) int pair -> ((lo, hi),); a
    tuple of pairs passes through; an empty tuple means 'never' (Golly
    allows e.g. an empty survival list in HROT rules)."""
    if isinstance(value, tuple) and not value:
        return ()
    if (isinstance(value, tuple) and len(value) == 2
            and all(isinstance(v, int) for v in value)):
        return (value,)
    if (isinstance(value, tuple) and value
            and all(isinstance(iv, tuple) and len(iv) == 2
                    and all(isinstance(v, int) for v in iv) for iv in value)):
        return value
    raise ValueError(
        f"{name} must be an inclusive (lo, hi) pair, a tuple of such "
        f"intervals, or () for 'never', got {value!r}")


@dataclasses.dataclass(frozen=True)
class LtLRule:
    """Larger-than-Life: interval birth/survival over a radius-r
    neighbourhood — Moore box ("M", Golly's NM) or von Neumann diamond
    ("N", Golly's NN, |dx|+|dy| <= r). ``states == 2`` is the classic
    binary family; ``states >= 3`` adds Generations-style decay (state 1
    alive, 2..states-1 dying and non-exciting)."""

    radius: int
    born: Tuple[int, int]       # (lo, hi) — or a tuple of such intervals
    survive: Tuple[int, int]    # (lo, hi) — or a tuple of such intervals
    middle: bool = True         # M1: a live cell counts itself in its window
    neighborhood: str = "M"     # "M" box | "N" von Neumann diamond
    states: int = 2             # 2 = binary; >= 3 = dying states 2..C-1

    def __post_init__(self):
        if not 1 <= self.radius <= MAX_RADIUS:
            raise ValueError(
                f"radius must be 1..{MAX_RADIUS} (bf16-exact window sums), "
                f"got {self.radius}"
            )
        if self.neighborhood not in ("M", "N"):
            raise ValueError(
                f"neighborhood must be 'M' (Moore box) or 'N' (von Neumann "
                f"diamond), got {self.neighborhood!r}")
        if not 2 <= self.states <= 256:
            raise ValueError(
                f"states must be 2..256 (uint8 cells), got {self.states}")
        full = self.window_size
        for name in ("born", "survive"):
            ivs = _as_intervals(name, getattr(self, name))
            # canonical storage (bare pair when single, interval tuple
            # otherwise — what the parser produces), so equal rules
            # compare and hash equal however they were constructed
            object.__setattr__(self, name, ivs[0] if len(ivs) == 1 else ivs)
            prev_hi = -2
            for lo, hi in ivs:
                if not (0 <= lo <= hi <= full):
                    raise ValueError(
                        f"{name} interval {lo}..{hi} outside 0..{full} "
                        f"for radius {self.radius} neighborhood "
                        f"{self.neighborhood}")
                if lo <= prev_hi + 1:
                    raise ValueError(
                        f"{name} intervals must be sorted and disjoint "
                        f"(non-adjacent), got {ivs}")
                prev_hi = hi

    @property
    def born_intervals(self) -> Tuple[Tuple[int, int], ...]:
        """``born`` as a tuple of inclusive (lo, hi) intervals — a single
        pair (the classic LtL form) normalizes to a 1-tuple; HROT lists
        pass through."""
        return _as_intervals("born", self.born)

    @property
    def survive_intervals(self) -> Tuple[Tuple[int, int], ...]:
        return _as_intervals("survive", self.survive)

    @property
    def window_size(self) -> int:
        """Cells in the neighbourhood window (centre included)."""
        r = self.radius
        return (2 * r + 1) ** 2 if self.neighborhood == "M" else (
            2 * r * (r + 1) + 1)

    @property
    def notation(self) -> str:
        def ivs(vals) -> str:
            return ",".join(f"{lo}..{hi}" for lo, hi in _as_intervals("", vals))

        return (
            f"R{self.radius},C{0 if self.states == 2 else self.states},"
            f"M{int(self.middle)},"
            f"S{ivs(self.survive)},"
            f"B{ivs(self.born)}"
            + ("" if self.neighborhood == "M" else ",NN")
        )

    def __str__(self) -> str:
        return self.notation


_VALUE_RE = re.compile(r"^(\d+)(?:(?:\.\.|-)(\d+))?$")
# shape sentinel for models.generations.parse_any dispatch: anything
# starting "R<d>,C<d>," is this family's (classic LtL or HROT form);
# full validation happens in parse_ltl
_LTL_RE = re.compile(r"^r\d+,c\d+,", re.IGNORECASE)

LTL_REGISTRY = {}


def _mk(spec: str, name: str) -> LtLRule:
    r = parse_ltl(spec)
    LTL_REGISTRY[name] = r
    return r


def parse_ltl(spec: "str | LtLRule") -> LtLRule:
    """Parse the classic LtL form (``R5,C0,M1,S34..58,B34..45[,NN]``) or
    Golly's HROT list form (``R2,C2,S6-9,B7-8[,NM]``) — S/B take
    comma-separated values or inclusive ranges (``a``, ``a-b``, ``a..b``),
    and an absent M token means M0 (HROT is outer-totalistic)."""
    if isinstance(spec, LtLRule):
        return spec
    key = spec.strip().lower().replace(" ", "")
    if key in LTL_REGISTRY:
        return LTL_REGISTRY[key]

    def fail(why: str) -> ValueError:
        return ValueError(
            f"not a Larger-than-Life/HROT rule: {spec!r} ({why}; want "
            f"'R5,C0,M1,S34..58,B34..45', 'R2,C2,S6-9,B7-8', or one of "
            f"{sorted(LTL_REGISTRY)})")

    tokens = key.split(",")
    if len(tokens) < 4 or not tokens[0].startswith("r") \
            or not tokens[1].startswith("c"):
        raise fail("expected R...,C...,[M...,]S...,B...")
    try:
        radius = int(tokens[0][1:])
        c = int(tokens[1][1:])
    except ValueError:
        raise fail("R and C take integers") from None
    i = 2
    middle = False  # HROT default: outer-totalistic (no M token)
    if tokens[i].startswith("m"):
        if tokens[i] not in ("m0", "m1"):
            raise fail("M takes 0 or 1")
        middle = tokens[i] == "m1"
        i += 1

    def values(lead: str, i: int):
        """Collect the comma-separated interval list opened by token
        ``lead`` + following bare-value tokens. A bare section token
        (e.g. 'S' straight before 'B...') is Golly's empty list."""
        if i >= len(tokens) or not tokens[i].startswith(lead):
            raise fail(f"expected {lead.upper()} section")
        ivs, first = [], tokens[i][1:]
        i += 1
        items = [first] if first else []
        while i < len(tokens) and _VALUE_RE.match(tokens[i]):
            items.append(tokens[i])
            i += 1
        for item in items:
            m = _VALUE_RE.match(item)
            if not m:
                raise fail(f"bad {lead.upper()} value {item!r}")
            lo = int(m.group(1))
            ivs.append((lo, int(m.group(2)) if m.group(2) else lo))
        return tuple(ivs), i

    survive, i = values("s", i)
    born, i = values("b", i)
    neighborhood = "M"
    if i < len(tokens):
        if tokens[i] in ("nm", "nn"):
            neighborhood = tokens[i][1].upper()
            i += 1
    if i != len(tokens):
        raise fail(f"unexpected trailing tokens {tokens[i:]}")
    return LtLRule(
        radius=radius,
        born=born,          # __post_init__ canonicalizes single intervals
        survive=survive,
        middle=middle,
        neighborhood=neighborhood,
        states=2 if c in (0, 1, 2) else c,  # Golly: C0/C1/C2 all binary
    )


BOSCO = _mk("R5,C0,M1,S34..58,B34..45", "bosco")
BUGS = _mk("R5,C0,M1,S34..58,B34..45", "bugs")  # alias: Bosco's rule IS "Bugs"
MAJORITY = _mk("R4,C0,M1,S41..81,B41..81", "majority")
