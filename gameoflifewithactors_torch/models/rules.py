"""Life-like cellular-automaton rules.

The reference (rikace/GameOfLifeWithActors) hard-codes Conway's B3/S23 inside
each ``CellActor``'s message handler (SURVEY.md §3 — the reference mount was
empty at survey time, so no file:line citation is possible; component names
come from BASELINE.json's north_star). Here the rule is a first-class value: a
parsed birth/survive set pair that compiles into branch-free bitmask lookups
usable both by the dense stencil and the bit-packed SWAR kernel.

A rule is written in standard B/S notation, e.g. ``"B3/S23"``: a dead cell
with a live-neighbor count in B is born; a live cell with a count in S
survives; everything else dies. Counts range over 0..8 (Moore neighborhood).

This is the PyTorch package's own copy of ``gameoflifewithactors_tpu``'s
rule algebra (the port imports nothing of that package). The Generations
and Larger-than-Life families live in :mod:`.generations` and :mod:`.ltl`
and the elementary (1D) family in :mod:`.elementary`
(:func:`.generations.parse_any` dispatches between all four).
"""

from __future__ import annotations

import dataclasses
import re
from typing import FrozenSet

_VALID_COUNTS = frozenset(range(9))


@dataclasses.dataclass(frozen=True)
class Rule:
    """A life-like CA rule (outer-totalistic, 2-state, Moore neighborhood)."""

    born: FrozenSet[int]
    survive: FrozenSet[int]
    name: str = ""

    def __post_init__(self):
        if not self.born <= _VALID_COUNTS or not self.survive <= _VALID_COUNTS:
            raise ValueError(
                f"neighbor counts must be in 0..8, got B{sorted(self.born)}"
                f"/S{sorted(self.survive)}"
            )

    @property
    def birth_mask(self) -> int:
        """9-bit mask: bit n set iff a dead cell with n live neighbors is born."""
        m = 0
        for n in self.born:
            m |= 1 << n
        return m

    @property
    def survive_mask(self) -> int:
        """9-bit mask: bit n set iff a live cell with n live neighbors survives."""
        m = 0
        for n in self.survive:
            m |= 1 << n
        return m

    @property
    def notation(self) -> str:
        return (
            "B" + "".join(str(n) for n in sorted(self.born))
            + "/S" + "".join(str(n) for n in sorted(self.survive))
        )

    def next_state(self, alive: int, count: int) -> int:
        """Scalar oracle: pure-Python next state (used by tests)."""
        if alive:
            return 1 if count in self.survive else 0
        return 1 if count in self.born else 0

    def __str__(self) -> str:
        return self.name or self.notation


_BS_RE = re.compile(r"^B(?P<b>[0-8]*)/?S(?P<s>[0-8]*)$", re.IGNORECASE)
_SB_RE = re.compile(r"^(?P<s>[0-8]*)/(?P<b>[0-8]*)$")  # classic "23/3" S/B form


def parse_rule(spec: "str | Rule") -> Rule:
    """Parse ``"B3/S23"`` (or classic ``"23/3"`` S/B form, or a named rule).

    Accepts a :class:`Rule` unchanged, a registry name like ``"highlife"``, or
    B/S notation in either order with case-insensitive letters.
    """
    if isinstance(spec, Rule):
        return spec
    text = spec.strip()
    key = text.lower().replace(" ", "").replace("&", "and").replace("'", "")
    if key in RULE_REGISTRY:
        return RULE_REGISTRY[key]
    compact = text.replace(" ", "")
    m = _BS_RE.match(compact)
    if m is None:
        # classic S/B form is typo-prone ('23/' for '23/3'), so unlike the
        # explicit lettered form it must name both digit groups
        m = _SB_RE.match(compact)
        if m is not None and not (m.group("b") and m.group("s")):
            m = None
    if m is not None and not (m.group("b") or m.group("s")):
        m = None  # bare 'B/S' or '/': nothing specified
    if m is None:
        raise ValueError(
            f"unrecognized rule {spec!r}; expected B/S notation like 'B3/S23' "
            f"or one of {sorted(RULE_REGISTRY)}"
        )
    born = frozenset(int(c) for c in m.group("b"))
    survive = frozenset(int(c) for c in m.group("s"))
    name = ""
    for r in RULE_REGISTRY.values():
        if r.born == born and r.survive == survive:
            name = r.name
            break
    return Rule(born=born, survive=survive, name=name)


def _mk(b: str, s: str, name: str) -> Rule:
    return Rule(frozenset(int(c) for c in b), frozenset(int(c) for c in s), name)


# Well-known life-like rules. Conway is the reference's only rule [META];
# the rest cover BASELINE.json config #4 (HighLife, Day & Night) and beyond.
CONWAY = _mk("3", "23", "Conway's Life")
HIGHLIFE = _mk("36", "23", "HighLife")
DAY_AND_NIGHT = _mk("3678", "34678", "Day & Night")
SEEDS = _mk("2", "", "Seeds")
LIFE_WITHOUT_DEATH = _mk("3", "012345678", "Life without Death")
REPLICATOR = _mk("1357", "1357", "Replicator")
DIAMOEBA = _mk("35678", "5678", "Diamoeba")
MORLEY = _mk("368", "245", "Morley")
ANNEAL = _mk("4678", "35678", "Anneal")
TWO_BY_TWO = _mk("36", "125", "2x2")
MAZE = _mk("3", "12345", "Maze")
CORAL = _mk("3", "45678", "Coral")

RULE_REGISTRY = {
    "conway": CONWAY,
    "conwayslife": CONWAY,
    "life": CONWAY,
    "b3/s23": CONWAY,
    "highlife": HIGHLIFE,
    "dayandnight": DAY_AND_NIGHT,
    "seeds": SEEDS,
    "lifewithoutdeath": LIFE_WITHOUT_DEATH,
    "replicator": REPLICATOR,
    "diamoeba": DIAMOEBA,
    "morley": MORLEY,
    "anneal": ANNEAL,
    "2x2": TWO_BY_TWO,
    "maze": MAZE,
    "coral": CORAL,
}

