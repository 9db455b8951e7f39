"""Generations rule family — multi-state cellular automata.

Counterpart of ``gameoflifewithactors_tpu.models.generations`` (this
package's own copy; it imports nothing of the JAX package). State 1 is
*alive* (the only state neighbours count), a live cell that fails survival
starts *dying* through states 2..C-1 (it occupies space but no longer
excites neighbours), and only from state C-1 does it return to dead 0. C=2
degenerates to plain life-like, so C >= 3 here.

Notation: "B2/S/C3" (Brian's Brain) — also accepted with G instead of C,
and as Golly's "survive/born/states" digit form ("2/3/3" ≡ B3/S2/C3 is
what Golly writes in RLE headers; counts are single digits 0..8, so the
form is unambiguous — only the trailing states field is multi-digit).

:func:`parse_any` dispatches a spec to its family by shape: life-like,
Generations, Larger than Life or elementary (1D).
"""

from __future__ import annotations

import dataclasses
import re
from typing import FrozenSet

from .rules import Rule, parse_rule


@dataclasses.dataclass(frozen=True)
class GenRule:
    """An outer-totalistic Generations rule: born/survive count sets + the
    number of cell states C (0 = dead, 1 = alive, 2..C-1 = dying)."""

    born: FrozenSet[int]
    survive: FrozenSet[int]
    states: int

    def __post_init__(self):
        object.__setattr__(self, "born", frozenset(self.born))
        object.__setattr__(self, "survive", frozenset(self.survive))
        if not all(0 <= n <= 8 for n in self.born | self.survive):
            raise ValueError(f"neighbor counts must be 0..8: {self}")
        if not 3 <= self.states <= 256:
            raise ValueError(
                f"Generations needs 3..256 states (C=2 is plain life-like; "
                f"use Rule), got {self.states}"
            )

    @property
    def birth_mask(self) -> int:
        m = 0
        for n in self.born:
            m |= 1 << n
        return m

    @property
    def survive_mask(self) -> int:
        m = 0
        for n in self.survive:
            m |= 1 << n
        return m

    @property
    def notation(self) -> str:
        return (
            "B" + "".join(str(n) for n in sorted(self.born))
            + "/S" + "".join(str(n) for n in sorted(self.survive))
            + f"/C{self.states}"
        )

    def __str__(self) -> str:
        return self.notation


_GEN_RE = re.compile(
    r"^B(?P<b>[0-8]*)/S(?P<s>[0-8]*)/[CG](?P<c>\d+)$", re.IGNORECASE
)
# Golly's RLE-header form: survive/born/states ("2/3/3" = Brian's Brain)
_GOLLY_GEN_RE = re.compile(r"^(?P<s>[0-8]*)/(?P<b>[0-8]*)/(?P<c>\d+)$")

GENERATIONS_REGISTRY = {}


def _mk(b: str, s: str, c: int, name: str) -> GenRule:
    r = GenRule(frozenset(int(x) for x in b), frozenset(int(x) for x in s), c)
    GENERATIONS_REGISTRY[name] = r
    return r


BRIANS_BRAIN = _mk("2", "", 3, "brain")
STAR_WARS = _mk("2", "345", 4, "starwars")
FROGS = _mk("34", "12", 3, "frogs")
BELZHAB = _mk("23", "23", 8, "belzhab")


def parse_generations(spec: "str | GenRule") -> GenRule:
    """Parse "B2/S/C3"-style notation or a registered name."""
    if isinstance(spec, GenRule):
        return spec
    key = spec.strip().lower().replace(" ", "").replace("'", "")
    if key in GENERATIONS_REGISTRY:
        return GENERATIONS_REGISTRY[key]
    # match the space-stripped key, so 'B2 / S / C3' parses
    m = _GEN_RE.match(key) or _GOLLY_GEN_RE.match(key)
    if not m:
        raise ValueError(
            f"not a Generations rule: {spec!r} (want 'B…/S…/C<n>', Golly's "
            f"'survive/born/states', or one of {sorted(GENERATIONS_REGISTRY)})"
        )
    return GenRule(
        frozenset(int(x) for x in m.group("b")),
        frozenset(int(x) for x in m.group("s")),
        int(m.group("c")),
    )


def parse_any(spec):
    """Life-like, Generations, Larger-than-Life or elementary (1D), decided
    by the *shape* of the spec — a string matching a family's form
    dispatches to that family's parser so validation errors (e.g. a bad
    state count) surface verbatim instead of degrading to 'unrecognized
    rule'."""
    from .elementary import _ELEM_RE, ElementaryRule, parse_elementary
    from .ltl import _LTL_RE, LTL_REGISTRY, LtLRule, parse_ltl

    if isinstance(spec, (Rule, GenRule, LtLRule, ElementaryRule)):
        return spec
    key = spec.strip().lower().replace(" ", "").replace("'", "")
    if (key in GENERATIONS_REGISTRY or _GEN_RE.match(key)
            or _GOLLY_GEN_RE.match(key)):
        return parse_generations(spec)
    if key in LTL_REGISTRY or _LTL_RE.match(key):
        return parse_ltl(spec)
    if _ELEM_RE.match(key):
        return parse_elementary(spec)
    return parse_rule(spec)
