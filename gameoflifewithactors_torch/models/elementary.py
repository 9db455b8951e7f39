"""Elementary (Wolfram) 1D cellular automata: rules 0..255.

Counterpart of ``gameoflifewithactors_tpu.models.elementary`` (this
package's own copy; it imports nothing of the JAX package). The rule
number's bit k gives the next state for the 3-cell pattern k = (left << 2)
| (center << 1) | right -- rule 110 is Turing-complete, rule 90 is the
Sierpinski XOR, rule 30 is Wolfram's chaos/PRNG rule.

Stepping lives in :mod:`..ops.elementary` (bit-packed SWAR over 32-cell
words); this module is the rule algebra only.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_ELEM_RE = re.compile(r"^(?:w|rule)(?P<n>\d{1,3})$")


@dataclass(frozen=True)
class ElementaryRule:
    """One of the 256 elementary rules, by Wolfram number."""

    number: int

    def __post_init__(self):
        if not 0 <= self.number <= 255:
            raise ValueError(
                f"elementary rule number must be 0..255, got {self.number}")

    @property
    def notation(self) -> str:
        return f"W{self.number}"

    def __str__(self) -> str:
        return self.notation

    def pattern_bit(self, left: int, center: int, right: int) -> int:
        """Next state for a (left, center, right) neighborhood."""
        return (self.number >> ((left << 2) | (center << 1) | right)) & 1


RULE_110 = ElementaryRule(110)
RULE_90 = ElementaryRule(90)
RULE_30 = ElementaryRule(30)


def parse_elementary(spec: "str | ElementaryRule") -> ElementaryRule:
    """Parse "W110" / "rule110" (case-insensitive) or pass through."""
    if isinstance(spec, ElementaryRule):
        return spec
    m = _ELEM_RE.match(str(spec).strip().lower().replace(" ", ""))
    if not m:
        raise ValueError(
            f"not an elementary rule spec: {spec!r} (want 'W<0..255>' or "
            f"'rule<0..255>', e.g. 'W110')")
    return ElementaryRule(int(m.group("n")))
