"""The yardstick's operation counts: a frozen copy of the port's formulas.

Copied from ``gameoflifewithactors_torch/obs/cost.py`` at commit df56cff
(``WORD`` through ``ltl_ops_per_word``, unchanged), so that a later change
to the program cannot move the denominator of a roofline share. An
operation is a bitwise one on a 32-bit word (a three-input logic op or a
funnel shift counting as one), set against the card's integer-op peak
(:mod:`.peaks`). The counts depend on the rule only.

The functions take any object with the attributes they read;
:func:`rule_from_config` builds one from a configuration file, and
:func:`rule_ops_per_word` picks the family's formula. ``gen_ops_per_word``
serves no cell yet; it is kept for a Generations configuration, since a
later PR may add files here but not edit this one. Stdlib only.
"""

from __future__ import annotations

import types

WORD = 32   # cells per packed word


def ops_per_word(rule) -> int:
    """Bitwise operations one generation of a B/S rule needs per 32-cell
    word, a three-input logic op or a funnel shift counting as one: 2
    shifts for the west/east planes, 4 for the row sums T and S, 8 for the
    4-bit count T_n + S + T_s, 2 per count-equality plane the rule tests,
    one OR per further born or survive count, and the final select."""
    return (2 + 4 + 8 + 2 * len(rule.born | rule.survive)
            + max(len(rule.born) - 1, 0) + max(len(rule.survive) - 1, 0) + 1)


def gen_ops_per_word(rule) -> int:
    """The same count for one generation of a Generations rule on b =
    n_planes(C) bit-planes, from packed_generations.step_planes_slab: the
    alive plane (an OR of b-1 planes and an and-not, ceil((b-1)/2)
    three-input ops), the 14 of the 3x3 count, the born and keep masks as
    for a B/S rule (2 per count-equality plane, an OR per further count),
    and transition_planes: the nonzero OR (ceil((b-1)/2)), kept, one and
    aging (3), the +1 carry chain (2 per plane past the first), the
    equality with C where C != 2**b (ceil((b-1)/2)), the b masked outputs
    and the OR of `one` into plane 0."""
    b = max(1, (rule.states - 1).bit_length())
    fold = -(-(b - 1) // 2)
    masks = (2 * len(rule.born | rule.survive) + max(len(rule.born) - 1, 0)
             + max(len(rule.survive) - 1, 0))
    eq = fold if rule.states != 1 << b else 0
    return fold + 14 + masks + fold + 3 + 2 * (b - 1) + eq + b + 1


def _csa_ops(n: int):
    """(planes, ops) of packed.bit_sliced_sum over n one-bit planes: full
    and half adders, 2 ops each."""
    planes = ops = 0
    while n:
        carries = 0
        while n >= 3:
            n, carries, ops = n - 2, carries + 1, ops + 2
        if n == 2:
            n, carries, ops = 1, carries + 1, ops + 2
        planes += 1
        n = carries
    return planes, ops


def _rule_ops(rule, counts: int, comparators: int, m0: bool = True) -> int:
    """The interval rule on a ``counts``-plane count: M0's subtraction (2
    ops per plane, where ``m0`` says it is made), ``comparators``
    comparators of 1 op per plane, an and-not per interval and an OR per
    further interval of each set, and the final select."""
    ops = 2 * counts if m0 and not rule.middle else 0
    ops += comparators * counts
    for intervals in (rule.born_intervals, rule.survive_intervals):
        ops += len(intervals) + max(len(intervals) - 1, 0)
    return ops + 1


def ltl_tree_ops_per_word(rule) -> int:
    """The same count for one generation of a binary LtL rule, walking
    packed_ltl's formulation with only the plane counts of its bit-sliced
    numbers: box_counts_packed (a carry-save sum of the 2r+1 row-shifted
    planes, full and half adders 2 ops each, then _sliding_sum_bs's two
    one-sided doubling trees of funnel shifts (1 op per plane) and ripple
    adds (2 ops per bit)) or diamond_counts_packed (r+1 shrinking sliding
    sums of pre-added row pairs), then _apply_intervals (M0's subtraction,
    2 ops per plane; a comparator per interval bound inside the count's
    range, 1 op per plane; an and-not per interval, an OR per further
    interval; the final select)."""
    ops = 0

    def csa(n: int) -> int:             # packed.bit_sliced_sum of n planes
        nonlocal ops
        planes, more = _csa_ops(n)
        ops += more
        return planes

    def add(a: int, b: int) -> int:     # packed_ltl.bs_add
        nonlocal ops
        ops += 2 * max(a, b)
        return max(a, b) + 1

    def one_sided(num: int, r: int) -> int:   # _one_sided_sum_bs
        nonlocal ops
        ops += num
        pows, m = {1: num}, 1
        while 2 * m <= r:
            ops += pows[m]
            pows[2 * m] = add(pows[m], pows[m])
            m *= 2
        acc, offset = None, 0
        for p2 in sorted(pows, reverse=True):
            while r - offset >= p2:
                ops += pows[p2] if offset else 0
                acc = pows[p2] if acc is None else add(acc, pows[p2])
                offset += p2
        return acc

    def sliding(num: int, k: int) -> int:     # _sliding_sum_bs
        r = (k - 1) // 2
        if r == 0:
            return num
        return add(add(one_sided(num, r), one_sided(num, r)), num)

    r = rule.radius
    if rule.neighborhood == "M":
        counts = sliding(csa(2 * r + 1), 2 * r + 1)
    else:
        nbits = (2 * r * r + 2 * r + 1).bit_length()
        counts = None
        for d in range(r + 1):
            term = sliding(1 if d == 0 else csa(2), 2 * (r - d) + 1)
            counts = term if counts is None else min(add(counts, term), nbits)
    comparators = sum(1 for intervals in (rule.born_intervals,
                                          rule.survive_intervals)
                      for lo, hi in intervals for c in (lo, hi + 1)
                      if 0 < c < 1 << counts)
    return ops + _rule_ops(rule, counts, comparators)


def ltl_sliding_ops_per_word(rule) -> int:
    """The same count by the sliding column, the order of kernel B4 and of
    packed_ltl.box_counts_sliding. Box: each row's horizontal window once
    (2r funnel shifts, 1 op each, and the carry-save sum of the 2r+1
    planes), added to a running count of C = bit_length((2r+1)^2) planes
    and the leaving row's window subtracted (2 ops per count plane each);
    diamond: the 2r+1 row windows of half-width r - |dy| summed directly
    (the same windows, 2r ripple adds of 2 ops per count plane). Then the
    rule on the distinct boundaries of both sets, shared between them: one
    comparator of 1 op per count plane for each boundary inside the
    count's range, and the and-nots, ORs and select of _rule_ops. M0 costs
    nothing: its survival boundaries move up by one instead
    (cuda_stencil._ltl_rule_encoding)."""
    r = rule.radius

    def window(a: int) -> int:
        return 2 * a + _csa_ops(2 * a + 1)[1]

    if rule.neighborhood == "M":
        counts = ((2 * r + 1) ** 2).bit_length()
        ops = window(r) + 2 * (2 * counts)
    else:
        counts = (2 * r * r + 2 * r + 1).bit_length()
        ops = sum(window(r - abs(dy)) for dy in range(-r, r + 1)) \
            + 2 * r * 2 * counts
    shift = 0 if rule.middle else 1
    bounds = {c for lo, hi in rule.born_intervals for c in (lo, hi + 1)} | {
        c + shift for lo, hi in rule.survive_intervals for c in (lo, hi + 1)}
    return ops + _rule_ops(rule, counts,
                           sum(1 for c in bounds if 0 < c < 1 << counts), m0=False)


def ltl_ops_per_word(rule) -> int:
    """The least bitwise operations one generation of a binary LtL rule
    needs per 32-cell word by a formulation the repo has: the JAX doubling
    tree (:func:`ltl_tree_ops_per_word`) or the sliding column
    (:func:`ltl_sliding_ops_per_word`)."""
    return min(ltl_tree_ops_per_word(rule), ltl_sliding_ops_per_word(rule))


def rule_from_config(config: dict) -> types.SimpleNamespace:
    """The attributes the formulas read, from a configuration file: a
    life-like rule (radius 1 without the centre) as born and survive
    sets, any other Moore box rule as Larger than Life intervals."""
    hood = config["neighbourhood"]
    born = [tuple(iv) for iv in config["born"]]
    survive = [tuple(iv) for iv in config["survive"]]
    if hood["radius"] == 1 and not hood["include_center"]:
        return types.SimpleNamespace(
            family="life-like",
            born=frozenset(c for lo, hi in born for c in range(lo, hi + 1)),
            survive=frozenset(c for lo, hi in survive
                              for c in range(lo, hi + 1)))
    return types.SimpleNamespace(
        family="ltl", radius=int(hood["radius"]),
        neighborhood="M" if hood["shape"] == "moore" else "N",
        middle=bool(hood["include_center"]),
        born_intervals=tuple(born), survive_intervals=tuple(survive))


def rule_ops_per_word(rule) -> int:
    """Operations per word and generation of ``rule``'s family formula."""
    if rule.family == "ltl":
        return ltl_ops_per_word(rule)
    return ops_per_word(rule)


def work(rule, words: int, generations: int, launches: int) -> dict:
    """The work ``launches`` launches need to step ``words`` words of
    state ``generations`` generations in all: the bitwise operations,
    and the bytes of the state read once and written once per launch."""
    return {"ops": float(generations) * words * rule_ops_per_word(rule),
            "bytes": float(launches) * 2 * words * 4}
