"""The operation count behind kernel B4's bound (``obs/cost.py``, which
``chip_smoke.py`` and the roofline import): the
least over the two formulations the repo has, the JAX doubling tree and
the sliding column of the kernel. Hand counts pin both, and no rule's
count may exceed the doubling tree's (the bound only tightens)."""

import chip_smoke
from gameoflifewithactors_torch.obs import cost
from gameoflifewithactors_torch.models.generations import parse_any

_NAMED = ["bosco", "majority", "R7,C0,M1,S20..60,B25..50,NN",
          "R1,C0,M1,S2..3,B3..3", "R3,C0,M0,S10..20,B12..16",
          "R2,C2,S6-9,12-14,B7-8,11", "R1,C2,S,B1-8", "R2,C0,M0,S6..11,B6..9,NN"]


def test_bosco_counts_78_operations_by_the_sliding_column():
    bosco = parse_any("bosco")
    window = 10 + 2 * (5 + 2 + 1)   # 10 funnel shifts; CSA of 11: 5, 2, 1 adders
    slide = 2 * (2 * 7)             # add and subtract on 7 count planes
    rule = 3 * 7 + 2 + 1            # boundaries 34, 46, 59; two and-nots; select
    assert window + slide + rule == 78
    assert cost.ltl_sliding_ops_per_word(bosco) == 78
    assert cost.ltl_ops_per_word(bosco) == 78


def test_diamond_counts_its_row_windows_directly():
    rule = parse_any("R1,C0,M1,S1..2,B1..2,NN")
    windows = 2 + 2                 # the centre row: 2 shifts, one full adder
    adds = 2 * (2 * 3)              # two more rows into a 3-plane count
    comparators = 2 * 3 + 2 + 1     # boundaries 1 and 3, shared; two and-nots; select
    assert cost.ltl_sliding_ops_per_word(rule) == windows + adds + comparators


def test_the_doubling_tree_keeps_its_counts():
    for name, ops in [("bosco", 179), ("majority", 137),
                      ("R7,C0,M1,S20..60,B25..50,NN", 519)]:
        assert cost.ltl_tree_ops_per_word(parse_any(name)) == ops, name


def test_no_rule_counts_more_than_the_doubling_tree():
    rules = [parse_any(name) for name in _NAMED] + chip_smoke.ltl_every_form()
    assert len(rules) == len(_NAMED) + 28
    for rule in rules:
        ops = cost.ltl_ops_per_word(rule)
        assert 0 < ops <= cost.ltl_tree_ops_per_word(rule), rule.notation
        assert ops == min(cost.ltl_tree_ops_per_word(rule),
                          cost.ltl_sliding_ops_per_word(rule))
    assert cost.ltl_ops_per_word(parse_any("majority")) < 137
    assert cost.ltl_ops_per_word(
        parse_any("R7,C0,M1,S20..60,B25..50,NN")) < 519
