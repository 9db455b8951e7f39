"""The plain reference against hand-worked patterns and brute force."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from benchmark import manifest
from benchmark.reference import box_rule, life_packed

CONWAY = box_rule.BoxRule(1, ((3, 3),), ((3, 4),))     # counts include the cell


def grid(shape, cells):
    g = torch.zeros(shape, dtype=torch.uint8)
    for r, c in cells:
        g[r, c] = 1
    return g


def brute(cells: np.ndarray, r: int, include_center: bool, born, survive,
          torus=True) -> np.ndarray:
    """The rule as a configuration states it, cell by cell."""
    h, w = cells.shape
    out = np.zeros_like(cells)
    for y, x in itertools.product(range(h), range(w)):
        count = 0
        for dy, dx in itertools.product(range(-r, r + 1), repeat=2):
            if (dy, dx) == (0, 0) and not include_center:
                continue
            yy, xx = y + dy, x + dx
            if torus:
                count += cells[yy % h, xx % w]
            elif 0 <= yy < h and 0 <= xx < w:
                count += cells[yy, xx]
        ivs = survive if cells[y, x] else born
        out[y, x] = any(lo <= count <= hi for lo, hi in ivs)
    return out


def test_blinker_oscillates():
    g = grid((5, 5), [(2, 1), (2, 2), (2, 3)])
    once = box_rule.step(g, CONWAY)
    assert once.tolist() == grid((5, 5), [(1, 2), (2, 2), (3, 2)]).tolist()
    assert box_rule.step(once, CONWAY).tolist() == g.tolist()


def test_glider_wraps_the_torus():
    glider = [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]
    g = grid((8, 8), glider)
    # a glider moves one cell down and right every 4 generations; 32
    # generations take it round the 8 x 8 torus and home again
    assert box_rule.run(g, CONWAY, 4).tolist() == grid(
        (8, 8), [(r + 1, c + 1) for r, c in glider]).tolist()
    assert box_rule.run(g, CONWAY, 32).tolist() == g.tolist()
    dead = box_rule.run(g, CONWAY, 32, torus=False)
    assert dead.tolist() != g.tolist()


@pytest.mark.parametrize("name,shape", [("conway-b3s23", (9, 11)),
                                        ("bosco-r5", (14, 13))])
@pytest.mark.parametrize("torus", [True, False])
def test_step_against_brute_force(name, shape, torus):
    config = manifest.config(manifest.load(), name)
    rule = box_rule.BoxRule.from_config(config)
    hood = config["neighbourhood"]
    gen = torch.Generator().manual_seed(5)
    cells = (torch.rand(shape, generator=gen) < 0.4).to(torch.uint8)
    got = box_rule.step(cells, rule, torus=torus).numpy()
    want = brute(cells.numpy(), hood["radius"], hood["include_center"],
                 config["born"], config["survive"], torus)
    assert (got == want).all()


@pytest.mark.parametrize("shape", [(9, 32), (17, 96), (40, 64)])
def test_packed_life_against_brute_force(shape):
    config = manifest.config(manifest.load(), "conway-b3s23")
    born, survive = life_packed.counts_of(config)
    gen = torch.Generator().manual_seed(7)
    cells = (torch.rand(shape, generator=gen) < 0.4).to(torch.uint8)
    words = box_rule.pack_cells(cells)
    want = cells.numpy()
    for _ in range(3):
        words = life_packed.step(words, born, survive)
        want = brute(want, 1, False, config["born"], config["survive"])
    assert (box_rule.unpack_words(words).numpy() == want).all()


def test_packed_life_takes_a_batch_and_other_rules():
    highlife = (frozenset({3, 6}), frozenset({2, 3}))
    gen = torch.Generator().manual_seed(8)
    cells = (torch.rand((3, 20, 64), generator=gen) < 0.5).to(torch.uint8)
    got = box_rule.unpack_words(life_packed.run(
        box_rule.pack_cells(cells), *highlife, 4))
    rule = box_rule.BoxRule(1, ((3, 3), (6, 6)), ((3, 4),))
    assert torch.equal(got, box_rule.run(cells, rule, 4))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 11])
def test_window_sums(k):
    x = torch.randint(0, 2, (3, 20), dtype=torch.uint8)
    want = torch.stack([x[:, i:i + k].sum(1) for i in range(20 - k + 1)], 1)
    assert box_rule.window_sums(x, k, -1).tolist() == want.to(torch.uint8).tolist()


def test_pack_round_trip_and_the_programs_layout():
    from gameoflifewithactors_torch.ops import bitpack

    cells = torch.randint(0, 2, (2, 5, 96), dtype=torch.uint8)
    words = box_rule.pack_cells(cells)
    assert words.dtype == torch.int32 and words.shape == (2, 5, 3)
    assert box_rule.unpack_words(words).tolist() == cells.tolist()
    assert torch.equal(words[0], bitpack.pack(cells[0]))
    one = torch.zeros((1, 32), dtype=torch.uint8)
    one[0, 31] = 1
    assert int(box_rule.pack_cells(one)[0, 0]) == -2**31


def test_packed_life_with_dead_edges_against_brute_force():
    config = manifest.config(manifest.load(), "conway-b3s23")
    born, survive = life_packed.counts_of(config)
    gen = torch.Generator().manual_seed(4)
    cells = (torch.rand((2, 12, 64), generator=gen) < 0.5).to(torch.uint8)
    got = box_rule.unpack_words(life_packed.run(
        box_rule.pack_cells(cells), born, survive, 1, torus=False))
    for i in range(2):
        want = brute(cells[i].numpy(), 1, False, config["born"],
                     config["survive"], torus=False)
        assert (got[i].numpy() == want).all()


def generations_config(born, survive, states):
    """A Generations rule as a configuration file states it: counts of
    the eight neighbours in state 1, as inclusive intervals."""
    return {"neighbourhood": {"shape": "moore", "radius": 1,
                              "include_center": False},
            "born": [[c, c] for c in sorted(born)],
            "survive": [[c, c] for c in sorted(survive)],
            "states": states, "reference": "generations"}


def brute_generations(cells: np.ndarray, born, survive, states,
                      torus=True) -> np.ndarray:
    """A Generations rule, cell by cell: only state 1 counts."""
    h, w = cells.shape
    out = np.zeros_like(cells)
    for y, x in itertools.product(range(h), range(w)):
        count = 0
        for dy, dx in itertools.product((-1, 0, 1), repeat=2):
            yy, xx = y + dy, x + dx
            if (dy, dx) == (0, 0):
                continue
            if torus:
                count += cells[yy % h, xx % w] == 1
            elif 0 <= yy < h and 0 <= xx < w:
                count += cells[yy, xx] == 1
        s = int(cells[y, x])
        if s == 0:
            out[y, x] = 1 if count in born else 0
        elif s == 1:
            out[y, x] = 1 if count in survive else 2 % states
        else:
            out[y, x] = (s + 1) % states
    return out


GENERATIONS_RULES = {
    "brians-brain": ({2}, set(), 3),            # B2/S/C3
    "star-wars": ({2}, {3, 4, 5}, 4),           # B2/S345/C4
    "life-c2": ({3}, {2, 3}, 2),                # B3/S23
}


@pytest.mark.parametrize("name", sorted(GENERATIONS_RULES))
@pytest.mark.parametrize("torus", [True, False])
def test_generations_against_brute_force(name, torus):
    from benchmark.reference import generations

    born, survive, states = GENERATIONS_RULES[name]
    config = generations_config(born, survive, states)
    run = generations.stepper(config)
    gen = torch.Generator().manual_seed(11)
    cells = torch.randint(0, states, (12, 64), generator=gen,
                          dtype=torch.uint8)
    state = generations.encode(cells, config)
    want = cells.numpy()
    for _ in range(4):
        state = run(state, 1, torus)
        want = brute_generations(want, born, survive, states, torus)
        got = generations.decode(state, generations.planes(config))
        assert (got.numpy() == want).all()


@pytest.mark.parametrize("torus", [True, False])
def test_generations_with_two_states_is_life_packed_bit_for_bit(torus):
    from benchmark.reference import generations

    born, survive, states = GENERATIONS_RULES["life-c2"]
    config = generations_config(born, survive, states)
    assert generations.planes(config) == 1
    gen = torch.Generator().manual_seed(12)
    words = box_rule.pack_cells(
        (torch.rand((3, 20, 96), generator=gen) < 0.4).to(torch.uint8))
    got = generations.stepper(config)(words, 6, torus)
    want = life_packed.run(words, frozenset(born), frozenset(survive), 6,
                           torus)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("states", [2, 3, 4, 5, 8, 17, 256])
def test_generations_encode_then_decode_is_the_identity(states):
    from benchmark.reference import generations

    config = generations_config({2}, set(), states)
    b = generations.planes(config)
    assert b == max(1, (states - 1).bit_length())
    cells = (torch.arange(2 * 16 * 64) % states).to(torch.uint8).reshape(
        2, 16, 64)
    state = generations.encode(cells, config)
    assert state.shape == ((2, 16, 2) if b == 1 else (2, b, 16, 2))
    assert torch.equal(generations.decode(state, b), cells)


def test_generations_layout_is_the_programs():
    from gameoflifewithactors_torch.models.generations import (
        parse_generations)
    from gameoflifewithactors_torch.ops.packed_generations import (
        pack_generations_for)
    from benchmark.reference import generations

    rule = parse_generations("B2/S345/C4")
    config = generations_config({2}, {3, 4, 5}, 4)
    cells = torch.randint(0, 4, (9, 64), dtype=torch.uint8)
    assert torch.equal(generations.encode(cells, config),
                       pack_generations_for(cells, rule))
