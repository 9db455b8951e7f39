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
