"""The comparison on stacks of bit-planes, and references found by name.

A Generations configuration holds each cell's state in b bit-planes
``(..., b, H, W/32)``; a cell counts once however many of its planes
differ. A reference is a file found by the name its configuration gives,
in a copy of the benchmark too. Brian's Brain, a configuration built
here and not in ``BENCHMARK.json``, is driven through the batch driver
on the CPU at a small size: sound, it is correct; with its step
returning the state unchanged, under the control, or with one plane
altered, it is not.
"""

from __future__ import annotations

import shutil

import pytest
import torch

from benchmark import check, manifest, run
from benchmark.chip import control
from benchmark.reference import generations

BRAIN = {
    "name": "brain-b2-c3", "rule": "B2/S/C3", "states": 3,
    "neighbourhood": {"shape": "moore", "radius": 1, "include_center": False},
    "born": [[2, 2]], "survive": [], "topology": "torus",
    "layout": "planes: bit i of cell (r, 32j+k)'s state is bit k of int32 "
              "word (i, r, j), 2 planes",
    "reference": "generations", "reduced": [],
}
SEED = 2**31 + 29


def random_state(shape, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return generations.encode(
        torch.randint(0, 3, shape, generator=gen, dtype=torch.uint8), BRAIN)


def test_a_cell_wrong_in_both_planes_counts_once():
    want = random_state((8, 64))
    assert want.shape == (2, 8, 2)
    got = want.clone()
    got[:, 3, 1] ^= 1 << 5          # one cell, both planes
    assert check.mismatched_cells(want, got, planes=2) == 1
    got[1, 6, 0] ^= 1 << 30         # another, its upper plane only
    assert check.mismatched_cells(want, got, planes=2) == 2
    # read as two grids of one plane, the same stacks differ in 3 bits
    assert check.mismatched_cells(want, got) == 3
    assert check.mismatched_cells(want, want.clone(), planes=2) == 0


def test_a_state_of_another_shape_is_refused():
    want = random_state((8, 64))
    with pytest.raises(ValueError, match="shape"):
        check.mismatched_cells(want, want[0], planes=2)


def test_the_reference_is_the_one_its_configuration_names():
    for name, planes in (("conway-b3s23", 1), ("bosco-r5", 1)):
        reference = check.Reference(manifest.config(manifest.load(), name))
        assert reference.planes == planes
    reference = check.Reference(BRAIN)
    assert reference.module is generations and reference.planes == 2
    with pytest.raises(FileNotFoundError, match="no_such_rule.py"):
        check.Reference(dict(BRAIN, reference="no_such_rule"))


def test_a_reference_added_in_a_copy_is_found_by_name(tmp_path):
    """A later PR adds a reference as a file: found by the name in its
    configuration, with no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "_work",
                                                  "__pycache__"))
    folder = root / "benchmark" / "reference"
    (folder / "brain_copy.py").write_text(
        (folder / "generations.py").read_text())
    config = dict(BRAIN, reference="brain_copy")
    with pytest.raises(FileNotFoundError, match="brain_copy.py"):
        check.Reference(config)
    reference = check.Reference(config, str(folder))
    assert reference.module.__file__ == str(folder / "brain_copy.py")
    assert reference.planes == 2
    state = random_state((16, 64))
    assert torch.equal(reference.run(state, 5),
                       check.Reference(BRAIN).run(state, 5))
    assert torch.equal(reference.run(state, 5, torus=False),
                       check.Reference(BRAIN).run(state, 5, torus=False))


def test_torus_rows_keep_the_planes():
    stack = torch.arange(24, dtype=torch.int32).reshape(2, 12, 1)
    bands = list(stack.split(3, dim=-2))
    got = check.torus_rows(bands, -4, 10, torch.device("cpu"))
    assert got.shape == (2, 10, 1)
    rows = [8, 9, 10, 11, 0, 1, 2, 3, 4, 5]
    assert got[0].flatten().tolist() == rows
    assert got[1].flatten().tolist() == [12 + r for r in rows]


def test_bands_of_a_stack_checked_apart_agree_with_the_whole_torus():
    reference = check.Reference(BRAIN)
    grid = random_state((4 * 16, 64), seed=4)
    want = reference.run(grid, 6)
    bands = list(grid.split(16, dim=-2))
    after = [b.clone() for b in want.split(16, dim=-2)]
    assert check.compare_bands(reference, bands, after, 6) == 0
    after[1][1, 15, 1] ^= 1 << 9
    assert check.compare_bands(reference, bands, after, 6) == 1


def drive_brain(seed: int = SEED) -> tuple:
    """A run of Brian's Brain on the batch driver's cell shape, at 128²
    with ticks of 8 generations, on the CPU."""
    bench = manifest.load()
    traffic = dict(manifest.traffic("batch-16384"), shape=[128, 128],
                   tick_generations=8)
    spec = run.RunSpec(cell="brain-batch-16384", config=BRAIN,
                       traffic=traffic, seed=seed, seconds=0.3, trace=False,
                       devices=[torch.device("cpu")])
    out = run.drive(spec)
    return run.result_line(bench, spec, out, {"platform": "cpu"}), out["ctx"]


def test_brians_brain_sound_is_correct():
    line, ctx = drive_brain()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1
    assert ctx["planes"] == 2 and ctx["words"] == 128 * 4


def _unchanged(monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    monkeypatch.setattr(Engine, "_run", lambda self, state, n: state)


def _control(monkeypatch):
    control.install(manifest.traffic("batch-16384"), BRAIN,
                    monkeypatch.setattr)


def _upper_plane_altered(monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    real = Engine._run

    def flipped(self, state, n):
        out = real(self, state, n).clone()
        out[1].view(-1)[7] ^= 1 << 3
        return out

    monkeypatch.setattr(Engine, "_run", flipped)


@pytest.mark.parametrize("fault", [_unchanged, _control,
                                   _upper_plane_altered])
def test_brians_brain_with_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, _ = drive_brain()
    assert not line["correct"]
    assert line["checks"]["start_mismatched_cells"]["value"] > 0
