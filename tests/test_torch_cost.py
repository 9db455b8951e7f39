"""``Engine.runner_cost_analysis``: the packed formulation's operation and
byte counts for each rule family, the same for every backend that steps
the rule on the grid (the ``"cuda"`` engine is built here by letting the
kernels claim the CPU; the count never launches them), None for the
activity-tiled engines; and ``chip_smoke.py`` imports the formulas from
``obs/cost.py`` and holds no copy of them."""

import ast
import os

import numpy as np
import pytest

import chip_smoke
from gameoflifewithactors_torch import engine as t_engine
from gameoflifewithactors_torch.engine import Engine
from gameoflifewithactors_torch.models.generations import parse_any
from gameoflifewithactors_torch.obs import cost
from gameoflifewithactors_torch.obs.report import build_run_report
from gameoflifewithactors_torch.parallel.mesh import make_mesh

SHAPE = (48, 96)
_FORMULAS = ("ops_per_word", "gen_ops_per_word", "_csa_ops", "_rule_ops",
             "ltl_tree_ops_per_word", "ltl_sliding_ops_per_word",
             "ltl_ops_per_word")


def _grid(states=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, SHAPE).astype(np.uint8)


@pytest.mark.parametrize("spec,states,opw", [
    ("B3/S23", 2, 20), ("brain", 3, 27), ("bosco", 2, 78),
    ("R7,C0,M1,S20..60,B25..50,NN", 2, None)])
def test_cost_per_family_equal_across_backends(spec, states, opw,
                                               monkeypatch):
    rule = parse_any(spec)
    want = opw or cost.ltl_ops_per_word(rule)
    planes = 2 if states == 3 else 1
    words = SHAPE[0] * SHAPE[1] // 32
    expected = {"generations": 8, "flops": float(8 * words * want),
                "bytes_accessed": float(2 * planes * words * 4),
                "ops_kind": "bitwise", "ops_per_word": want,
                "planes": planes}
    monkeypatch.setattr(t_engine, "_kernels_run_on", lambda device: True)
    for backend in ("cuda", "packed", "dense"):
        eng = Engine(_grid(states), spec, backend=backend, device="cpu")
        assert eng.runner_cost_analysis() == expected, backend
    eng = Engine(_grid(states), spec, backend="packed", device="cpu",
                 mesh=make_mesh((2, 1), ["cpu"] * 2))
    assert eng.runner_cost_analysis(gens=16)["flops"] == 2 * expected["flops"]


def test_tiled_engines_and_multistate_ltl_have_no_static_cost():
    for backend in ("sparse", "paged"):
        eng = Engine(_grid(), "B3/S23", backend=backend, device="cpu",
                     sparse_opts={"tile_rows": 16, "tile_words": 1})
        assert eng.runner_cost_analysis() is None, backend
    eng = Engine(_grid(3), "R2,C3,S6-9,B7-8", device="cpu")
    assert eng.runner_cost_analysis() is None


def test_the_report_roofline_reads_the_engine_cost():
    eng = Engine(_grid(), "B3/S23", device="cpu")
    rec = {"generation": 8, "generations_stepped": 8, "wall_seconds": 0.5,
           "cell_updates_per_sec": SHAPE[0] * SHAPE[1] * 8 / 0.5}
    roof = build_run_report(engine=eng, step_records=[rec]).roofline
    ca = roof["cost_analysis"]
    assert ca["flops_per_gen"] == SHAPE[0] * SHAPE[1] // 32 * 20
    assert ca["ops_kind"] == "bitwise"
    assert roof["achieved"]["flops_per_sec"] == pytest.approx(
        ca["flops_per_gen"] * 16)        # 16 generations per second
    assert roof["platform"] == "cpu" and roof["peak_modelled"] is None


def test_chip_smoke_imports_the_formulas_and_holds_no_copy():
    for name in _FORMULAS:
        if hasattr(chip_smoke, name):
            assert getattr(chip_smoke, name) is getattr(cost, name), name
    assert chip_smoke.ops_per_word is cost.ops_per_word
    assert chip_smoke.ltl_ops_per_word is cost.ltl_ops_per_word
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)}
    assert not defined & set(_FORMULAS + ("_device_activity",
                                          "device_activity"))
    from gameoflifewithactors_torch.utils import profiling
    assert chip_smoke.device_activity is profiling.device_activity
