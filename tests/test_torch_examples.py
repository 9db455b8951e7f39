"""The port's ten demos (``gameoflifewithactors_torch/examples/``) against
the JAX package's (``examples/``), each run in-process through its
``main``/``run`` at the same toy arguments: stdout line for line with
only the timing fields and paths masked, tolerance 0 (populations,
densities, generations, pages, the W90 diagram). Where a demo holds a
grid, the port's final state is also held bit for bit against the JAX
engine's, built from the same numpy input. The port runs with
``--device cpu``; the mesh demos run on the conftest's eight fake JAX CPU
devices and on ``--positions 8`` CPU positions of the port. No JAX demo
here runs at a ``(64, 64)`` B3/S23 grid (``tests/test_aot.py`` wants that
packed runner cold)."""

import json
import re

import numpy as np
import pytest
import torch

_MASKS = (
    (re.compile(r"\(\s*[0-9.]+ gens/s\)"), "(<rate> gens/s)"),
    (re.compile(r"[0-9.]+e[+-][0-9]+ cell-updates/s"), "<rate> cell-updates/s"),
    (re.compile(r"-> \S+"), "-> <path>"),
)


def _mask(text):
    lines = []
    for line in text.splitlines():
        for pattern, repl in _MASKS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


def _both(name, capsys, argv, port_argv=()):
    """(JAX demo's masked stdout lines, port demo's, port's ``run`` result)."""
    import importlib

    jax_demo = importlib.import_module(f"examples.{name}")
    port_demo = importlib.import_module(
        f"gameoflifewithactors_torch.examples.{name}")
    capsys.readouterr()
    jax_rc = jax_demo.main(list(argv))
    want = _mask(capsys.readouterr().out)
    got_run = port_demo.run(list(argv) + ["--device", "cpu"] + list(port_argv))
    got = _mask(capsys.readouterr().out)
    return want, got, got_run, jax_rc


@pytest.mark.parametrize("argv", [
    ["--rule", "W90", "--width", "64", "--steps", "16"],
    ["--rule", "W30", "--width", "96", "--steps", "24", "--seed", "random"],
], ids=["W90-center", "W30-random"])
def test_wolfram_prints_the_jax_diagram(capsys, argv):
    want, got, res, _ = _both("wolfram", capsys, argv)
    assert got == want
    assert res["image"].shape == (int(argv[5]) + 1, int(argv[3]))
    if argv[1] == "W90":
        # generation 16 of rule 90 has exactly 2 live cells (2^popcount(16))
        assert got[16].count("#") == 2


def test_ltl_zoo_matches_and_holds_every_final_grid(capsys):
    import gameoflifewithactors_tpu as jgol

    # at the default fill both binary rules die out by generation 6
    argv = ["--side", "64", "--gens", "6", "--fill", "0.5"]
    want, got, finals, _ = _both("ltl_zoo", capsys, argv)
    assert got == want and len(got) == 3 and "decay" in got[2]
    assert all(int(line.split("pop")[1]) > 0 for line in got)
    soup = (np.random.default_rng(0).random((64, 64)) < 0.5).astype(np.uint8)
    for spec, grid in finals.items():
        e = jgol.Engine(soup, spec)
        e.step(6)
        np.testing.assert_array_equal(grid, np.asarray(e.snapshot()))


def test_checkpoint_resume_matches_and_holds_the_final_grid(capsys):
    import gameoflifewithactors_tpu as jgol
    from gameoflifewithactors_tpu.models import seeds

    want, got, res, _ = _both("checkpoint_resume", capsys,
                              ["--side", "96", "--gens", "20"])
    assert got == want
    assert "resumed == uninterrupted: True" in got[-1]
    e = jgol.Engine(np.asarray(seeds.seeded((96, 96), "gosper_gun", 8, 8)),
                    "B3/S23")
    e.step(20)
    np.testing.assert_array_equal(res["resumed"], np.asarray(e.snapshot()))
    np.testing.assert_array_equal(res["uninterrupted"], res["resumed"])


def test_sparse_gun_prints_the_jax_populations(capsys):
    want, got, res, _ = _both("sparse_gun", capsys,
                              ["--side", "256", "--gens", "90",
                               "--report-every", "45"])
    assert got == want
    # after 90 gens the gun (36 cells) has emitted 3 gliders (5 cells each)
    assert res["pops"][-1] == (90, 51)
    assert res["engine"].backend == "sparse"


def test_ensemble_prints_the_jax_densities(capsys):
    want, got, res, _ = _both("ensemble", capsys,
                              ["--batch", "3", "--side", "96", "--gens", "10",
                               "--report-every", "4"])
    assert got == want and len(got) == 3 and "gen    10" in got[-1]
    assert res["grids"].shape == (3, 96, 96)
    # the lane form's plain version against the plain batched runner
    from gameoflifewithactors_torch.models.rules import parse_rule
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.parallel import batched

    soups = np.random.default_rng(0).integers(0, 2, size=(3, 96, 96),
                                              dtype=np.uint8)
    words = torch.stack([bitpack.pack(torch.from_numpy(u)) for u in soups])
    plain = batched.make_multi_step_packed_batched(parse_rule("B3/S23"))(
        words, 10)
    np.testing.assert_array_equal(
        res["grids"], torch.stack([bitpack.unpack(p) for p in plain]).numpy())


def test_telemetry_report_fields_match(tmp_path, capsys):
    from examples.telemetry import main as jax_main

    from gameoflifewithactors_torch.examples.telemetry import run

    def lines():
        return capsys.readouterr().out.splitlines()

    args = ["--side", "96", "--gens", "8", "--ticks", "4", "--stall-demo"]
    jax_main(args + ["--out", str(tmp_path / "jax.json")])
    want = lines()
    res = run(args + ["--out", str(tmp_path / "port.json"), "--device",
                      "cpu"])
    got = lines()
    # the watchdog diagnostic, word for word
    assert got[0] == want[0] and "last completed span:" in got[0]
    assert res["stall"].label == "tick@gen8+1"
    for prefix in ("config:", "halo bytes/gen:", "report written:"):
        pick = [[x for x in side if x.startswith(prefix)] for side in (want, got)]
        assert len(pick[1]) == 1
        if prefix != "report written:":
            assert pick[0] == pick[1]
    jrep = json.load(open(tmp_path / "jax.json"))
    prep = json.load(open(tmp_path / "port.json"))
    counts = [{k: v["count"] for k, v in r["phase_seconds"].items()}
              for r in (jrep, prep)]
    assert counts[1] == counts[0]
    assert counts[1]["coordinator.tick"] == 4 and counts[1]["scheduler.run"] == 1
    assert len(prep["step_metrics"]) == len(jrep["step_metrics"]) == 4
    assert prep["config"] == jrep["config"]
    assert (tmp_path / "port.trace.json").exists()
    assert (tmp_path / "jax.trace.json").exists()


def test_unbounded_glider_matches_and_holds_the_flown_cells(capsys):
    from gameoflifewithactors_tpu.memory import PagedUniverse, TilePool
    from gameoflifewithactors_tpu.models.generations import parse_any
    from gameoflifewithactors_tpu.serve.lanes import paged_lane_runner

    argv = ["--gens", "128", "--report-every", "32", "--capacity", "32"]
    want, got, res, jax_rc = _both("unbounded_glider", capsys, argv)
    assert got == want and res["rc"] == jax_rc == 0
    assert "(796 bytes, 9 pages)" in got[2]
    rule = parse_any("B3/S23")
    u = PagedUniverse(rule, pool=TilePool(
        rule, 32, tile_rows=16, tile_words=1, name="glider-truth",
        runner=paged_lane_runner(rule, 16, 1)))
    cells = np.zeros((8, 8), np.uint8)
    for y, x in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        cells[y, x] = 1
    u.seed_cells(cells, origin=(1, 1))
    u.step(128)
    origin, snap = u.snapshot_cells()
    for port_u in (res["universe"], res["twin"]):
        p_origin, p_snap = port_u.snapshot_cells()
        assert p_origin == origin
        np.testing.assert_array_equal(p_snap, np.asarray(snap))


def test_long_row_matches_on_eight_positions(capsys):
    want, got, finals, _ = _both(
        "long_row", capsys,
        ["--cells", "2048", "--gens", "64", "--rules", "W30,W184"],
        ["--positions", "8"])
    assert got == want and "8 devices" in got[0]
    assert sorted(finals) == ["W184", "W30"]


def test_fault_recovery_matches_and_holds_the_replayed_grid(capsys):
    import jax

    import gameoflifewithactors_tpu as jgol
    from gameoflifewithactors_tpu.parallel import mesh as jmesh

    argv = ["--side", "96", "--gens", "24", "--checkpoint-every", "4"]
    want, got, res, _ = _both("fault_recovery", capsys, argv,
                              ["--positions", "8"])
    assert got == want
    assert "dropped device shard 4 of 8" in got[0]
    assert got[-1] == "final state bit-identical to the unfaulted run"
    grid = np.random.default_rng(2026).integers(0, 2, size=(96, 192),
                                                dtype=np.uint8)
    e = jgol.Engine(grid, "B3/S23",
                    mesh=jmesh.make_mesh((8, 1), jax.devices()))
    e.step(24)
    np.testing.assert_array_equal(res["replayed"], np.asarray(e.snapshot()))


def test_distributed_bands_matches_every_layout(capsys):
    want, got, finals, _ = _both("distributed_bands", capsys,
                                 ["--side", "256", "--gens", "4"],
                                 ["--positions", "8"])
    # halo bytes per generation and populations, layout for layout
    assert got == want and len(got) == 3
    assert [b for b, _ in finals.values()] == ["packed", "cuda", "cuda"]
    grids = [g for _, g in finals.values()]
    assert all(np.array_equal(grids[0], g) for g in grids[1:])


def test_every_demo_raises_without_a_card(monkeypatch):
    import importlib

    from gameoflifewithactors_torch import examples

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = ["wolfram", "ltl_zoo", "checkpoint_resume", "sparse_gun",
             "ensemble", "telemetry", "unbounded_glider", "long_row",
             "fault_recovery", "distributed_bands"]
    for name in names:
        demo = importlib.import_module(f"{examples.__name__}.{name}")
        assert callable(demo.main)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo.run([])
