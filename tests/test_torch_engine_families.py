"""The slice as a whole: the port's Engine, GridCoordinator and CLI on the
Generations and Larger-than-Life families against the JAX package on the
CPU — snapshots, population (state 1 only) and generation counts, the
backend ``auto`` picks, and a JAX engine's state handed over mid-run.
Grids are made with numpy from a seed; tolerance 0."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch.utils import interop
import gameoflifewithactors_tpu as jg

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cells(states, h, w, seed):
    return np.random.default_rng(seed).integers(0, states, size=(h, w),
                                                dtype=np.uint8)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_engine_matches_jax_for_brain_and_bosco(topology):
    for rule, states in [("brain", 3), ("bosco", 2), ("R2,C4,M1,S3..8,B5..9", 4)]:
        grid = _cells(states, 40, 64, seed=states)
        je = jg.Engine(grid, rule, topology=jg.Topology(topology))
        te = tg.Engine(grid, rule, topology=tg.Topology(topology), device="cpu")
        assert te.backend == je.backend, rule
        for n in (1, 6):
            je.step(n)
            te.step(n)
            np.testing.assert_array_equal(te.snapshot(), je.snapshot(), err_msg=rule)
            assert te.population() == je.population(), rule
        assert te.generation == je.generation == 7
        np.testing.assert_array_equal(te.snapshot(max_shape=(10, 20)),
                                      je.snapshot(max_shape=(10, 20)), err_msg=rule)


def test_auto_backend_on_cpu_is_the_jax_choice():
    for rule, width in [("brain", 64), ("brain", 40), ("bosco", 64), ("bosco", 40),
                        ("R2,C3,M1,S3..8,B5..9", 64), ("R4,C3,M1,S3..8,B5..9", 64),
                        ("R5,C3,M1,S3..8,B5..9,NN", 64), ("R2,C3,M1,S3..8,B5..9", 40)]:
        grid = np.zeros((8, width), np.uint8)
        assert tg.Engine(grid, rule, device="cpu").backend == \
            jg.Engine(grid, rule).backend, (rule, width)


def test_every_backend_matches_jax():
    """Explicit packed and dense for each family: the plane stack, the
    bit-sliced words and the byte paths all agree with the JAX engine."""
    for rule, states in [("starwars", 4), ("B2/S34/C5", 5), ("majority", 2),
                         ("R2,C0,M0,S6..11,B6..9,NN", 2), ("R1,C3,M0,S1..3,B2..2,NN", 3)]:
        grid = _cells(states, 24, 64, seed=10 + states)
        for backend in ("packed", "dense"):
            je = jg.Engine(grid, rule, backend=backend)
            te = tg.Engine(grid, rule, backend=backend, device="cpu")
            je.step(5)
            te.step(5)
            np.testing.assert_array_equal(te.snapshot(), je.snapshot(),
                                          err_msg=f"{rule} {backend}")
            assert te.population() == je.population()
            if backend == "packed":
                np.testing.assert_array_equal(interop.state_to_numpy(te.state),
                                              np.asarray(je.state))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_state_carried_mid_run_from_jax(topology):
    """JAX engine k steps -> port m steps == JAX k+m steps, for a
    Generations stack, LtL words and a C >= 3 LtL stack."""
    for rule, states in [("brain", 3), ("bosco", 2), ("R2,C4,M1,S3..8,B5..9", 4)]:
        grid = _cells(states, 32, 64, seed=20 + states)
        je = jg.Engine(grid, rule, topology=jg.Topology(topology), backend="packed")
        je.step(5)
        words = np.asarray(je.state)
        for backend in ("packed", "dense"):
            te = tg.Engine.from_packed(words, rule, topology=tg.Topology(topology),
                                       backend=backend, device="cpu")
            assert te.shape == (32, 64) and te.backend == backend
            te.step(7)
            if backend == "packed":
                je.step(7)
                np.testing.assert_array_equal(interop.state_to_numpy(te.state),
                                              np.asarray(je.state))
            np.testing.assert_array_equal(te.snapshot(), je.snapshot(),
                                          err_msg=f"{rule} {backend}")
            assert te.population() == je.population()


def test_from_packed_checks_the_layout_and_copies():
    brain = np.asarray(jg.Engine(_cells(3, 8, 64, 1), "brain").state)
    assert brain.shape == (2, 8, 2)
    with pytest.raises(ValueError, match="bit-plane stack"):
        tg.Engine.from_packed(brain[0], "brain", device="cpu")
    with pytest.raises(ValueError, match="words"):
        tg.Engine.from_packed(brain, "bosco", device="cpu")
    with pytest.raises(ValueError, match="3, H, W/32"):
        tg.Engine.from_packed(brain, "B2/S/C5", device="cpu")
    t = interop.state_from_numpy(brain)
    te = tg.Engine.from_packed(t, "brain", device="cpu")
    te.step(3)
    np.testing.assert_array_equal(interop.state_to_numpy(t), brain)
    with pytest.raises(TypeError):
        tg.Engine.from_packed(torch.zeros((1, 2, 8, 2), dtype=torch.int32),
                              "brain", device="cpu")


def test_states_population_and_set_grid():
    grid = _cells(3, 16, 64, seed=5)
    te = tg.Engine(grid, "brain", device="cpu")
    assert te.population() == int((grid == 1).sum())       # state 1 only
    te.set_grid(np.full((16, 64), 2, np.uint8), generation=9)
    assert te.population() == 0 and te.generation == 9
    te.step(1)                                             # all dying -> dead
    assert te.snapshot().max() == 0
    with pytest.raises(ValueError, match="states 0..2"):
        te.set_grid(np.full((16, 64), 3, np.uint8))
    with pytest.raises(ValueError, match="states 0..2"):
        tg.Engine(np.full((4, 32), 3, np.uint8), "brain", device="cpu")
    with pytest.raises(ValueError, match="binary"):
        tg.Engine(np.full((4, 32), 2, np.uint8), "bosco", device="cpu")
    tg.Engine(np.full((4, 32), 255, np.uint8), "B3/S23/C256", device="cpu")


def test_backend_errors():
    grid = np.zeros((8, 64), np.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        tg.Engine(grid, "brain", backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        tg.Engine(np.zeros((8, 40), np.uint8), "brain", backend="packed", device="cpu")
    for rule in ["W110", "rule30"]:   # 1D: the JAX engine's ValueError
        with pytest.raises(ValueError) as j_err:
            jg.Engine(grid, rule)
        with pytest.raises(ValueError) as t_err:
            tg.Engine(grid, rule, device="cpu")
        assert str(t_err.value) == str(j_err.value).replace(
            "gameoflifewithactors_tpu", "gameoflifewithactors_torch")
        assert "is a 1D (elementary) rule" in str(t_err.value)
    for backend in ("sparse", "paged"):   # ported: test_torch_sparse_families.py
        assert tg.Engine(grid, "bosco", backend=backend,
                         device="cpu").backend == backend


def test_coordinator_matches_jax_for_brain_and_bosco():
    for rule, states in [("brain", 3), ("bosco", 2)]:
        seed = _cells(states, 40, 64, seed=30 + states)
        jc = jg.GridCoordinator((48, 96), rule, seed=seed, track_population=True,
                                view_shape=(12, 24))
        tc = tg.GridCoordinator((48, 96), rule, seed=seed, track_population=True,
                                view_shape=(12, 24), device="cpu")
        got, want = [], []
        tc.subscribe(got.append)
        jc.subscribe(want.append)
        tc.run(12, render_every=5)
        jc.run(12, render_every=5)
        assert [(f.generation, f.population) for f in got] == \
            [(f.generation, f.population) for f in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.grid, b.grid)
        np.testing.assert_array_equal(tc.snapshot(), jc.snapshot())
        assert tc.rule.notation == jc.rule.notation


def test_interop_plane_stack_round_trip():
    stack = np.asarray(jg.Engine(_cells(5, 8, 64, 2), "B2/S34/C5").state)
    t = interop.state_from_numpy(stack)
    assert t.dtype == torch.int32 and t.shape == (3, 8, 2)
    np.testing.assert_array_equal(interop.state_to_numpy(t), stack)
    with pytest.raises(ValueError):
        interop.state_from_numpy(stack[None])
    with pytest.raises(TypeError):
        interop.state_to_numpy(torch.zeros((1, 1, 2, 2), dtype=torch.int32))
    np.testing.assert_array_equal(
        tg.Engine.from_packed(stack, "B2/S34/C5", device="cpu").snapshot(),
        jnp.asarray(jg.Engine(_cells(5, 8, 64, 2), "B2/S34/C5").snapshot()))


def _cli(package, *argv, env=None):
    return subprocess.run([sys.executable, "-m", package, *argv], cwd=_REPO,
                          capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("rule", ["brain", "bosco"])
def test_cli_runs_both_families_like_the_jax_cli(rule):
    flags = ["--rule", rule, "--grid", "48x64", "--seed", "r_pentomino" if
             rule == "brain" else "pulsar", "--steps", "9", "--render", "final",
             "--population"]
    want = _cli("gameoflifewithactors_tpu", *flags,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert want.returncode == 0, want.stderr
    got = _cli("gameoflifewithactors_torch", "--device", "cpu", *flags)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert got.stdout.splitlines()[-1].startswith("gen 9 ")
