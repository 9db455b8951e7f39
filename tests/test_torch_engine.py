"""The port's Engine and the state hand-over from the JAX package,
against the JAX package, cell for cell, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch import engine as t_engine
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.utils import interop
import gameoflifewithactors_tpu as jg
from gameoflifewithactors_tpu.models import seeds as j_seeds


def _grid(h, w, seed, p=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < p).astype(np.uint8)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_engine_matches_jax(topology):
    grid = _grid(48, 96, seed=2)
    for backend in ("dense", "packed"):
        je = jg.Engine(grid, "highlife", topology=jg.Topology(topology),
                       backend=backend)
        te = tg.Engine(grid, "highlife", topology=tg.Topology(topology),
                       backend=backend, device="cpu")
        assert te.backend == backend
        for n in (1, 6):
            je.step(n)
            te.step(n)
            np.testing.assert_array_equal(te.snapshot(), je.snapshot(),
                                          err_msg=backend)
            assert te.population() == je.population(), backend
        assert te.generation == je.generation == 7
        np.testing.assert_array_equal(te.snapshot(max_shape=(10, 20)),
                                      je.snapshot(max_shape=(10, 20)),
                                      err_msg=backend)


def test_auto_backend_on_cpu():
    assert tg.Engine(np.zeros((4, 64), np.uint8), "conway",
                     device="cpu").backend == "packed"
    assert tg.Engine(np.zeros((4, 40), np.uint8), "conway",
                     device="cpu").backend == "dense"


def test_snapshot_downsample_matches_jax_on_ragged_blocks():
    grid = j_seeds.seeded((70, 100), "glider", 66, 96)  # live cells in the last partial block
    je = jg.Engine(grid, "conway", backend="dense")
    te = tg.Engine(grid, "conway", backend="dense", device="cpu")
    for shape in [(8, 8), (40, 80), (70, 100), (1, 1)]:
        np.testing.assert_array_equal(te.snapshot(max_shape=shape),
                                      je.snapshot(max_shape=shape))


def test_engine_copies_the_callers_grid():
    grid = j_seeds.seeded((16, 32), "blinker", 5, 5)
    for backend in ("dense", "packed"):
        te = tg.Engine(grid, "conway", backend=backend, device="cpu")
        grid[:] = 1
        assert te.population() == 3
        grid[:] = j_seeds.seeded((16, 32), "blinker", 5, 5)
    t = torch.from_numpy(grid)
    te = tg.Engine(t, "conway", backend="dense", device="cpu")
    te.step(1)
    assert t.sum() == 3 and torch.equal(t, torch.from_numpy(grid))


def test_snapshot_is_a_stable_copy():
    te = tg.Engine(j_seeds.seeded((8, 32), "blinker", 3, 3), "conway",
                   backend="dense", device="cpu")
    snap = te.snapshot()
    te.step(1)
    assert not np.array_equal(snap, te.snapshot())
    np.testing.assert_array_equal(snap, j_seeds.seeded((8, 32), "blinker", 3, 3))


def test_set_grid_and_validation():
    te = tg.Engine(np.zeros((8, 32), np.uint8), "conway", device="cpu")
    te.set_grid(j_seeds.seeded((8, 32), "block", 2, 2), generation=40)
    assert te.population() == 4 and te.generation == 40
    with pytest.raises(ValueError, match="shape"):
        te.set_grid(np.zeros((8, 64), np.uint8))
    with pytest.raises(ValueError, match="binary"):
        te.set_grid(np.full((8, 32), 2, np.uint8))
    with pytest.raises(ValueError, match="negative"):
        te.step(-1)
    with pytest.raises(ValueError, match="2D"):
        tg.Engine(np.zeros((2, 8, 32), np.uint8), "conway", device="cpu")


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.Engine(np.zeros((8, 32), np.uint8), "conway")
    with pytest.raises(RuntimeError, match="no CUDA"):
        tg.GridCoordinator((8, 32), "conway", seed="blinker")


def test_cuda_backend_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        tg.Engine(np.zeros((8, 32), np.uint8), "conway", backend="cuda",
                  device="cpu")


def test_unported_families_and_backends_raise():
    # Generations and Larger than Life are ported (tests/test_torch_*_families.py)
    for rule in ["B2/S/C3", "brain", "bosco", "R2,C0,M1,S2..3,B3..3"]:
        tg.Engine(np.zeros((8, 32), np.uint8), rule, device="cpu")
    from gameoflifewithactors_torch.parallel.mesh import make_mesh

    # the sparse and paged backends are ported (tests/test_torch_sparse.py,
    # tests/test_torch_paged.py), and the sparse one's sharded form
    # (tests/test_torch_engine_mesh_paths.py)
    for backend in ("sparse", "paged"):
        assert tg.Engine(np.zeros((8, 32), np.uint8), "conway", device="cpu",
                         backend=backend).backend == backend
    assert tg.Engine(np.zeros((8, 32), np.uint8), "conway", device="cpu",
                     mesh=make_mesh((1, 1), ["cpu"]),
                     backend="sparse").active_tiles() == 0
    # elementary (1D) rules are ported, but the 2D Engine refuses them with
    # the JAX engine's ValueError, naming this package's CLI
    for rule in ["W110", "rule30"]:
        with pytest.raises(ValueError) as j_err:
            jg.Engine(np.zeros((8, 32), np.uint8), rule)
        with pytest.raises(ValueError) as t_err:
            tg.Engine(np.zeros((8, 32), np.uint8), rule, device="cpu")
        assert str(t_err.value) == str(j_err.value).replace(
            "gameoflifewithactors_tpu", "gameoflifewithactors_torch")


def test_unknown_backend_and_rule_raise_value_error():
    with pytest.raises(ValueError, match="backend"):
        tg.Engine(np.zeros((8, 32), np.uint8), "conway", backend="pallas",
                  device="cpu")
    with pytest.raises(ValueError, match="unrecognized rule"):
        tg.Engine(np.zeros((8, 32), np.uint8), "B9/S", device="cpu")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_state_carried_mid_run_from_jax(topology):
    """JAX engine k steps -> port m steps == JAX k+m steps."""
    grid = _grid(40, 96, seed=21)
    for backend in ("packed", "dense"):
        je = jg.Engine(grid, "conway", topology=jg.Topology(topology),
                       backend="packed")
        je.step(5)
        words = np.asarray(je.state)
        te = tg.Engine.from_packed(words, "conway", topology=tg.Topology(topology),
                                   backend=backend, device="cpu")
        assert te.shape == (40, 96) and te.backend == backend
        te.step(7)
        je.step(7)
        np.testing.assert_array_equal(te.snapshot(), je.snapshot(), err_msg=backend)
        if backend == "packed":
            np.testing.assert_array_equal(interop.state_to_numpy(te.state),
                                          np.asarray(je.state))


def test_interop_round_trip_and_no_alias():
    words = np.asarray(jg.pack(jnp.asarray(_grid(8, 64, seed=4))))
    t = interop.state_from_numpy(words)
    assert t.dtype == torch.int32
    back = interop.state_to_numpy(t)
    assert back.dtype == np.dtype("<u4")
    np.testing.assert_array_equal(back, words)
    expected = words.copy()
    t.fill_(0)  # neither the source nor the copy back aliases the tensor
    np.testing.assert_array_equal(words, expected)
    np.testing.assert_array_equal(back, expected)
    np.testing.assert_array_equal(
        t_bitpack.unpack(interop.state_from_numpy(words)).numpy(),
        t_bitpack.unpack_np(words))
    with pytest.raises(TypeError):
        interop.state_from_numpy(words.astype(np.int64))
    with pytest.raises(ValueError):
        interop.state_from_numpy(words[0])


def test_from_packed_copies_a_tensor():
    p = t_bitpack.pack(torch.from_numpy(j_seeds.seeded((8, 32), "glider", 1, 1)))
    te = tg.Engine.from_packed(p, "conway", device="cpu")
    te.step(4)
    assert torch.equal(p, t_bitpack.pack(
        torch.from_numpy(j_seeds.seeded((8, 32), "glider", 1, 1))))


def test_resolve_device():
    assert t_engine.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        t_engine.resolve_device("meta")
