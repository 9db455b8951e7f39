"""The temporal-blocked kernel's plain version (``multi_step_reference``)
against the JAX package's Pallas kernel run in interpret mode, the packed
stepper and the numpy oracle, and the wrapper's checks. The CUDA kernel
itself is held against the plain version on a card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The plain version runs the kernel's own algorithm (tiles, modulo-wrapped
halo gather, DEAD re-zero every generation, a shorter last launch), so
these tests hold the kernel's tiling, wrap and edge logic on the CPU.
Integers throughout: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch.models import rules as t_rules
from gameoflifewithactors_torch.ops import bitpack as t_bitpack
from gameoflifewithactors_torch.ops import cuda_stencil
from gameoflifewithactors_torch.ops.packed import multi_step_packed
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import rules as j_rules
from gameoflifewithactors_tpu.models import seeds as j_seeds
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.pallas_stencil import multi_step_pallas
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from tests.oracle import numpy_run


def _grid(h, w, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(h, w), dtype=np.uint8)


def _both(grid):
    words = j_bitpack.pack_np(grid)
    return jnp.asarray(words), torch.from_numpy(words.view(np.int32).copy())


def _same(got: torch.Tensor, want, msg: str = "") -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want),
                                  err_msg=msg)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_reference_matches_pallas_interpret(topology):
    jp, tp = _both(_grid(64, 96, seed=7))
    for rule in ["conway", "highlife", "dayandnight"]:
        want = multi_step_pallas(jp, 12, rule=j_rules.parse_rule(rule),
                                 topology=JTop(topology), block_rows=16,
                                 gens_per_call=4, interpret=True)
        got = cuda_stencil.multi_step_reference(
            tp, 12, rule=t_rules.parse_rule(rule), topology=TTop(topology),
            gens_per_call=4, tile=(16, 1))
        _same(got, want, rule)


# small tiles, ragged tiles, tiles larger than the grid, g at both ends
@pytest.mark.parametrize("g,tile", [(8, (8, 1)), (5, (16, 2)), (1, (32, 3)),
                                    (8, (64, 64)), (32, (5, 2))])
def test_reference_depth_and_tile_sweep(g, tile):
    grid = _grid(64, 96, seed=3)
    jp, tp = _both(grid)
    want = multi_step_pallas(jp, 11, rule=j_rules.CONWAY, topology=JTop.TORUS,
                             block_rows=8, gens_per_call=min(g, 8),
                             interpret=True)
    got = cuda_stencil.multi_step_kernel(tp, 11, rule=t_rules.CONWAY,
                                         topology=TTop.TORUS,
                                         gens_per_call=g, tile=tile)
    _same(got, want)


def test_reference_dead_boundary_exterior_stays_dead():
    """Life hugging every edge under DEAD: the per-generation exterior
    re-zero is what keeps edge tiles exact."""
    grid = j_seeds.empty((32, 64))
    grid[0, :20] = 1
    grid[-1, 30:50] = 1
    grid[5:25, 0] = 1
    grid[3:9, -1] = 1
    jp, tp = _both(grid)
    want = multi_step_pallas(jp, 10, rule=j_rules.CONWAY, topology=JTop.DEAD,
                             block_rows=8, gens_per_call=4, interpret=True)
    for tile in [(8, 1), (6, 3), (64, 64)]:
        got = cuda_stencil.multi_step_reference(
            tp, 10, rule=t_rules.CONWAY, topology=TTop.DEAD, gens_per_call=4,
            tile=tile)
        _same(got, want, str(tile))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_reference_small_and_ragged_grids_match_oracle(topology):
    for rule in ["conway", "B03/S23"]:
        for shape in [(2, 32), (8, 64), (72, 96)]:
            grid = _grid(*shape, seed=shape[0])
            jr = j_rules.parse_rule(rule)
            _, tp = _both(grid)
            got = cuda_stencil.multi_step_reference(
                tp, 19, rule=t_rules.parse_rule(rule), topology=TTop(topology),
                gens_per_call=8, tile=(64, 2))
            np.testing.assert_array_equal(
                t_bitpack.unpack(got).numpy(),
                numpy_run(grid, jr, JTop(topology), 19), err_msg=f"{rule} {shape}")


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    _, tp = _both(_grid(16, 64, seed=1))
    before = cuda_stencil.KERNEL_LAUNCHES
    got = cuda_stencil.multi_step_kernel(tp, 13, rule=t_rules.CONWAY)
    assert cuda_stencil.KERNEL_LAUNCHES == before
    assert torch.equal(got, multi_step_packed(tp, 13, rule=t_rules.CONWAY))
    assert cuda_stencil.multi_step_kernel(tp, 0, rule=t_rules.CONWAY) is tp


def test_wrapper_rejects_what_the_kernel_cannot_take():
    for bad, error in [
        (torch.zeros((8, 2), dtype=torch.int64), TypeError),
        (torch.zeros((8, 2), dtype=torch.uint8), TypeError),
        (np.zeros((8, 2), dtype=np.int32), TypeError),
        (torch.zeros((8, 4), dtype=torch.int32)[:, ::2], ValueError),
        (torch.zeros((8,), dtype=torch.int32), ValueError),
        (torch.zeros((2, 8, 2), dtype=torch.int32), ValueError),
    ]:
        with pytest.raises(error):
            cuda_stencil.multi_step_kernel(bad, 3, rule=t_rules.CONWAY)


def test_wrapper_rejects_bad_depth_tile_and_count():
    p = torch.zeros((8, 2), dtype=torch.int32)
    for g, tile in [(0, None), (33, None), (8, (0, 4)), (32, (256, 128))]:
        with pytest.raises(ValueError):
            cuda_stencil.multi_step_kernel(p, 3, rule=t_rules.CONWAY,
                                           gens_per_call=g, tile=tile)
    with pytest.raises(ValueError, match="negative"):
        cuda_stencil.multi_step_kernel(p, -3, rule=t_rules.CONWAY)


def test_supported_takes_every_word_divisible_shape():
    assert cuda_stencil.supported((16384, 512))
    assert cuda_stencil.supported((1, 1))
    assert cuda_stencil.supported((1000, 33))
    assert not cuda_stencil.supported((0, 4))
    # more row tiles of the default height than the launch grid holds
    assert not cuda_stencil.supported((cuda_stencil.DEFAULT_TILE[0] * 70000, 1))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_key_follows_the_source():
    path = _build.library_path("life_packed")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("life_packed")
