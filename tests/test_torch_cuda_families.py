"""The plain versions of the Generations (B3) and Larger-than-Life (B4)
kernels — ``multi_step_generations_reference`` and
``multi_step_ltl_reference`` — against the JAX package's Pallas kernels
run in interpret mode and its plain steppers, and the wrappers' checks.
The CUDA kernels themselves are held against these plain versions on a
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The plain versions run the kernels' own algorithm (tiles, modulo-wrapped
halo gather, DEAD re-zero every generation, a shorter last launch), so
these tests hold the kernels' tiling, wrap and edge logic on the CPU.
Integers throughout: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import _build
from gameoflifewithactors_torch.models import generations as t_gen
from gameoflifewithactors_torch.models import ltl as t_ltl
from gameoflifewithactors_torch.ops import cuda_stencil as cs
from gameoflifewithactors_torch.ops import packed_generations as t_pg
from gameoflifewithactors_torch.ops.packed_ltl import multi_step_ltl_packed
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import generations as j_gen
from gameoflifewithactors_tpu.ops import packed_generations as j_pg
from gameoflifewithactors_tpu.ops import packed_ltl as j_pl
from gameoflifewithactors_tpu.ops.pallas_stencil import (
    multi_step_ltl_pallas,
    multi_step_pallas_generations,
)
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop


def _stack(name, h, w, seed):
    rule = j_gen.parse_any(name)
    cells = np.random.default_rng(seed).integers(0, rule.states, size=(h, w),
                                                 dtype=np.uint8)
    jp = j_pg.pack_generations_for(jnp.asarray(cells), rule)
    return jp, torch.from_numpy(np.asarray(jp).view(np.int32).copy())


def _words(h, wp, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=(h, wp),
                                             dtype=np.uint32)
    return jnp.asarray(w), torch.from_numpy(w.view(np.int32).copy())


def _same(got: torch.Tensor, want, msg: str = "") -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want),
                                  err_msg=msg)


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_generations_reference_matches_pallas_interpret(topology):
    # C = 3 (b = 2), C = 5 (b = 3) and C = 8 (b = 3, wraps by the carry)
    for i, name in enumerate(["brain", "B2/S34/C5", "belzhab"]):
        jp, tp = _stack(name, 64, 64, seed=i)
        want = multi_step_pallas_generations(
            jp, 11, rule=j_gen.parse_any(name), topology=JTop(topology),
            block_rows=16, gens_per_call=4, interpret=True)
        # tiles smaller than the grid, ragged, and larger than the grid
        for g, tile in [(4, (16, 1)), (3, (7, 2)), (8, (128, 8)), (1, None)]:
            got = cs.multi_step_generations_reference(
                tp, 11, rule=t_gen.parse_any(name), topology=TTop(topology),
                gens_per_call=g, tile=tile)
            _same(got, want, f"{name} g={g} tile={tile}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ltl_reference_matches_pallas_interpret(topology):
    for i, (name, wp) in enumerate([("bosco", 4), ("R2,C0,M0,S6..11,B6..9,NN", 3)]):
        jp, tp = _words(64, wp, seed=10 + i)
        want = multi_step_ltl_pallas(jp, 5, rule=j_gen.parse_any(name),
                                     topology=JTop(topology), interpret=True,
                                     block_rows=16, gens_per_call=2)
        for g, tile in [(2, (16, 1)), (3, (7, 2)), (1, (128, 8)), (None, None)]:
            got = cs.multi_step_ltl_reference(
                tp, 5, rule=t_gen.parse_any(name), topology=TTop(topology),
                gens_per_call=g, tile=tile)
            _same(got, want, f"{name} g={g} tile={tile}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ltl_reference_on_grids_narrower_and_shorter_than_the_halo(topology):
    """A grid narrower than the halo words or shorter than the halo rows
    still wraps exactly under TORUS (modulo indexing) and stays dead
    outside under DEAD; r = 1, 5 and 7, box and diamond, M0 and HROT."""
    specs = ["R1,C0,M1,S2..3,B3..3", "bosco", "R7,C0,M1,S20..60,B25..50,NN",
             "R3,C0,M0,S10..20,B12..16", "R2,C2,S6-9,12-14,B7-8,11"]
    for i, name in enumerate(specs):
        for h, wp, g in [(8, 1, 8), (40, 2, 5), (3, 3, 4)]:
            jp, tp = _words(h, wp, seed=20 + i)
            rule = t_gen.parse_any(name)
            want = multi_step_ltl_packed(tp, 2 * g + 1, rule=rule,
                                         topology=TTop(topology))
            if topology == "torus":
                # XLA takes minutes to compile the JAX DEAD path at some of
                # these shapes; tests/test_torch_ltl.py holds the port's
                # packed stepper to it under DEAD
                _same(want, j_pl.multi_step_ltl_packed(
                    jp, 2 * g + 1, rule=j_gen.parse_any(name),
                    topology=JTop(topology)), name)
            got = cs.multi_step_ltl_reference(tp, 2 * g + 1, rule=rule,
                                              topology=TTop(topology),
                                              gens_per_call=g, tile=(16, 1))
            assert torch.equal(got, want), f"{name} {(h, wp)} g={g}"


def test_generations_reference_on_small_grids_and_dead_edges():
    for i, name in enumerate(["brain", "starwars", "B3/S23/C256"]):
        for h, w in [(2, 32), (9, 64), (72, 96)]:
            jp, tp = _stack(name, h, w, seed=30 + i)
            for top in ("torus", "dead"):
                want = j_pg.multi_step_packed_generations(
                    jp, 19, rule=j_gen.parse_any(name), topology=JTop(top))
                got = cs.multi_step_generations_reference(
                    tp, 19, rule=t_gen.parse_any(name), topology=TTop(top),
                    gens_per_call=8, tile=(8, 2))
                _same(got, want, f"{name} {(h, w)} {top}")
    # live cells hugging every edge under DEAD
    cells = np.zeros((32, 64), np.uint8)
    cells[0, :20] = 1
    cells[-1, 30:50] = 1
    cells[5:25, 0] = 2
    cells[3:9, -1] = 1
    rule = t_gen.parse_any("starwars")
    tp = t_pg.pack_generations_for(torch.from_numpy(cells), rule)
    want = t_pg.multi_step_packed_generations(tp, 10, rule=rule, topology=TTop.DEAD)
    for tile in [(8, 1), (6, 3), (64, 64)]:
        got = cs.multi_step_generations_reference(tp, 10, rule=rule,
                                                  topology=TTop.DEAD,
                                                  gens_per_call=4, tile=tile)
        assert torch.equal(got, want), tile


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    brain, bosco = t_gen.parse_any("brain"), t_gen.parse_any("bosco")
    _, planes = _stack("brain", 16, 64, seed=1)
    _, words = _words(16, 2, seed=2)
    before = (cs.GENERATIONS_LAUNCHES, cs.LTL_LAUNCHES, cs.KERNEL_LAUNCHES)
    got = cs.multi_step_generations_kernel(planes, 13, rule=brain)
    assert torch.equal(got, t_pg.multi_step_packed_generations(planes, 13, rule=brain))
    got = cs.multi_step_ltl_kernel(words, 5, rule=bosco)
    assert torch.equal(got, multi_step_ltl_packed(words, 5, rule=bosco))
    assert (cs.GENERATIONS_LAUNCHES, cs.LTL_LAUNCHES, cs.KERNEL_LAUNCHES) == before
    assert cs.multi_step_generations_kernel(planes, 0, rule=brain) is planes
    assert cs.multi_step_ltl_kernel(words, 0, rule=bosco) is words


def test_wrappers_reject_what_the_kernels_cannot_take():
    brain, bosco = t_gen.parse_any("brain"), t_gen.parse_any("bosco")
    for bad, error in [
        (torch.zeros((2, 8, 2), dtype=torch.int64), TypeError),
        (np.zeros((2, 8, 2), dtype=np.int32), TypeError),
        (torch.zeros((8, 2), dtype=torch.int32), ValueError),
        (torch.zeros((3, 8, 2), dtype=torch.int32), ValueError),   # brain: 2 planes
        (torch.zeros((2, 8, 4), dtype=torch.int32)[..., ::2], ValueError),
    ]:
        with pytest.raises(error):
            cs.multi_step_generations_kernel(bad, 3, rule=brain)
    for bad, rule, error in [
        (torch.zeros((8, 2), dtype=torch.uint8), bosco, TypeError),
        (torch.zeros((2, 8, 2), dtype=torch.int32), bosco, ValueError),
        (torch.zeros((8, 2), dtype=torch.int32),
         t_gen.parse_any("R2,C3,M1,S3..8,B5..9"), ValueError),      # C >= 3
    ]:
        with pytest.raises(error):
            cs.multi_step_ltl_kernel(bad, 3, rule=rule)
    planes, words = torch.zeros((2, 8, 2), dtype=torch.int32), torch.zeros(
        (8, 2), dtype=torch.int32)
    for g, tile in [(0, None), (33, None), (8, (0, 4)), (32, (256, 128))]:
        with pytest.raises(ValueError):
            cs.multi_step_generations_kernel(planes, 3, rule=brain,
                                             gens_per_call=g, tile=tile)
        with pytest.raises(ValueError):
            cs.multi_step_ltl_kernel(words, 3, rule=bosco, gens_per_call=g,
                                     tile=tile)
    with pytest.raises(ValueError, match="negative"):
        cs.multi_step_ltl_kernel(words, -1, rule=bosco)


def test_supported_predicates_and_default_tiles():
    assert cs.supported_generations((16384, 512), 2)
    assert cs.supported_generations((1, 1), 8)
    assert not cs.supported_generations((16384, 512), 1)
    assert not cs.supported_generations((16384, 512), 9)
    assert not cs.supported_generations((0, 4), 2)
    th = cs._resolve_generations(2, None, None)[1]   # more row tiles than
    assert not cs.supported_generations((th * 70000, 1), 2)   # the grid holds
    for b in range(2, 9):          # the default tile shrinks until it fits
        for g in (1, 8, 32):
            got, th, tw = cs._resolve_generations(b, g, None)
            assert got == g and 2 * b * (th + 2 * g) * (tw + 4) * 4 <= cs._SMEM_LIMIT
    bosco = t_gen.parse_any("bosco")
    assert cs.supported_ltl((16384, 512), bosco)
    assert cs.supported_ltl((1, 1), t_gen.parse_any("R7,C0,M1,S20..60,B25..50,NN"))
    assert not cs.supported_ltl((16384, 512), t_gen.parse_any("R2,C3,M1,S3..8,B5..9"))
    assert not cs.supported_ltl((16384, 512), t_gen.parse_any("conway"))
    many = tuple((2 * k, 2 * k) for k in range(17))      # 17 intervals
    assert not cs.supported_ltl((64, 4), t_ltl.LtLRule(radius=7, born=many,
                                                       survive=(3, 5)))
    assert cs.supported_ltl((64, 4), t_ltl.LtLRule(radius=7, born=many[:16],
                                                   survive=(3, 5)))
    for r in range(1, 8):
        for g in (1, 4, 8):
            got, th, tw = cs._resolve_ltl(t_ltl.LtLRule(radius=r, born=(1, 2),
                                                        survive=(1, 2)), g, None)
            hw = -(-r * g // 32)
            assert got == g and 32 * hw >= r * g
            assert 2 * (th + 2 * r * g) * (tw + 2 * hw + 2) * 4 <= cs._SMEM_LIMIT


def test_build_names_every_kernel_source(monkeypatch, tmp_path):
    for name in ("life_packed", "life_generations", "life_ltl"):
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["life_generations", "life_ltl"])
