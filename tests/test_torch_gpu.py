"""The CUDA kernels (B1 life_packed, B2 life_slab, B3 life_generations, B4
life_ltl) on a card: each against its plain version, bit for bit, and
through the Engine's and the session service's main paths. Each test
skips without a CUDA device.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import Engine, GridCoordinator
from gameoflifewithactors_torch.models.generations import parse_any
from gameoflifewithactors_torch.models.ltl import LtLRule
from gameoflifewithactors_torch.models.rules import CONWAY, parse_rule
from gameoflifewithactors_torch.ops import bitpack, cuda_stencil
from gameoflifewithactors_torch.ops.packed import multi_step_packed
from gameoflifewithactors_torch.ops.packed_generations import (
    multi_step_packed_generations,
    pack_generations_for,
    population_packed_generations,
)
from gameoflifewithactors_torch.ops.packed_ltl import multi_step_ltl_packed
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.serve import SessionService, SpecFamily


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _grid(h, w, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(h, w), dtype=np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "B03/S23"])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_kernel_matches_plain_version(rule, topology):
    _need_cuda()
    p = bitpack.pack(torch.from_numpy(_grid(1000, 1056, seed=4)).cuda())
    for g, tile in [(1, None), (8, None), (32, None), (5, (7, 3))]:
        kwargs = dict(rule=parse_rule(rule), topology=Topology(topology),
                      gens_per_call=g, tile=tile)
        got = cuda_stencil.multi_step_kernel(p, 2 * g + 3, **kwargs)
        want = cuda_stencil.multi_step_reference(p, 2 * g + 3, **kwargs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_engine_main_path_launches_the_kernel():
    _need_cuda()
    grid = _grid(256, 512, seed=5)
    engine = Engine(grid, "B3/S23")
    assert engine.backend == "cuda" and engine.device.type == "cuda"
    before = cuda_stencil.KERNEL_LAUNCHES
    engine.step(21)
    assert cuda_stencil.KERNEL_LAUNCHES - before == 3   # 8 + 8 + 5
    plain = multi_step_packed(bitpack.pack(torch.from_numpy(grid)), 21, rule=CONWAY)
    assert torch.equal(engine.state.cpu(), plain)
    assert engine.population() == bitpack.population(plain)


@pytest.mark.gpu
def test_coordinator_defaults_to_the_card():
    _need_cuda()
    c = GridCoordinator((64, 64), "conway", seed="glider", track_population=True)
    c.run(10)
    assert c.engine.backend == "cuda" and c.population() == 5


@pytest.mark.gpu
def test_plain_backends_on_the_card_match_the_cpu():
    _need_cuda()
    ragged = _grid(24, 40, seed=6)   # not word-divisible: auto picks dense
    gpu = Engine(ragged, "highlife", topology=Topology.DEAD)
    cpu = Engine(ragged, "highlife", topology=Topology.DEAD, device="cpu")
    assert gpu.backend == "dense"
    gpu.step(9)
    cpu.step(9)
    np.testing.assert_array_equal(gpu.snapshot(), cpu.snapshot())
    grid = _grid(48, 96, seed=7)
    gpu = Engine(grid, "B03/S23", backend="packed")
    cpu = Engine(grid, "B03/S23", backend="packed", device="cpu")
    gpu.step(9)
    cpu.step(9)
    assert torch.equal(gpu.state.cpu(), cpu.state)
    np.testing.assert_array_equal(gpu.snapshot(max_shape=(10, 20)),
                                  cpu.snapshot(max_shape=(10, 20)))
    assert gpu.population() == cpu.population()


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_generations_kernel_matches_plain_version(topology):
    _need_cuda()
    rng = np.random.default_rng(8)
    for name in ["brain", "belzhab", "B3/S23/C256"]:
        rule = parse_any(name)
        cells = rng.integers(0, rule.states, size=(1000, 1056), dtype=np.uint8)
        planes = pack_generations_for(torch.from_numpy(cells).cuda(), rule)
        for g, tile in [(1, None), (8, None), (5, (7, 3))]:
            kwargs = dict(rule=rule, topology=Topology(topology),
                          gens_per_call=g, tile=tile)
            got = cuda_stencil.multi_step_generations_kernel(planes, 2 * g + 3, **kwargs)
            want = cuda_stencil.multi_step_generations_reference(
                planes, 2 * g + 3, **kwargs)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, g, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ltl_kernel_matches_plain_version(topology):
    _need_cuda()
    for name in ["bosco", "R2,C0,M0,S6..11,B6..9,NN", "R2,C2,S6-9,12-14,B7-8"]:
        rule = parse_any(name)
        for shape in [(1000, 1056), (8, 32)]:        # (8, 32): narrower than the halo
            p = bitpack.pack(torch.from_numpy(_grid(*shape, seed=9)).cuda())
            for g, tile in [(1, None), (2, None), (4, None), (3, (7, 3))]:
                kwargs = dict(rule=rule, topology=Topology(topology),
                              gens_per_call=g, tile=tile)
                got = cuda_stencil.multi_step_ltl_kernel(p, 2 * g + 1, **kwargs)
                want = cuda_stencil.multi_step_ltl_reference(p, 2 * g + 1, **kwargs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, shape, g, tile)


@pytest.mark.gpu
def test_engine_families_launch_their_kernels():
    _need_cuda()
    brain, bosco = parse_any("brain"), parse_any("bosco")
    cells = np.random.default_rng(10).integers(0, 3, size=(256, 512), dtype=np.uint8)
    engine = Engine(cells, brain)
    assert engine.backend == "cuda"
    before = cuda_stencil.GENERATIONS_LAUNCHES
    engine.step(21)
    g = cuda_stencil.DEFAULT_GENERATIONS_GENS_PER_CALL
    assert cuda_stencil.GENERATIONS_LAUNCHES - before == -(-21 // g)
    plain = multi_step_packed_generations(
        pack_generations_for(torch.from_numpy(cells), brain), 21, rule=brain)
    assert torch.equal(engine.state.cpu(), plain)
    assert engine.population() == population_packed_generations(plain)
    grid = _grid(256, 512, seed=11)
    engine = Engine(grid, bosco)
    assert engine.backend == "cuda"
    before = cuda_stencil.LTL_LAUNCHES
    engine.step(21)
    g = cuda_stencil.DEFAULT_LTL_GENS_PER_CALL
    assert cuda_stencil.LTL_LAUNCHES - before == -(-21 // g)
    plain = multi_step_ltl_packed(bitpack.pack(torch.from_numpy(grid)), 21, rule=bosco)
    assert torch.equal(engine.state.cpu(), plain)
    assert engine.population() == bitpack.population(plain)


@pytest.mark.gpu
def test_cuda_backend_refuses_what_no_kernel_takes():
    _need_cuda()
    grid = np.zeros((64, 64), np.uint8)
    multistate_ltl = "R2,C3,M1,S3..8,B5..9"
    assert Engine(grid, multistate_ltl).backend == "packed"
    assert Engine(np.zeros((64, 40), np.uint8), "brain").backend == "dense"
    for rule, shape in [(multistate_ltl, (64, 64)), ("brain", (64, 40)),
                        ("bosco", (64, 40)),
                        (LtLRule(radius=7, born=tuple((2 * k, 2 * k) for k in range(17)),
                                 survive=(3, 5)), (64, 64))]:
        with pytest.raises(ValueError):
            Engine(np.zeros(shape, np.uint8), rule, backend="cuda")


@pytest.mark.gpu
def test_slab_kernel_matches_plain_version():
    _need_cuda()
    rng = np.random.default_rng(12)
    for rule, topology in [("conway", "torus"), ("conway", "dead"),
                           ("B0123478/S01234678", "torus"),
                           ("B0123478/S01234678", "dead")]:
        for shape in [(1, 40, 3), (8, 1040, 32), (2, 530, 64)]:
            words = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
            ext = torch.from_numpy(words.astype(np.int32)).cuda()
            for g, code, tile in [(1, 0, None), (3, 1, None), (8, 3, None),
                                  (16, 2, None), (5, 3, (7, 3))]:
                kwargs = dict(rule=parse_rule(rule), topology=Topology(topology),
                              edge_code=code, tile=tile)
                got = cuda_stencil.slab_step_kernel(ext, g, **kwargs)
                want = cuda_stencil.slab_step_reference(ext, g, **kwargs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (rule, shape, g, code, tile)


@pytest.mark.gpu
def test_cuda_lane_steps_n_generations_through_the_slab_kernel():
    _need_cuda()
    svc = SessionService(ladder=(1, 8), sleep_fn=lambda s: None)
    spec = {"rule": "B3/S23", "height": 64, "width": 128, "topology": "dead"}
    sids = [svc.create("t", spec, fill=0.35, rng_seed=i)["sid"] for i in range(5)]
    assert svc.info(sids[0])["spec"]["backend"] == "cuda"
    before = (cuda_stencil.SLAB_LAUNCHES, cuda_stencil.KERNEL_LAUNCHES)
    for sid in sids:
        svc.step(sid, 21, pump=False)
    assert svc.pump() == 1
    assert cuda_stencil.SLAB_LAUNCHES - before[0] == 3      # 8 + 8 + 5
    assert cuda_stencil.KERNEL_LAUNCHES == before[1]
    for i, sid in enumerate(sids):
        cells = (np.random.default_rng(i).random((64, 128)) < 0.35).astype(np.uint8)
        want = multi_step_packed(bitpack.pack(torch.from_numpy(cells)), 21,
                                 rule=CONWAY, topology=Topology.DEAD)
        np.testing.assert_array_equal(svc.grid(sid), bitpack.unpack(want).numpy())


@pytest.mark.gpu
def test_auto_lane_backend_is_the_kernel_on_the_card():
    _need_cuda()
    spec = {"rule": "B3/S23", "height": 1024, "width": 1024}
    assert SpecFamily.from_spec(spec, "cuda").backend == "cuda"
    assert SpecFamily.from_spec(dict(spec, height=4), "cuda").backend == "packed"
    assert SpecFamily.from_spec(spec, "cpu").backend == "packed"

