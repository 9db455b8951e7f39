"""The slab forms of kernels B3 and B4, B2's per-band edge codes and the
sharded engine on a card: each kernel against its plain version, bit for
bit, and the band path against the single-device kernel path; the
ghost-zone and deep runners, the sharded sparse engine and the batch mesh
(B2's slab form) on meshes of one card against the single-device
engines. Each test skips without a CUDA device.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_gpu_mesh.py``.
"""

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import Engine, GridCoordinator
from gameoflifewithactors_torch.models.generations import parse_any
from gameoflifewithactors_torch.models.rules import parse_rule
from gameoflifewithactors_torch.ops import cuda_stencil
from gameoflifewithactors_torch.ops.packed_generations import n_planes
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.models import seeds
from gameoflifewithactors_torch.ops import bitpack
from gameoflifewithactors_torch.parallel import batched, sharded
from gameoflifewithactors_torch.parallel.batched import multi_step_kernel_batched
from gameoflifewithactors_torch.parallel.mesh import (
    device_put_sharded_grid,
    make_mesh,
)

from chip_smoke import GEN_RULES, ltl_every_form   # B3's rule paths, B4's forms


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _words(shape, seed):
    words = np.random.default_rng(seed).integers(-2 ** 31, 2 ** 31, size=shape,
                                                 dtype=np.int64)
    return torch.from_numpy(words.astype(np.int32)).cuda()


def _codes(batch):
    """Per-band codes as a mesh of ``batch`` bands has them."""
    codes = [0] * batch
    codes[0] |= 1
    codes[-1] |= 2
    return torch.tensor(codes, dtype=torch.int32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_generations_slab_kernel_matches_plain_version(topology):
    """A rule on each rule path of B3 and C = 256, at g up to 32."""
    _need_cuda()
    for name in list(GEN_RULES.values()) + ["B3/S23/C256"]:
        rule = parse_any(name)
        b = n_planes(rule.states)
        for batch, rows, wp in [(1, 40, 3), (4, 530, 32), (8, 72, 5)]:
            for g, tile in [(1, None), (3, None), (16, None), (32, None),
                            (5, (7, 3))]:
                ext = _words((batch, b, rows + 2 * g, wp), 21 + g)
                for code in (0, 3, _codes(batch)):
                    kwargs = dict(rule=rule, topology=Topology(topology),
                                  edge_code=code, tile=tile)
                    got = cuda_stencil.slab_step_generations_kernel(ext, g, **kwargs)
                    want = cuda_stencil.slab_step_generations_reference(
                        ext, g, **kwargs)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (name, batch, g, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ltl_slab_kernel_matches_plain_version(topology):
    """Every radius 1..7, box and diamond, M0 and M1 (the slab
    instantiations of the LtL kernel), and two named rules."""
    _need_cuda()
    named = [parse_any(name) for name in ["R2,C0,M0,S6..11,B6..9,NN", "bosco"]]
    for rule in named + ltl_every_form():
        shapes = [(1, 40, 3), (4, 300, 32), (8, 64, 5)] if rule in named else [
            (1, 40, 3), (4, 90, 6)]
        for batch, rows, wp in shapes:
            for g, tile in [(1, None), (2, None), (2, (128, 64)), (4, None),
                            (3, (7, 3))]:
                ext = _words((batch, rows + 2 * rule.radius * g, wp), 31 + g)
                for code in (0, 3, _codes(batch)):
                    kwargs = dict(rule=rule, topology=Topology(topology),
                                  edge_code=code, tile=tile)
                    got = cuda_stencil.slab_step_ltl_kernel(ext, g, **kwargs)
                    want = cuda_stencil.slab_step_ltl_reference(ext, g, **kwargs)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (rule.notation, batch, g, tile)


@pytest.mark.gpu
def test_slab_kernel_takes_per_band_codes_and_lanes_stay_as_they_were():
    """B2 with a tensor of per-band codes equals its plain version and one
    launch per band with an int code; the serving lanes, which pass one
    int code, step as the single-device kernel does."""
    _need_cuda()
    rule = parse_rule("B36/S23")
    ext = _words((6, 1040, 32), 41)
    codes = _codes(6)
    got = cuda_stencil.slab_step_kernel(ext, 8, rule=rule, topology=Topology.DEAD,
                                        edge_code=codes)
    want = cuda_stencil.slab_step_reference(ext, 8, rule=rule,
                                            topology=Topology.DEAD, edge_code=codes)
    assert torch.equal(got, want)
    for i, code in enumerate(codes.tolist()):
        one = cuda_stencil.slab_step_kernel(ext[i:i + 1], 8, rule=rule,
                                            topology=Topology.DEAD, edge_code=code)
        assert torch.equal(got[i], one[0])
    lane = _words((4, 256, 8), 42)
    for topology in Topology:
        stepped = multi_step_kernel_batched(lane, 21, rule=rule, topology=topology)
        for i in range(4):
            alone = cuda_stencil.multi_step_kernel(lane[i], 21, rule=rule,
                                                   topology=topology)
            assert torch.equal(stepped[i], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_mesh_engine_on_one_card_matches_the_single_device_kernels(topology):
    """Four bands on cuda:0 (and a flattened (2, 2) mesh): each chunk is one
    slab launch, no full-grid kernel runs, and 19 generations equal the
    single-device kernel run from the same start, for every family."""
    _need_cuda()
    cuda0 = torch.device("cuda", 0)
    for shape in [(4, 1), (2, 2)]:
        mesh = make_mesh(shape, [cuda0] * 4)
        for rule, states, counter, g in [
                ("conway", 2, "SLAB_LAUNCHES", 8),
                ("brain", 3, "GENERATIONS_SLAB_LAUNCHES", 16),
                ("bosco", 2, "LTL_SLAB_LAUNCHES",
                 cuda_stencil.DEFAULT_LTL_GENS_PER_CALL)]:
            cells = np.random.default_rng(43).integers(0, states, size=(512, 256),
                                                       dtype=np.uint8)
            sharded = Engine(cells, rule, topology=Topology(topology), mesh=mesh)
            single = Engine(cells, rule, topology=Topology(topology),
                            backend="cuda")
            assert sharded.backend == "cuda" and sharded.gens_per_exchange == g
            full = (cuda_stencil.KERNEL_LAUNCHES, cuda_stencil.GENERATIONS_LAUNCHES,
                    cuda_stencil.LTL_LAUNCHES)
            before = getattr(cuda_stencil, counter)
            sharded.step(19)
            assert getattr(cuda_stencil, counter) - before == -(-19 // g)
            assert (cuda_stencil.KERNEL_LAUNCHES, cuda_stencil.GENERATIONS_LAUNCHES,
                    cuda_stencil.LTL_LAUNCHES) == full
            single.step(19)
            assert torch.equal(sharded.state, single.state), (shape, rule)
            assert sharded.population() == single.population()


@pytest.mark.gpu
def test_coordinator_with_a_mesh_defaults_to_the_card():
    _need_cuda()
    mesh = make_mesh((4, 1), ["cuda"] * 4)
    c = GridCoordinator((64, 64), "conway", seed="glider", mesh=mesh,
                        track_population=True)
    c.run(10)
    assert c.engine.backend == "cuda" and c.population() == 5
    assert c.engine.state.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ghost_and_deep_on_one_card_match_b1(topology):
    """G = 8 on a (2, 2) mesh of the card: the engine's ghost pipeline
    (with a remainder) and the deep runner equal B1; the halo bytes'
    model equals the measured figure."""
    _need_cuda()
    top = Topology(topology)
    mesh = make_mesh((2, 2), ["cuda"] * 4)
    cells = (np.random.default_rng(3).random((1024, 2048)) < 0.4).astype(
        np.uint8)
    truth = Engine(cells, "B3/S23", topology=top, backend="cuda")
    truth.step(83)
    engine = Engine(cells, "B3/S23", topology=top, backend="packed",
                    mesh=mesh, gens_per_exchange=8)
    assert engine._ghost_pipeline
    engine.step(83)
    assert torch.equal(engine.state, truth.state)
    assert engine.halo_bytes_per_gen("model") == \
        engine.halo_bytes_per_gen("measured")
    rule = parse_rule("B3/S23")
    state = device_put_sharded_grid(bitpack.pack(torch.from_numpy(cells)
                                                 .cuda()), mesh)
    deep = sharded.make_multi_step_packed_deep(mesh, rule, top, 8)
    pergen = sharded.make_multi_step_packed(mesh, rule, top)
    assert torch.equal(pergen(deep(state, 10), 3).gather(), truth.state)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_sharded_sparse_on_one_card_matches_the_kernels(topology):
    """A Gosper gun (B1) and a brain blob (B3) on the sparse engine of a
    (2, 2) mesh of the card, with its overflow branch at capacity 2."""
    _need_cuda()
    top = Topology(topology)
    mesh = make_mesh((2, 2), ["cuda"] * 4)
    words = seeds.seeded_packed((2048, 2048), "gosper_gun", top=1000,
                                left_word=31)
    truth = Engine.from_packed(words, "B3/S23", topology=top, backend="cuda")
    engine = Engine.from_packed(words, "B3/S23", topology=top,
                                backend="sparse", mesh=mesh)
    truth.step(300)
    engine.step(300)
    assert torch.equal(engine.state, truth.state)
    assert 0 < engine.active_tiles() and engine._runner.stats["syncs"] == 300
    cells = np.zeros((1024, 1024), np.uint8)
    cells[480:560, 480:560] = np.random.default_rng(5).integers(0, 3, (80, 80))
    for opts in (None, {"capacity": 2}):
        truth = Engine(cells, "brain", topology=top, backend="cuda")
        engine = Engine(cells, "brain", topology=top, backend="sparse",
                        mesh=mesh, sparse_opts=opts)
        truth.step(120)
        engine.step(120)
        assert torch.equal(engine.state, truth.state)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_batch_mesh_launches_the_slab_form(topology):
    """A (2, 2, 1) and a (1, 2, 2) batch mesh of the card: one B2
    slab-form launch per chunk, masked universes frozen, equal to the
    lane form."""
    _need_cuda()
    top = Topology(topology)
    rule = parse_rule("B3/S23")
    cells = (np.random.default_rng(9).random((8 * 256, 512)) < 0.35).astype(
        np.uint8)
    grids = bitpack.pack(torch.from_numpy(cells).cuda()).view(8, 256, 16)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1])
    want = multi_step_kernel_batched(grids, 48, mask, rule=rule,
                                     topology=top)
    for shape, placement in [((2, 2, 1), batched.batch_sharding),
                             ((1, 2, 2), batched.batch_band_sharding)]:
        bmesh = batched.make_batch_mesh(shape, ["cuda"] * 4)
        run = batched.make_multi_step_kernel_batched_mesh(
            bmesh, rule, top, gens_per_exchange=8, masked=True)
        before = cuda_stencil.SLAB_LAUNCHES
        got = run(batched.device_put(grids, placement(bmesh)), 6, mask)
        assert cuda_stencil.SLAB_LAUNCHES - before == 6
        assert torch.equal(got.gather(), want)
    assert torch.equal(want[1], grids[1])
