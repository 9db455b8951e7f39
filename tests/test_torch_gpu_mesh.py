"""The slab forms of kernels B3 and B4, B2's per-band edge codes and the
sharded engine on a card: each kernel against its plain version, bit for
bit, and the band path against the single-device kernel path. Each test
skips without a CUDA device.

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
from gameoflifewithactors_torch.parallel.batched import multi_step_kernel_batched
from gameoflifewithactors_torch.parallel.mesh import make_mesh

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
