"""The activity-tiled backends on a card: ``Engine(backend="sparse")`` and
``Engine(backend="paged")`` hold their state on the device and step it in
plain torch; each equals the ``"cuda"`` engine (kernels B1, B3, B4) bit for
bit. Each test skips without a CUDA device.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_gpu_sparse.py``.
"""

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch.models import seeds
from gameoflifewithactors_torch.ops.stencil import Topology


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _blob(shape, states, seed):
    rng = np.random.default_rng(seed)
    cells = np.zeros(shape, np.uint8)
    h, w = shape
    live = rng.random((h // 4, w // 4)) < 0.4
    cells[h // 3:h // 3 + h // 4, w // 3:w // 3 + w // 4] = \
        live * rng.integers(1, states, live.shape)
    return cells


@pytest.mark.gpu
@pytest.mark.parametrize("spec,states", [("B3/S23", 2), ("brain", 3),
                                         ("bosco", 2)])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_sparse_and_paged_equal_the_kernel_engine(spec, states, topology):
    _need_cuda()
    shape = (512, 1024)
    gun = spec == "B3/S23"
    cells = seeds.seeded(shape, "gosper_gun", 200, 400) if gun else \
        _blob(shape, states, seed=4)
    # a capped pool for the gun's few pages; the blobs get the default
    # (every tile and the dead slot: never exhausted)
    opts = {"sparse": None, "paged": {"capacity": 64} if gun else None}
    engines = {b: Engine(cells, spec, topology=Topology(topology), backend=b,
                         sparse_opts=opts.get(b))
               for b in ("cuda", "sparse", "paged")}
    for n in (1, 37, 100):
        for engine in engines.values():
            engine.step(n)
        want = engines["cuda"].state
        for b in ("sparse", "paged"):
            got = engines[b].state
            assert got.is_cuda
            assert torch.equal(got, want), (b, n)
    assert engines["sparse"]._sparse.padded.is_cuda
    assert engines["paged"]._sparse.pool.tiles.is_cuda
    assert engines["sparse"].active_tiles() > 0


@pytest.mark.gpu
def test_sparse_fixed_capacity_overflow_is_exact_on_the_card():
    _need_cuda()
    soup = (np.random.default_rng(2).random((512, 512)) < 0.4).astype(np.uint8)
    sparse = Engine(soup, "B3/S23", backend="sparse",
                    sparse_opts={"capacity": 8})
    kernel = Engine(soup, "B3/S23", backend="cuda")
    sparse.step(25)
    kernel.step(25)
    assert torch.equal(sparse.state, kernel.state)
    assert sparse._sparse.capacity == 8
