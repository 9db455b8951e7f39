"""Kernels B1 (life_packed) and B2 (life_slab, slab and lane forms) on a
card, against their plain versions bit for bit, on each rule path (the
equality path over 1..4 counts and the table), on rows that fit one warp
and rows that do not; and the session service stepping its lanes through
the lane form alone. Each test skips without a CUDA device.

This file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_gpu_packed.py``.
"""

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models.rules import CONWAY, parse_rule
from gameoflifewithactors_torch.ops import bitpack, cuda_stencil
from gameoflifewithactors_torch.ops.packed import multi_step_packed
from gameoflifewithactors_torch.ops.stencil import Topology
from gameoflifewithactors_torch.serve import SessionService

from chip_smoke import PACKED_RULES   # a rule on each of B1/B2's rule paths


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _words(shape, seed):
    words = np.random.default_rng(seed).integers(-2 ** 31, 2 ** 31, size=shape,
                                                 dtype=np.int64)
    return torch.from_numpy(words.astype(np.int32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_packed_kernel_matches_plain_version_on_every_rule_path(topology):
    """B1 on grids of 1, 3, 32 and 33 words a row (the row forms and the
    halo form) at the default and ragged tiles, g up to 32."""
    _need_cuda()
    for name in PACKED_RULES.values():
        for shape in [(40, 1), (72, 3), (100, 32), (300, 33)]:
            p = _words(shape, 51)
            for g, tile in [(1, None), (8, None), (32, None), (5, (7, 3)),
                            (3, (9, 64))]:
                kwargs = dict(rule=parse_rule(name), topology=Topology(topology),
                              gens_per_call=g, tile=tile)
                got = cuda_stencil.multi_step_kernel(p, 2 * g + 3, **kwargs)
                want = cuda_stencil.multi_step_reference(p, 2 * g + 3, **kwargs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, shape, g, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_slab_form_matches_plain_version_on_every_rule_path(topology):
    """B2's slab form with one edge code per batch and one per band."""
    _need_cuda()
    for name in PACKED_RULES.values():
        for shape in [(1, 40, 3), (4, 530, 32), (3, 90, 40)]:
            ext = _words(shape, 52)
            codes = torch.zeros(shape[0], dtype=torch.int32, device="cuda")
            codes[0] |= 1
            codes[-1] |= 2
            for g, code, tile in [(1, 0, None), (8, 3, None), (16, codes, None),
                                  (5, codes, (7, 3))]:
                kwargs = dict(rule=parse_rule(name), topology=Topology(topology),
                              edge_code=code, tile=tile)
                got = cuda_stencil.slab_step_kernel(ext, g, **kwargs)
                want = cuda_stencil.slab_step_reference(ext, g, **kwargs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, shape, g, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_lane_form_matches_plain_version_and_keeps_frozen_slots(topology):
    """The lane form against the exchange, slab step, crop and select, on
    lanes of 1, 5, 32 and 64 words a row, a mask freezing every other
    slot; a frozen slot comes out bit-identical to its input."""
    _need_cuda()
    for name in PACKED_RULES.values():
        for shape in [(3, 20, 1), (4, 40, 5), (6, 64, 32), (3, 70, 64)]:
            grids = _words(shape, 53)
            mask = torch.tensor([1, 0] * 3, dtype=torch.int32,
                                device="cuda")[:shape[0]]
            for g in (1, 5, 8, 16):
                kwargs = dict(rule=parse_rule(name), topology=Topology(topology),
                              mask=mask)
                got = cuda_stencil.multi_step_lane_kernel(
                    grids, g, gens_per_call=g, **kwargs)
                want = cuda_stencil.lane_step_reference(grids, g, **kwargs)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, shape, g)
                assert torch.equal(got[1::2], grids[1::2]), (name, shape, g)


@pytest.mark.gpu
def test_serving_steps_lanes_through_the_lane_form_alone(monkeypatch):
    """A DEAD and a TORUS family of 1024-cell grids: 21 generations are
    three lane-form launches per lane (8 + 8 + 5), no slab-form launch and
    no ``torch.cat`` on the card, and every grid equals the plain packed
    stepper."""
    _need_cuda()
    svc = SessionService(ladder=(1, 8), sleep_fn=lambda s: None)
    sids = []
    for topology in ("torus", "dead"):
        spec = {"rule": "B3/S23", "height": 64, "width": 1024,
                "topology": topology}
        sids += [(svc.create("t", spec, fill=0.35, rng_seed=i)["sid"], topology, i)
                 for i in range(5)]
    assert svc.info(sids[0][0])["spec"]["backend"] == "cuda"
    seen = {"lane": 0, "slab": 0, "cat": 0}
    launch_lane, launch_slab, cat = (cuda_stencil._launch_lane,
                                     cuda_stencil._launch_slab, torch.cat)

    def count(key, fn):
        def counted(*args, **kwargs):
            if key == "cat":
                args = (list(args[0]),) + args[1:]
            if key != "cat" or any(t.is_cuda for t in args[0]):
                seen[key] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(cuda_stencil, "_launch_lane", count("lane", launch_lane))
    monkeypatch.setattr(cuda_stencil, "_launch_slab", count("slab", launch_slab))
    monkeypatch.setattr(torch, "cat", count("cat", cat))
    before = cuda_stencil.SLAB_LAUNCHES
    for sid, _, _ in sids:
        svc.step(sid, 21, pump=False)
    assert svc.pump() == 2
    assert seen == {"lane": 6, "slab": 0, "cat": 0}
    assert cuda_stencil.SLAB_LAUNCHES - before == 6
    monkeypatch.undo()
    for sid, topology, seed in sids:
        cells = (np.random.default_rng(seed).random((64, 1024)) < 0.35).astype(np.uint8)
        want = multi_step_packed(bitpack.pack(torch.from_numpy(cells)), 21,
                                 rule=CONWAY, topology=Topology(topology))
        np.testing.assert_array_equal(svc.grid(sid), bitpack.unpack(want).numpy())
