"""Kernel B2's plain version (``slab_step_reference``) against the JAX
package's slab-mode Pallas kernel run in interpret mode, on the whole
``(He, W/32)`` output (halo rows included), and the wrapper's checks.
The CUDA kernel itself is held against the plain version on a card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The plain version runs the kernel's own algorithm (tiles, zero rows
beyond the band, the dead band re-zeroed before every generation, the
horizontal wrap or DEAD words), so these tests hold the kernel's tiling
and edge logic on the CPU. Integers throughout: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import rules as t_rules
from gameoflifewithactors_torch.ops import cuda_stencil
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models import rules as j_rules
from gameoflifewithactors_tpu.ops.pallas_stencil import make_pallas_slab_step
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop

B0_RULE = "B0123478/S01234678"   # born on 0 neighbours: lights the background


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _tensor(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _pallas(words, rule, topology, g, code, block_rows):
    """JAX ``make_pallas_slab_step(interpret=True)``; ``code`` None is the
    form without ``dead_band``."""
    step = make_pallas_slab_step(
        j_rules.parse_rule(rule), JTop(topology), words.shape, gens=g,
        block_rows=block_rows, interpret=True, dead_band=code is not None)
    if code is None:
        return np.asarray(step(jnp.asarray(words)))
    return np.asarray(step(jnp.asarray(words), jnp.full((1, 1), code, jnp.int32)))


def _plain(words, rule, topology, g, code, tile=None):
    out = cuda_stencil.slab_step_reference(
        _tensor(words)[None], g, rule=t_rules.parse_rule(rule),
        topology=TTop(topology), edge_code=code or 0, tile=tile)
    return out[0].numpy().view(np.uint32)


@pytest.mark.parametrize("rule", ["conway", "highlife", "dayandnight", B0_RULE])
def test_reference_matches_pallas_slab_step(rule):
    """The whole output, halo rows included, under TORUS and DEAD, without
    ``dead_band`` and with edge codes 0-3, at g = 1, 3 and 8."""
    words = _words((48, 2), seed=11)
    for topology in ("torus", "dead"):
        for i, code in enumerate([None, 0, 1, 2, 3]):
            g = (1, 3, 8)[i % 3]
            want = _pallas(words, rule, topology, g, code, block_rows=16)
            np.testing.assert_array_equal(
                _plain(words, rule, topology, g, code, tile=(7, 1)), want,
                err_msg=f"{rule} {topology} g={g} code={code}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_output_does_not_depend_on_the_block_height(topology):
    """Two JAX block heights and three port tiles give one result."""
    words = _words((48, 3), seed=12)
    want = _pallas(words, B0_RULE, topology, 3, 3, block_rows=8)
    np.testing.assert_array_equal(
        _pallas(words, B0_RULE, topology, 3, 3, block_rows=24), want)
    for tile in [(5, 1), (16, 2), None]:
        np.testing.assert_array_equal(
            _plain(words, B0_RULE, topology, 3, 3, tile=tile), want, err_msg=str(tile))


def test_batch_members_step_independently():
    """One call over a batch equals one call per band, at g = 8."""
    words = _words((3, 40, 2), seed=13)
    rule = t_rules.parse_rule("highlife")
    got = cuda_stencil.slab_step_reference(_tensor(words), 8, rule=rule,
                                           topology=TTop.DEAD, edge_code=2)
    for b in range(3):
        want = cuda_stencil.slab_step_reference(
            _tensor(words[b])[None], 8, rule=rule, topology=TTop.DEAD,
            edge_code=2)
        assert torch.equal(got[b], want[0])


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    ext = _tensor(_words((2, 24, 2), seed=14))
    before = cuda_stencil.SLAB_LAUNCHES
    got = cuda_stencil.slab_step_kernel(ext, 4, rule=t_rules.CONWAY,
                                        edge_code=3)
    assert cuda_stencil.SLAB_LAUNCHES == before   # no kernel on the CPU
    assert torch.equal(got, cuda_stencil.slab_step_reference(
        ext, 4, rule=t_rules.CONWAY, edge_code=3))
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_stencil.slab_step_kernel(ext.to("meta"), 4, rule=t_rules.CONWAY)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    ext = _tensor(_words((1, 24, 2), seed=15))
    rule = t_rules.CONWAY
    with pytest.raises(ValueError, match="3D"):
        cuda_stencil.slab_step_kernel(ext[0], 4, rule=rule)
    with pytest.raises(ValueError, match="edge_code"):
        cuda_stencil.slab_step_kernel(ext, 4, rule=rule, edge_code=4)
    for g in (0, 33):
        with pytest.raises(ValueError, match="gens_per_call"):
            cuda_stencil.slab_step_kernel(ext, g, rule=rule)
    with pytest.raises(TypeError):
        cuda_stencil.slab_step_kernel(ext.to(torch.int64), 4, rule=rule)
    assert cuda_stencil.supported_slab((16400, 512), 8, batch=1)
    assert cuda_stencil.supported_slab((1040, 32), 8, batch=256)
    assert not cuda_stencil.supported_slab((1040, 32), 8, batch=70000)
    assert not cuda_stencil.supported_slab((1040, 32), 40)
    assert not cuda_stencil.supported_slab((64 * 65536, 64), 8)
    # the tile keeps about 4096 words, narrows to the band and splits its
    # rows evenly
    assert cuda_stencil._resolve_slab(8, 1040, 32, None) == (8, 130, 32)
    assert cuda_stencil._resolve_slab(8, 16400, 512, None) == (8, 65, 64)
    assert cuda_stencil._resolve_slab(3, 24, 2, None) == (3, 24, 2)
