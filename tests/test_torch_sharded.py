"""The port's sharded runners against the JAX package on its 8 fake CPU
devices, bit for bit (tolerance 0: integer words).

The band runners hold the JAX ``make_multi_step_pallas``,
``make_multi_step_generations_pallas`` and ``make_multi_step_ltl_pallas``
with the Pallas slab kernels in interpret mode; on CPU tensors the port's
runners step through the slab kernels' plain versions, which repeat the
kernels' tiles, halo rows and per-band dead band. The slab plain versions
themselves are held against ``make_pallas_gen_slab_step`` and
``make_ltl_pallas_slab_step`` in interpret mode. The CUDA slab kernels are
held against their plain versions on a card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.models import rules as t_rules
from gameoflifewithactors_torch.models.generations import parse_any as t_parse
from gameoflifewithactors_torch.ops import cuda_stencil
from gameoflifewithactors_torch.ops.packed import multi_step_packed as t_packed
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.parallel import sharded as t_sharded
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse
from gameoflifewithactors_tpu.models.rules import parse_rule as j_parse_rule
from gameoflifewithactors_tpu.ops import pallas_stencil as ps
from gameoflifewithactors_tpu.ops.packed_generations import n_planes
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import sharded as j_sharded

LTL_BOX = "R2,C0,M1,S9..16,B8..12"
LTL_DIAMOND = "R2,C0,M0,S6..11,B6..9,NN"


def _meshes(shape):
    n = shape[0] * shape[1]
    return (t_mesh.make_mesh(shape, ["cpu"] * n),
            j_mesh.make_mesh(shape, jax.devices()[:n]))


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _jax_run(run, words, jm, banded, *args):
    placed = j_mesh.device_put_sharded_grid(jnp.asarray(words), jm,
                                            banded=banded)
    return np.asarray(run(placed, *args))


def _port_run(run, words, tm, banded, n):
    placed = t_mesh.device_put_sharded_grid(_t(words), tm, banded=banded)
    return run(placed, n).gather().numpy().view(np.uint32)


def _planes(rule_name, shape, seed):
    rule = j_parse(rule_name)
    cells = np.random.default_rng(seed).integers(0, rule.states, size=shape,
                                                 dtype=np.uint8)
    from gameoflifewithactors_tpu.ops.packed_generations import \
        pack_generations_for

    return np.asarray(pack_generations_for(jnp.asarray(cells), rule))


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_band_runner_matches_jax(topology):
    """B2's band runner: meshes (8, 1), (4, 1), (2, 4) and (4, 2) (the 2D
    ones flattened x-major), g in {1, 3, 8}, three chunks each."""
    words = _words((64, 8), 29)
    for shape, g in [((8, 1), 1), ((8, 1), 3), ((4, 1), 8), ((2, 4), 8),
                     ((4, 2), 3)]:
        tm, jm = _meshes(shape)
        want = _jax_run(j_sharded.make_multi_step_pallas(
            jm, j_parse_rule("conway"), JTop(topology), gens_per_exchange=g,
            interpret=True), words, jm, shape[1] > 1, 3)
        got = _port_run(t_sharded.make_multi_step_kernel(
            tm, t_rules.CONWAY, TTop(topology), g), words, tm, True, 3 * g)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} g={g}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_generations_band_runner_matches_jax(topology):
    """B3's band runner: Brian's Brain and Star Wars (b = 2) and a b = 3
    rule (C = 5), meshes (8, 1), (4, 1) and (2, 4), g in {1, 3, 8}."""
    for name, shape, g in [("brain", (8, 1), 3), ("B2/S345/C5", (4, 1), 8),
                           ("starwars", (2, 4), 1), ("B2/S345/C5", (2, 4), 3)]:
        planes = _planes(name, (64, 96), 37)
        tm, jm = _meshes(shape)
        want = _jax_run(j_sharded.make_multi_step_generations_pallas(
            jm, j_parse(name), JTop(topology), gens_per_exchange=g,
            interpret=True), planes, jm, shape[1] > 1, 2)
        got = _port_run(t_sharded.make_multi_step_generations_kernel(
            tm, t_parse(name), TTop(topology), g), planes, tm, True, 2 * g)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{name} {shape} g={g}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_ltl_band_runner_matches_jax(topology):
    """B4's band runner: a radius-2 box and a radius-2 diamond rule on
    (96, 128) grids over (4, 1) and (2, 4) meshes, g in {1, 2}; the
    exchange and the crop are r*g rows deep."""
    words = _words((96, 4), 53)
    for name, shape, g in [(LTL_BOX, (4, 1), 2), (LTL_DIAMOND, (4, 1), 1),
                           (LTL_BOX, (2, 4), 1), (LTL_DIAMOND, (2, 4), 2)]:
        tm, jm = _meshes(shape)
        want = _jax_run(j_sharded.make_multi_step_ltl_pallas(
            jm, j_parse(name), JTop(topology), gens_per_exchange=g,
            interpret=True), words, jm, shape[1] > 1, 2)
        got = _port_run(t_sharded.make_multi_step_ltl_kernel(
            tm, t_parse(name), TTop(topology), g), words, tm, True, 2 * g)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{name} {shape} g={g}")


def test_banded_runner_matches_jax():
    """The per-generation band companion, for all three families, on the
    flattened (2, 4) mesh."""
    tm, jm = _meshes((2, 4))
    cases = [("conway", _words((64, 8), 61), 7),
             ("brain", _planes("brain", (64, 96), 67), 5),
             ("bosco", _words((256, 3), 71), 3)]
    for topology in ("torus", "dead"):
        for name, state, n in cases:
            want = _jax_run(j_sharded.make_multi_step_banded(
                jm, j_parse(name), JTop(topology)), state, jm, True, n)
            got = _port_run(t_sharded.make_multi_step_banded(
                tm, t_parse(name), TTop(topology)), state, tm, True, n)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {topology}")


@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_tile_runners_match_jax(topology):
    """The 2D-tile per-generation runners on a (2, 4) mesh: packed and dense
    B/S (and the one-step builders), Generations on planes and bytes,
    binary LtL on words and bytes, multi-state LtL on planes."""
    tm, jm = _meshes((2, 4))
    cells = np.random.default_rng(73).integers(0, 2, size=(32, 256),
                                               dtype=np.uint8)
    words = _words((32, 8), 74)
    brain = np.random.default_rng(75).integers(0, 3, size=(32, 256),
                                               dtype=np.uint8)
    cases = [
        ("make_multi_step_packed", "conway", words, 4),
        ("make_step_packed", "conway", words, None),
        ("make_multi_step_dense", "highlife", cells, 4),
        ("make_step_dense", "highlife", cells, None),
        ("make_multi_step_generations_packed", "brain",
         _planes("brain", (32, 256), 76), 4),
        ("make_multi_step_generations", "brain", brain, 4),
        ("make_multi_step_ltl_packed", LTL_BOX, words, 3),
        ("make_multi_step_ltl", LTL_DIAMOND, cells, 2),
        ("make_multi_step_ltl_planes", "R2,C3,M1,S3..8,B5..9",
         _planes("R2,C3,M1,S3..8,B5..9", (32, 256), 77), 3),
    ]
    for builder, name, state, n in cases:
        jrun = getattr(j_sharded, builder)(jm, j_parse(name), JTop(topology))
        trun = getattr(t_sharded, builder)(tm, t_parse(name), TTop(topology))
        args = () if n is None else (n,)
        want = _jax_run(jrun, state, jm, False, *args)
        placed = t_mesh.device_put_sharded_grid(
            _t(state) if state.dtype == np.uint32 else torch.from_numpy(state),
            tm)
        got = trun(placed, *args).gather().numpy()
        if state.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=builder)


def test_band_runner_steps_exactly_n():
    """n // g chunks, then one chunk of n % g: 19 generations at g = 8 on
    a (4, 2) mesh equal 19 single-device generations, for every family."""
    tm = t_mesh.make_mesh((4, 2), ["cpu"] * 8)
    for topology in TTop:
        words = _t(_words((64, 8), 79))
        got = t_sharded.make_multi_step_kernel(tm, t_rules.CONWAY, topology, 8)(
            t_mesh.device_put_sharded_grid(words, tm, banded=True), 19)
        assert torch.equal(got.gather(), t_packed(words, 19, rule=t_rules.CONWAY,
                                                  topology=topology))
        for name, state, g in [("brain", _planes("brain", (64, 96), 80), 8),
                               (LTL_BOX, _words((96, 4), 81), 2)]:
            rule = t_parse(name)
            make = (t_sharded.make_multi_step_ltl_kernel if name == LTL_BOX
                    else t_sharded.make_multi_step_generations_kernel)
            got = make(tm, rule, topology, g)(
                t_mesh.device_put_sharded_grid(_t(state), tm, banded=True),
                2 * g + 1)
            want = t_sharded.make_multi_step_banded(tm, rule, topology)(
                t_mesh.device_put_sharded_grid(_t(state), tm, banded=True),
                2 * g + 1)
            assert torch.equal(got.gather(), want.gather()), name


def test_band_runners_refuse_a_chunk_deeper_than_a_band():
    tm = t_mesh.make_mesh((8, 1), ["cpu"] * 8)
    words = t_mesh.device_put_sharded_grid(_t(_words((64, 2), 83)), tm,
                                           banded=True)
    run = t_sharded.make_multi_step_kernel(tm, t_rules.CONWAY, TTop.TORUS, 16)
    run(words, 8)                      # one chunk of 8 fits the 8-row bands
    with pytest.raises(ValueError, match="band height"):
        run(words, 16)
    ltl = t_sharded.make_multi_step_ltl_kernel(tm, t_parse(LTL_BOX),
                                               TTop.DEAD, 5)
    ltl(words, 4)                      # r*4 = 8 rows: fits
    with pytest.raises(ValueError, match="band height"):
        ltl(words, 5)                  # r*5 = 10 rows: deeper than a band
    short = t_mesh.device_put_sharded_grid(_t(_words((32, 2), 84)), tm,
                                           banded=True)   # 4-row bands
    with pytest.raises(ValueError, match="band height"):
        t_sharded.make_multi_step_banded(tm, t_parse("bosco"), TTop.TORUS)(
            short, 1)
    with pytest.raises(ValueError, match="gens_per_call"):
        t_sharded.make_multi_step_kernel(tm, t_rules.CONWAY, TTop.TORUS, 40)


def _gen_slab_pallas(name, words, topology, g, code):
    step = ps.make_pallas_gen_slab_step(
        j_parse(name), JTop(topology), words.shape, gens=g, block_rows=8,
        interpret=True, dead_band=True)
    return np.asarray(step(jnp.asarray(words), jnp.full((1, 1), code, jnp.int32)))


def test_generations_slab_reference_matches_pallas():
    """B3 slab's plain version on a batch of four bands with edge codes 0-3
    (one per band, as a tensor), against the JAX slab step per band, at
    g in {1, 3, 8}, b = 2 and 3, under TORUS and DEAD."""
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    for name in ["brain", "B2/S345/C5"]:
        b = n_planes(j_parse(name).states)
        words = _words((4, b, 40, 2), 85)
        for topology in ("torus", "dead"):
            for g, tile in [(1, (7, 1)), (3, None), (8, (5, 2))]:
                got = cuda_stencil.slab_step_generations_reference(
                    _t(words), g, rule=t_parse(name), topology=TTop(topology),
                    edge_code=codes, tile=tile).numpy().view(np.uint32)
                for i in range(4):
                    np.testing.assert_array_equal(
                        got[i], _gen_slab_pallas(name, words[i], topology, g, i),
                        err_msg=f"{name} {topology} g={g} code={i}")


def test_ltl_slab_reference_matches_pallas():
    """B4 slab's plain version on a batch of four bands with edge codes
    0-3, against the JAX slab step per band: a box and a diamond rule,
    halo and dead band r*g rows deep."""
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    for name in [LTL_BOX, LTL_DIAMOND]:
        r = t_parse(name).radius
        for topology in ("torus", "dead"):
            for g in (1, 2):
                He = 24 + 2 * r * g
                words = _words((4, He, 2), 87 + g)
                got = cuda_stencil.slab_step_ltl_reference(
                    _t(words), g, rule=t_parse(name), topology=TTop(topology),
                    edge_code=codes, tile=(9, 1)).numpy().view(np.uint32)
                for i in range(4):
                    step = ps.make_ltl_pallas_slab_step(
                        j_parse(name), JTop(topology), (He, 2), gens=g,
                        block_rows=He, interpret=True, dead_band=True)
                    want = np.asarray(step(jnp.asarray(words[i]),
                                           jnp.full((1, 1), i, jnp.int32)))
                    np.testing.assert_array_equal(
                        got[i], want, err_msg=f"{name} {topology} g={g} code={i}")


def test_per_band_codes_equal_one_launch_per_code():
    """A tensor of per-band codes gives each band what a launch with that
    band's code alone gives: B2, B3 slab and B4 slab."""
    codes = torch.tensor([1, 0, 0, 2], dtype=torch.int32)
    cases = [
        (cuda_stencil.slab_step_reference, t_rules.parse_rule("B36/S23"),
         _words((4, 30, 2), 90), 3),
        (cuda_stencil.slab_step_generations_reference, t_parse("starwars"),
         _words((4, 2, 30, 2), 91), 3),
        (cuda_stencil.slab_step_ltl_reference, t_parse(LTL_BOX),
         _words((4, 30, 2), 92), 2),
    ]
    for fn, rule, words, g in cases:
        got = fn(_t(words), g, rule=rule, topology=TTop.DEAD, edge_code=codes)
        for i, code in enumerate(codes.tolist()):
            want = fn(_t(words[i:i + 1]), g, rule=rule, topology=TTop.DEAD,
                      edge_code=code)
            assert torch.equal(got[i], want[0]), (fn.__name__, i)


def test_slab_wrappers_run_the_plain_version_on_the_cpu_only():
    brain, box = t_parse("brain"), t_parse(LTL_BOX)
    planes, words = _t(_words((3, 2, 40, 2), 93)), _t(_words((3, 40, 2), 94))
    before = (cuda_stencil.GENERATIONS_SLAB_LAUNCHES,
              cuda_stencil.LTL_SLAB_LAUNCHES)
    codes = torch.tensor([1, 0, 2], dtype=torch.int32)
    got = cuda_stencil.slab_step_generations_kernel(planes, 4, rule=brain,
                                                    edge_code=codes)
    assert torch.equal(got, cuda_stencil.slab_step_generations_reference(
        planes, 4, rule=brain, edge_code=codes))
    got = cuda_stencil.slab_step_ltl_kernel(words, 2, rule=box, edge_code=3)
    assert torch.equal(got, cuda_stencil.slab_step_ltl_reference(
        words, 2, rule=box, edge_code=3))
    assert (cuda_stencil.GENERATIONS_SLAB_LAUNCHES,
            cuda_stencil.LTL_SLAB_LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_stencil.slab_step_generations_kernel(planes.to("meta"), 4,
                                                  rule=brain)
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_stencil.slab_step_ltl_kernel(words.to("meta"), 2, rule=box)


def test_slab_wrappers_refuse_what_the_kernels_cannot_take():
    brain, box = t_parse("brain"), t_parse(LTL_BOX)
    planes, words = _t(_words((2, 2, 40, 2), 95)), _t(_words((2, 40, 2), 96))
    with pytest.raises(ValueError, match="4D"):
        cuda_stencil.slab_step_generations_kernel(planes[0], 4, rule=brain)
    with pytest.raises(ValueError, match="bit-planes"):
        cuda_stencil.slab_step_generations_kernel(planes, 4,
                                                  rule=t_parse("B2/S345/C5"))
    with pytest.raises(ValueError, match="binary"):
        cuda_stencil.slab_step_ltl_kernel(words, 2,
                                          rule=t_parse("R2,C3,M1,S3..8,B5..9"))
    for bad in (torch.zeros(3, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="per-band edge codes"):
            cuda_stencil.slab_step_ltl_kernel(words, 2, rule=box, edge_code=bad)
    with pytest.raises(ValueError, match="edge_code"):
        cuda_stencil.slab_step_generations_kernel(planes, 4, rule=brain,
                                                  edge_code=4)
    with pytest.raises(ValueError, match="gens_per_call"):
        cuda_stencil.slab_step_ltl_kernel(words, 33, rule=box)
    # the 16384^2 mesh main path's bands: four per launch
    assert cuda_stencil.supported_generations_slab((4128, 512), 2, 16, batch=4)
    assert cuda_stencil.supported_ltl_slab((4116, 512), t_parse("bosco"), 2,
                                           batch=4)
    assert not cuda_stencil.supported_generations_slab((4128, 512), 9, 16)
    assert not cuda_stencil.supported_generations_slab((40, 2), 2, 16,
                                                       batch=70000)
    assert not cuda_stencil.supported_ltl_slab((40, 2), t_parse("bosco"), 40)
    assert not cuda_stencil.supported_ltl_slab(
        (40, 2), t_parse("R2,C3,M1,S3..8,B5..9"), 2)
    # tiles: the full-grid tile (28 words: one warp of 30 written words
    # with the halo), no wider than the band, rows evened out
    assert cuda_stencil._resolve_generations_slab(2, 16, 4128, 512, None) \
        == (16, 188, 28)
    # (the LtL tile's 256 rows evened over 4116: 16 tiles of 258 rows)
    assert cuda_stencil._resolve_ltl_slab(t_parse("bosco"), 2, 4116, 512,
                                          None) == (2, 258, 32)
    assert cuda_stencil._resolve_generations_slab(8, 16, 40, 2, None)[2] == 2
