"""The four-card cell on four CPU positions: the batch driver's mesh
branch, the banded comparison and the faults it catches, and the mesh's
readers.

B2's slab form runs its plain version on CPU positions, so each test
drives the whole of a run but the look for the cards, at a small size.
"""

from __future__ import annotations

import random

import pytest
import torch

from benchmark import check, manifest
from benchmark.chip import control
from benchmark.drivers import batch
from benchmark.tests.conftest import SMALL, drive_cpu, names_of

CELL = "conway-mesh4-65536"
SEED = 2**31 + 11


def config():
    return manifest.config(manifest.load(), names_of(CELL)[0])


def test_a_sound_run_on_four_positions_is_correct():
    line = drive_cpu(CELL)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"start_mismatched_cells",
                                   "tick_mismatched_cells"}
    assert list(line)[-1] == "checks"


def _control(monkeypatch):
    control.install(manifest.traffic(names_of(CELL)[1]), config(),
                    monkeypatch.setattr)


def _no_exchange(monkeypatch):
    """Each band wraps round onto itself: no row crosses to a neighbour."""
    from gameoflifewithactors_torch.parallel import sharded

    def own_rows(parts, mesh, topology, axis=None, depth=1):
        return [torch.cat([p[..., -depth:, :], p, p[..., :depth, :]], dim=-2)
                for p in parts]

    monkeypatch.setattr(sharded, "exchange_rows", own_rows)


def _unchanged(monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    monkeypatch.setattr(Engine, "_run", lambda self, state, n: state)


def _altered(monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    real = Engine._run

    def flipped(self, state, n):
        out = real(self, state, n)
        parts = [p.clone() for p in out.parts]
        parts[-1].view(-1)[-7] ^= 1 << 3
        return out.with_parts(parts)

    monkeypatch.setattr(Engine, "_run", flipped)


@pytest.mark.parametrize("fault", [_control, _no_exchange, _unchanged,
                                   _altered])
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = drive_cpu(CELL)
    assert not line["correct"]
    assert line["checks"]["start_mismatched_cells"]["value"] > 0


@pytest.mark.parametrize("h, gens, radius", [(16, 5, 1), (8, 12, 1),
                                             (16, 2, 3)])
def test_bands_checked_apart_agree_with_the_whole_torus(h, gens, radius):
    """A margin deeper than a band reaches past its neighbour; a wider
    rule's margin is radius x generations."""
    conf = (config() if radius == 1 else
            manifest.config(manifest.load(), "bosco-r5"))
    if radius != 1:
        conf = dict(conf, neighbourhood=dict(conf["neighbourhood"],
                                             radius=radius))
    reference = check.Reference(conf)
    gen = torch.Generator().manual_seed(5)
    grid = torch.randint(-2**31, 2**31, (4 * h, 4), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    want = reference.run(grid, gens)
    bands = list(grid.split(h))
    after = [b.clone() for b in want.split(h)]
    assert check.compare_bands(reference, bands, after, gens, radius) == 0
    after[2][h - 1, 3] ^= 1 << 9
    assert check.compare_bands(reference, bands, after, gens, radius) == 1


def test_torus_rows_wrap_round():
    bands = list(torch.arange(12, dtype=torch.int32).reshape(12, 1).split(3))
    got = check.torus_rows(bands, -4, 10, torch.device("cpu"))
    assert got.flatten().tolist() == [8, 9, 10, 11, 0, 1, 2, 3, 4, 5]


def test_the_mesh_readers_in_a_traced_run():
    """The halo bytes are the program's counter, equal to its model: four
    bands on the torus each receive two strips of 32 rows of W/32 words
    per 32 generations, 4 x 2 x W/8 bytes a generation."""
    from gameoflifewithactors_torch.engine import Engine
    from gameoflifewithactors_torch.parallel.mesh import make_mesh

    line = drive_cpu(CELL, seconds=2.0, trace=True, trace_skip_seconds=0.05,
                     trace_seconds=0.3)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    h, w = SMALL[CELL]["shape"]
    assert metrics["mesh.halo_bytes_per_gen"]["value"] == 4 * 2 * w // 8
    engine = Engine(torch.zeros(h, w, dtype=torch.uint8), "B3/S23",
                    backend="cuda", gens_per_exchange=32,
                    mesh=make_mesh((4, 1), [torch.device("cpu")] * 4))
    assert engine.halo_bytes_per_gen("model") == 4 * 2 * w // 8
    assert metrics["coordinator.enqueue_ms_per_tick"]["value"] > 0
    assert metrics["device.idle_share.batch"]["value"] == 1.0  # no card
    # no launch of a kernel is counted on CPU positions: no share
    assert "b2_slab_roofline" not in metrics


def test_b2_slab_roofline_from_a_hand_made_trace():
    # one 512-generation tick of the cell: 16 chunks on each of 4 cards
    words = 65536 * 2048
    trace = {"kernels": {"void life_packed::life_packed_kernel<1, 2, 0>":
                         {"count": 64, "seconds": 0.2}},
             "counters": {"generations": 512,
                          "launches": {"life_slab": 64, "life_packed": 0}},
             "busy_s": 0.05, "window_s": 0.052, "whole": True}
    peaks = {"int_ops_per_sec": 1.6e13, "hbm_bytes_per_sec": 3.2e12}
    ctx = {"driver": "batch", "words": words, "trace": trace, "peaks": peaks,
           "config": config(), "traffic": {"shape": [65536, 65536]},
           "window": {"band_rows": 16384, "gens_per_exchange": 32}}
    ops = 512 * words * 20
    band_bytes = 64 * 2 * (16384 + 2 * 32) * 2048 * 4
    want = 100 * max(ops / 1.6e13, band_bytes / 3.2e12) / 0.2
    value, how = manifest.read_metric("b2_slab_roofline", ctx)
    assert value == pytest.approx(want) and "ops" in how
    # bytes-bound on a slower memory: one extended band a launch, not the
    # whole grid, four times as much
    slow = dict(ctx, peaks=dict(peaks, hbm_bytes_per_sec=1e11))
    value, how = manifest.read_metric("b2_slab_roofline", slow)
    assert value == pytest.approx(100 * band_bytes / 1e11 / 0.2)
    assert "bytes" in how
    # records lost, or a cell on one card: no share
    lost = dict(trace, kernels={"void life_packed::life_packed_kernel<1, 2, 0>":
                                {"count": 63, "seconds": 0.2}})
    assert manifest.read_metric("b2_slab_roofline",
                                dict(ctx, trace=lost)) is None
    assert manifest.read_metric("b2_slab_roofline",
                                dict(ctx, window={})) is None


@pytest.mark.parametrize("cell", ["conway-batch-16384", CELL])
def test_the_engine_calls_of_a_run(cell, monkeypatch):
    """A run without a mesh builds the engine on the one card and reads
    its state whole; a mesh run builds it on the mesh and reads the bands
    where they lie. Either way the ticks run as before: warm-up, then the
    window, the state read before and after each tick the reservoir
    keeps."""
    from gameoflifewithactors_torch.engine import Engine

    calls, inits = [], []
    real_init = Engine.__init__

    def init(self, grid, rule, **kw):
        inits.append(kw)
        real_init(self, grid, rule, **kw)

    def recorder(name, real):
        def call(self, *a, **kw):
            calls.append(name)
            return real(self, *a, **kw)
        return call

    def reader(name, prop):
        return property(lambda self: (calls.append(name), prop.fget(self))[1])

    monkeypatch.setattr(Engine, "__init__", init)
    for name in ("step", "block_until_ready"):
        monkeypatch.setattr(Engine, name, recorder(name, getattr(Engine, name)))
    for name in ("state", "sharded_state"):
        monkeypatch.setattr(Engine, name, reader(name, getattr(Engine, name)))
    line = drive_cpu(cell, seed=SEED)
    assert line["correct"], line["checks"]

    read = "state" if cell != CELL else "sharded_state"
    (kw,) = inits
    if cell == CELL:
        assert kw["gens_per_exchange"] == 32 and "device" not in kw
        assert tuple(kw["mesh"].shape.values()) == (4, 1)
    else:
        assert set(kw) == {"topology", "backend", "device"}
    want = ["step", "block_until_ready", read]
    rng = random.Random(SEED ^ batch.RESERVOIR_SALT)
    for t in range(line["attempted"]):
        keep = rng.random() * (t + 1) < 1.0
        want += ([read] if keep else []) + ["step", "block_until_ready"] + (
            [read] if keep else [])
    assert calls == want
