"""The observed and supervised run on a card: the sampling profiler's
window, opened from its own thread, sees the kernels the main thread
launches; the roofline reads the card's peaks from the device; a
supervised run recovers from a corrupt_region bit for bit; an induced
retrace runs ``nvcc`` and lands in the compile log. Each test skips
without a CUDA device.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_gpu_observe.py``.
"""

import pytest
import torch

from gameoflifewithactors_torch import GridCoordinator
from gameoflifewithactors_torch.obs import compile as obs_compile
from gameoflifewithactors_torch.obs.device import gpu_peaks
from gameoflifewithactors_torch.obs.report import begin_run_telemetry
from gameoflifewithactors_torch.resilience import (FaultEvent, Supervisor,
                                                   apply_fault,
                                                   induce_retrace)

SHAPE = (4096, 4096)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("spec,marker", [("B3/S23", "life_packed_kernel"),
                                         ("brain", "life_generations_kernel"),
                                         ("bosco", "ltl_kernel")])
def test_profiler_window_sees_the_main_threads_kernels(spec, marker):
    _need_cuda()
    coord = GridCoordinator(SHAPE, spec, random_fill=0.5, rng_seed=2)
    coord.run(16)
    telem = begin_run_telemetry(profile_sample=5.0)
    telem.attach(coord)
    coord.run(400, render_every=100)
    rep = telem.finish(engine=coord.engine)
    prof = rep.profile
    assert prof["source"] == "device_tracks"
    assert marker in prof["top_kernels"][0][0]
    assert prof["op_class_fraction"]["stencil"] > 0.5
    assert 0 < prof["device_duty_cycle"] <= 1
    frac = rep.roofline["achieved_fraction"]
    assert 0 < frac["of_int_op_peak"] <= 1.05
    assert 0 < frac["of_hbm_bandwidth"] <= 1.05


@pytest.mark.gpu
def test_peaks_come_from_the_device():
    _need_cuda()
    peaks = gpu_peaks(0)
    props = torch.cuda.get_device_properties(0)
    assert peaks["sms"] == props.multi_processor_count
    assert peaks["int_ops_per_sec"] == pytest.approx(
        props.multi_processor_count * 64 * peaks["max_sm_clock_mhz"] * 1e6)
    assert 1e11 < peaks["hbm_gbps"] * 1e9 < 1e13
    if "H100" in props.name and "HBM3" in props.name:
        assert peaks["hbm_gbps"] == pytest.approx(3350, rel=0.01)


@pytest.mark.gpu
def test_supervised_run_recovers_bit_for_bit(tmp_path):
    _need_cuda()
    coord = GridCoordinator(SHAPE, "B3/S23", random_fill=0.5, rng_seed=3)
    plain = GridCoordinator(SHAPE, "B3/S23", random_fill=0.5, rng_seed=3)
    sup = Supervisor(coord, checkpoint_path=str(tmp_path / "c.npz"),
                     checkpoint_every=100, sleep_fn=lambda s: None)
    event = FaultEvent(0, 100, "corrupt_region",
                       {"top_f": 0.1, "left_f": 0.2, "h_f": 0.3, "w_f": 0.3,
                        "seed": 5})
    sup.before_chunk = lambda gen: (
        apply_fault(sup, event) if gen == 100 and not sup.stats()["restarts"]
        else None)
    stats = sup.run(300)
    plain.run(300)
    assert stats["restarts_by_cause"] == {"fault:corrupt_region": 1}
    assert torch.equal(coord.engine.state, plain.engine.state)


@pytest.mark.gpu
def test_induced_retrace_builds_a_kernel_variant():
    _need_cuda()
    log = len(obs_compile.COMPILE_LOG.events())
    induce_retrace("cuda")
    new = obs_compile.COMPILE_LOG.events()[log:]
    assert [(e.runner, e.kind) for e in new] == \
        [("resilience.induced_retrace", "cache_miss")]
    assert new[0].wall_seconds > 0.5      # nvcc ran
