"""The analysis package on a card: the transfer guard has teeth (a sync
inside it raises) and restores the mode; each kernel runner of the
contract gate launches ceil(n/g) of its own kernel, no other kernel and
no device-to-host copy; each family's engine steps under the guard equal
to its unguarded run; the gate holds every registered runner on the card
against the committed manifest. Each test skips without a CUDA device.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_gpu_analysis.py``.
"""

import math

import pytest
import torch

from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch.analysis import contracts, sanitizers
from gameoflifewithactors_torch.models import seeds

CUDA_RUNNERS = ("cuda.multi_step_kernel", "cuda.multi_step_lane_kernel",
                "cuda.slab_step_kernel", "cuda.multi_step_generations_kernel",
                "cuda.slab_step_generations_kernel", "cuda.multi_step_ltl_kernel",
                "cuda.slab_step_ltl_kernel")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
def test_the_guard_raises_on_a_sync_and_restores_the_mode(monkeypatch):
    _need_cuda()
    monkeypatch.setenv(sanitizers.ENV_SANITIZE, "1")
    t = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError):
        with sanitizers.no_implicit_host_transfers("cuda"):
            # goltpu: ignore[GOL001] -- the negative control: this sync must raise
            int(t.sum())
    assert torch.cuda.get_sync_debug_mode() == 0
    with sanitizers.no_implicit_host_transfers("cuda"):
        with sanitizers.allow_host_transfers("a declared readback"):
            assert int(t.sum()) == 64
    assert sanitizers.guard_depth() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", CUDA_RUNNERS)
def test_kernel_runner_launches_its_kernel_alone(name):
    _need_cuda()
    spec = contracts.load_registry()[name]
    res = contracts.check_runner(spec, "cuda")
    built = spec.factory(torch.device("cuda"))
    assert res.errors == []
    assert res.launches == {built.kernel: built.launches}
    assert res.other_kernels == 0
    assert res.sync_ops["Memcpy DtoH"] == 0 and res.host_syncs == 0


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["B3/S23", "brain", "bosco"])
def test_engine_steps_under_the_guard_equal_to_unguarded(monkeypatch, spec):
    _need_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cells = seeds.bernoulli(gen, (1024, 1024), 0.5)
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv(sanitizers.ENV_SANITIZE, flag)
        engine = Engine(cells, spec, device="cuda")
        engine.step(37)
        with sanitizers.no_implicit_host_transfers("cuda"):
            engine.population()
            engine.snapshot(max_shape=(16, 16))
        out.append(engine.state.clone())
    assert torch.equal(out[0], out[1])
    assert math.isfinite(float(out[0].float().sum()))


@pytest.mark.gpu
def test_the_gate_holds_every_runner_on_the_card():
    _need_cuda()
    results = contracts.check_all("cuda")
    lines = contracts.gate(results, contracts.load_manifest(), "cuda",
                           strict=True)
    assert not [line for line in lines if line.startswith("FAIL")], lines
    assert len(lines) == len(contracts.load_registry())
