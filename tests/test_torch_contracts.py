"""The runner contract gate of the port on the CPU: the registry carries
the JAX package's 15 names (plus the kernel runners, tagged ``cuda``);
``--device cpu --strict`` passes against the committed manifest; the
communication-avoiding runners move exactly the JAX manifest's bytes; the
injection seam fails the gate naming its runner; a manifest of another
torch version gates as stale, a kernel runner on the CPU as needing CUDA;
each invariant (host syncs, in place, halo bytes, gathers) fails on a
runner built to break it, and the manifest's completeness is checked.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from gameoflifewithactors_torch.analysis import contracts
from gameoflifewithactors_torch.ops._builders import (BuilderSpec,
                                                      BuiltRunner,
                                                      steps_in_place)
from gameoflifewithactors_tpu.analysis import contracts as jax_contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MANIFEST = os.path.join(REPO, "results", "hlo_contracts.json")
CLI = [sys.executable, "-m", "gameoflifewithactors_torch.analysis.contracts"]


def _gate_cli(*args, env=None):
    e = dict(os.environ)
    e.update(env or {})
    return subprocess.run(CLI + list(args), cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cpu_results():
    return {r.name: r for r in contracts.check_all("cpu")}


def test_the_registry_carries_the_jax_names():
    ours = contracts.load_registry()
    plain = {n for n, s in ours.items() if "cuda" not in s.tags}
    assert plain == set(jax_contracts.load_registry())
    assert len(plain) == 15
    kernels = {n for n, s in ours.items() if "cuda" in s.tags}
    assert len(kernels) == 7 and all(n.startswith("cuda.") for n in kernels)


def test_the_cli_passes_strict_on_the_cpu_against_the_manifest():
    r = _gate_cli("--device", "cpu", "--strict")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert sum(line.startswith("ok ") for line in lines) == 15
    assert sum(line.startswith("needs CUDA ") for line in lines) == 7


def test_comm_avoiding_bytes_equal_the_jax_manifest(cpu_results):
    with open(JAX_MANIFEST) as f:
        ref = json.load(f)["runners"]
    for name in ("sharded.multi_step_packed_ghost",
                 "sharded.multi_step_packed_deep"):
        res = cpu_results[name]
        assert res.errors == []
        assert res.halo_bytes == res.expected_halo_bytes == \
            ref[name]["expected_collective_bytes"]
    assert cpu_results["sharded.multi_step_packed_ghost"].halo_bytes == 1536
    assert cpu_results["sharded.multi_step_packed_deep"].halo_bytes == 2048


def test_the_injection_seam_fails_the_gate_naming_the_runner():
    name = "sharded.multi_step_packed_ghost"
    r = _gate_cli("--device", "cpu", "--only", name,
                  env={contracts.ENV_INJECT: name})
    assert r.returncode == 1, r.stdout + r.stderr
    fails = [line for line in r.stdout.splitlines()
             if line.startswith("FAIL")]
    assert fails and all(line.startswith(f"FAIL {name}:") for line in fails)
    assert "halo bytes" in fails[0]


def test_stale_manifest_and_kernel_runners_on_the_cpu(cpu_results):
    frozen = contracts.load_manifest()
    results = list(cpu_results.values())
    lines = contracts.gate(results, frozen, "cpu", strict=True)
    assert not any(line.startswith("FAIL") for line in lines), lines
    stale = json.loads(json.dumps(frozen))
    stale["platforms"]["cpu"]["torch"] = "0.0.0"
    lines = contracts.gate(results, stale, "cpu", strict=True)
    assert sum(line.startswith("skipped (stale) ") for line in lines) == 15
    needs = [line for line in lines if line.startswith("needs CUDA ")]
    assert len(needs) == 7 and not any(line.startswith("ok ") for line in lines)


def test_the_paged_and_pool_runners_step_in_place(cpu_results):
    for name in ("batched.multi_step_paged", "memory.pool_write_slot",
                 "memory.pool_zero_slot"):
        assert cpu_results[name].in_place is True
    assert cpu_results["batched.multi_step_paged"].gathers > 0
    assert not any(r.in_place for n, r in cpu_results.items()
                   if n.startswith(("ops.", "sharded.")))


def _spec(factory, tags=("test",)):
    return BuilderSpec(name="test.runner", factory=factory, tags=tags)


def test_each_invariant_fails_naming_the_runner():
    t = torch.arange(16, dtype=torch.int32)

    def syncing(device):
        return BuiltRunner(lambda s: s + int(s.sum()), (t.clone(),))

    @steps_in_place
    def pure_but_declared(s):
        return s + 1

    def lying(device):
        return BuiltRunner(pure_but_declared, (t.clone(),))

    def writing(device):
        def run(s):
            s.add_(1)
            return s
        return BuiltRunner(run, (t.clone(),))

    def gatherless(device):
        return BuiltRunner(lambda s: s + 1, (t.clone(),), require_gather=True,
                           expected_halo_bytes=8, halo_model="a model")

    msgs = {name: contracts.check_runner(_spec(f), "cpu").errors
            for name, f in [("sync", syncing), ("lie", lying),
                            ("write", writing), ("gather", gatherless)]}
    assert len(msgs["sync"]) == 1 and "host sync" in msgs["sync"][0]
    assert "did not write" in msgs["lie"][0]
    assert "wrote its arguments" in msgs["write"][0]
    assert len(msgs["gather"]) == 2
    assert all(m.startswith("test.runner: ") for v in msgs.values() for m in v)
    budgeted = contracts.check_runner(_spec(lambda d: BuiltRunner(
        lambda s: s + int(s.sum()), (t.clone(),), host_syncs=1,
        host_sync_reason="one declared count")), "cpu")
    assert budgeted.errors == [] and budgeted.host_syncs == 1
    with pytest.raises(ValueError, match="reason"):
        BuiltRunner(lambda s: s, (t,), host_syncs=1)


@pytest.mark.parametrize("lost", [1, contracts.TRACE_ATTEMPTS])
def test_a_trace_that_lost_records_is_measured_again(monkeypatch, lost):
    # the CPU profiler keeps no card records, so the card's count of
    # (launch calls, records) is stood in for: `lost` short traces first
    real, builds, traces = contracts._measure, [], []

    def measure(spec, device, inject):
        built, events, facts, _ = real(spec, device, inject)
        traces.append((5, 3) if len(traces) < lost else (5, 5))
        return built, events, facts, traces[-1]

    def factory(device):
        builds.append(device)
        return BuiltRunner(lambda s: s + 1, (torch.arange(4),))

    monkeypatch.setattr(contracts, "_measure", measure)
    res = contracts.check_runner(_spec(factory), "cpu")
    assert len(builds) == len(traces) == min(lost + 1,
                                             contracts.TRACE_ATTEMPTS)
    assert res.traces == len(traces)
    if lost < contracts.TRACE_ATTEMPTS:
        assert res.errors == [] and "traces=2" in res.summary()
    else:
        assert len(res.errors) == 1
        assert res.errors[0].startswith("test.runner: the profiler lost "
                                        "records in each of 3 measured calls")
        assert "3 of 5" in res.errors[0]


def test_strict_unpinned_and_unregistered_runners_fail(cpu_results):
    frozen = contracts.load_manifest()
    some = [cpu_results["ops.multi_step"]]
    lines = contracts.gate(some, frozen, "cpu", strict=True)
    missing = [line for line in lines if "no longer registered" in line]
    assert len(missing) == 14 and lines[0].startswith("ok ops.multi_step")
    assert contracts.gate(some, frozen, "cpu", strict=True,
                          complete=False) == lines[:1]
    lines = contracts.gate(some, {"platforms": {}}, "cpu", strict=True)
    assert lines[0].startswith("FAIL ops.multi_step: not pinned")
    assert contracts.gate(some, None, "cpu")[0].startswith("unpinned")


def test_bad_input_exits_2(tmp_path):
    assert _gate_cli("--device", "cpu", "--only", "no.such").returncode == 2
    bad = tmp_path / "m.json"
    bad.write_text("[]")
    assert _gate_cli("--device", "cpu", "--manifest",
                     str(bad)).returncode == 2


def test_write_pins_this_platform_and_keeps_the_others(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"platforms": {"cuda": {"torch": "x",
                                                       "runners": {}}}}))
    r = _gate_cli("--device", "cpu", "--write", "--only", "ops.multi_step",
                  "--manifest", str(path))
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(path.read_text())
    assert set(doc["platforms"]) == {"cpu", "cuda"}
    assert doc["platforms"]["cpu"]["torch"] == torch.__version__
    assert list(doc["platforms"]["cpu"]["runners"]) == ["ops.multi_step"]
