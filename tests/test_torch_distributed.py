"""The port's elastic multi-process runtime against the JAX package's, on
the CPU.

The control plane (heartbeats, deadline-bounded barriers, peer monitors,
preempt flags) is the JAX package's own tests over the port's module;
``ElasticSpec``'s JSON and the genesis grid equal the JAX package's. Then
the real thing: gloo processes of ``python -m
gameoflifewithactors_torch.resilience.distributed`` on CPU positions,
one SIGKILLed at the midpoint, the survivors exiting on the peer-lost
status within the JAX package's bound, the rebuilt fleet replaying from
the last verified sharded checkpoint to a final grid equal to the JAX
package's single-device ``multi_step_packed``; and a preempted worker
shrinking the fleet, then a corrupted checkpoint refused at restore.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from gameoflifewithactors_torch.aot import cache as aot_cache
from gameoflifewithactors_torch.resilience import distributed as D
from gameoflifewithactors_torch.resilience.faultplan import FaultEvent
from gameoflifewithactors_tpu.models.generations import parse_any
from gameoflifewithactors_tpu.ops import bitpack
from gameoflifewithactors_tpu.ops.packed import multi_step_packed
from gameoflifewithactors_tpu.ops.stencil import Topology
from gameoflifewithactors_tpu.resilience import distributed as JD


# -- heartbeats + peer monitor -------------------------------------------------

def test_heartbeat_beats_and_carries_generation(tmp_path):
    hb = D.Heartbeat(tmp_path, epoch=0, process_id=3,
                     interval_seconds=0.05).start()
    try:
        hb.set_generation(42)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            payload = D.read_heartbeat(tmp_path, 0, 3)
            if payload and payload["generation"] == 42 and payload["seq"] >= 2:
                break
            time.sleep(0.02)
        assert payload["process_id"] == 3
        assert payload["generation"] == 42
        assert payload["seq"] >= 2  # the thread is beating, not just start()
    finally:
        hb.stop()


def test_peer_monitor_flags_dead_peer_within_deadline(tmp_path):
    """A peer that stops beating is declared lost in bounded time; a
    beating peer never is."""
    peer = D.Heartbeat(tmp_path, epoch=0, process_id=1,
                       interval_seconds=0.05).start()
    lost, lost_at = {}, []

    def on_lost(stale):
        lost.update(stale)
        lost_at.append(time.perf_counter())

    mon = D.PeerMonitor(tmp_path, epoch=0, process_id=0, num_processes=2,
                        deadline_seconds=0.5, on_peer_lost=on_lost,
                        poll_seconds=0.05).start()
    try:
        time.sleep(1.2)
        assert not lost  # beating peer stays alive past 2x the deadline
        peer.stop()  # "SIGKILL": the heartbeat file goes quiet
        t_dead = time.perf_counter()
        deadline = time.perf_counter() + 10.0
        while not lost and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert set(lost) == {1}
        assert lost[1] >= 0.5  # measured staleness honors the deadline
        assert lost_at[0] - t_dead < 5.0  # detected in bounded time
    finally:
        mon.stop()
        peer.stop()


def test_peer_monitor_flags_peer_that_never_appeared(tmp_path):
    lost = {}
    mon = D.PeerMonitor(tmp_path, epoch=2, process_id=0, num_processes=2,
                        deadline_seconds=0.3, on_peer_lost=lost.update,
                        poll_seconds=0.05).start()
    try:
        deadline = time.perf_counter() + 10.0
        while not lost and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert set(lost) == {1}
    finally:
        mon.stop()


# -- deadline-bounded barriers -------------------------------------------------

def test_barrier_completes_when_all_arrive(tmp_path):
    errs = []

    def arrive(pid):
        try:
            D.barrier(tmp_path, 0, "c0-pre", pid, 3, deadline_seconds=10.0)
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errs.append(exc)

    threads = [threading.Thread(target=arrive, args=(p,)) for p in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15.0)
    assert not errs
    assert not any(t.is_alive() for t in threads)


def test_barrier_deadline_bounds_the_wait(tmp_path):
    """A stalled peer must cost exactly the deadline, never a hang."""
    t0 = time.perf_counter()
    with pytest.raises(D.PeerLostError) as exc_info:
        D.barrier(tmp_path, 0, "c1-pre", 0, 2, deadline_seconds=0.5)
    elapsed = time.perf_counter() - t0
    assert 0.5 <= elapsed < 5.0
    assert exc_info.value.missing == (1,)  # the absentee is named


def test_barrier_fast_exits_on_terminal_peer(tmp_path):
    """A peer that already published a terminal status will never
    arrive — waiting out the full deadline would only slow recovery."""
    D.write_status(tmp_path, 0, 1, "error", 7, detail="boom")
    t0 = time.perf_counter()
    with pytest.raises(D.PeerLostError, match="terminal"):
        D.barrier(tmp_path, 0, "c2-pre", 0, 2, deadline_seconds=60.0)
    assert time.perf_counter() - t0 < 10.0  # nowhere near the 60s deadline


def test_preempt_flags_are_per_epoch(tmp_path):
    D.request_preempt(tmp_path, epoch=1, process_id=2)
    assert D.preempts_requested(tmp_path, 1, 4) == {2}
    assert D.preempts_requested(tmp_path, 2, 4) == set()


def test_elastic_spec_json_roundtrip():
    spec = D.ElasticSpec(shape=(32, 64), target_gens=50, chunk=10,
                         chunk_sleep_seconds=0.1)
    again = D.ElasticSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert again == spec
    assert isinstance(again.shape, tuple)


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"shape": (32, 64), "target_gens": 50, "chunk": 10,
         "chunk_sleep_seconds": 0.1},
    {"mesh_shape": (2, 2), "gens_per_exchange": 8, "rng_seed": 5,
     "random_fill": 0.5, "devices_per_process": 2},
])
def test_spec_json_and_genesis_equal_jax(kw):
    """The same spec gives the JAX package's JSON, exit statuses and
    genesis grid, and each package reads the other's JSON back."""
    spec, jspec = D.ElasticSpec(**kw), JD.ElasticSpec(**kw)
    assert spec.to_dict() == jspec.to_dict()
    assert D.ElasticSpec.from_dict(jspec.to_dict()) == spec
    np.testing.assert_array_equal(D.initial_grid(spec),
                                  JD.initial_grid(jspec))
    assert (D.EXIT_DONE, D.EXIT_PREEMPTED, D.EXIT_PEER_LOST) == \
        (JD.EXIT_DONE, JD.EXIT_PREEMPTED, JD.EXIT_PEER_LOST) == (0, 17, 18)
    assert D.TERMINAL_STATUSES == JD.TERMINAL_STATUSES


# -- the real thing: kill one worker, recover bit-exact ------------------------

def _oracle(spec):
    packed0 = jnp.asarray(bitpack.pack_np(JD.initial_grid(spec)))
    return bitpack.unpack_np(np.asarray(multi_step_packed(
        packed0, spec.target_gens, rule=parse_any(spec.rule),
        topology=Topology(spec.topology))))[:, :spec.shape[1]]


def _kill_one_and_recover(tmp_path, n):
    spec = D.ElasticSpec(shape=(96, 64), target_gens=80, chunk=20,
                         chunk_sleep_seconds=0.25)
    fleet = D.ElasticFleet(tmp_path / "run", spec, num_processes=n,
                           device="cpu", backend="gloo")
    # the workers load kernels from this process's build cache root
    assert fleet._env[aot_cache.ENV_CACHE_DIR] == aot_cache.cache_root()
    report = fleet.run([FaultEvent(worker=1, at_gen=40,
                                   kind="process_kill")])

    assert report["ok"], json.dumps(report["epochs"], indent=2)
    assert [f["kind"] for f in report["faults_fired"]] == ["process_kill"]
    fault_epochs = [e for e in report["epochs"] if e["fired"]]
    bound = (spec.heartbeat_deadline_seconds
             + spec.barrier_deadline_seconds + 20.0)
    assert fault_epochs and fault_epochs[0]["detection_seconds"] <= bound
    # the SIGKILLed worker is replaced, not shrunk: the roster stays
    assert all(e["num_processes"] == n for e in report["epochs"])
    # survivors exited on the distinct peer-lost status, nobody wedged
    codes = fault_epochs[0]["exit_codes"]
    assert codes.count(D.EXIT_PEER_LOST) == n - 1 and None not in codes
    assert report["epochs"][-1]["recovery_seconds"] > 0
    oracle = _oracle(spec)
    np.testing.assert_array_equal(np.load(report["final_grid"]), oracle)
    assert oracle.sum() > 0  # the universe is alive — the diff means something


def test_kill_one_of_two_recovers_bit_identical(tmp_path):
    """Two gloo processes, SIGKILL one mid-run: the survivor self-detects
    within the deadline, the replacement resumes from the last verified
    sharded checkpoint, and the final grid equals the JAX oracle."""
    _kill_one_and_recover(tmp_path, 2)


def test_preempt_shrinks_and_checkpoint_rot_falls_back(tmp_path):
    """The JAX package's roster rules on the port: a preempted worker
    leaves (the fleet shrinks from two processes to one, the preempted
    worker exits 17 and its peer 18); a ``checkpoint_corrupt`` kills the
    last worker and flips a byte of the newest committed shard, so the
    replacement refuses that generation and falls back to an older one;
    the final grid still equals the JAX oracle."""
    spec = D.ElasticSpec(shape=(96, 64), target_gens=120, chunk=20,
                         chunk_sleep_seconds=0.25)
    fleet = D.ElasticFleet(tmp_path / "run", spec, num_processes=2,
                           device="cpu", backend="gloo")
    report = fleet.run([
        FaultEvent(worker=1, at_gen=20, kind="process_preempt"),
        FaultEvent(worker=0, at_gen=40, kind="checkpoint_corrupt",
                   params={"seed": 3})])
    assert report["ok"], json.dumps(report["epochs"], indent=2)
    assert [f["kind"] for f in report["faults_fired"]] == \
        ["process_preempt", "checkpoint_corrupt"]
    assert "corrupted" in report["faults_fired"][1]["detail"]
    assert [e["num_processes"] for e in report["epochs"]] == [2, 1, 1]
    assert sorted(report["epochs"][0]["exit_codes"]) == \
        [D.EXIT_PREEMPTED, D.EXIT_PEER_LOST]
    restore = json.loads(
        (tmp_path / "run" / "restore" / "e002-p0000.json").read_text())
    refused = [int(d.rsplit("gen-", 1)[1]) for d, _why in restore["skipped"]]
    assert refused and restore["resumed_generation"] < min(refused)
    np.testing.assert_array_equal(np.load(report["final_grid"]),
                                  _oracle(spec))


@pytest.mark.slow
def test_kill_one_of_four_recovers_bit_identical(tmp_path):
    """The JAX package's slow test on the port: four processes, one
    SIGKILLed, three survivors exit 18."""
    _kill_one_and_recover(tmp_path, 4)
