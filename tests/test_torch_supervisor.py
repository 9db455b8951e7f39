"""The port's Supervisor, fault plans and fault injectors against the JAX
package's, on the CPU: the same grid (numpy, from a seed) under the same
FaultPlan event ends in the same grid with equal ``stats()``; a
permanent fault opens the circuit; a corrupted newest checkpoint is
restored from ``.prev``; ``FaultPlan.generate`` gives the same JSON in
both packages."""

import numpy as np
import pytest

from gameoflifewithactors_torch.analysis.sanitizers import RetraceError
from gameoflifewithactors_torch.coordinator import GridCoordinator as TCoord
from gameoflifewithactors_torch.engine import Engine as TEngine
from gameoflifewithactors_torch.obs import compile as t_compile
from gameoflifewithactors_torch.obs import flight as t_flight
from gameoflifewithactors_torch.obs import watchdog as t_watchdog
from gameoflifewithactors_torch.parallel.mesh import make_mesh
from gameoflifewithactors_torch.resilience import (
    ALL_KINDS,
    CircuitOpenError,
    FaultEvent as TEvent,
    FaultPlan as TPlan,
    RestartPolicy,
    Supervisor as TSup,
    apply_fault as t_apply,
    induce_retrace,
    induce_stall,
)
from gameoflifewithactors_torch.utils import fault as t_fault
from gameoflifewithactors_tpu.coordinator import GridCoordinator as JCoord
from gameoflifewithactors_tpu.engine import Engine as JEngine
from gameoflifewithactors_tpu.resilience import (
    FaultEvent as JEvent,
    FaultPlan as JPlan,
    Supervisor as JSup,
    apply_fault as j_apply,
)
from gameoflifewithactors_tpu.utils import fault as j_fault

SHAPE = (48, 96)


def _grid(seed=7, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.35).astype(np.uint8)


def _port(**kw):
    return TCoord(SHAPE, "B3/S23", seed=_grid(), device="cpu",
                  backend="packed", **kw)


def _oracle(generations):
    c = _port()
    c.tick(generations)
    return c.snapshot()


def _supervised(pkg, tmp_path, event: dict, *, validator: bool):
    """Run 100 generations under each package's Supervisor (chunks of
    20), firing ``event`` at the first boundary at or past its at_gen;
    returns (final grid, stats)."""
    if pkg == "torch":
        coord = _port()
        Sup, fault, apply, Event = TSup, t_fault, t_apply, TEvent
    else:
        coord = JCoord(SHAPE, "B3/S23", seed=_grid(), backend="dense")
        Sup, fault, apply, Event = JSup, j_fault, j_apply, JEvent
    validators = [fault.population_bounds_validator(min_pop=1)] \
        if validator else ()
    sup = Sup(coord, checkpoint_path=str(tmp_path / f"{pkg}.npz"),
              checkpoint_every=20, validators=validators,
              sleep_fn=lambda s: None)
    ev = Event.from_dict(event)
    fired = []

    def before_chunk(gen):
        if gen >= ev.at_gen and not fired:
            fired.append(gen)
            if validator:
                # an undetected fault: the validator finds it at the
                # boundary
                fault.drop_region(coord.engine, 0, 0, *SHAPE)
            else:
                apply(sup, ev)

    sup.before_chunk = before_chunk
    stats = sup.run(100)
    assert fired, "the fault never fired"
    return coord.snapshot(), stats


@pytest.mark.parametrize("kind", ["corrupt_region", "drop_region",
                                  "validator"])
def test_supervised_run_matches_jax(tmp_path, kind):
    plan = TPlan.generate(
        3, workers=1, horizon=100, faults_per_worker=0,
        ensure_kinds=[kind if kind != "validator" else "drop_region"])
    event = plan.events[0].to_dict()
    got, t_stats = _supervised("torch", tmp_path, event,
                               validator=kind == "validator")
    want, j_stats = _supervised("jax", tmp_path, event,
                                validator=kind == "validator")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(100))
    assert t_stats == j_stats
    assert t_stats["restarts"] == 1 and t_stats["generation"] == 100


@pytest.mark.parametrize("seed", [0, 123])
def test_faultplan_generate_json_matches_jax(seed):
    kw = dict(workers=3, horizon=200, faults_per_worker=4,
              ensure_kinds=["retrace", "checkpoint_corrupt"],
              kill_workers=[1])
    t_plan, j_plan = TPlan.generate(seed, **kw), JPlan.generate(seed, **kw)
    assert t_plan.to_json() == j_plan.to_json()
    assert TPlan.from_json(j_plan.to_json()) == t_plan
    assert set(t_plan.kinds()) <= set(ALL_KINDS) | {"kill"}


def test_corrupt_region_bits_match_jax():
    grid = _grid(5)
    t_eng = TEngine(grid, "B3/S23", device="cpu")
    j_eng = JEngine(grid, "B3/S23", backend="dense")
    t_fault.corrupt_region(t_eng, 3, 10, 20, 40, seed=77)
    j_fault.corrupt_region(j_eng, 3, 10, 20, 40, seed=77)
    np.testing.assert_array_equal(t_eng.snapshot(), j_eng.snapshot())
    assert not np.array_equal(t_eng.snapshot(), grid)


def test_permanent_fault_opens_the_circuit(tmp_path):
    sleeps = []
    policy = RestartPolicy(max_restarts=3, backoff_initial_seconds=0.1,
                           backoff_max_seconds=0.25, backoff_factor=2.0)
    sup = TSup(_port(), checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=10, policy=policy, sleep_fn=sleeps.append)
    sup.before_chunk = lambda gen: sup.inject(
        "corrupt_region",
        lambda e: t_fault.corrupt_region(e, 0, 0, 8, 8, seed=1))
    with pytest.raises(CircuitOpenError, match="max_restarts=3"):
        sup.run(100)
    assert sleeps == [0.1, 0.2, 0.25]
    stats = sup.stats()
    assert stats["circuit_open"] is True and stats["restarts"] == 3


def test_corrupt_newest_checkpoint_restores_from_prev(tmp_path):
    path = tmp_path / "ck.npz"
    sup = TSup(_port(), checkpoint_path=str(path), checkpoint_every=10,
               sleep_fn=lambda s: None)
    corrupted = []

    def before_chunk(gen):
        if gen == 30 and not corrupted:
            t_fault.corrupt_checkpoint_file(path, seed=4)
            corrupted.append(gen)
            sup.inject("corrupt_region",
                       lambda e: t_fault.corrupt_region(e, 0, 0, 8, 8, seed=9))

    sup.before_chunk = before_chunk
    stats = sup.run(50)
    assert stats["checkpoint_fallbacks"] == 1 and stats["restarts"] == 1
    assert (tmp_path / "ck.npz.prev").exists()
    np.testing.assert_array_equal(sup.coordinator.snapshot(), _oracle(50))


def test_stall_is_detected_restored_and_dumped(tmp_path):
    wd = t_watchdog.arm(t_watchdog.StallWatchdog(0.2))
    fr = t_flight.FlightRecorder(str(tmp_path / "flight.jsonl"))
    fr.install(watchdog=wd)
    t_flight.arm(fr)
    try:
        sup = TSup(_port(), checkpoint_path=str(tmp_path / "c.npz"),
                   checkpoint_every=15, sleep_fn=lambda s: None)
        sup.before_chunk = lambda gen: (
            sup.inject("stall", lambda e: induce_stall(sup.coordinator, 0.6))
            if gen == 15 and not sup.stats()["restarts"] else None)
        stats = sup.run(45)
        assert stats["stalls_detected"] == 1
        assert stats["restarts_by_cause"] == {"fault:stall": 1}
        assert fr.dumps >= 1 and "stall" in fr.last_dump_reason
        assert len(wd.events) == 1
        np.testing.assert_array_equal(sup.coordinator.snapshot(), _oracle(45))
    finally:
        t_flight.disarm()
        t_watchdog.disarm()


def test_induced_retrace_is_attributed_not_rolled_back(tmp_path):
    sup = TSup(_port(), checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=10, sleep_fn=lambda s: None)
    events = len(t_compile.COMPILE_LOG.events())
    sup.before_chunk = lambda gen: (
        t_apply(sup, TEvent(0, 10, "retrace"))
        if gen == 10 and not sup.stats()["retraces_attributed"] else None)
    stats = sup.run(30)
    assert stats["retraces_attributed"] == 1 and stats["restarts"] == 0
    new = t_compile.COMPILE_LOG.events()[events:]
    assert [e.runner for e in new if e.cache_miss] == \
        ["resilience.induced_retrace"]
    np.testing.assert_array_equal(sup.coordinator.snapshot(), _oracle(30))


def test_unattributed_kernel_build_after_warmup_raises(tmp_path):
    sup = TSup(_port(), checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=10, sleep_fn=lambda s: None)
    # a build no injection explains, after the first clean chunk
    sup.before_chunk = lambda gen: induce_retrace() if gen == 20 else None
    with pytest.raises(RetraceError, match="kernel build"):
        sup.run(30)


def test_shard_injectors_on_a_mesh_and_their_fallback(tmp_path):
    grid = _grid(11)
    mesh = make_mesh((2, 1), ["cpu"] * 2)
    eng = TEngine(grid, "B3/S23", mesh=mesh, device="cpu")
    assert eng.backend == "packed"
    t_fault.drop_shard(eng, 1)
    got = eng.snapshot()
    np.testing.assert_array_equal(got[24:], 0)
    np.testing.assert_array_equal(got[:24], grid[:24])
    t_fault.corrupt_shard(eng, 0, seed=2)
    words = np.random.default_rng(2).integers(
        0, 2 ** 32, size=(24, 3), dtype=np.uint32)
    block = eng.sharded_state.blocks()[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(block, words)
    # without a mesh a shard fault degrades to its region form
    sup = TSup(_port(), checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=10, sleep_fn=lambda s: None)
    assert t_apply(sup, TEvent(0, 0, "drop_shard", {"shard_f": 0.5})) \
        == "drop_region"
    with pytest.raises(ValueError, match="launcher kinds"):
        t_apply(sup, TEvent(0, 0, "process_kill"))


def test_guarded_run_recovers_bit_exact(tmp_path):
    eng = TEngine(_grid(), "B3/S23", device="cpu")
    dropped = []

    def validate(e):
        if e.generation == 40 and not dropped:
            dropped.append(e.generation)
            return False
        return True

    run = t_fault.GuardedRun(eng, checkpoint_every=20,
                             checkpoint_path=str(tmp_path / "g.npz"),
                             validator=validate)
    run.run(80)
    assert run.recoveries == 1 and eng.generation == 80
    np.testing.assert_array_equal(eng.snapshot(), _oracle(80))
