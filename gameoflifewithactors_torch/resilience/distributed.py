"""Elastic multi-process runtime: preemption-tolerant sharded runs.

Counterpart of ``gameoflifewithactors_tpu.resilience.distributed``, on
``torch.distributed`` (:mod:`..parallel.multihost`). The
:class:`~.supervisor.Supervisor` restarts a coordinator inside one
process; this module extends the same policy shape -- detect, restore
from a verified checkpoint, replay, give up after too many -- across a
fleet of processes forming one process group, where the failure mode is
harsher: one SIGKILLed process wedges every survivor inside an exchange
forever, and a single-file checkpoint cannot even be written (no process
holds the grid). Three pieces:

**Failure detection, bounded.** Every worker beats a per-process
heartbeat file on the shared rundir (the control plane -- a filesystem,
deliberately not a collective: it must keep working exactly when the
collectives don't) and each compute chunk is bracketed by
deadline-bounded :func:`barrier` rendezvous. The two detectors are
complementary: a *dead* peer (SIGKILL) stops beating and every
survivor's :class:`PeerMonitor` notices within ``heartbeat_deadline``
-- even while the survivor's main thread is wedged inside a receive,
because the monitor is a daemon thread and a gloo wait releases the GIL
-- and the survivor exits ``EXIT_PEER_LOST`` instead of hanging; a
*stalled* peer (alive, beating, not progressing) never reaches the
barrier and trips ``barrier_deadline`` instead. The process group's own
timeout (:func:`..parallel.multihost.initialize`) is a second bound.
Heartbeat staleness is judged by *local* clock elapsed since the file's
mtime last changed -- no cross-host clock comparison.

**Sharded, verified checkpoints.** After every chunk each process
writes only its own shards plus per-shard CRC32s
(``utils/checkpoint.py`` sharded v2), a barrier proves all shards
durable, and process 0 publishes the manifest with one atomic rename --
the only commit point. Restore verifies every checksum and falls back
generation by generation past torn or corrupt ones
(``load_latest_verified``), so a byte-flipped shard costs one
generation of replay, never a wrong grid.

**Elastic recovery.** On peer loss the survivors exit in bounded time;
the :class:`ElasticFleet` launcher tears the epoch down, rebuilds the
mesh over the remaining (or replacement) process set, re-places the
restored grid with ``put_global_grid``, and replays from the last
verified generation. On SIGTERM preemption a worker finishes its
chunk, checkpoints, flags its peers through the control plane, and
exits with the distinct ``EXIT_PREEMPTED`` status; the fleet re-forms
without it. Replay is pure function re-execution, so the final grid is
bit-identical to an unfaulted single-device run.

Workers run ``python -m gameoflifewithactors_torch.resilience.distributed``
on ``--device`` (default the card; the tests pass ``cpu``) with
``--backend`` (``gloo``, also for ranks that share one card, or
``nccl``), under the parent's kernel build cache root, so that no worker
runs ``nvcc``. Heartbeat misses, barrier timeouts, checkpoint
fallbacks, and fleet recovery latency all land in the ``obs`` registry
and the per-worker flight recorder.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..obs import flight as obs_flight
from ..obs import spans as obs_spans
from ..obs.registry import REGISTRY
from ..utils import checkpoint as ckpt_lib
from ..utils.checkpoint import CheckpointCorruptError

# distinct exit statuses — the launcher's classification signal
EXIT_DONE = 0
EXIT_PREEMPTED = 17  # got SIGTERM, finished chunk, checkpointed, left
EXIT_PEER_LOST = 18  # detected a dead/stalled/preempted peer; fleet must rebuild

TERMINAL_STATUSES = ("done", "preempted", "peer_lost", "error")


class PeerLostError(RuntimeError):
    """A peer failed to show up within the deadline."""

    def __init__(self, missing: Sequence[int], where: str,
                 deadline_seconds: float):
        self.missing = tuple(sorted(missing))
        self.where = where
        self.deadline_seconds = deadline_seconds
        super().__init__(
            f"peers {list(self.missing)} missing at {where!r} after "
            f"{deadline_seconds:.1f}s deadline")


# -- control-plane layout (everything under one shared rundir) ----------------

def _hb_path(rundir: Path, epoch: int, process_id: int) -> Path:
    return Path(rundir) / "hb" / f"e{epoch:03d}" / f"p{process_id:04d}.json"


def _status_path(rundir: Path, epoch: int, process_id: int) -> Path:
    return Path(rundir) / "status" / f"e{epoch:03d}-p{process_id:04d}.json"


def _preempt_flag(rundir: Path, epoch: int, process_id: int) -> Path:
    return Path(rundir) / "control" / f"e{epoch:03d}-preempt-p{process_id:04d}"


def _barrier_dir(rundir: Path, epoch: int, name: str) -> Path:
    return Path(rundir) / "barrier" / f"e{epoch:03d}-{name}"


def _write_json(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


def _read_json(path: Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (FileNotFoundError, ValueError, OSError):
        return None


def write_status(rundir: Path, epoch: int, process_id: int, status: str,
                 generation: int, detail: Optional[str] = None) -> None:
    """Publish this worker's terminal verdict for the epoch (atomic)."""
    _write_json(_status_path(rundir, epoch, process_id), {
        "process_id": process_id, "epoch": epoch, "status": status,
        "generation": int(generation), "detail": detail,
        "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })


def read_status(rundir: Path, epoch: int, process_id: int) -> Optional[dict]:
    return _read_json(_status_path(rundir, epoch, process_id))


def request_preempt(rundir: Path, epoch: int, process_id: int) -> None:
    """Mark ``process_id`` as preempting — visible to every peer at the
    next chunk boundary, so the whole fleet re-forms without waiting
    for a barrier timeout. Touched (not JSON) so it is safe from a
    signal handler."""
    flag = _preempt_flag(rundir, epoch, process_id)
    flag.parent.mkdir(parents=True, exist_ok=True)
    flag.touch()


def preempts_requested(rundir: Path, epoch: int,
                       num_processes: int) -> Set[int]:
    return {p for p in range(num_processes)
            if _preempt_flag(rundir, epoch, p).exists()}


def read_heartbeat(rundir: Path, epoch: int,
                   process_id: int) -> Optional[dict]:
    return _read_json(_hb_path(rundir, epoch, process_id))


class Heartbeat:
    """Daemon thread beating this process's liveness file.

    Each beat rewrites ``hb/e<epoch>/p<id>.json`` atomically; liveness
    is carried by the mtime *changing*, the payload (generation, beat
    sequence) is for the launcher's progress view and post-mortems."""

    def __init__(self, rundir: Path, epoch: int, process_id: int,
                 interval_seconds: float = 0.25):
        self._path = _hb_path(rundir, epoch, process_id)
        self._process_id = process_id
        self._epoch = epoch
        self._interval = interval_seconds
        self._lock = threading.Lock()
        self._generation = 0
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def set_generation(self, generation: int) -> None:
        with self._lock:
            self._generation = int(generation)

    def beat(self) -> None:
        with self._lock:
            self._seq += 1
            payload = {"process_id": self._process_id,
                       "epoch": self._epoch, "pid": os.getpid(),
                       "generation": self._generation, "seq": self._seq}
        _write_json(self._path, payload)

    def start(self) -> "Heartbeat":
        self.beat()  # visible before the first interval elapses
        self._thread = threading.Thread(
            target=self._loop, name="elastic-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()


class PeerMonitor:
    """Daemon thread flagging peers whose heartbeat went stale.

    Staleness is ``perf_counter() - (local time the file's mtime last
    changed)`` — each process judges peers against its *own* monotonic
    clock, so clock skew between hosts cannot fake (or hide) a death.
    Fires ``on_peer_lost({peer: stale_seconds})`` at most once, from
    the monitor thread; workers use it to exit in bounded time even
    while the main thread is wedged inside a collective."""

    def __init__(self, rundir: Path, epoch: int, process_id: int,
                 num_processes: int, deadline_seconds: float,
                 on_peer_lost: Callable[[Dict[int, float]], None],
                 poll_seconds: Optional[float] = None):
        self._paths = {p: _hb_path(rundir, epoch, p)
                       for p in range(num_processes) if p != process_id}
        self._deadline = deadline_seconds
        self._on_peer_lost = on_peer_lost
        self._poll = poll_seconds or max(0.05, deadline_seconds / 10.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PeerMonitor":
        self._thread = threading.Thread(
            target=self._loop, name="elastic-peer-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        last_change: Dict[int, Tuple[Optional[int], float]] = {
            p: (None, time.perf_counter()) for p in self._paths}
        while not self._stop.wait(self._poll):
            now = time.perf_counter()
            stale: Dict[int, float] = {}
            for p, path in self._paths.items():
                try:
                    mtime = os.stat(path).st_mtime_ns
                except OSError:
                    mtime = None
                prev_mtime, prev_t = last_change[p]
                if mtime is not None and mtime != prev_mtime:
                    last_change[p] = (mtime, now)
                elif now - prev_t > self._deadline:
                    stale[p] = now - prev_t
            if stale and not self._stop.is_set():
                self._stop.set()
                self._on_peer_lost(stale)
                return


def barrier(rundir: Path, epoch: int, name: str, process_id: int,
            num_processes: int, deadline_seconds: float,
            poll_seconds: float = 0.01) -> None:
    """Deadline-bounded rendezvous: touch our marker, wait for all
    ``num_processes`` markers. Raises :class:`PeerLostError` naming the
    absentees when the deadline passes — or immediately once a missing
    peer has published a *terminal* status for this epoch (it will
    never arrive; waiting out the deadline would only slow recovery).

    This is what keeps a stalled-but-alive peer from wedging the fleet:
    its heartbeat stays fresh, but it never reaches the barrier, and
    every healthy peer gives up after exactly ``deadline_seconds``."""
    d = _barrier_dir(rundir, epoch, name)
    d.mkdir(parents=True, exist_ok=True)
    (d / f"p{process_id:04d}").touch()
    t0 = time.perf_counter()
    while True:
        missing = [p for p in range(num_processes)
                   if not (d / f"p{p:04d}").exists()]
        if not missing:
            return
        for p in missing:
            st = read_status(rundir, epoch, p)
            if st is not None and st.get("status") in TERMINAL_STATUSES:
                raise PeerLostError(
                    [p], f"{name} (peer already terminal: "
                    f"{st.get('status')})", time.perf_counter() - t0)
        if time.perf_counter() - t0 > deadline_seconds:
            raise PeerLostError(missing, name, deadline_seconds)
        time.sleep(poll_seconds)


# -- the worker ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """One fleet's simulation + failure-model knobs (JSON-plain)."""

    shape: Tuple[int, int] = (96, 64)
    rule: str = "B3/S23"
    topology: str = "torus"
    target_gens: int = 120
    chunk: int = 20
    rng_seed: int = 0
    random_fill: float = 0.33
    devices_per_process: int = 1
    # preferred 2D tile decomposition (mesh rows, mesh cols) for the
    # ghost-zone pipeline; None = lock-step (n, 1) bands. A preferred
    # shape the surviving roster cannot host (device count, divisibility,
    # tile capacity) degrades deterministically on every controller —
    # parallel/multihost.global_mesh_for_grid is the one decision point.
    mesh_shape: Optional[Tuple[int, int]] = None
    # halo exchange once per k generations (width-k ghost zones); tiles
    # too small for the pipeline fall back to lock-step per-gen exchange
    gens_per_exchange: int = 1
    heartbeat_interval_seconds: float = 0.25
    heartbeat_deadline_seconds: float = 3.0
    barrier_deadline_seconds: float = 10.0
    chunk_sleep_seconds: float = 0.0
    ckpt_keep: int = 2

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        if self.mesh_shape is not None:
            d["mesh_shape"] = list(self.mesh_shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ElasticSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        kwargs["shape"] = tuple(d.get("shape", cls.shape))
        if d.get("mesh_shape") is not None:
            kwargs["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(**kwargs)


def initial_grid(spec: ElasticSpec):
    """The deterministic genesis grid — same seed, same grid, on every
    process and in the launcher's oracle."""
    import numpy as np

    rng = np.random.default_rng(spec.rng_seed)
    return (rng.random(spec.shape) < spec.random_fill).astype(np.uint8)


def _die(code: int) -> None:
    """Terminal exit for a fleet worker: skip interpreter teardown
    entirely. Normal exit may block in ``destroy_process_group`` on a
    peer that no longer exists —
    the exact hang this module exists to bound. Everything durable
    (status, checkpoint, flight dump) is already on disk by the time
    this is called."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def run_worker(rundir: "str | Path", spec: ElasticSpec, *, epoch: int,
               process_id: int, num_processes: int, port: int,
               device: str = "cuda", backend: str = "gloo") -> int:
    """One elastic worker: join the fleet, resume from the last verified
    sharded checkpoint, run chunk/checkpoint/barrier rounds to
    ``target_gens``. Never returns through a wedged exchange: every
    abnormal path funnels through :func:`_die` with a distinct exit
    status after publishing its verdict to the control plane. The
    worker's ``devices_per_process`` positions live on ``device``."""
    import numpy as np
    import torch

    from ..aot import cache as aot_cache
    from ..models.generations import parse_any
    from ..ops import bitpack
    from ..ops.stencil import Topology
    from ..parallel import multihost, sharded

    rundir = Path(rundir)
    hbd = spec.heartbeat_deadline_seconds
    rule = parse_any(spec.rule)
    topology = Topology(spec.topology)

    multihost.initialize(f"localhost:{port}", num_processes, process_id,
                         backend=backend, initialization_timeout=120,
                         device=device)
    aot_cache.ensure_persistent_cache()  # the fleet's root: no nvcc here
    devices = [device] * spec.devices_per_process
    # packed grid dims decide the tiling; every process computes the
    # same mesh from the same global roster + spec (the 2D re-tiling
    # after a shrink/replace epoch is THIS call, nothing stateful)
    grid_rows = spec.shape[0]
    grid_words = -(-spec.shape[1] // 32)  # ops/bitpack.py WORD
    kpe = max(1, int(spec.gens_per_exchange))
    if spec.mesh_shape is not None or kpe > 1:
        mesh = multihost.global_mesh_for_grid(
            (grid_rows, grid_words), spec.mesh_shape,
            gens_per_exchange=kpe, devices=devices)
    else:
        mesh = multihost.global_mesh(
            (num_processes * spec.devices_per_process, 1), devices)
    on_card = mesh.groups[0][0].type == "cuda"

    flight_dir = rundir / "flight"
    flight_dir.mkdir(parents=True, exist_ok=True)
    fr = obs_flight.FlightRecorder(
        str(flight_dir / f"e{epoch:03d}-p{process_id:04d}.jsonl"))
    fr.install(signals=False)  # SIGTERM means preempt here, not die
    obs_flight.arm(fr)
    # the launcher passes GOLTPU_TRACE through the env (spans.py reads it
    # at import), so every span below nests under the fleet launcher's
    # trace; nothing else to do here — but tape a breadcrumb so the
    # merged timeline shows when this worker joined
    fr.note("worker_start", {"process_id": process_id, "epoch": epoch,
                             "num_processes": num_processes})

    preempted = threading.Event()

    def _on_sigterm(signum, frame) -> None:
        # graceful preemption: flag it fleet-wide, finish the chunk,
        # checkpoint, exit with the distinct status — never die mid-step
        preempted.set()
        request_preempt(rundir, epoch, process_id)
        fr.note("preempt_requested", {"process_id": process_id})

    unchain = obs_flight.chain_signal_handler(
        signal.SIGTERM, _on_sigterm, propagate=False)

    # -- resume: newest generation that verifies clean ------------------------
    ckroot = rundir / "ckpt"
    gen = 0
    state_np = None
    skipped: List[Tuple[Path, str]] = []
    if ckpt_lib.list_generations(ckroot):
        try:
            state_np, meta, gen_dir, skipped = \
                ckpt_lib.load_latest_verified(ckroot)
            gen = int(meta["generation"])
        except CheckpointCorruptError as exc:
            # every generation refused: genesis replay is the honest
            # floor — deterministic, so still bit-exact, just slower
            obs_flight.note_event(
                "checkpoint_genesis_fallback", {"error": str(exc)})
            skipped = []
    for gen_dir_skipped, why in skipped:
        REGISTRY.counter(
            "elastic_checkpoint_fallbacks_total",
            "sharded-checkpoint generations refused at restore "
            "(corrupt/torn), causing fallback to an older one"
        ).inc()
        obs_flight.note_event(
            "checkpoint_generation_refused",
            {"dir": str(gen_dir_skipped), "why": why[:500]})
    if state_np is None:
        state_np = bitpack.pack_np(initial_grid(spec))
    state_np = np.asarray(state_np, dtype=np.uint32)
    state = multihost.put_global_grid(state_np, mesh)
    from ..parallel import mesh as mesh_lib
    nx = mesh.shape[mesh_lib.ROW_AXIS]
    ny = mesh.shape[mesh_lib.COL_AXIS]
    pergen = sharded.make_multi_step_packed(mesh, rule, topology)
    use_ghost = kpe > 1 and mesh_lib.ghost_fits(
        state_np.shape[0] // nx, state_np.shape[1] // ny, kpe)
    if use_ghost:
        # the ghost-zone pipeline is the compute core; n % k remainder
        # generations (shrunk final chunks, odd resume points) take the
        # per-gen runner so any chunk size stays bit-exact
        ghost = sharded.make_multi_step_packed_ghost(
            mesh, rule, topology, gens_per_exchange=kpe)

        def runner(s, n):
            blocks, rem = divmod(int(n), kpe)
            if blocks:
                s = ghost(s, blocks)
            if rem:
                s = pergen(s, rem)
            return s
    else:
        runner = pergen
    # durable restore record: the chaos launcher (and a human post-mortem)
    # can see exactly which generations each worker refused and why —
    # and where this epoch re-placed the 2D tiles — even when the worker
    # goes on to finish cleanly (flight-recorder notes only reach disk
    # on a dump)
    _write_json(rundir / "restore" / f"e{epoch:03d}-p{process_id:04d}.json",
                {"resumed_generation": gen,
                 "mesh": [nx, ny],
                 "runner": "ghost" if use_ghost else "lockstep",
                 "gens_per_exchange": kpe if use_ghost else 1,
                 "skipped": [[str(d), why[:300]] for d, why in skipped]})

    hb = Heartbeat(rundir, epoch, process_id,
                   spec.heartbeat_interval_seconds)
    hb.set_generation(gen)
    hb.start()

    def _peer_lost_hard(stale: Dict[int, float]) -> None:
        # monitor-thread path: main thread may be wedged in a
        # collective whose peer is gone — record, dump, die bounded
        for peer, seconds in stale.items():
            REGISTRY.counter(
                "elastic_heartbeat_misses_total",
                "peers declared dead after a stale heartbeat"
            ).inc(peer=str(peer))
        obs_flight.note_event(
            "heartbeat_miss",
            {"stale": {str(k): round(v, 3) for k, v in stale.items()},
             "deadline_seconds": hbd, "at_gen": gen})
        write_status(rundir, epoch, process_id, "peer_lost", gen,
                     detail=f"heartbeat stale: {sorted(stale)}")
        fr.dump(f"peer lost (heartbeat): {sorted(stale)}")
        _die(EXIT_PEER_LOST)

    monitor = PeerMonitor(rundir, epoch, process_id, num_processes,
                          hbd, _peer_lost_hard)
    monitor.start()

    def _sync(name: str) -> None:
        barrier(rundir, epoch, name, process_id, num_processes,
                spec.barrier_deadline_seconds)

    try:
        while gen < spec.target_gens:
            _sync(f"c{gen:08d}-pre")
            k = min(spec.chunk, spec.target_gens - gen)
            with obs_spans.span("elastic.chunk", epoch=epoch,
                                process_id=process_id,
                                start_gen=gen, generations=k):
                state = runner(state, k)
                if on_card:
                    torch.cuda.synchronize()
            gen += k
            hb.set_generation(gen)
            # sharded checkpoint: shards → barrier → manifest → barrier
            gd = ckpt_lib.generation_dir(ckroot, gen)
            ckpt_lib.write_shards(
                gd, process_id, multihost.local_shards(state),
                global_shape=state_np.shape, dtype=np.uint32)
            _sync(f"c{gen:08d}-shards")
            if process_id == 0:
                ckpt_lib.commit_manifest(
                    gd, num_processes=num_processes,
                    meta={"rule": rule.notation,
                          "topology": topology.value,
                          "generation": gen,
                          "shape": list(spec.shape),
                          "layout": "packed32"})
                ckpt_lib.prune_sharded(ckroot, keep=spec.ckpt_keep)
            _sync(f"c{gen:08d}-commit")
            # preemption boundary: the checkpoint just committed is the
            # hand-off point for whoever leaves the fleet here
            requested = preempts_requested(rundir, epoch, num_processes)
            if preempted.is_set() or process_id in requested:
                monitor.stop()
                write_status(rundir, epoch, process_id, "preempted", gen)
                fr.dump(f"preempted at generation {gen}")
                _die(EXIT_PREEMPTED)
            if requested:
                monitor.stop()
                obs_flight.note_event(
                    "peer_preempted",
                    {"peers": sorted(requested), "at_gen": gen})
                write_status(rundir, epoch, process_id, "peer_lost", gen,
                             detail=f"peers preempted: {sorted(requested)}")
                fr.dump(f"peers preempted: {sorted(requested)}")
                _die(EXIT_PEER_LOST)
            if spec.chunk_sleep_seconds > 0:
                time.sleep(spec.chunk_sleep_seconds)
        # done: one allgather so process 0 can persist the full grid the
        # launcher diffs against the single-device oracle
        gathered = multihost.gather_global(state)
        monitor.stop()
        if process_id == 0:
            final = bitpack.unpack_np(gathered)[:, :spec.shape[1]]
            tmp = rundir / f"final.npy.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, final)
            os.replace(tmp, rundir / "final.npy")
            _write_json(rundir / "final.json",
                        {"generation": gen, "epoch": epoch,
                         "num_processes": num_processes})
        write_status(rundir, epoch, process_id, "done", gen)
        # clean exits leave a tape too: the fleet-wide merged timeline
        # needs every worker's spans, not just the ones that died
        fr.dump(f"done at generation {gen}")
        _die(EXIT_DONE)
    except PeerLostError as exc:
        monitor.stop()
        REGISTRY.counter(
            "elastic_barrier_timeouts_total",
            "barriers abandoned after the deadline (peer lost/stalled)"
        ).inc(where=exc.where.split(" ")[0])
        obs_flight.note_event(
            "peer_lost", {"missing": list(exc.missing),
                          "where": exc.where, "at_gen": gen})
        write_status(rundir, epoch, process_id, "peer_lost", gen,
                     detail=str(exc))
        fr.dump(f"peer lost (barrier): {exc}")
        _die(EXIT_PEER_LOST)
    except Exception as exc:  # noqa: BLE001 — the launcher needs the verdict
        monitor.stop()
        write_status(rundir, epoch, process_id, "error", gen,
                     detail=f"{type(exc).__name__}: {exc}")
        fr.dump(f"worker error: {type(exc).__name__}: {exc}")
        raise
    finally:
        hb.stop()
        unchain()
        obs_flight.disarm()
    return 1  # unreachable; _die never returns


# -- the fleet launcher --------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class _Fired:
    """One launcher-side fault actually executed."""

    kind: str
    worker: int
    at_gen: int
    fired_at_gen: int
    epoch: int
    t: float  # launcher perf_counter at firing
    detail: Optional[str] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("t")
        return d


class ElasticFleet:
    """Localhost fleet launcher: launch N workers, execute launcher-side
    faults (``process_kill`` / ``process_preempt`` /
    ``checkpoint_corrupt`` FaultEvents), and rebuild the fleet over the
    remaining or replacement process set until the run completes.

    The launcher is deliberately dumb about simulation state: workers own
    resume (``load_latest_verified``), the launcher only owns the process
    set. Preempted workers leave the roster permanently (the fleet
    shrinks — "remaining"); killed workers are replaced by fresh
    processes when ``replace_killed`` (the default — "replacement"),
    exercising both elastic paths. Recovery latency (fault fired →
    first heartbeat of the rebuilt epoch) lands in this process's
    ``obs`` registry and the per-epoch report.

    Every worker's positions live on ``device`` (default the card) and
    its process group runs ``backend``; the workers build kernels into
    this process's cache root (``GOLTPU_CACHE_DIR``)."""

    def __init__(self, rundir: "str | Path", spec: ElasticSpec, *,
                 num_processes: int, env: Optional[dict] = None,
                 max_epochs: int = 8, replace_killed: bool = True,
                 startup_deadline_seconds: float = 180.0,
                 poll_seconds: float = 0.05, device: str = "cuda",
                 backend: str = "gloo"):
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {num_processes}")
        h = spec.shape[0]
        wp = -(-spec.shape[1] // 32)  # packed words (ops/bitpack.py)
        ndev = num_processes * spec.devices_per_process
        if spec.mesh_shape is not None:
            mx, my = spec.mesh_shape
            if mx * my != ndev:
                raise ValueError(
                    f"mesh_shape {spec.mesh_shape} needs {mx * my} devices, "
                    f"fleet has {num_processes} processes x "
                    f"{spec.devices_per_process} devices")
            if h % mx or wp % my:
                raise ValueError(
                    f"packed grid ({h}, {wp}) words not divisible by "
                    f"mesh_shape {spec.mesh_shape}")
            if spec.gens_per_exchange > 1:
                from ..parallel.mesh import ghost_fits
                if not ghost_fits(h // mx, wp // my,
                                  spec.gens_per_exchange):
                    raise ValueError(
                        f"gens_per_exchange={spec.gens_per_exchange} does "
                        f"not fit ({h // mx}, {wp // my})-word tiles of "
                        f"mesh_shape {spec.mesh_shape}; ghost zones need "
                        "2k rows and 2*ceil(k/32) words per tile")
        elif h % ndev:
            raise ValueError(
                f"grid rows {h} not divisible over {num_processes} "
                f"processes x {spec.devices_per_process} devices")
        self.rundir = Path(rundir)
        self.spec = spec
        self.num_processes = num_processes
        self.max_epochs = max_epochs
        self.replace_killed = replace_killed
        self.startup_deadline = startup_deadline_seconds
        self.poll_seconds = poll_seconds
        self.device = str(device)
        self.backend = backend
        self._env = dict(env if env is not None else os.environ)
        from ..aot import cache as aot_cache
        root = aot_cache.cache_root()
        if root is not None:
            self._env[aot_cache.ENV_CACHE_DIR] = root
        # workers run `python -m gameoflifewithactors_torch...` from an
        # arbitrary cwd: make the package importable regardless
        repo_root = str(Path(__file__).resolve().parents[2])
        parts = [p for p in
                 self._env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if repo_root not in parts:
            self._env["PYTHONPATH"] = os.pathsep.join([repo_root] + parts)
        # fleet-wide trace: the launcher mints (or inherits) the trace id
        # and hands workers its own span id as their parent via the env,
        # so worker spans nest under the launcher on the merged timeline
        ambient = obs_spans.current_trace()
        self.trace = obs_spans.TraceContext(
            trace_id=(ambient.trace_id if ambient is not None
                      else obs_spans.new_trace_id()),
            span_id=obs_spans.new_span_id())
        obs_spans.set_process_context(self.trace)
        self._env.update(self.trace.child_env())
        self.rundir.mkdir(parents=True, exist_ok=True)
        _write_json(self.rundir / "spec.json", spec.to_dict())

    # -- one epoch -------------------------------------------------------------

    def _spawn(self, epoch: int, n: int, port: int) -> List[subprocess.Popen]:
        logdir = self.rundir / "logs"
        logdir.mkdir(parents=True, exist_ok=True)
        procs = []
        for p in range(n):
            log = open(logdir / f"e{epoch:03d}-p{p:04d}.log", "ab")
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "gameoflifewithactors_torch.resilience.distributed",
                 "--rundir", str(self.rundir),
                 "--spec", str(self.rundir / "spec.json"),
                 "--epoch", str(epoch), "--process-id", str(p),
                 "--num-processes", str(n), "--port", str(port),
                 "--device", self.device, "--backend", self.backend],
                env=self._env, stdout=log, stderr=log))
            log.close()  # the child holds its own descriptor
        return procs

    def _fire(self, ev, procs: List[subprocess.Popen], epoch: int,
              fired_gen: int) -> _Fired:
        from ..utils import fault as fault_lib

        rec = _Fired(kind=ev.kind, worker=ev.worker, at_gen=ev.at_gen,
                     fired_at_gen=fired_gen, epoch=epoch,
                     t=time.perf_counter())
        target = procs[ev.worker]
        if ev.kind == "process_kill":
            os.kill(target.pid, signal.SIGKILL)
        elif ev.kind == "process_preempt":
            os.kill(target.pid, signal.SIGTERM)
        elif ev.kind == "checkpoint_corrupt":
            # SIGKILL first, corrupt after the target is confirmed dead:
            # with a peer gone no barrier can pass, so no *newer* clean
            # generation can commit and the corrupted one is guaranteed
            # to be the newest at rebuild — the restore MUST refuse it
            # and fall back a generation
            os.kill(target.pid, signal.SIGKILL)
            target.wait(timeout=30)
            committed = [d for _g, d in
                         ckpt_lib.list_generations(self.rundir / "ckpt")
                         if (d / ckpt_lib.MANIFEST_NAME).exists()]
            if committed:
                # corrupt process 0's shard: present in every roster size
                victim = committed[-1] / "shard-p0000.npz"
                fault_lib.corrupt_checkpoint_file(
                    victim, seed=int(ev.params.get("seed", 0)))
                rec.detail = f"corrupted {victim}"
            else:
                rec.detail = "no committed generation yet; kill only"
        else:
            raise ValueError(f"not a launcher fault kind: {ev.kind!r}")
        REGISTRY.counter("elastic_launcher_faults_total",
                         "launcher-side faults executed, by kind"
                         ).inc(kind=ev.kind)
        # instant event on the launcher tape: kill/preempt/corrupt must be
        # visible on the merged fleet timeline, not just in the report
        obs_flight.note_event(
            "launcher_fault",
            {"fault": ev.kind, "worker": ev.worker, "epoch": epoch,
             "fired_at_gen": fired_gen, "detail": rec.detail})
        return rec

    def _epoch_deadline(self) -> float:
        spec = self.spec
        chunks = max(1, -(-spec.target_gens // spec.chunk))
        return (self.startup_deadline
                + chunks * (spec.chunk_sleep_seconds + 5.0)
                + spec.barrier_deadline_seconds
                + spec.heartbeat_deadline_seconds + 60.0)

    def run(self, events: Sequence = ()) -> dict:
        """Drive the fleet to ``target_gens`` through every scheduled
        fault; returns the report (never raises on worker failure —
        ``report["ok"]`` carries the verdict)."""
        pending = sorted(events, key=lambda e: e.at_gen)
        fired: List[_Fired] = []
        epochs: List[dict] = []
        n = self.num_processes
        ok = False
        for epoch in range(self.max_epochs):
            with obs_spans.span("elastic.epoch", epoch=epoch,
                                num_processes=n):
                info = self._run_epoch(epoch, n, pending, fired)
            epochs.append(info)
            if info["completed"]:
                ok = True
                break
            n = self._next_roster(n, info)
            if n < 1:
                info["note"] = "roster empty; giving up"
                break
        final_meta = _read_json(self.rundir / "final.json") or {}
        report = {
            "trace_id": self.trace.trace_id,
            "spec": self.spec.to_dict(),
            "num_processes_initial": self.num_processes,
            "epochs": epochs,
            "faults_fired": [f.to_dict() for f in fired],
            "faults_unfired": [getattr(e, "to_dict", lambda: e)()
                               for e in pending],
            "final": final_meta,
            "final_grid": (str(self.rundir / "final.npy")
                           if (self.rundir / "final.npy").exists() else None),
            "ok": bool(ok and final_meta
                       and final_meta.get("generation")
                       == self.spec.target_gens),
            "registry": {
                k: v for k, v in REGISTRY.snapshot().items()
                if k.startswith("elastic_") or k.startswith("faults_")},
        }
        _write_json(self.rundir / "chaos_report.json", report)
        return report

    def _run_epoch(self, epoch: int, n: int, pending: list,
                   fired: List[_Fired]) -> dict:
        port = _free_port()
        t0 = time.perf_counter()
        procs = self._spawn(epoch, n, port)
        info: dict = {"epoch": epoch, "num_processes": n, "port": port,
                      "fired": [], "wedged": False, "completed": False}
        # recovery latency: fault fired (previous epoch) → first
        # heartbeat of this rebuilt epoch
        prev_fault_t = fired[-1].t if fired else None
        seen_heartbeat = False
        deadline = t0 + self._epoch_deadline()
        fired_this_epoch: List[_Fired] = []
        escalate_at: Dict[int, float] = {}
        while True:
            now = time.perf_counter()
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            if now > deadline:
                # the elastic promise failed — nothing may hang forever,
                # including the launcher's patience
                info["wedged"] = True
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            if not seen_heartbeat:
                hb = read_heartbeat(self.rundir, epoch, 0)
                if hb is not None:
                    seen_heartbeat = True
                    info["startup_seconds"] = round(now - t0, 3)
                    if prev_fault_t is not None:
                        recovery = now - prev_fault_t
                        info["recovery_seconds"] = round(recovery, 3)
                        REGISTRY.histogram(
                            "elastic_recovery_seconds",
                            "fault fired -> rebuilt fleet heartbeating"
                        ).observe(recovery)
            # escalate preempts whose grace window ran out
            for idx, t_esc in list(escalate_at.items()):
                if now > t_esc and procs[idx].poll() is None:
                    procs[idx].kill()
                    escalate_at.pop(idx)
            # fire at most one fault per poll, only on a healthy fleet
            if (pending and not fired_this_epoch
                    and all(rc is None for rc in rcs)):
                ev = pending[0]
                if ev.worker < n:
                    hb = read_heartbeat(self.rundir, epoch, ev.worker)
                    g = (hb or {}).get("generation", 0)
                    if hb is not None and g >= ev.at_gen:
                        pending.pop(0)
                        rec = self._fire(ev, procs, epoch, g)
                        fired.append(rec)
                        fired_this_epoch.append(rec)
                        info["fired"].append(rec.to_dict())
                        if ev.kind == "process_preempt":
                            grace = float(ev.params.get("grace_seconds", 10.0))
                            escalate_at[ev.worker] = rec.t + grace
                else:
                    pending.pop(0)  # roster shrank past the target
            time.sleep(self.poll_seconds)
        rcs = [p.poll() for p in procs]
        info["exit_codes"] = rcs
        info["statuses"] = [read_status(self.rundir, epoch, p)
                            for p in range(n)]
        info["wall_seconds"] = round(time.perf_counter() - t0, 3)
        if fired_this_epoch:
            # detection latency: fault fired → every worker exited (all
            # survivors self-detected and left; nothing hung)
            info["detection_seconds"] = round(
                time.perf_counter() - fired_this_epoch[0].t, 3)
        info["completed"] = all(rc == EXIT_DONE for rc in rcs)
        if not info["completed"]:
            REGISTRY.counter(
                "elastic_fleet_rebuilds_total",
                "fleet teardown+relaunch cycles, by trigger").inc(
                    cause=(fired_this_epoch[0].kind if fired_this_epoch
                           else "peer_lost"))
        return info

    def _next_roster(self, n: int, info: dict) -> int:
        preempted = sum(1 for rc in info["exit_codes"]
                        if rc == EXIT_PREEMPTED)
        killed_like = sum(1 for rc in info["exit_codes"]
                          if rc not in (EXIT_DONE, EXIT_PREEMPTED,
                                        EXIT_PEER_LOST))
        n_next = n - preempted
        if not self.replace_killed:
            n_next -= killed_like
        # the mesh over the shrunk roster must still tile the grid the
        # same way the workers will choose it (multihost.
        # global_mesh_for_grid); if it can't, keep the old size
        # (replacements instead)
        while n_next >= 1 and not self._roster_tiles(n_next):
            n_next += 1
        return min(n_next, n) if n_next >= 1 else n

    def _roster_tiles(self, n_procs: int) -> bool:
        """Whether ``n_procs`` processes can host SOME valid mesh for the
        spec's packed grid — mirroring the workers' deterministic mesh
        choice, 2D factorizations included."""
        spec = self.spec
        h = spec.shape[0]
        ndev = n_procs * spec.devices_per_process
        if spec.mesh_shape is None and spec.gens_per_exchange <= 1:
            return h % ndev == 0  # legacy lock-step (n, 1) bands
        from ..parallel.mesh import best_mesh_shape
        wp = -(-spec.shape[1] // 32)
        if (spec.gens_per_exchange > 1
                and best_mesh_shape(ndev, h, wp,
                                    gens_per_exchange=spec.gens_per_exchange)):
            return True
        if best_mesh_shape(ndev, h, wp, gens_per_exchange=0):
            return True
        return h % ndev == 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="elastic multi-process worker (one fleet process)")
    parser.add_argument("--rundir", required=True)
    parser.add_argument("--spec", required=True)
    parser.add_argument("--epoch", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--device", default="cuda",
                        help="where this worker's positions live "
                        "(default: the card)")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                        help="the process group's backend")
    args = parser.parse_args(argv)

    spec = ElasticSpec.from_dict(json.loads(Path(args.spec).read_text()))
    return run_worker(args.rundir, spec, epoch=args.epoch,
                      process_id=args.process_id,
                      num_processes=args.num_processes, port=args.port,
                      device=args.device, backend=args.backend)


if __name__ == "__main__":
    sys.exit(main())
