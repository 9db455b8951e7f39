"""Serve drill: one server process, hundreds of mixed-spec sessions,
one SIGKILL + ``--resume`` cycle, bit-exact oracle checks throughout.

    python -m gameoflifewithactors_torch.drills.serve_load --sessions 200

Counterpart of the JAX package's ``scripts/serve_load.py``. Launches
``python -m gameoflifewithactors_torch serve --device DEVICE`` under
``GOLTPU_SANITIZE=1``, creates ``--sessions`` sessions spread over three
spec families and four tenants through the HTTP API, steps them in mixed
rounds, and verifies a sample of grids against the pure-NumPy oracle
(:mod:`.oracle` -- every session's seed is reproducible from its
``rng_seed`` + ``fill``; each sampled grid is stepped on from its last
check). Then it checkpoints, SIGKILLs the server mid-flight, relaunches
with ``--resume``, and asserts

- every session survived with its generation cursor intact,
- resumed grids are still bit-identical to the oracle,
- sessions keep stepping correctly after the resume,
- ``/metrics`` serves a nonzero ``goltpu_session_steps_total`` for every
  tenant and the ``goltpu_session_queue_depth`` gauge.

Exit 0 = all green. Artifacts (server log, flight dump, checkpoint) land
in ``--out``. ``--device`` (default ``cuda``) is where the server's lanes
live; without a card ``cuda`` exits non-zero before the server starts.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..engine import resolve_device
from ..models.generations import parse_any
from ..ops import bitpack
from ..ops.stencil import Topology
from ..serve.service import decode_words
from .oracle import Advancer

_REPO = str(Path(__file__).resolve().parents[2])

# three families (two rules × two shapes, one dead-edge) so compaction
# and placement run per-family, and four tenants for the per-tenant
# counter assertion
FAMILIES = (
    {"rule": "B3/S23", "height": 32, "width": 32, "topology": "torus"},
    {"rule": "B36/S23", "height": 32, "width": 32, "topology": "torus"},
    {"rule": "B3/S23", "height": 16, "width": 32, "topology": "dead"},
)
TENANTS = ("acme", "globex", "initech", "umbrella")


class Server:
    """The serve subprocess + its announced port."""

    def __init__(self, out: Path, env: dict, extra: List[str],
                 resume: bool = False):
        self.out = out
        self.log = open(out / "server.log", "ab")
        cmd = [sys.executable, "-m", "gameoflifewithactors_torch", "serve",
               "--port", "0",
               "--checkpoint", str(out / "sessions.npz"),
               "--checkpoint-every", "600",
               "--flight-dump", str(out / "serve.flight.jsonl"),
               *extra]
        if resume:
            cmd.append("--resume")
        self.proc = subprocess.Popen(cmd, cwd=_REPO, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=self.log, text=True)
        self.port: Optional[int] = None

    def read_port(self) -> int:
        line = self.proc.stdout.readline()
        if not line.startswith("SERVE_PORT"):
            raise RuntimeError(
                f"server announced {line!r} instead of SERVE_PORT")
        self.port = int(line.split()[1])
        return self.port

    def request(self, method: str, path: str,
                body: Optional[dict] = None) -> Tuple[int, object]:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                raw = resp.read()
                ctype = resp.headers.get("Content-Type", "")
                return resp.status, (json.loads(raw) if
                                     ctype.startswith("application/json")
                                     else raw.decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def sigkill(self) -> None:
        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc.stdout.close()
        self.log.close()


def oracle_grid(spec: dict, fill: float, rng_seed: int, gens: int,
                advancer: Optional[Advancer] = None) -> np.ndarray:
    """The exact cells a session must hold after ``gens`` generations —
    same seeding contract as SessionService._seed_words. With an
    ``advancer``, the grid steps on from this session's last check."""
    h, w = spec["height"], spec["width"]
    rule = parse_any(spec["rule"])
    topology = Topology(spec["topology"])

    def seed() -> np.ndarray:
        return (np.random.default_rng(rng_seed).random((h, w))
                < fill).astype(np.uint8)

    advancer = advancer if advancer is not None else Advancer()
    key = (rng_seed, fill, rule.notation, h, w, topology.value)
    return advancer.at(key, seed, rule, topology, gens)


def fetch_grid(server: Server, sid: str) -> Tuple[int, np.ndarray]:
    code, g = server.request("GET", f"/sessions/{sid}/grid")
    if code != 200:
        raise RuntimeError(f"GET grid {sid}: HTTP {code} {g}")
    words = decode_words(g["cells_hex"], g["height"], g["width"] // 32)
    return g["generation"], bitpack.unpack_np(words)


def session_assignment(i: int, families: Sequence[dict] = FAMILIES
                       ) -> Tuple[dict, str]:
    """Session ``i``'s spec family and tenant."""
    return families[i % len(families)], TENANTS[i % len(TENANTS)]


def sample_stride(n_sessions: int, sample: int) -> int:
    """Every how many sessions one is oracle-checked.

    A stride divisible by len(TENANTS) would sample one tenant only,
    starving the post-resume per-tenant counter check (the resumed
    process starts with fresh counters and only sampled sessions step
    after the kill) — bump it off the tenant period."""
    stride = max(1, n_sessions // max(1, sample))
    if stride % len(TENANTS) == 0 and n_sessions > len(TENANTS):
        stride += 1
    return stride


def run(out: Path, *, sessions: int = 200, fill: float = 0.35,
        rounds: int = 2, sample: int = 40, ladder: str = "1,8,64",
        kill: bool = True, device: str = "cuda",
        families: Sequence[dict] = FAMILIES) -> dict:
    """The drill; prints its progress and verdict lines and returns
    ``{"ok", "failures", "wall_seconds", "resume_seconds", "sessions",
    "sampled"}``. Raises RuntimeError at once when ``device`` is
    ``cuda`` and there is no card."""
    resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, GOLTPU_SANITIZE="1",
               GOLTPU_CACHE_DIR=os.environ.get(
                   "GOLTPU_CACHE_DIR",
                   os.path.join(_REPO, ".goltpu_cache")))
    extra = ["--device", device, "--ladder", ladder]
    failures: List[str] = []
    advancer = Advancer()
    resume_seconds = None
    t0 = time.perf_counter()

    def check_grid(s: dict, when: str) -> None:
        gen, got = fetch_grid(server, s["sid"])
        want = oracle_grid(s["spec"], fill, s["rng_seed"], s["gens"],
                           advancer)
        if gen != s["gens"] or not np.array_equal(got, want):
            failures.append(f"{s['sid']}: {when} grid diverged from "
                            f"oracle (gen {gen}, expected {s['gens']})")

    server = Server(out, env, extra)
    try:
        server.read_port()
        print(f"serve_load: server up on :{server.port}", flush=True)

        # -- create the fleet -------------------------------------------------
        fleet: List[dict] = []  # {sid, tenant, spec, rng_seed, gens}
        for i in range(sessions):
            spec, tenant = session_assignment(i, families)
            code, info = server.request("POST", "/sessions", {
                "tenant": tenant, "spec": spec, "fill": fill,
                "rng_seed": i})
            if code not in (201, 202):
                failures.append(f"create #{i}: HTTP {code} {info}")
                continue
            fleet.append({"sid": info["sid"], "tenant": tenant,
                          "spec": spec, "rng_seed": i, "gens": 0})
        print(f"serve_load: created {len(fleet)} sessions "
              f"({len(families)} families, {len(TENANTS)} tenants)",
              flush=True)

        # -- mixed step rounds (divergent cursors on shared lanes) ------------
        for r in range(rounds):
            for i, s in enumerate(fleet):
                n = 1 + (i + r) % 4
                code, info = server.request(
                    "POST", f"/sessions/{s['sid']}/step", {"n": n})
                if code != 200:
                    failures.append(f"step {s['sid']}: HTTP {code} {info}")
                    continue
                s["gens"] += n
                if info["generation"] != s["gens"]:
                    failures.append(
                        f"{s['sid']}: generation {info['generation']} != "
                        f"expected {s['gens']}")

        sampled = fleet[::sample_stride(len(fleet), sample)]
        for s in sampled:
            check_grid(s, "pre-kill")
        print(f"serve_load: {len(sampled)} grids oracle-checked pre-kill",
              flush=True)

        # -- SIGKILL + resume -------------------------------------------------
        if kill:
            code, ck = server.request("POST", "/admin/checkpoint")
            if code != 200:
                failures.append(f"checkpoint: HTTP {code} {ck}")
            server.sigkill()
            print("serve_load: SIGKILLed the server; resuming", flush=True)
            server.close()
            t_resume = time.perf_counter()
            server = Server(out, env, extra, resume=True)
            server.read_port()
            code, h = server.request("GET", "/healthz")
            resume_seconds = time.perf_counter() - t_resume
            live = h.get("sessions", {}).get("live", 0) if code == 200 else 0
            if live != len(fleet):
                failures.append(
                    f"resume lost sessions: {live} live != {len(fleet)}")
            for s in sampled:
                check_grid(s, "post-resume")
            # stepping must keep working (and stay exact) after the resume
            for s in sampled:
                code, info = server.request(
                    "POST", f"/sessions/{s['sid']}/step", {"n": 3})
                if code != 200:
                    failures.append(
                        f"post-resume step {s['sid']}: HTTP {code}")
                    continue
                s["gens"] += 3
                check_grid(s, "post-resume-step")
            print(f"serve_load: resume verified on {len(sampled)} sessions "
                  f"(restart to a live /healthz in {resume_seconds:.2f}s)",
                  flush=True)

        # -- metrics ----------------------------------------------------------
        code, metrics = server.request("GET", "/metrics")
        if code != 200:
            failures.append(f"/metrics: HTTP {code}")
            metrics = ""
        for tenant in TENANTS:
            needle = f'goltpu_session_steps_total{{tenant="{tenant}"}}'
            line = next((ln for ln in metrics.splitlines()
                         if ln.startswith(needle)), None)
            if line is None or float(line.split()[-1]) <= 0:
                failures.append(
                    f"/metrics: no positive steps counter for {tenant}")
        if "goltpu_session_queue_depth" not in metrics:
            failures.append("/metrics: queue depth gauge missing")
    finally:
        server.close()

    wall = time.perf_counter() - t0
    result = {"ok": not failures, "failures": failures,
              "wall_seconds": wall, "resume_seconds": resume_seconds,
              "sessions": len(fleet), "sampled": len(sampled)}
    if failures:
        print(f"serve_load: FAILED after {wall:.1f}s "
              f"({len(failures)} failures):", flush=True)
        for f in failures[:20]:
            print(f"  - {f}", flush=True)
        return result
    print(f"serve_load: OK in {wall:.1f}s — {len(fleet)} sessions, "
          f"{rounds} step rounds, "
          f"{'kill/resume verified, ' if kill else ''}"
          "all sampled grids bit-identical to oracle", flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="serve-layer load + kill/resume drill")
    ap.add_argument("--sessions", type=int, default=200)
    ap.add_argument("--fill", type=float, default=0.35)
    ap.add_argument("--rounds", type=int, default=2,
                    help="mixed step rounds before the kill")
    ap.add_argument("--sample", type=int, default=40,
                    help="sessions whose grids are oracle-checked")
    ap.add_argument("--ladder", default="1,8,64",
                    help="lane ladder passed to the server")
    ap.add_argument("--out", default=None,
                    help="artifact dir (default: ./serve_out)")
    ap.add_argument("--no-kill", action="store_true",
                    help="skip the SIGKILL + resume cycle")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the server's lanes live (default: the card)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"serve_load: {exc}", file=sys.stderr)
        return 2
    result = run(Path(args.out or os.path.join(_REPO, "serve_out")),
                 sessions=args.sessions, fill=args.fill, rounds=args.rounds,
                 sample=args.sample, ladder=args.ladder,
                 kill=not args.no_kill, device=args.device)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
