#!/usr/bin/env python3
"""Smoke run of gameoflifewithactors_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each unguarded (any failure exits non-zero before the last line):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel from ``csrc/`` (one ``nvcc``
   per source, all started together; time, registers, spills, the SASS
   inner loop).
2. Each kernel against its plain PyTorch version on the card, bit for bit
   (tolerance 0: integer words), over rules, topologies, shapes up to
   16384², generations per call, edge codes and seam-crossing gliders.
3. The main paths, each driven with every kernel's launch count set to 0
   just before and read just after: three ``GridCoordinator`` runs at
   16384² with a 50% random soup under TORUS, held against the kernel's
   plain version from a copy of the start state -- B3/S23 (kernel B1),
   Brian's Brain (B3) and Bosco (B4) -- then the CLI in a subprocess for
   each rule family. Then the session service (kernel B2): a full
   256-slot lane of 1024² B3/S23 TORUS sessions, 64 B36/S23 DEAD sessions
   and one 16384² session on mixed cursors through ``SessionService``,
   every grid held against its own dedicated ``Engine`` run, compaction
   after closes, and ``python -m gameoflifewithactors_torch serve`` over
   HTTP in a subprocess.
4. Timing with CUDA events: each kernel per launch at its main path's
   shapes, its plain version, the plain packed path, the least time the
   card could take, and a depth and tile sweep; the serving rate.

Prints the kernels' JSON line, then as the last line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM published HBM3 rate
INT32_LANES_PER_SM = 64      # 32-bit integer/logic results per SM per clock
MAIN_SHAPE = (16384, 16384)
MAIN_GENERATIONS = 300       # not a multiple of g: the shorter launch runs too
MAIN_TICK = 100
KERNELS = ("life_packed", "life_slab", "life_generations", "life_ltl")
LANE_SHAPE = (1024, 1024)      # the serving sessions' grids
LANE_SESSIONS = 256            # one full top-rung lane
DEAD_SESSIONS = 64
SERVE_GENERATIONS = 2000
PALLAS = "gameoflifewithactors_tpu/ops/pallas_stencil.py"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ops_per_word(rule) -> int:
    """Bitwise operations one generation of a B/S rule needs per 32-cell
    word, a three-input logic op or a funnel shift counting as one: 2
    shifts for the west/east planes, 4 for the row sums T and S, 8 for the
    4-bit count T_n + S + T_s, 2 per count-equality plane the rule tests,
    one OR per further born or survive count, and the final select."""
    return (2 + 4 + 8 + 2 * len(rule.born | rule.survive)
            + max(len(rule.born) - 1, 0) + max(len(rule.survive) - 1, 0) + 1)


def gen_ops_per_word(rule) -> int:
    """The same count for one generation of a Generations rule on b =
    n_planes(C) bit-planes, from packed_generations.step_planes_slab: the
    alive plane (an OR of b-1 planes and an and-not, ceil((b-1)/2)
    three-input ops), the 14 of the 3x3 count, the born and keep masks as
    for a B/S rule (2 per count-equality plane, an OR per further count),
    and transition_planes: the nonzero OR (ceil((b-1)/2)), kept, one and
    aging (3), the +1 carry chain (2 per plane past the first), the
    equality with C where C != 2**b (ceil((b-1)/2)), the b masked outputs
    and the OR of `one` into plane 0."""
    b = max(1, (rule.states - 1).bit_length())
    fold = -(-(b - 1) // 2)
    masks = (2 * len(rule.born | rule.survive) + max(len(rule.born) - 1, 0)
             + max(len(rule.survive) - 1, 0))
    eq = fold if rule.states != 1 << b else 0
    return fold + 14 + masks + fold + 3 + 2 * (b - 1) + eq + b + 1


def ltl_ops_per_word(rule) -> int:
    """The same count for one generation of a binary LtL rule, walking
    packed_ltl's formulation with only the plane counts of its bit-sliced
    numbers: box_counts_packed (a carry-save sum of the 2r+1 row-shifted
    planes, full and half adders 2 ops each, then _sliding_sum_bs's two
    one-sided doubling trees of funnel shifts (1 op per plane) and ripple
    adds (2 ops per bit)) or diamond_counts_packed (r+1 shrinking sliding
    sums of pre-added row pairs), then _apply_intervals (M0's subtraction,
    2 ops per plane; a comparator per interval bound inside the count's
    range, 1 op per plane; an and-not per interval, an OR per further
    interval; the final select)."""
    ops = 0

    def csa(n: int) -> int:             # packed.bit_sliced_sum of n planes
        nonlocal ops
        planes = 0
        while n:
            carries = 0
            while n >= 3:
                n, carries, ops = n - 2, carries + 1, ops + 2
            if n == 2:
                n, carries, ops = 1, carries + 1, ops + 2
            planes += 1
            n = carries
        return planes

    def add(a: int, b: int) -> int:     # packed_ltl.bs_add
        nonlocal ops
        ops += 2 * max(a, b)
        return max(a, b) + 1

    def one_sided(num: int, r: int) -> int:   # _one_sided_sum_bs
        nonlocal ops
        ops += num
        pows, m = {1: num}, 1
        while 2 * m <= r:
            ops += pows[m]
            pows[2 * m] = add(pows[m], pows[m])
            m *= 2
        acc, offset = None, 0
        for p2 in sorted(pows, reverse=True):
            while r - offset >= p2:
                ops += pows[p2] if offset else 0
                acc = pows[p2] if acc is None else add(acc, pows[p2])
                offset += p2
        return acc

    def sliding(num: int, k: int) -> int:     # _sliding_sum_bs
        r = (k - 1) // 2
        if r == 0:
            return num
        return add(add(one_sided(num, r), one_sided(num, r)), num)

    r = rule.radius
    if rule.neighborhood == "M":
        counts = sliding(csa(2 * r + 1), 2 * r + 1)
    else:
        nbits = (2 * r * r + 2 * r + 1).bit_length()
        counts = None
        for d in range(r + 1):
            term = sliding(1 if d == 0 else csa(2), 2 * (r - d) + 1)
            counts = term if counts is None else min(add(counts, term), nbits)
    if not rule.middle:
        ops += 2 * counts
    for intervals in (rule.born_intervals, rule.survive_intervals):
        for lo, hi in intervals:
            ops += sum(counts for c in (lo, hi + 1) if 0 < c < 1 << counts) + 1
        ops += max(len(intervals) - 1, 0)
    return ops + 1


def sass_counts(so_path: str, nvcc: str):
    """(SASS instructions in the library, instructions in its shortest loop
    that both loads and stores shared memory -- a kernel's per-word,
    per-generation row loop -- and the LOP3s among them), read with
    ``cuobjdump`` beside ``nvcc``; the loop's counts are None where no such
    loop is found."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loop = lop3 = None
    for addr, text in ins:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
        if (any(re.search(r"\bLDS\b", t) for t in body)
                and any(re.search(r"\bSTS\b", t) for t in body)):
            if loop is None or len(body) < loop:
                loop = len(body)
                lop3 = sum("LOP3" in t for t in body)
    return len(ins), loop, lop3


def timed_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` warm calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def reset_launches(cs) -> None:
    cs.KERNEL_LAUNCHES = cs.GENERATIONS_LAUNCHES = cs.LTL_LAUNCHES = 0
    cs.SLAB_LAUNCHES = 0


def launches(cs) -> dict:
    return {"life_packed": cs.KERNEL_LAUNCHES,
            "life_slab": cs.SLAB_LAUNCHES,
            "life_generations": cs.GENERATIONS_LAUNCHES,
            "life_ltl": cs.LTL_LAUNCHES}


def seed_cells(shape, seed: int, fill: float = 0.35) -> np.ndarray:
    """A session's cells as ``SessionService`` seeds them from ``fill`` and
    ``rng_seed``."""
    return (np.random.default_rng(seed).random(shape) < fill).astype(np.uint8)


def check_slab_kernel(cs, bitpack, seeds, rules, rng, CONWAY, Topology) -> int:
    """Phase 2 for B2: ``slab_step_kernel`` against ``slab_step_reference``
    on batches of 1, 8 and 256 bands up to 16384 rows, every edge code and
    g in {1, 3, 8, 16}, then a glider crossing a word seam through the
    lane runner. Returns the largest error (0)."""
    import torch
    from gameoflifewithactors_torch.parallel.batched import \
        multi_step_kernel_batched

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=rng,
                             device=rng.device, dtype=torch.int64).to(torch.int32)

    cases, worst = 0, 0

    def hold(ext, g, rule, topology, code):
        nonlocal cases, worst
        got = cs.slab_step_kernel(ext, g, rule=rule, topology=topology,
                                  edge_code=code)
        want = cs.slab_step_reference(ext, g, rule=rule, topology=topology,
                                      edge_code=code)
        err = max_abs_err(got, want)
        check(err == 0, f"B2 kernel != plain at {tuple(ext.shape)} {rule} "
                        f"{topology} g={g} code={code}")
        worst = max(worst, err)
        cases += 1

    for shape in [(1, 40, 3), (8, 72, 5)]:
        ext = words(shape)
        for rule in rules:
            for topology in Topology:
                for code in range(4):
                    for g in (1, 3, 8, 16):
                        hold(ext, g, rule, topology, code)
    # the serving shapes: lanes of 1024^2 sessions (g = 8 and the 13-step
    # remainder chunk of 5) and one 16384^2 band
    for shape, gs in [((256, 1040, 32), (8,)), ((256, 1034, 32), (5,)),
                      ((64, 1040, 32), (8,)), ((1, 16400, 512), (8,)),
                      ((1, 16394, 512), (5,))]:
        ext = words(shape)
        for rule in rules[:2] if shape[0] > 64 else rules:
            for topology in Topology:
                for code in (0, 3):
                    for g in gs:
                        hold(ext, g, rule, topology, code)
    ext = words((256, 1056, 32))
    for g in (1, 3, 16):
        hold(ext, g, CONWAY, Topology.TORUS, 0)
    # a glider crossing the column-32 word seam and the torus seams: 256
    # generations move it (64, 64) cells, on a 64-row torus a pure shift
    for top, left in [(0, 29), (60, 125)]:
        start = seeds.seeded((64, 128), "glider", top, left)
        p = bitpack.pack(torch.from_numpy(start).to(rng.device))[None]
        got = multi_step_kernel_batched(p, 256, rule=CONWAY)
        moved = bitpack.unpack(got[0]).cpu().numpy()
        check((moved == np.roll(start, 64, axis=1)).all(),
              f"glider from ({top}, {left}) did not return shifted through B2")
        cases += 1
    print(f"B2 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst}")
    return worst


def serve_phase(cs, card: str) -> dict:
    """Phase 3 for B2: the session service at full size on the card.
    Returns the launches and the timed request's figures."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.models.rules import parse_rule
    from gameoflifewithactors_torch.obs.registry import MetricsRegistry
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops.packed import multi_step_packed
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.serve import (AdmissionController,
                                                  SessionService)

    h, w = LANE_SHAPE
    families = [  # (spec, sessions, first rng_seed)
        ({"rule": "B3/S23", "height": h, "width": w, "topology": "torus"},
         LANE_SESSIONS, 0),
        ({"rule": "B36/S23", "height": h, "width": w, "topology": "dead"},
         DEAD_SESSIONS, LANE_SESSIONS),
        ({"rule": "B3/S23", "height": MAIN_SHAPE[0], "width": MAIN_SHAPE[1],
          "topology": "torus"}, 1, LANE_SESSIONS + DEAD_SESSIONS),
    ]
    reg = MetricsRegistry()
    svc = SessionService(registry=reg, admission=AdmissionController(
        registry=reg))
    check(svc.device.type == "cuda", f"service on {svc.device}")
    reset_launches(cs)
    sessions = []   # (sid, spec, rng_seed, generations)
    for spec, count, first in families:
        for i in range(first, first + count):
            info = svc.create(f"tenant{i % 4}", spec, fill=0.35, rng_seed=i)
            check(info["spec"]["backend"] == "cuda",
                  f"auto picked {info['spec']['backend']!r} for {spec}")
            sessions.append([info["sid"], spec, i, 0])
    lanes = svc.lane_stats()
    check(sorted(ln["capacity"] for ln in lanes) == [1, DEAD_SESSIONS,
                                                     LANE_SESSIONS],
          f"lanes {lanes}")
    # mixed cursors: even sessions owe 8 generations, odd ones 13 (the
    # single session 13), then 2000 each in one request per session
    g = cs.DEFAULT_GENS_PER_CALL
    for k, sess in enumerate(sessions):
        n = 13 if k % 2 or sess[1]["height"] == MAIN_SHAPE[0] else 8
        svc.step(sess[0], n, pump=False)
        sess[3] += n
    d1 = svc.pump()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for sess in sessions:
        svc.step(sess[0], SERVE_GENERATIONS, pump=False)
        sess[3] += SERVE_GENERATIONS
    d2 = svc.pump()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)
    counts = launches(cs)
    # planned: per lane, the 8-generation dispatch and the 5 more the
    # 13-step sessions owe (the single session: one of 13), then 2000
    planned = [[8, 5], [8, 5], [13]]
    expected = sum(math.ceil(n / g) for plan in planned
                   for n in plan + [SERVE_GENERATIONS])
    check(d1 == 5 and d2 == 3, f"pump dispatches {d1}, {d2}; expected 5, 3")
    check(counts["life_slab"] == expected,
          f"serving launched life_slab {counts['life_slab']} times, planned "
          f"{expected}")
    check(all(v == 0 for k, v in counts.items() if k != "life_slab"),
          f"serving launched another kernel: {counts}")
    cells = sum(s[1]["height"] * s[1]["width"] for s in sessions)
    rate = cells * SERVE_GENERATIONS / wall
    print(f"serving main path: {len(sessions)} sessions in {len(lanes)} lanes "
          f"(capacities {sorted(ln['capacity'] for ln in lanes)}), cursors 8/13 "
          f"then {SERVE_GENERATIONS} generations per session, {d1} + {d2} "
          f"dispatches, {counts['life_slab']} life_slab launches == planned, "
          f"no other kernel")
    print(f"serving timed: {SERVE_GENERATIONS} generations of {cells} cells "
          f"in {len(sessions)} requests + one pump ({d2} dispatches): "
          f"{wall:.4f} s host clock incl. sync, {device_ms / 1e3:.4f} s "
          f"between CUDA events, {rate:.4e} cell-updates/s  [{card}]")

    # every session against its own dedicated engine on the card, and a
    # sample against the plain packed stepper
    lane_of = {}
    for sid, spec, seed, gens in sessions:
        info = svc.info(sid)
        check(info["generation"] == gens and info["pending_steps"] == 0,
              f"{sid}: {info}")
        lane = svc.pools[info["family"]].lanes[info["lane"]]
        lane_of[sid] = (lane, info["slot"])
        engine = Engine(seed_cells((spec["height"], spec["width"]), seed),
                        spec["rule"], topology=Topology(spec["topology"]),
                        backend="cuda")
        engine.step(gens)
        check(torch.equal(lane.state[info["slot"]], engine.state),
              f"session {sid} ({spec['rule']} {spec['topology']}, seed {seed}) "
              "differs from its dedicated Engine run")
    for sid, spec, seed, gens in [sessions[1], sessions[LANE_SESSIONS]]:
        plain = multi_step_packed(
            bitpack.pack(torch.from_numpy(seed_cells(LANE_SHAPE, seed)).cuda()),
            gens, rule=parse_rule(spec["rule"]), topology=Topology(spec["topology"]))
        lane, slot = lane_of[sid]
        check(torch.equal(lane.state[slot], plain),
              f"session {sid} differs from the plain packed stepper")
    print(f"serving results: all {len(sessions)} sessions == their dedicated "
          "Engine(backend='cuda') runs; 2 == the plain packed stepper")

    # closes: a quarter of the 256 sessions leaves plan(192) = [256] and
    # moves nothing, so close three quarters: the last close repacks the
    # 64 survivors into a 64-slot lane, slot by slot on the card
    top = sessions[:LANE_SESSIONS]
    before = {sid: lane_of[sid][0].state[lane_of[sid][1]].clone()
              for sid, *_ in top[::4]}
    pool = next(p for p in svc.pools.values() if p.family.height == h
                and p.family.topology is Topology.TORUS)
    compactions = pool.compactions
    for k, (sid, *_) in enumerate(top):
        if k % 4:
            svc.close(sid)
    check(pool.compactions == compactions + 1 and [
        ln.capacity for ln in pool.lanes.values()] == [64],
        f"closes left lanes {pool.stats()}")
    for sid, words in before.items():
        info = svc.info(sid)
        lane = pool.lanes[info["lane"]]
        check(torch.equal(lane.state[info["slot"]], words),
              f"compaction changed session {sid}")
    print(f"serving compaction: {LANE_SESSIONS - len(before)} of "
          f"{LANE_SESSIONS} closed, {len(before)} survivors repacked into a "
          f"{len(before)}-slot lane bit-identically")
    return {"launches": counts["life_slab"], "wall": wall,
            "device_ms": device_ms, "dispatches": d2, "rate": rate,
            "cells": cells}


def start_server(repo: str, build_dir: str) -> subprocess.Popen:
    """``python -m gameoflifewithactors_torch serve`` on the card, on an
    ephemeral port."""
    return subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", "serve",
         "--port", "0", "--flight-dump",
         os.path.join(build_dir, "chip_smoke_serve.flight.jsonl")],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def drive_server(proc: subprocess.Popen) -> None:
    """Phase 3: the server started by :func:`start_server` over HTTP, its
    grid held against the same session run in-process, then SIGTERM."""
    import signal
    import urllib.request

    from gameoflifewithactors_torch.serve import SessionService

    def req(port, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data, method=method),
            timeout=120)
        raw = r.read().decode()
        return r.status, (json.loads(raw) if r.headers.get(
            "Content-Type", "").startswith("application/json") else raw)

    spec = {"rule": "B3/S23", "height": 256, "width": 256, "topology": "torus"}
    try:
        line = proc.stdout.readline()
        check(line.startswith("SERVE_PORT "), f"serve announced {line!r}")
        port = int(line.split()[1])
        code, info = req(port, "POST", "/sessions", {
            "tenant": "smoke", "spec": spec, "fill": 0.35, "rng_seed": 5})
        check(code == 201 and info["spec"]["backend"] == "cuda", f"{code} {info}")
        code, info = req(port, "POST", f"/sessions/{info['sid']}/step", {"n": 100})
        check(code == 200 and info["generation"] == 100, f"{code} {info}")
        code, grid = req(port, "GET", f"/sessions/{info['sid']}/grid")
        local = SessionService()
        sid = local.create("smoke", spec, fill=0.35, rng_seed=5)["sid"]
        local.step(sid, 100)
        check(code == 200 and grid["cells_hex"] == local.grid_hex(sid)["cells_hex"],
              "served grid differs from the same session run in-process")
        code, info = req(port, "DELETE", f"/sessions/{info['sid']}")
        check(code == 200 and info["state"] == "closed", f"{code} {info}")
        code, health = req(port, "GET", "/healthz")
        check(code == 200 and health["ok"], f"{code} {health}")
        code, text = req(port, "GET", "/metrics")
        check(code == 200 and 'goltpu_session_steps_total{tenant="smoke"} 100'
              in text, "metrics lack the session's steps")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"serve exited {rc} on SIGTERM: {proc.stderr.read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print("serve entry point on the card: SERVE_PORT, create/step/grid "
          "(== in-process)/delete/healthz/metrics over HTTP, SIGTERM exit 0")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s: {what} done]")

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from gameoflifewithactors_torch import GridCoordinator, _build
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.models.rules import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, parse_rule)
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.packed import multi_step_packed
    from gameoflifewithactors_torch.ops.packed_generations import (
        multi_step_packed_generations, n_planes, pack_generations_for,
        population_packed_generations)
    from gameoflifewithactors_torch.ops.packed_ltl import multi_step_ltl_packed
    from gameoflifewithactors_torch.ops.stencil import Topology

    # -- 1. the card and the build -------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_seconds = _build.build_all(KERNELS)
    print(f"build of {len(KERNELS)} sources, one nvcc each, all started "
          f"together: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        built = _build.load(name)
        print(f"build {name}.cu: nvcc {build_seconds[name]:.2f} s  ({built.path})")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        total, loop, lop3 = sass_counts(built.path, _build.find_nvcc())
        if name == "life_packed":
            check(loop is not None, "no shared-memory loop found in B1's SASS")
        if loop is None:
            print(f"  sass: {total} instructions; no loop that both loads "
                  "and stores shared memory found")
        else:
            print(f"  sass: {total} instructions; shortest shared-memory "
                  f"loop {loop} instructions, {lop3} of them LOP3")
    stamp("the build")
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(0)
    worst = {name: 0 for name in KERNELS}

    # -- 2. kernels against their plain versions, bit for bit -----------------
    rules = [CONWAY, HIGHLIFE, DAY_AND_NIGHT, parse_rule("B03/S23")]
    cases = 0
    for shape in [(2, 32), (8, 64), (72, 96), (1000, 1056), MAIN_SHAPE]:
        for rule in rules:
            p = bitpack.pack(seeds.bernoulli(rng, shape, 0.5))
            for topology in Topology:
                for g in (1, 8, 32):
                    n = 2 * g + 3
                    got = cs.multi_step_kernel(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    want = cs.multi_step_reference(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B1 kernel != plain at {shape} {rule} "
                                    f"{topology} g={g} n={n}")
                    worst["life_packed"] = max(worst["life_packed"], err)
                    cases += 1
    # gliders crossing word boundaries and the torus seams: 4*64 generations
    # move a glider (64, 64) cells, which on a 64-row torus is a pure shift
    # of 64 columns
    for tile in [None, (8, 1)]:
        for top, left in [(0, 29), (60, 125)]:
            start = seeds.seeded((64, 128), "glider", top, left)
            p = bitpack.pack(torch.from_numpy(start).to(dev))
            got = cs.multi_step_kernel(p, 256, rule=CONWAY, tile=tile)
            want = cs.multi_step_reference(p, 256, rule=CONWAY, tile=tile)
            check(torch.equal(got, want), f"glider kernel != plain, tile {tile}")
            moved = bitpack.unpack(got).cpu().numpy()
            check((moved == np.roll(start, 64, axis=1)).all(),
                  f"glider from ({top}, {left}) did not return shifted")
            cases += 1
    print(f"B1 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst['life_packed']}")
    worst["life_slab"] = check_slab_kernel(cs, bitpack, seeds, rules, rng,
                                           CONWAY, Topology)

    cases = 0
    for name in ["brain", "starwars", "belzhab", "B2/S34/C5", "B3/S23/C256"]:
        rule = parse_any(name)
        for shape in [(2, 32), (72, 96), (1000, 1056)] + \
                ([MAIN_SHAPE] if name == "brain" else []):
            u = torch.rand(shape, generator=rng, device=dev)
            planes = pack_generations_for((u * rule.states).to(torch.uint8), rule)
            for topology in Topology:
                for g in (1, 8):
                    n = 2 * g + 3
                    got = cs.multi_step_generations_kernel(
                        planes, n, rule=rule, topology=topology, gens_per_call=g)
                    want = cs.multi_step_generations_reference(
                        planes, n, rule=rule, topology=topology, gens_per_call=g)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B3 kernel != plain at {shape} {name} "
                                    f"{topology} g={g} n={n}")
                    worst["life_generations"] = max(worst["life_generations"], err)
                    cases += 1
    print(f"B3 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst['life_generations']}")

    cases = 0
    for name in ["bosco", "majority", "R1,C0,M1,S2..3,B3..3",
                 "R7,C0,M1,S20..60,B25..50,NN", "R3,C0,M0,S10..20,B12..16",
                 "R2,C2,S6-9,12-14,B7-8,11"]:
        rule = parse_any(name)
        for shape in [(64, 96), (96, 128), (1000, 1056)] + \
                ([MAIN_SHAPE] if name == "bosco" else []):
            p = bitpack.pack(seeds.bernoulli(rng, shape, 0.5))
            for topology in Topology:
                for g in (2, 4):
                    n = 2 * g + 1        # not a multiple of g
                    got = cs.multi_step_ltl_kernel(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    want = cs.multi_step_ltl_reference(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B4 kernel != plain at {shape} {name} "
                                    f"{topology} g={g} n={n}")
                    worst["life_ltl"] = max(worst["life_ltl"], err)
                    cases += 1
    print(f"B4 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst['life_ltl']}")

    stamp("the kernels against their plain versions")

    # -- 3. the main paths ---------------------------------------------------
    main_launches = {}
    main_rates = {}
    paths = [
        ("life_packed", "B3/S23", cs.DEFAULT_GENS_PER_CALL,
         lambda s, n, rule: cs.multi_step_reference(s, n, rule=rule),
         bitpack.population),
        ("life_generations", "brain", cs.DEFAULT_GENERATIONS_GENS_PER_CALL,
         lambda s, n, rule: cs.multi_step_generations_reference(s, n, rule=rule),
         population_packed_generations),
        ("life_ltl", "bosco", cs.DEFAULT_LTL_GENS_PER_CALL,
         lambda s, n, rule: cs.multi_step_ltl_reference(s, n, rule=rule),
         bitpack.population),
    ]
    for kernel, spec, g, plain, plain_population in paths:
        coord = GridCoordinator(MAIN_SHAPE, spec, random_fill=0.5, rng_seed=1,
                                device="cuda", view_shape=(40, 80))
        check(coord.engine.backend == "cuda",
              f"auto picked {coord.engine.backend!r} for {spec}, not 'cuda'")
        start_state = coord.engine.state.clone()
        frames = []
        coord.subscribe(frames.append)
        reset_launches(cs)
        coord.run(MAIN_GENERATIONS, render_every=MAIN_TICK)
        counts = launches(cs)
        ticks = MAIN_GENERATIONS // MAIN_TICK
        expected = ticks * math.ceil(MAIN_TICK / g)
        check(counts[kernel] == expected,
              f"{spec} main path launched {kernel} {counts[kernel]} times, "
              f"expected {expected}")
        check(all(v == 0 for k, v in counts.items() if k != kernel),
              f"{spec} main path launched another kernel: {counts}")
        main_launches[kernel] = counts[kernel]
        check(len(frames) == ticks and frames[-1].grid.shape == (40, 80),
              "subscribers did not see every tick's frame")
        pop = coord.population()
        want = start_state
        for _ in range(ticks):
            want = plain(want, MAIN_TICK, coord.rule)
        check(torch.equal(coord.engine.state, want),
              f"{spec} main-path state differs from the plain version")
        check(pop == plain_population(want) and 0 < pop < MAIN_SHAPE[0] * MAIN_SHAPE[1],
              f"{spec} population {pop} is not the plain version's")
        print(f"main path: GridCoordinator {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} {spec} "
              f"50% soup TORUS, {MAIN_GENERATIONS} generations in {ticks} ticks, "
              f"backend {coord.engine.backend}, {counts[kernel]} {kernel} "
              f"launches, population {pop} == plain version")
        t0 = time.perf_counter()
        coord.run(2000)
        coord.engine.block_until_ready()
        wall = time.perf_counter() - t0
        main_rates[kernel] = MAIN_SHAPE[0] * MAIN_SHAPE[1] * 2000 / wall
        print(f"main path timed ({spec}): 2000 generations in one tick, "
              f"{wall:.4f} s host clock incl. sync, {main_rates[kernel]:.4e} "
              f"cell-updates/s  [{card}]")
        del coord, start_state, want, frames

    # the entry points in subprocesses, all started at once (each takes
    # seconds to reach the card) while nothing is timed: the CLI for each
    # family and the session server
    def cli(*args):
        return subprocess.Popen([sys.executable, "-m", "gameoflifewithactors_torch",
                                 *args], cwd=repo, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def last_line(proc):
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"CLI {proc.args} exited {proc.returncode}: {err}")
        return out.splitlines()[-1]

    # the same seed on the card and on the CPU: a numpy soup as an RLE file
    # beside the kernels' builds (the random fill draws from each device's
    # own generator)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    soup = os.path.join(_build.BUILD_DIR, "chip_smoke_soup.rle")
    with open(soup, "w") as f:
        f.write(seeds.to_rle(
            (np.random.default_rng(7).random((64, 64)) < 0.4).astype(np.uint8)))
    server = start_server(repo, _build.BUILD_DIR)
    glider = cli("--grid", "64x64", "--seed", "glider", "--steps", "10",
                 "--render", "final", "--population")
    runs = {}
    for spec in ["brain", "bosco"]:
        args = ("--rule", spec, "--grid", "96x128", "--seed", "@" + soup,
                "--steps", "12", "--render", "final", "--population")
        runs[spec] = (cli(*args), cli(*args, "--device", "cpu"))
    line = last_line(glider)
    check(line.endswith("pop 5"), "CLI output: " + line)
    print("CLI on the card:", line)
    for spec, (card_run, cpu_run) in runs.items():
        on_card, on_cpu = last_line(card_run), last_line(cpu_run)
        check(on_card == on_cpu and re.search(r"gen 12 .*pop [1-9]", on_card),
              f"CLI --rule {spec}: card {on_card!r} vs cpu {on_cpu!r}")
        print(f"CLI --rule {spec} on the card: {on_card} (== --device cpu)")
    drive_server(server)
    stamp("the main paths and the entry points")

    serving = serve_phase(cs, card)
    main_launches["life_slab"] = serving["launches"]
    stamp("the serving main path")

    # -- 4. timing at the main path's shape ------------------------------------
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    op_rate = sms * INT32_LANES_PER_SM * clock_hz
    cells = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    rows = []

    def bound(nbytes: float, ops: float):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / op_rate * 1e3
        return max(bytes_ms, ops_ms), bytes_ms, ops_ms

    # B1
    p = bitpack.pack(seeds.bernoulli(rng, MAIN_SHAPE, 0.5))
    H, Wp = p.shape
    g = cs.DEFAULT_GENS_PER_CALL
    reps = 200
    ms = timed_ms(lambda: cs.multi_step_kernel(p, g * reps, rule=CONWAY), 1) / reps
    plain_ms = timed_ms(lambda: cs.multi_step_reference(p, g, rule=CONWAY), 3)
    packed_ms = timed_ms(lambda: multi_step_packed(p, 10, rule=CONWAY), 1) / 10
    bound_ms, bytes_ms, ops_ms = bound(2 * H * Wp * 4,
                                       g * H * Wp * ops_per_word(CONWAY))
    print(f"B1 kernel {MAIN_SHAPE[0]}^2 g={g}: {ms:.5f} ms/launch, "
          f"{cells * g / (ms / 1e3):.4e} cell-updates/s; bound {bound_ms:.5f} ms "
          f"(bytes {bytes_ms:.5f}, ops {ops_ms:.5f}: {ops_per_word(CONWAY)} "
          f"ops/word/gen, {sms} SMs x {INT32_LANES_PER_SM} x "
          f"{clock_hz / 1e6:.0f} MHz)  [{card}]")
    print(f"B1 plain version (multi_step_reference, no yardstick): {plain_ms:.4f} "
          f"ms/launch; plain packed path (multi_step_packed, no yardstick): "
          f"{packed_ms:.4f} ms/generation  [{card}]")
    sweep = []
    for gs, tile in [(8, (64, 64)), (8, (128, 32)), (8, (32, 128)), (16, (64, 64)),
                     (4, (64, 64))]:
        t = timed_ms(lambda: cs.multi_step_kernel(
            p, gs * 50, rule=CONWAY, gens_per_call=gs, tile=tile), 1) / (50 * gs)
        sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B1 sweep:", "; ".join(sweep), f" [{card}]")
    rows.append(("life_packed", 160, ms, plain_ms, bound_ms, ops_ms >= bytes_ms))

    # B2 at the serving shapes: a full lane of 1024^2 sessions, the DEAD
    # family's 64-slot lane and the 16384^2 session's band, at g = 8
    from gameoflifewithactors_torch.parallel.batched import \
        multi_step_kernel_batched
    g = cs.DEFAULT_GENS_PER_CALL
    slab_ms = {}
    for batch, (bh, bw), rule, topology in [
            (LANE_SESSIONS, LANE_SHAPE, CONWAY, Topology.TORUS),
            (DEAD_SESSIONS, LANE_SHAPE, parse_rule("B36/S23"), Topology.DEAD),
            (1, MAIN_SHAPE, CONWAY, Topology.TORUS)]:
        lane = torch.stack([bitpack.pack(seeds.bernoulli(rng, (bh, bw), 0.35))
                            for _ in range(batch)])
        code = 3 if topology is Topology.DEAD else 0
        ext = torch.cat([lane[:, -g:], lane, lane[:, :g]], dim=1)
        He, Wq = ext.shape[1:]
        t = timed_ms(lambda: cs.slab_step_kernel(
            ext, g, rule=rule, topology=topology, edge_code=code), 50)
        chunk = timed_ms(lambda: multi_step_kernel_batched(
            lane, g * 20, np.ones(batch, np.uint32), rule=rule,
            topology=topology), 1) / 20
        b_ms, by_ms, op_ms = bound(2 * batch * He * Wq * 4,
                                   g * batch * He * Wq * ops_per_word(rule))
        slab_ms[(batch, bh)] = t
        cu = batch * bh * bw * g / (t / 1e3)
        print(f"B2 kernel {batch} x {bh}x{bw} {rule.notation} {topology.value} "
              f"(ext {He}x{Wq} words) g={g} "
              f"code={code}: {t:.5f} ms/launch, {cu:.4e} cell-updates/s; bound "
              f"{b_ms:.5f} ms (bytes {by_ms:.5f}, ops {op_ms:.5f}); lane chunk "
              f"(exchange + B2 + crop and mask select) {chunk:.5f} ms  [{card}]")
        if batch == LANE_SESSIONS:
            slab_row = (t, b_ms, op_ms >= by_ms, ext)
        del lane, ext
    t, b_ms, by_ops, ext = slab_row
    plain_ms = timed_ms(lambda: cs.slab_step_reference(ext, g, rule=CONWAY), 3)
    print(f"B2 plain version (slab_step_reference, no yardstick) at "
          f"{LANE_SESSIONS} x {LANE_SHAPE[0]}^2: {plain_ms:.4f} ms/launch  [{card}]")
    sweep = []
    for gs in (4, 8, 16):   # bands with a gs-row halo: cut or widen ext
        e = (ext[:, g - gs:ext.shape[1] - g + gs] if gs <= g else torch.cat(
            [ext[:, -(gs - g):], ext, ext[:, :gs - g]], dim=1)).contiguous()
        tt = timed_ms(lambda: cs.slab_step_kernel(e, gs, rule=CONWAY), 20)
        sweep.append(f"g={gs}: {tt / gs * 1e3:.2f} us/gen")
    print(f"B2 sweep ({LANE_SESSIONS} x {LANE_SHAPE[0]}^2 lane):", "; ".join(sweep),
          f" [{card}]")
    stamp("timing B1 and B2")
    rows.append(("life_slab", 748, t, plain_ms, b_ms, by_ops))
    kernel_ms = sum(
        n * slab_ms[key] for key, n in [
            ((LANE_SESSIONS, LANE_SHAPE[0]), SERVE_GENERATIONS // g),
            ((DEAD_SESSIONS, LANE_SHAPE[0]), SERVE_GENERATIONS // g),
            ((1, MAIN_SHAPE[0]), SERVE_GENERATIONS // g)])
    extra = (serving["wall"] * 1e3 - kernel_ms) / serving["dispatches"]
    print(f"serving breakdown: {serving['dispatches']} dispatches of "
          f"{SERVE_GENERATIONS} generations, B2 device time "
          f"{kernel_ms:.3f} ms of {serving['wall'] * 1e3:.3f} ms host clock; "
          f"{extra:.3f} ms per dispatch beyond the kernel's device time "
          f"({extra * serving['dispatches'] / (serving['wall'] * 1e3):.1%} of the "
          f"request)  [{card}]")
    del ext, slab_row

    # B3: Brian's Brain
    brain = parse_any("brain")
    u = torch.rand(MAIN_SHAPE, generator=rng, device=dev)
    planes = pack_generations_for((u * brain.states).to(torch.uint8), brain)
    b = n_planes(brain.states)
    g = cs.DEFAULT_GENERATIONS_GENS_PER_CALL
    reps = 50
    ms = timed_ms(lambda: cs.multi_step_generations_kernel(
        planes, g * reps, rule=brain), 1) / reps
    plain_ms = timed_ms(lambda: cs.multi_step_generations_reference(
        planes, g, rule=brain), 2)
    packed_ms = timed_ms(lambda: multi_step_packed_generations(
        planes, 5, rule=brain), 1) / 5
    opw = gen_ops_per_word(brain)
    bound_ms, bytes_ms, ops_ms = bound(2 * b * H * Wp * 4, g * H * Wp * opw)
    print(f"B3 kernel {MAIN_SHAPE[0]}^2 brain (b={b}) g={g}: {ms:.5f} ms/launch, "
          f"{cells * g / (ms / 1e3):.4e} cell-updates/s; bound {bound_ms:.5f} ms "
          f"(bytes {bytes_ms:.5f}, ops {ops_ms:.5f}: {opw} ops/word/gen)  [{card}]")
    print(f"B3 plain version (multi_step_generations_reference, no yardstick): "
          f"{plain_ms:.4f} ms/launch; plain packed path "
          f"(multi_step_packed_generations, no yardstick): {packed_ms:.4f} "
          f"ms/generation  [{card}]")
    sweep = []
    for gs, tile in [(8, (64, 64)), (8, (32, 64)), (8, (64, 32)), (16, (64, 64)),
                     (16, (32, 64)), (32, (64, 64)), (4, (64, 64))]:
        t = timed_ms(lambda: cs.multi_step_generations_kernel(
            planes, gs * 20, rule=brain, gens_per_call=gs, tile=tile), 1) / (20 * gs)
        sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B3 sweep:", "; ".join(sweep), f" [{card}]")
    rows.append(("life_generations", 218, ms, plain_ms, bound_ms, ops_ms >= bytes_ms))
    del planes, u

    # B4: Bosco
    bosco = parse_any("bosco")
    g = cs.DEFAULT_LTL_GENS_PER_CALL
    reps = 100
    ms = timed_ms(lambda: cs.multi_step_ltl_kernel(p, g * reps, rule=bosco), 1) / reps
    plain_ms = timed_ms(lambda: cs.multi_step_ltl_reference(p, g, rule=bosco), 2)
    packed_ms = timed_ms(lambda: multi_step_ltl_packed(p, 2, rule=bosco), 1) / 2
    opw = ltl_ops_per_word(bosco)
    bound_ms, bytes_ms, ops_ms = bound(2 * H * Wp * 4, g * H * Wp * opw)
    print(f"B4 kernel {MAIN_SHAPE[0]}^2 bosco (r=5) g={g} tile="
          f"{cs.DEFAULT_LTL_TILE[0]}x{cs.DEFAULT_LTL_TILE[1]}: {ms:.5f} ms/launch, "
          f"{cells * g / (ms / 1e3):.4e} cell-updates/s; bound {bound_ms:.5f} ms "
          f"(bytes {bytes_ms:.5f}, ops {ops_ms:.5f}: {opw} ops/word/gen)  [{card}]")
    print(f"B4 plain version (multi_step_ltl_reference, no yardstick): "
          f"{plain_ms:.4f} ms/launch; plain packed path (multi_step_ltl_packed, "
          f"no yardstick): {packed_ms:.4f} ms/generation  [{card}]")
    sweep = []
    for gs in (1, 2, 4, 8):
        for tile in [(64, 64), (128, 32), (256, 16)]:
            t = timed_ms(lambda: cs.multi_step_ltl_kernel(
                p, gs * 10, rule=bosco, gens_per_call=gs, tile=tile), 1) / (10 * gs)
            sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B4 sweep:", "; ".join(sweep), f" [{card}]")
    rows.append(("life_ltl", 308, ms, plain_ms, bound_ms, ops_ms >= bytes_ms))

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"gameoflifewithactors_torch/csrc/{name}.cu",
        "replaces": f"{PALLAS}:{line}",
        "launches": main_launches[name],
        "identical": True,
        "max_abs_err": worst[name],
        "ms": ms,
        "ms_per_launch": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops else "bytes",
        "library_ms": None,
    } for name, line, ms, plain_ms, bound_ms, by_ops in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
