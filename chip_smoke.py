#!/usr/bin/env python3
"""Smoke run of gameoflifewithactors_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each unguarded (any failure exits non-zero before the last line):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel from ``csrc/`` (one ``nvcc``
   per source, all started together; time, registers, spills, the SASS
   inner loop per output row of every instantiation of B1-B4), and the
   rule paths of B3 and of B1/B2 against their wrappers' encodings.
2. Each kernel against its plain PyTorch version on the card, bit for bit
   (tolerance 0: integer words), over rules, topologies, shapes up to
   16384², generations per call, edge codes (one per batch and one per
   band) and seam-crossing gliders; B1 on each rule path and on rows that
   fit one warp; B2's lane form with frozen slots, up to the serving
   lanes' shapes; B3 on each rule path, at g up to 32
   and on a tile that divides neither axis; B4 and its slab form at every radius
   1..7, box and diamond, M0 and M1, at g in {1, 2, 4}; the slab forms of
   B3 and B4 on batches of 1, 4 and 8 bands, b = 2..8 planes, and a
   4-band 16384² batch each. Then the rule sweep (``rule_sweep_phase``):
   rules drawn from a printed seed through every kernel form at small
   drawn shapes, depths, tiles, edge codes and masks -- B1 over 208 B/S
   rules under both topologies, B2's slab and lane forms, B3 and its slab
   form over 112 Generations rules, B4 and its slab form over 112 binary
   LtL rules -- each case bit for bit against the plain version, each
   case that ``supported*`` refuses raising ValueError in the wrapper; and
   one drawn rule per family through ``GridCoordinator`` at 16384²
   (``python3 chip_smoke.py --rule-sweep SEED`` runs the sweep alone).
3. The main paths, each driven with every kernel's launch count set to 0
   just before and read just after: three ``GridCoordinator`` runs at
   16384² with a 50% random soup under TORUS, held against the kernel's
   plain version from a copy of the start state -- B3/S23 (kernel B1),
   Brian's Brain (B3) and Bosco (B4); the same three on a mesh of four
   row bands on this one card (B2, B3 slab, B4 slab: one slab launch per
   chunk, no full-grid kernel), each held against its single-device run,
   and the three on a flattened (2, 2) mesh under DEAD at 4096²; then the
   CLI in a subprocess for each rule family, with and without ``--mesh
   bands``. Then the session service (B2's lane form, no other launch
   and no ``torch.cat`` on the card): a full
   256-slot lane of 1024² B3/S23 TORUS sessions, 64 B36/S23 DEAD sessions
   and one 16384² session on mixed cursors through ``SessionService``,
   every grid held against its own dedicated ``Engine`` run, compaction
   after closes, and ``python -m gameoflifewithactors_torch serve`` over
   HTTP in a subprocess. Checkpoints: each 16384² main path runs 150
   generations, saves, reloads onto the card and runs 150 more, launching
   its kernel in both halves, equal to the uninterrupted run; the B3/S23
   (4, 1) mesh path writes sharded v2 checkpoints at two generations, a
   flipped byte makes ``load_latest_verified`` fall back to the older one,
   which resumes onto the mesh. The elementary (1D) family (plain torch,
   no TPU kernel serves it): a 16384 x 16384-cell ensemble, W110 TORUS and
   W30 DEAD, 2000 generations against a dense truth-table reference, the
   W110 run on a (1, 4) mesh, and the CLI's 1D route with ``--ppm``. The
   CLI's ``--checkpoint``/``--resume`` round trip at 4096² with
   ``--save-rle`` and ``--ppm``, with and without ``--mesh bands``. The
   activity-tiled engines (plain torch: no TPU kernel serves them, and
   they launch no kernel): BASELINE.json config #5, a Gosper gun at the
   centre of a 65536² TORUS field, 2000 generations on
   ``Engine(backend="sparse")``, ``backend="paged"`` (capacity 4096) and
   ``backend="cuda"`` (B1), equal on the card, each with its rate, active
   tiles, capacity, dispatches and host syncs per generation and peak
   memory; Brian's Brain and Bosco 512² blobs in 8192² fields on the
   sparse engine against B3 and B4 (and B3/S23 against B1), each also at a
   fixed capacity of 8 whose dense fallback must be exact; 256
   mostly-empty 1024² sessions (gliders and guns) through
   ``SessionService(paged=True)``, each equal to its dedicated engine, and
   a ``paged1`` save and load. The rest of the single-host mesh, on a (2,
   2) mesh of the card (plain torch, launching no kernel): B3/S23 through
   the ghost-zone pipeline (``Engine(mesh=..., backend="packed",
   gens_per_exchange=8)``) and the deep runner, at 16384² TORUS (2000
   generations) and 4096² DEAD (500), each equal to B1, with its
   exchanges, the registry's ``halo_bytes_total`` against
   ``ghost_exchange_bytes`` and ``halo_bytes_per_gen`` measured against
   the model; the sharded sparse engine on config #5 (equal to B1 and the
   one-device sparse engine) and on the 8192² brain and Bosco blobs (400
   generations, equal to B3 and B4), with rates, host syncs, active tiles,
   capacity and peak memory; and 64 masked 1024² B3/S23 universes on a (2,
   2, 1) batch mesh, TORUS and DEAD, 2000 generations: one launch of B2's
   slab form per chunk, equal to the lane form, ms per chunk beside the
   lane form's. The observed and supervised run: the CLI with
   ``--telemetry-out`` and ``--profile-sample`` on the three 16384² main
   paths, each report's roofline shares in (0, 1.05], its attribution
   from the device tracks with B1, B3 or B4 as the top kernel, the duty
   cycle, the idle gaps and the compile events, and a tick's cost under
   telemetry (in turns); ``--supervise`` at 16384² B3/S23 with a
   ``FaultPlan`` corrupt_region after generation 1000 (one restart, equal
   to the unsupervised run, the seconds of saves, restores and stepping);
   an induced stall at 4096² (one StallEvent, one restart, a flight
   dump). Warm start, on cache roots of its own: ``warmup --manifest`` on
   an empty root (B1, B3, B4 and B2's lane form each a ``cache_miss``
   with nvcc seconds, the ``packed`` spec's registry record written);
   the CLI at 16384² B3/S23 from spawn to the end of its first
   2000-generation tick on an empty root and on the warmed one (no
   build); the registry-served ``Engine(backend="packed")`` (CUDA
   graphs of the plain loop) equal to the eager runner and to B1 after
   200 generations, launching no kernel, its ms per generation against
   the eager runner at 16384² and 1024²; ``serve --manifest`` on the
   warmed root (the ladder warmed, sessions grown through every rung,
   no build). The multi-process run (``multiprocess_phase``), two gloo
   processes sharing the card (``chip_smoke.py --band-worker RANK WORLD
   PORT WORK`` each): on a flattened (2, 2) global mesh, two bands per
   process, B2's slab form steps the 16384^2 B3/S23 state of the main
   path 2000 generations further, equal to the single-device B1 run, and
   B3's and B4's slab forms step brain and Bosco at 4096^2 DEAD, equal to
   their engines; each process launches its slab form once per chunk and
   no full-grid kernel, its chunk timed against the same runner on a
   single-process (2, 2) mesh, with the bytes staged through host memory;
   the elastic fleet (two workers, 4096^2, a ``process_kill`` at the
   midpoint, detection and recovery seconds, ``final.npy`` equal to B1);
   the soak worker's packed flavor SIGKILLed and resumed, equal to an
   unfaulted run. The analysis phase (``analysis_phase``): under
   ``GOLTPU_SANITIZE=1`` the transfer guard around B1, B3 and B4 at
   16384^2, B2's slab form on the 4-band mesh, B2's lane form on the
   256-session lane and config #5 on the sparse and paged engines, each
   two chunks and a remainder, no raise, equal to its unguarded run; the
   negative control raises; the contract gate on the card
   (``contracts --device cuda --strict``, one line per runner); the lint
   of the port tree; B1's ms per generation with the guard and without.
   The fleet drills (``drills_phase``, ``gameoflifewithactors_torch.drills``
   called at card sizes, every drill process under ``GOLTPU_SANITIZE=1``):
   ``serve_load`` over 100 sessions of 1024^2-class grids (B2's lane form)
   with a SIGKILL and ``--resume`` of the server; ``soak``, a worker per
   flavor at 1024^2-4096^2 and an unfaulted twin each under the seeded
   fault plan, one SIGKILLed and resumed, the packed worker also equal to
   B1; ``chaos_multihost``, four gloo processes on a (2, 2) mesh at 6144 x
   4096 through a preemption, checkpoint rot and a kill, 14 verdicts, the
   final grid equal to the single-device oracle and to B1. The examples
   (``examples_phase``): the ten demos of
   ``gameoflifewithactors_torch.examples`` at their default sizes with
   ``--device cuda`` (the mesh demos on four positions of cuda:0), each
   with its launches counted (B1 in checkpoint_resume and telemetry, B2 in
   ensemble, fault_recovery and both band layouts of distributed_bands, B4
   in ltl_zoo) and its wall seconds, held against its CPU twin (the same
   demo with ``--device cpu``: stdout and final grids) and its own oracle;
   then ``fleet_top --once`` over a live port server on the card. The
   bench (``bench_phase``): ``python -m gameoflifewithactors_torch.bench``
   in a subprocess on each 16384^2 main path (B1, B3, B4; 2000
   generations, three repetitions), its launches per repetition counted
   and its rate within 2x of this phase's tick; the bench in-process
   under the profiler against the plain B1, its report through
   ``roofline_report --check``; ``weak_scaling`` (packed and band) on 1,
   2 and 4 positions of the card against B1; the gate, the history and
   the store's scoreboard.
   Config #5, the CLI's time to first step and every tick above are timed
   by the bench package's helpers (``bench/timing.py``,
   ``bench/config5.py``, ``bench/warm_vs_cold.py``).
4. Timing with CUDA events: each kernel per launch at its main path's
   shapes, its plain version, the plain packed path, the least time the
   card could take, and a depth and tile sweep; B1 on each rule path; B2's
   lane form at the serving lanes beside a lane chunk and the slab form;
   the serving rate; the
   slab kernels at the mesh's 4-band shapes, a mesh chunk (exchange,
   launch, crop) beside its launch, and the mesh paths' rates.

Prints the kernels' JSON line, then as the last line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    from gameoflifewithactors_torch.obs.cost import (  # noqa: F401
        gen_ops_per_word, ltl_ops_per_word, ltl_sliding_ops_per_word,
        ltl_tree_ops_per_word, ops_per_word)
    from gameoflifewithactors_torch.utils.profiling import device_activity
    from gameoflifewithactors_torch.bench.timing import (  # noqa: F401
        nvidia_smi, tick_seconds, timed_ms, timed_run)
except ImportError:
    print("chip_smoke: gameoflifewithactors_torch is not beside this script",
          file=sys.stderr)
    sys.exit(1)

MAIN_SHAPE = (16384, 16384)
MAIN_GENERATIONS = 300       # not a multiple of g: the shorter launch runs too
MAIN_TICK = 100
KERNELS = ("life_packed", "life_slab", "life_generations", "life_ltl")
MESH_BANDS = 4               # the mesh main path: four row bands on one card
MESH_DEAD_SHAPE = (4096, 4096)
LANE_SHAPE = (1024, 1024)      # the serving sessions' grids
LANE_SESSIONS = 256            # one full top-rung lane
DEAD_SESSIONS = 64
SERVE_GENERATIONS = 2000
PALLAS = "gameoflifewithactors_tpu/ops/pallas_stencil.py"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sass_counts(so_path: str, nvcc: str):
    """(SASS instructions in the library, and for each kernel function its
    shortest loop that both loads and stores shared memory and starts no
    asynchronous copy (B4's tile load does) -- a kernel's per-word,
    per-generation row loop -- as (label, instructions, LOP3s)),
    read with ``cuobjdump`` beside ``nvcc``. Each function's addresses
    start at 0, so loops are found within one function at a time; the
    label is the function's template arguments (``ILi2ELb1EE``: b = 2,
    slab mode), or ``kernel`` for a function that has none."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    total, loops = 0, []
    for chunk in re.split(r"Function : ", sass)[1:]:
        name = chunk.split(None, 1)[0]
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        total += len(ins)
        best = None
        for addr, text in ins:
            m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if (any(re.search(r"\bLDS\b", t) for t in body)
                    and any(re.search(r"\bSTS\b", t) for t in body)
                    and not any("LDGSTS" in t for t in body)):
                if best is None or len(body) < best[0]:
                    best = (len(body), sum("LOP3" in t for t in body))
        if best is not None:
            label = re.search(r"kernel(I\w*?EE)?E", name)
            loops.append(((label.group(1) if label and label.group(1)
                           else "kernel"),) + best)
    return total, loops


def ltl_rows(label: str, n: int) -> str:
    """For a B4 instantiation (``ILi5ELb0ELb1EE``: radius 5, box, slab), its
    row loop's instructions per output row: the box loop is unrolled over
    the 2r+1 rows of its ring."""
    m = re.fullmatch(r"ILi(\d)ELb([01])ELb([01])EE", label)
    if not m:
        return ""
    rows = 1 if m.group(2) == "1" else 2 * int(m.group(1)) + 1
    return f" ({n / rows:.1f} per row; r={m.group(1)}, " \
           f"{'diamond' if m.group(2) == '1' else 'box'}, " \
           f"{'slab' if m.group(3) == '1' else 'full grid'})"


def gen_rows(label: str, n: int) -> str:
    """For a B3 instantiation (``ILi2ELb0ELi1EE``: b = 2, full grid, the
    equality path over one count), its row loop's instructions per output
    row: the loop is unrolled over a ring of three rows."""
    m = re.fullmatch(r"ILi(\d)ELb([01])ELi(\d)EE", label)
    if not m:
        return ""
    path = f"{m.group(3)} count(s)" if m.group(3) != "0" else "table"
    return f" ({n / 3:.1f} per row; b={m.group(1)}, rule path {path}, " \
           f"{'slab' if m.group(2) == '1' else 'full grid'})"


def packed_rows(label: str, n: int) -> str:
    """For a B1/B2 instantiation (``ILi0ELi2ELi1EE``: the grid form, the
    equality path over two counts, a whole row per warp wrapping), its row
    loop's instructions per output row: the loop is unrolled over a ring
    of three rows."""
    m = re.fullmatch(r"ILi([01])ELi(\d)ELi([012])EE", label)
    if not m:
        return ""
    path = f"{m.group(2)} count(s)" if m.group(2) != "0" else "table"
    cols = ("halo words", "row, torus", "row, dead")[int(m.group(3))]
    return f" ({n / 3:.1f} per row; {'slab' if m.group(1) == '1' else 'grid'}, " \
           f"rule path {path}, {cols})"


# the instantiations of B1 and B2: (form, rule path, columns) as template
# labels; B1 builds the grid form, B2 the slab form (halo words only) and
# the grid form for its lanes
PACKED_LABELS = {
    "life_packed": [f"ILi0ELi{k}ELi{c}EE" for k in range(5) for c in range(3)],
    "life_slab": [f"ILi1ELi{k}ELi0EE" for k in range(5)]
    + [f"ILi0ELi{k}ELi{c}EE" for k in range(5) for c in range(3)],
}
PACKED_RULES = {  # a B/S rule on each of B1/B2's rule paths
    1: "B2/S", 2: "B3/S23", 3: "B36/S23", 4: "B3/S245", 0: "B03/S23"}


GEN_RULES = {  # a rule on each of B3's rule paths (equality over K counts, table)
    1: "brain", 2: "belzhab", 3: "B2/S34/C5", 4: "starwars",
    0: "B0/S8/C4"}


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def mesh_codes(batch: int, device):
    """The per-band edge codes of ``batch`` row bands of one grid: 1 for
    the top band, 2 for the bottom one, 0 between."""
    import torch

    codes = [0] * batch
    codes[0] |= 1
    codes[-1] |= 2
    return torch.tensor(codes, dtype=torch.int32, device=device)


def band_batch(grid, bands: int, depth: int, topology):
    """``grid`` (``(H, Wp)`` words or a ``(b, H, Wp)`` plane stack) cut into
    ``bands`` full-width row bands, each extended by ``depth`` rows of its
    neighbours (wrapped under TORUS, zeros beyond the grid under DEAD): the
    batch a mesh of ``bands`` positions on one device hands its slab
    kernel."""
    import torch

    from gameoflifewithactors_torch.ops.stencil import Topology

    if topology is Topology.TORUS:
        ext = torch.cat([grid[..., -depth:, :], grid, grid[..., :depth, :]],
                        dim=-2)
    else:
        zeros = torch.zeros_like(grid[..., :depth, :])
        ext = torch.cat([zeros, grid, zeros], dim=-2)
    h = grid.shape[-2] // bands
    return torch.stack([ext[..., i * h:(i + 1) * h + 2 * depth, :]
                        for i in range(bands)]).contiguous()


def ltl_every_form():
    """One binary LtL rule for each radius 1..7, box and diamond, M0 and M1
    -- the 28 instantiations of kernel B4 and both rule paths' M0 branch
    -- with Bosco's intervals scaled to the window (birth 0.28..0.37 of
    it, survival 0.28..0.48)."""
    from gameoflifewithactors_torch.models.ltl import LtLRule

    rules = []
    for r in range(1, 8):
        for hood in "MN":
            cells = (2 * r + 1) ** 2 if hood == "M" else 2 * r * (r + 1) + 1
            lo = max(1, round(0.28 * cells))
            for middle in (True, False):
                rules.append(LtLRule(
                    radius=r, born=(lo, max(lo, round(0.37 * cells))),
                    survive=(lo, max(lo, round(0.48 * cells))), middle=middle,
                    neighborhood=hood))
    return rules


def seed_cells(shape, seed: int, fill: float = 0.35) -> np.ndarray:
    """A session's cells as ``SessionService`` seeds them from ``fill`` and
    ``rng_seed``."""
    return (np.random.default_rng(seed).random(shape) < fill).astype(np.uint8)


def check_slab_kernel(cs, bitpack, seeds, rules, rng, CONWAY, Topology) -> int:
    """Phase 2 for B2: ``slab_step_kernel`` against ``slab_step_reference``
    on batches of 1, 8 and 256 bands up to 16384 rows, the edge codes 0,
    3 and one per band (1, 0.., 2; the rule sweep draws every code) and
    g in {1, 3, 8, 16}, the batch mesh's 128 bands with their per-band
    codes, then a glider crossing a word seam through the lane runner.
    Returns the largest error (0)."""
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
                # codes 1 and 2 come with the per-band ones (the top and
                # bottom bands); the rule sweep draws every code
                for code in [0, 3, mesh_codes(shape[0], rng.device)]:
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
    # the batch mesh's batch: 32 universes on each of the four positions of
    # a (2, 2, 1) mesh of one device, the per-band codes repeated per universe
    from gameoflifewithactors_torch.parallel import batched, halo
    bmesh = batched.make_batch_mesh(BATCH_MESH, [rng.device] * 4)
    bl = BATCH_UNIVERSES // BATCH_MESH[0]
    ext = words((4 * bl, LANE_SHAPE[0] // 2 + 16, LANE_SHAPE[1] // 32))
    for topology in Topology:
        hold(ext, 8, CONWAY, topology, halo.band_edge_codes(
            bmesh, repeat=bl)[0] if topology is Topology.DEAD else 0)
    # the mesh main path's batch: four bands of a 16384^2 grid, one code
    # per band
    grid = words(MAIN_SHAPE[:1] + (MAIN_SHAPE[1] // 32,))
    for topology in Topology:
        ext = band_batch(grid, MESH_BANDS, 8, topology)
        hold(ext, 8, CONWAY, topology, mesh_codes(MESH_BANDS, rng.device)
             if topology is Topology.DEAD else 0)
    del grid, ext
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


def check_lane_kernel(cs, rng, parse_rule, Topology) -> int:
    """Phase 2 for B2's lane form: one launch of ``multi_step_lane_kernel``
    against ``lane_step_reference`` (the row exchange, the slab form's
    plain version, the crop and the select) on lanes whose rows fit one
    warp and lanes that do not, a rule on each rule path, g in {1, 8, 32}
    where the grids take it (the rule sweep draws the other depths), with
    a mask that freezes slots (each frozen slot
    bit-identical to its input), then the serving lanes at their shapes.
    Returns the largest error (0)."""
    import torch

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=rng,
                             device=rng.device, dtype=torch.int64).to(torch.int32)

    cases, worst = 0, 0

    def hold(grids, g, rule, topology, mask):
        nonlocal cases, worst
        got = cs.multi_step_lane_kernel(grids, g, mask, rule=rule,
                                        topology=topology, gens_per_call=g)
        want = cs.lane_step_reference(grids, g, rule=rule, topology=topology,
                                      mask=mask)
        err = max_abs_err(got, want)
        check(err == 0, f"B2 lane form != plain at {tuple(grids.shape)} "
                        f"{rule} {topology} g={g}")
        if mask is not None:
            frozen = (mask == 0).nonzero().flatten()
            check(torch.equal(got[frozen], grids[frozen]),
                  f"B2 lane form changed a frozen slot at {tuple(grids.shape)}")
        worst = max(worst, err)
        cases += 1

    for shape in [(3, 20, 1), (4, 40, 5), (5, 33, 32), (2, 24, 33), (3, 70, 64)]:
        grids = words(shape)
        mask = torch.tensor([1, 0] * 3, dtype=torch.int32,
                            device=rng.device)[:shape[0]]
        for name in PACKED_RULES.values():
            rule = parse_rule(name)
            for topology in Topology:
                for g in (1, 8, 32):         # the rule sweep draws the rest
                    if g <= shape[1]:
                        hold(grids, g, rule, topology, mask if g != 8 else None)
    # the serving lanes: 1024^2 sessions at g = 8 and the 13-step
    # remainder chunk of 5, a quarter of the slots frozen; one 16384^2
    for shape, gs in [((256, 1024, 32), (8, 5)), ((64, 1024, 32), (8,)),
                      ((1, 16384, 512), (8, 5))]:
        grids = words(shape)
        mask = (torch.arange(shape[0], device=rng.device) % 4 != 1).to(torch.int32)
        for name in ("B3/S23", "B36/S23"):
            for topology in Topology:
                for g in gs:
                    hold(grids, g, parse_rule(name), topology, mask)
    print(f"B2 lane form vs plain: {cases} cases bit-identical (tolerance 0), "
          f"frozen slots unchanged, max_abs_err {worst}")
    return worst


def check_slab_forms(cs, rng, Topology, parse_any, n_planes) -> dict:
    """Phase 2 for the slab forms of B3 and B4 against their plain
    versions: batches of 1, 4 and 8 bands with one code per batch (0) and
    one per band (a batch of one band: 3; the rule sweep draws the other
    codes), B3 at b = 2..8 planes, both rule paths and g in {1,
    3, 16, 32}, B4 on
    named rules and at every radius 1..7, box and diamond, M0 and M1
    (:func:`ltl_every_form`, on 4 bands), at g in {1, 2, 4}; then a 4-band
    16384^2 batch each, at the mesh main path's depth. Returns the largest
    error of each (0)."""
    import torch

    def words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=rng,
                             device=rng.device, dtype=torch.int64).to(torch.int32)

    worst = {"life_generations_slab": 0, "life_ltl_slab": 0}
    cases = dict.fromkeys(worst, 0)

    def hold(name, kernel, plain, ext, g, rule, topology, code):
        got = kernel(ext, g, rule=rule, topology=topology, edge_code=code)
        want = plain(ext, g, rule=rule, topology=topology, edge_code=code)
        err = max_abs_err(got, want)
        check(err == 0, f"{name} kernel != plain at {tuple(ext.shape)} "
                        f"{rule.notation} {topology} g={g} code={code}")
        worst[name] = max(worst[name], err)
        cases[name] += 1

    gen = ("life_generations_slab", cs.slab_step_generations_kernel,
           cs.slab_step_generations_reference)
    ltl = ("life_ltl_slab", cs.slab_step_ltl_kernel, cs.slab_step_ltl_reference)
    for name in ["brain", "starwars", "B2/S345/C5", "B3/S23/C9", "B3/S23/C17",
                 "B3/S23/C33", "B3/S23/C65", "B3/S23/C256", "B0/S8/C4"]:
        rule = parse_any(name)
        b = n_planes(rule.states)
        for batch, rows, wp in [(1, 40, 3), (4, 72, 5), (8, 130, 33)]:
            for g in (1, 3, 16, 32):
                ext = words((batch, b, rows + 2 * g, wp))
                for topology in Topology:
                    for code in (0, mesh_codes(batch, rng.device)):
                        hold(*gen, ext, g, rule, topology, code)
    named = [(parse_any(name), [(1, 40, 3), (4, 72, 5), (8, 130, 33)])
             for name in ["R1,C0,M1,S2..3,B3..3", "R2,C0,M1,S9..16,B8..12",
                          "bosco", "R2,C0,M0,S6..11,B6..9,NN", "majority"]]
    every = [(rule, [(4, 72, 5)]) for rule in ltl_every_form()]
    for rule, shapes in named + every:
        for batch, rows, wp in shapes:
            for g in (1, 2, 4):
                ext = words((batch, rows + 2 * rule.radius * g, wp))
                for topology in Topology:
                    for code in (0, mesh_codes(batch, rng.device)):
                        hold(*ltl, ext, g, rule, topology, code)
    # the mesh main path's batches: four bands of a 16384^2 grid
    wp = MAIN_SHAPE[1] // 32
    brain, bosco = parse_any("brain"), parse_any("bosco")
    g = cs.DEFAULT_GENERATIONS_GENS_PER_CALL
    planes = words((2,) + MAIN_SHAPE[:1] + (wp,))
    planes[1] &= ~planes[0]       # valid Brian's Brain states: no 3
    for topology in Topology:
        code = mesh_codes(MESH_BANDS, rng.device) \
            if topology is Topology.DEAD else 0
        hold(*gen, band_batch(planes, MESH_BANDS, g, topology), g, brain,
             topology, code)
    del planes
    grid = words(MAIN_SHAPE[:1] + (wp,))
    g = cs.DEFAULT_LTL_GENS_PER_CALL
    for topology in Topology:
        code = mesh_codes(MESH_BANDS, rng.device) \
            if topology is Topology.DEAD else 0
        hold(*ltl, band_batch(grid, MESH_BANDS, bosco.radius * g, topology),
             g, bosco, topology, code)
    del grid
    for name in worst:
        print(f"{name} kernel vs plain: {cases[name]} cases bit-identical "
              f"(tolerance 0), max_abs_err {worst[name]}")
    return worst


# -- the rule sweep: drawn rules through every kernel form --------------------

RULE_SWEEP_SEED = 18           # printed; `chip_smoke.py --rule-sweep SEED` re-runs it
SWEEP_BS_RULES = 208           # B1, each under TORUS and DEAD
SWEEP_GEN_RULES = 112          # B3, each on the full grid and in a slab
SWEEP_LTL_RULES = 112          # B4, each on the full grid and in a slab
SWEEP_SLAB_CASES = 96          # B2's slab form
SWEEP_LANE_CASES = 96          # B2's lane form
SWEEP_MAX_ROWS = 255           # odd heights up to 255 rows ...
SWEEP_MAX_WORDS = 16           # ... and widths up to 512 cells
SWEEP_TICK = 64                # the 16384^2 tick of each family's drawn rule
SWEEP_FORMS = ("life_packed", "life_slab", "life_slab_lane",
               "life_generations", "life_generations_slab", "life_ltl",
               "life_ltl_slab")


def _mask_set(mask: int) -> frozenset:
    return frozenset(n for n in range(9) if (mask >> n) & 1)


def _draw_count_sets(rng):
    """(born, survive) over counts 0..8: half the draws name 1..4 counts in
    1..7 between them (the kernels' equality paths), half are any two sets
    (mostly the table; B0 and count 8 in about half)."""
    if rng.random() < 0.5:
        born = survive = 0
        for count in rng.choice(np.arange(1, 8), size=int(rng.integers(1, 5)),
                                replace=False):
            kind = int(rng.integers(1, 4))      # 1 born, 2 survive, 3 both
            born |= (kind & 1) << int(count)
            survive |= (kind >> 1) << int(count)
        return _mask_set(born), _mask_set(survive)
    born, survive = (int(m) for m in rng.integers(0, 512, size=2))
    return _mask_set(born), _mask_set(survive)


def _draw_intervals(rng, window: int, past: bool):
    """Sorted disjoint non-adjacent intervals in 0..window: k of them, k in
    1..16 (at most MAX_LTL_BOUNDS boundaries; one interval in about half
    the draws, the full 16 now and then) or, with ``past``, 17..24 (past
    what the kernel takes). Drawn as their 2k boundaries lo, hi + 1:
    distinct values in 0..window + 1."""
    top = (window + 2) // 2
    if past:
        k = int(rng.integers(17, min(24, top) + 1))
    else:
        k = 1 if rng.random() < 0.5 else int(rng.integers(1, min(16, top) + 1))
        if rng.random() < 0.1:
            k = min(16, top)
    bounds = np.sort(rng.choice(window + 2, size=2 * k, replace=False))
    return tuple((int(bounds[2 * i]), int(bounds[2 * i + 1]) - 1)
                 for i in range(k))


def _draw_ltl_rule(rng):
    """A binary LtL rule: radius 1..7, box or diamond, M0 or M1, HROT
    interval lists within the kernel's boundary count or (about one rule
    in five, where the window holds 17 intervals) past it in one set."""
    from gameoflifewithactors_torch.models.ltl import LtLRule

    r = int(rng.integers(1, 8))
    hood = "M" if rng.random() < 0.5 else "N"
    window = (2 * r + 1) ** 2 if hood == "M" else 2 * r * (r + 1) + 1
    past = window >= 32 and rng.random() < 0.2
    which = int(rng.integers(2))            # the set that goes past
    return LtLRule(radius=r, neighborhood=hood, middle=bool(rng.integers(2)),
                   born=_draw_intervals(rng, window, past and which == 0),
                   survive=_draw_intervals(rng, window, past and which == 1))


def _draw_shape(rng):
    """(H, Wp): an odd height up to SWEEP_MAX_ROWS, 1..SWEEP_MAX_WORDS words."""
    return (int(rng.integers(0, SWEEP_MAX_ROWS // 2 + 1)) * 2 + 1,
            int(rng.integers(1, SWEEP_MAX_WORDS + 1)))


def _draw_tile(rng, wp: int, rows=(4, 65)):
    """None (the wrapper's own) or a tile whose width makes the row 1..3
    tiles wide."""
    if rng.random() < 0.35:
        return None
    return (int(rng.integers(*rows)), int(rng.integers(-(-wp // 3), wp + 1)))


def _draw_depth(rng, most: int) -> int:
    """Generations per launch, 1..most, the small ones likelier."""
    return int(min(most, rng.geometric(3.0 / most)))


def _draw_n(rng, g: int) -> int:
    """Generations to run at ``g`` per launch: a full launch and a shorter
    one (``n % g`` > 0 wherever g > 1)."""
    return g + (int(rng.integers(1, g)) if g > 1 else 1)


def _draw_code(rng, batch: int):
    """One edge code for the batch (an int 0..3) or one per band."""
    if rng.random() < 0.5:
        return int(rng.integers(0, 4))
    return [int(c) for c in rng.integers(0, 4, size=batch)]


def draw_rule_sweep(seed: int) -> dict:
    """The sweep's cases for every kernel form, from one numpy generator:
    form -> a list of dicts (``rule``, ``shape`` of the words, ``topology``,
    ``g`` the depth per launch, ``n`` generations (a slab form: one launch
    of ``g``), ``tile``, ``code`` / ``mask``, ``data`` the seed of the
    words). Drawing needs no card."""
    from gameoflifewithactors_torch.models.generations import GenRule
    from gameoflifewithactors_torch.models.rules import Rule
    from gameoflifewithactors_torch.ops.stencil import Topology

    rng = np.random.default_rng(seed)
    topologies = list(Topology)

    def topology():
        return topologies[int(rng.integers(2))]

    def data():
        return int(rng.integers(2 ** 63))

    draws = {form: [] for form in SWEEP_FORMS}
    bs_rules, seen = [], set()
    while len(bs_rules) < SWEEP_BS_RULES:
        born, survive = _draw_count_sets(rng)
        if (born, survive) not in seen:
            seen.add((born, survive))
            bs_rules.append(Rule(born=born, survive=survive))
    for rule in bs_rules:
        shape = _draw_shape(rng)
        g = _draw_depth(rng, 32)
        tile = _draw_tile(rng, shape[1])
        n = _draw_n(rng, g)
        for top in topologies:
            draws["life_packed"].append(dict(
                rule=rule, shape=shape, topology=top, g=g, n=n, tile=tile,
                data=data()))
    for _ in range(SWEEP_SLAB_CASES):
        rule = bs_rules[int(rng.integers(len(bs_rules)))]
        batch = int(rng.integers(1, 5))
        rows, wp = _draw_shape(rng)
        g = _draw_depth(rng, 32)
        draws["life_slab"].append(dict(
            rule=rule, shape=(batch, rows + 2 * g, wp), topology=topology(),
            g=g, n=g, tile=_draw_tile(rng, wp), code=_draw_code(rng, batch),
            data=data()))
    for _ in range(SWEEP_LANE_CASES):
        rule = bs_rules[int(rng.integers(len(bs_rules)))]
        batch = int(rng.integers(1, 7))
        h, wp = _draw_shape(rng)
        if rng.random() < 0.3:              # short grids: a deeper g is refused
            h = int(rng.integers(0, 5)) * 2 + 1
        shape = (batch, h, wp)
        g = _draw_depth(rng, 32)
        mask = None if rng.random() < 0.3 else \
            [int(m) for m in rng.integers(0, 2, size=batch)]
        draws["life_slab_lane"].append(dict(
            rule=rule, shape=shape, topology=topology(), g=g,
            n=_draw_n(rng, g), tile=_draw_tile(rng, shape[2]), mask=mask,
            data=data()))
    seen = set()
    while len(seen) < SWEEP_GEN_RULES:
        b = int(rng.integers(2, 9))
        born, survive = _draw_count_sets(rng)
        rule = GenRule(born=born, survive=survive, states=int(
            rng.integers(2 ** (b - 1) + 1, 2 ** b + 1)))
        if rule in seen:
            continue
        seen.add(rule)
        h, wp = _draw_shape(rng)
        g = _draw_depth(rng, 32)
        draws["life_generations"].append(dict(
            rule=rule, shape=(b, h, wp), topology=topology(), g=g,
            n=_draw_n(rng, g), tile=_draw_tile(rng, wp), data=data()))
        batch = int(rng.integers(1, 5))
        rows, wp = _draw_shape(rng)
        g = _draw_depth(rng, 32)
        draws["life_generations_slab"].append(dict(
            rule=rule, shape=(batch, b, rows + 2 * g, wp), topology=topology(),
            g=g, n=g, tile=_draw_tile(rng, wp), code=_draw_code(rng, batch),
            data=data()))
    seen = set()
    while len(seen) < SWEEP_LTL_RULES:
        rule = _draw_ltl_rule(rng)
        if rule in seen:
            continue
        seen.add(rule)
        shape = _draw_shape(rng)
        g = _draw_depth(rng, 8)
        draws["life_ltl"].append(dict(
            rule=rule, shape=shape, topology=topology(), g=g,
            n=_draw_n(rng, g), tile=_draw_tile(rng, shape[1]), data=data()))
        batch = int(rng.integers(1, 5))
        rows, wp = _draw_shape(rng)
        g = _draw_depth(rng, 8)
        draws["life_ltl_slab"].append(dict(
            rule=rule, shape=(batch, rows + 2 * rule.radius * g, wp),
            topology=topology(), g=g, n=g, tile=_draw_tile(rng, wp),
            code=_draw_code(rng, batch), data=data()))
    return draws


def sweep_input(case: dict, device):
    """The words of a drawn case on ``device``, from its ``data`` seed:
    uniform random words, or (a Generations form) cells uniform in 0..C-1
    packed as the rule's plane stack."""
    import torch
    from gameoflifewithactors_torch.models.generations import GenRule
    from gameoflifewithactors_torch.ops.packed_generations import \
        pack_generations_for
    from gameoflifewithactors_torch.utils.interop import state_from_numpy

    rng = np.random.default_rng(case["data"])
    rule, shape = case["rule"], case["shape"]
    if not isinstance(rule, GenRule):
        words = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        return torch.from_numpy(words.view(np.int32).copy()).to(device)
    *lead, b, h, wp = shape
    stacks = []
    for _ in range(int(np.prod(lead, dtype=int))):
        cells = rng.integers(0, rule.states, size=(h, wp * 32), dtype=np.uint8)
        stacks.append(pack_generations_for(
            torch.from_numpy(cells).to(device), rule))
    return stacks[0] if not lead else torch.stack(stacks).contiguous()


def sweep_calls(cs, form: str, case: dict, x):
    """(supported, the kernel's call, its plain version's call) of a drawn
    case: ``supported`` is what the ``supported*`` function of the form
    says of the case, with the wrapper's own arguments."""
    import torch

    rule, top, g, n, tile = (case[k] for k in ("rule", "topology", "g", "n",
                                               "tile"))
    code = case.get("code")
    if isinstance(code, list):
        code = torch.tensor(code, dtype=torch.int32, device=x.device)
    if form == "life_packed":
        return (cs.supported(x.shape, tile=tile),
                lambda: cs.multi_step_kernel(x, n, rule=rule, topology=top,
                                             gens_per_call=g, tile=tile),
                lambda: cs.multi_step_reference(x, n, rule=rule, topology=top,
                                                gens_per_call=g, tile=tile))
    if form == "life_generations":
        return (cs.supported_generations(x.shape[1:], x.shape[0], tile=tile,
                                         gens_per_call=g),
                lambda: cs.multi_step_generations_kernel(
                    x, n, rule=rule, topology=top, gens_per_call=g, tile=tile),
                lambda: cs.multi_step_generations_reference(
                    x, n, rule=rule, topology=top, gens_per_call=g, tile=tile))
    if form == "life_ltl":
        return (cs.supported_ltl(x.shape, rule, tile=tile, gens_per_call=g),
                lambda: cs.multi_step_ltl_kernel(
                    x, n, rule=rule, topology=top, gens_per_call=g, tile=tile),
                lambda: cs.multi_step_ltl_reference(
                    x, n, rule=rule, topology=top, gens_per_call=g, tile=tile))
    if form == "life_slab_lane":
        mask = case["mask"]

        def plain():
            out = x
            for gens in cs._launch_plan(n, g):
                out = cs.lane_step_reference(out, gens, rule=rule,
                                             topology=top, mask=mask)
            return out

        return (cs.supported_lane(x.shape[1:], g, batch=x.shape[0], tile=tile),
                lambda: cs.multi_step_lane_kernel(
                    x, n, mask, rule=rule, topology=top, gens_per_call=g,
                    tile=tile), plain)
    slab = {"life_slab": (cs.supported_slab, cs.slab_step_kernel,
                          cs.slab_step_reference),
            "life_generations_slab": (cs.supported_generations_slab,
                                      cs.slab_step_generations_kernel,
                                      cs.slab_step_generations_reference),
            "life_ltl_slab": (cs.supported_ltl_slab, cs.slab_step_ltl_kernel,
                              cs.slab_step_ltl_reference)}[form]
    supported, kernel, reference = slab
    if form == "life_slab":
        ok = supported(x.shape[1:], g, batch=x.shape[0], tile=tile)
    elif form == "life_generations_slab":
        ok = supported(x.shape[2:], x.shape[1], g, batch=x.shape[0], tile=tile)
    else:
        ok = supported(x.shape[1:], rule, g, batch=x.shape[0], tile=tile)
    kw = dict(rule=rule, topology=top, edge_code=code, tile=tile)
    return ok, lambda: kernel(x, g, **kw), lambda: reference(x, g, **kw)


def _first_difference(got, want) -> str:
    """The first word where two results differ, as index and uint32 hex."""
    at = tuple(int(i) for i in (got != want).nonzero()[0])
    return (f"first differing word at {at}: kernel "
            f"{int(got[at]) & 0xFFFFFFFF:#010x}, plain "
            f"{int(want[at]) & 0xFFFFFFFF:#010x}")


def rule_sweep_phase(cs, card: str, dev, seed: int = RULE_SWEEP_SEED) -> dict:
    """Drawn rules through every kernel form against its plain version at
    tolerance 0 (the cases of :func:`draw_rule_sweep` from ``seed``): B1
    over 208 B/S rules under TORUS and DEAD, B2's slab form with per-band
    edge codes, its lane form with a drawn mask, B3 and its slab form over
    112 Generations rules (b = 2..8), B4 and its slab form over 112 binary
    LtL rules (radius 1..7, box and diamond, M0 and M1, HROT lists within
    and past the kernel's boundary count). A case that ``supported*``
    refuses must make the wrapper raise ValueError and is not stepped;
    a mismatch prints the case and fails the run. Then one drawn rule per
    family through ``GridCoordinator`` at 16384^2 TORUS (``backend="cuda"``,
    one tick of 64 generations): ``ceil(64/g)`` launches of its kernel and
    a state equal to the plain version's. Returns each form's counts."""
    import torch

    from gameoflifewithactors_torch import GridCoordinator

    t_phase = time.perf_counter()
    print(f"rule sweep: seed {seed} (numpy default_rng; re-run with "
          f"`python3 chip_smoke.py --rule-sweep {seed}`)")
    draws = draw_rule_sweep(seed)
    out = {}
    for form, cases in draws.items():
        t0 = time.perf_counter()
        refused = 0
        for i, case in enumerate(cases):
            x = sweep_input(case, dev)
            ok, kernel, plain = sweep_calls(cs, form, case, x)
            where = (f"{form} case {i} of seed {seed}: {case['rule']} words "
                     f"{tuple(x.shape)} {case['topology'].value} g={case['g']} "
                     f"n={case['n']} tile={case['tile']} code="
                     f"{case.get('code')} mask={case.get('mask')}")
            if not ok:
                try:
                    kernel()
                except ValueError:
                    refused += 1
                    continue
                check(False, f"{where}: supported* refuses it, the wrapper "
                             "did not raise ValueError")
            got, want = kernel(), plain()
            if not torch.equal(got, want):
                print(f"rule sweep MISMATCH {where}: "
                      f"{_first_difference(got, want)}")
                check(False, f"{where}: kernel != plain")
        out[form] = {"cases": len(cases), "refusals": refused,
                     "rules": len({c["rule"] for c in cases}),
                     "seconds": time.perf_counter() - t0}
        print(f"rule sweep {form}: {len(cases)} cases, "
              f"{len(cases) - refused} bit-identical to the plain version "
              f"(tolerance 0), {out[form]['rules']} distinct rules, "
              f"{refused} refusals (each refused by supported* and raised "
              f"by the wrapper), {out[form]['seconds']:.1f} s  [{card}]")
    # one drawn rule per family at full width, through the main path
    paths = [("life_packed", cs.DEFAULT_GENS_PER_CALL, cs.multi_step_reference),
             ("life_generations", cs.DEFAULT_GENERATIONS_GENS_PER_CALL,
              cs.multi_step_generations_reference),
             ("life_ltl", cs.DEFAULT_LTL_GENS_PER_CALL,
              cs.multi_step_ltl_reference)]
    for kernel, g, plain in paths:
        rule = next(c["rule"] for c in draws[kernel] if kernel != "life_ltl"
                    or cs._ltl_rule_fits(c["rule"]))
        coord = GridCoordinator(MAIN_SHAPE, rule, backend="cuda",
                                random_fill=0.5, rng_seed=seed, device="cuda")
        start = coord.engine.state.clone()
        cs.reset_launch_counts()
        coord.run(SWEEP_TICK, render_every=SWEEP_TICK)
        counts = cs.launch_counts()
        want = math.ceil(SWEEP_TICK / g)
        check(counts[kernel] == want
              and all(v == 0 for k, v in counts.items() if k != kernel),
              f"rule sweep at {MAIN_SHAPE}: {rule} launched {counts}, "
              f"expected {want} of {kernel} alone")
        expected = plain(start, SWEEP_TICK, rule=rule)
        if not torch.equal(coord.engine.state, expected):
            print(f"rule sweep MISMATCH {kernel} at {MAIN_SHAPE} TORUS, "
                  f"{rule}, n={SWEEP_TICK}, seed {seed}: "
                  f"{_first_difference(coord.engine.state, expected)}")
            check(False, f"rule sweep: {rule} at {MAIN_SHAPE} != plain")
        out[kernel]["main_path"] = str(rule)
        print(f"rule sweep main path: GridCoordinator {MAIN_SHAPE[0]}x"
              f"{MAIN_SHAPE[1]} {rule} TORUS, one tick of {SWEEP_TICK} "
              f"generations, {counts[kernel]} {kernel} launches "
              f"(= ceil({SWEEP_TICK}/{g})), state == the plain version")
        del coord, start, expected
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"rule sweep phase: {out['seconds']:.1f} s  [{card}]")
    return out


def rule_sweep_main(seed: int) -> int:
    """``chip_smoke.py --rule-sweep SEED``: build the kernels and run the
    rule sweep alone from ``SEED`` (a failing case of a full run re-runs
    from the seed it printed)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from gameoflifewithactors_torch import _build
    from gameoflifewithactors_torch.ops import cuda_stencil as cs

    card = nvidia_smi("name,power.limit")
    print(card)
    _build.build_all(KERNELS)
    rule_sweep_phase(cs, card, torch.device("cuda"), seed)
    return 0


MAIN_PATHS = [  # (kernel, rule, family's default depth attribute)
    ("life_packed", "B3/S23", "DEFAULT_GENS_PER_CALL"),
    ("life_generations", "brain", "DEFAULT_GENERATIONS_GENS_PER_CALL"),
    ("life_ltl", "bosco", "DEFAULT_LTL_GENS_PER_CALL"),
]
MESH_PATHS = [  # (kernel, rule, family's default depth attribute)
    ("life_slab", "B3/S23", "DEFAULT_BAND_GENS_PER_CALL"),
    ("life_generations_slab", "brain", "DEFAULT_GENERATIONS_GENS_PER_CALL"),
    ("life_ltl_slab", "bosco", "DEFAULT_LTL_GENS_PER_CALL"),
]


def mesh_phase(cs, card: str, dev, single: dict, single_rates: dict) -> dict:
    """Phase 3 for the band runners: the three 16384^2 ``GridCoordinator``
    main paths again, on a mesh of four row bands on this card, each held
    against its single-device run from the same start (``single[rule]`` =
    (start state, state after the main path, its population)); then the
    three families under DEAD on a flattened (2, 2) mesh at 4096^2 against
    the single-device kernels, all on the device ``dev``. Returns each slab
    kernel's launches and the mesh paths' rates."""
    import torch
    from gameoflifewithactors_torch import Engine, GridCoordinator
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel.mesh import make_mesh

    mesh = make_mesh((MESH_BANDS, 1), [dev] * MESH_BANDS)
    out = {}
    for kernel, spec, depth_attr in MESH_PATHS:
        g = getattr(cs, depth_attr)
        start, after, pop = single[spec]
        coord = GridCoordinator(MAIN_SHAPE, spec, random_fill=0.5, rng_seed=1,
                                device=dev, mesh=mesh, backend="cuda",
                                view_shape=(40, 80))
        check(coord.engine.gens_per_exchange == g,
              f"{spec} mesh chunk {coord.engine.gens_per_exchange}, not {g}")
        check(torch.equal(coord.engine.state, start),
              f"{spec} mesh start state differs from the single-device one")
        frames = []
        coord.subscribe(frames.append)
        cs.reset_launch_counts()
        coord.run(MAIN_GENERATIONS, render_every=MAIN_TICK)
        counts = cs.launch_counts()
        ticks = MAIN_GENERATIONS // MAIN_TICK
        expected = ticks * math.ceil(MAIN_TICK / g)
        check(counts[kernel] == expected,
              f"{spec} mesh path launched {kernel} {counts[kernel]} times, "
              f"expected one per chunk: {expected}")
        check(all(v == 0 for k, v in counts.items() if k != kernel),
              f"{spec} mesh path launched another kernel: {counts}")
        check(len(frames) == ticks and frames[-1].grid.shape == (40, 80),
              "subscribers did not see every tick's frame")
        check(torch.equal(coord.engine.state, after),
              f"{spec} mesh path state differs from the single-device run")
        check(coord.population() == pop,
              f"{spec} mesh path population {coord.population()} != {pop}")
        print(f"mesh main path: GridCoordinator {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} "
              f"{spec} 50% soup TORUS on {MESH_BANDS} row bands of {dev}, "
              f"{MAIN_GENERATIONS} generations in {ticks} ticks, g={g}, "
              f"{counts[kernel]} {kernel} launches (one per chunk), no "
              f"full-grid kernel, state and population {pop} == the "
              "single-device kernel run")
        cs.reset_launch_counts()
        wall = tick_seconds(coord, 2000)
        timed = cs.launch_counts()[kernel]
        rate = MAIN_SHAPE[0] * MAIN_SHAPE[1] * 2000 / wall
        out[kernel] = {"launches": counts[kernel], "rate": rate}
        print(f"mesh main path timed ({spec}): 2000 generations in one tick, "
              f"{timed} {kernel} launches, "
              f"{wall:.4f} s host clock incl. sync, {rate:.4e} cell-updates/s "
              f"(single device: {single_rates[spec]:.4e}, ratio "
              f"{rate / single_rates[spec]:.4f})  [{card}]")
        del coord, frames

    mesh22 = make_mesh((2, 2), [dev] * 4)
    states = {"B3/S23": 2, "brain": 3, "bosco": 2}
    for kernel, spec, depth_attr in MESH_PATHS:
        g = getattr(cs, depth_attr)
        cells = (np.random.default_rng(5).random(MESH_DEAD_SHAPE)
                 * states[spec]).astype(np.uint8)
        sharded = Engine(cells, spec, topology=Topology.DEAD, mesh=mesh22)
        alone = Engine(cells, spec, topology=Topology.DEAD, backend="cuda",
                       device=dev)
        check(sharded.backend == "cuda", f"auto picked {sharded.backend}")
        cs.reset_launch_counts()
        sharded.step(MAIN_GENERATIONS)
        counts = cs.launch_counts()
        expected = math.ceil(MAIN_GENERATIONS / g)
        check(counts[kernel] == expected and all(
            v == 0 for k, v in counts.items() if k != kernel),
            f"{spec} DEAD (2, 2) mesh launched {counts}, expected {expected} "
            f"of {kernel}")
        alone.step(MAIN_GENERATIONS)
        check(torch.equal(sharded.state, alone.state),
              f"{spec} DEAD (2, 2) mesh differs from the single-device run")
        print(f"mesh DEAD: Engine {MESH_DEAD_SHAPE[0]}^2 {spec} on a flattened "
              f"(2, 2) mesh (auto backend {sharded.backend}), "
              f"{MAIN_GENERATIONS} generations, {counts[kernel]} {kernel} "
              f"launches, population {sharded.population()} == the "
              "single-device kernel run")
    return out


ELEMENTARY_SHAPE = (16384, 512)   # 16384 universes of 16384 cells, 2^28
ELEMENTARY_GENERATIONS = 2000
ELEMENTARY_CLI = ("W90", 4096, 2047)   # rule, row width, steps


def dense_elementary(cells, n: int, rule, topology):
    """The plain reference of the 1D family on the card: ``n`` generations
    of ``(..., W)`` uint8 cells, each the rule's 8-entry truth table (from
    ``pattern_bit``) looked up at (left, center, right) of rolled
    neighbours, zeros past the ends under DEAD."""
    import torch

    from gameoflifewithactors_torch.ops.stencil import Topology

    table = torch.tensor([rule.pattern_bit((k >> 2) & 1, (k >> 1) & 1, k & 1)
                          for k in range(8)], dtype=torch.uint8,
                         device=cells.device)
    for _ in range(n):
        left = torch.roll(cells, 1, dims=-1)
        right = torch.roll(cells, -1, dims=-1)
        if topology is Topology.DEAD:
            left[..., 0] = 0
            right[..., -1] = 0
        cells = table[((left << 2) | (cells << 1) | right).long()]
    return cells


def elementary_phase(cs, card: str, dev, repo: str, cli_dir: str) -> dict:
    """Phase 3 for the 1D family (plain torch; no TPU kernel serves it): a
    16384-universe ensemble of 16384 cells through multi_step_elementary,
    W110 under TORUS and W30 under DEAD, each held bit for bit against the
    dense truth-table reference; the W110 run again through the sharded
    runner on a (1, 4) mesh of ``dev`` at g = 8; the CLI's 1D route with
    ``--ppm`` against ``save_ppm`` of the library's spacetime diagram.
    Launches no kernel of B1-B4. Returns the rates."""
    import torch
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.elementary import parse_elementary
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops.elementary import (
        evolve_spacetime, multi_step_elementary)
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel.mesh import (
        device_put_sharded_grid, make_mesh)
    from gameoflifewithactors_torch.parallel.sharded import \
        make_multi_step_elementary_sharded
    from gameoflifewithactors_torch.utils.render import save_ppm

    rule_name, width, steps = ELEMENTARY_CLI
    ppm = os.path.join(cli_dir, "elementary_cli.ppm")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", "--rule",
         rule_name, "--grid", f"1x{width}", "--steps", str(steps), "--ppm",
         ppm], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    h, wp = ELEMENTARY_SHAPE
    n = ELEMENTARY_GENERATIONS
    cells = h * wp * 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    start = bitpack.pack(seeds.bernoulli(gen, (h, wp * 32), 0.5))
    out = {}
    cs.reset_launch_counts()
    for name, topology in [("W110", Topology.TORUS), ("W30", Topology.DEAD)]:
        rule = parse_elementary(name)
        multi_step_elementary(start, 8, rule=rule, topology=topology)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = multi_step_elementary(start, n, rule=rule, topology=topology)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = bitpack.pack(dense_elementary(bitpack.unpack(start), n, rule,
                                             topology))
        check(torch.equal(got, want),
              f"elementary {name} {topology.value} ensemble != the dense "
              "truth-table reference")
        out[name] = cells * n / wall
        print(f"elementary ensemble: {h} universes x {wp * 32} cells "
              f"({h}x{wp} int32 words) {name} {topology.value}, {n} "
              f"generations of multi_step_elementary in {wall:.4f} s host "
              f"clock incl. sync, {out[name]:.4e} cell-updates/s; == the "
              f"dense uint8 truth-table reference bit for bit  [{card}]")
        if name == "W110":
            single = got
        del got, want
    mesh = make_mesh((1, 4), [dev] * 4)
    g = 8
    run = make_multi_step_elementary_sharded(mesh, parse_elementary("W110"),
                                             Topology.TORUS, g)
    placed = device_put_sharded_grid(start, mesh)
    run(placed, 1)    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = run(placed, n // g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(done.gather(), single),
          "elementary W110 on the (1, 4) mesh != the single-device run")
    out["sharded"] = cells * n / wall
    print(f"elementary sharded: W110 TORUS on a (1, 4) mesh of {dev} "
          f"(width over the column axis, one halo word per side per chunk), "
          f"g={g}, {n // g} chunks in {wall:.4f} s host clock incl. sync, "
          f"{out['sharded']:.4e} cell-updates/s (single device "
          f"{out['W110']:.4e}, ratio {out['sharded'] / out['W110']:.4f}); "
          f"== the single-device run  [{card}]")
    counts = cs.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"the elementary paths launched a kernel of B1-B4: {counts}")
    del single, done, placed, start

    _, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"CLI {proc.args} exited {proc.returncode}: {err}")
    row = np.zeros(width, np.uint8)
    row[width // 2] = 1
    st = evolve_spacetime(bitpack.pack(torch.from_numpy(row[None]).to(dev)),
                          steps, rule=parse_elementary(rule_name))
    want_ppm = os.path.join(cli_dir, "elementary_library.ppm")
    save_ppm(bitpack.unpack(st[:, 0, :]).cpu().numpy(), want_ppm)
    with open(ppm, "rb") as a, open(want_ppm, "rb") as b:
        check(a.read() == b.read(),
              f"CLI --rule {rule_name} --ppm differs from save_ppm of "
              "evolve_spacetime")
    print(f"CLI --rule {rule_name} --grid 1x{width} --steps {steps} --ppm on "
          f"the card: {os.path.getsize(ppm)} bytes == save_ppm of the "
          "library's evolve_spacetime")
    os.unlink(ppm)
    os.unlink(want_ppm)
    # the dense reference's 2 GiB index temporaries: hand them back, so the
    # timing phase's allocations find the pool as the other phases leave it
    del st
    torch.cuda.empty_cache()
    return out


def resume_phase(cs, card: str, single: dict, work: str) -> dict:
    """Phase 3 for checkpoints: each 16384^2 main path (``single[spec]`` =
    (start, state after MAIN_GENERATIONS, population)) runs half its
    generations from the start state, saves, loads onto the card and runs
    the other half, launching its kernel in both halves; the result equals
    the uninterrupted run. Returns seconds and MiB per path."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.utils import checkpoint as ckpt

    half = MAIN_GENERATIONS // 2
    out = {}
    for kernel, spec, depth_attr in MAIN_PATHS:
        g = getattr(cs, depth_attr)
        start, after, _ = single[spec]
        engine = Engine.from_packed(start, spec, device="cuda")
        cs.reset_launch_counts()
        engine.step(half)
        engine.block_until_ready()
        first = cs.launch_counts()[kernel]
        path = os.path.join(work, f"resume-{kernel}.npz")
        t0 = time.perf_counter()
        ckpt.save(engine, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.load_engine(path)
        back.block_until_ready()
        load_s = time.perf_counter() - t0
        check(back.backend == "cuda" and back.generation == half
              and back.device.type == "cuda",
              f"{spec} resumed as {back.backend} on {back.device} at "
              f"generation {back.generation}")
        cs.reset_launch_counts()
        back.step(MAIN_GENERATIONS - half)
        second = cs.launch_counts()[kernel]
        expected = math.ceil(half / g)
        check(first == expected and second == expected,
              f"{spec} resume launched {kernel} {first} + {second} times, "
              f"expected {expected} each")
        check(torch.equal(back.state, after),
              f"{spec} resumed run differs from the uninterrupted run")
        mib = os.path.getsize(path) / 2 ** 20
        out[spec] = {"save_s": save_s, "load_s": load_s, "mib": mib}
        layout = ckpt.load_grid(path)[1]["layout"]
        print(f"resume: {MAIN_SHAPE[0]}^2 {spec} {half} generations, save "
              f"({layout}) {save_s:.4f} s, {mib:.2f} MiB, load_engine onto "
              f"the card {load_s:.4f} s, {MAIN_GENERATIONS - half} more; "
              f"{first} + {second} {kernel} launches; == the uninterrupted "
              f"{MAIN_GENERATIONS}-generation run  [{card}]")
        os.unlink(path)
        del engine, back
    return out


def sharded_v2_phase(cs, card: str, dev, single: dict, work: str) -> dict:
    """Phase 3 for the sharded checkpoint: the B3/S23 main path on the
    (4, 1) mesh writes its shards at two generations and commits each; a
    byte flipped in the newer generation's shard makes
    ``load_latest_verified`` fall back to the older one, which resumes onto
    the mesh and runs on to MAIN_GENERATIONS, equal to the single-device
    run."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel.mesh import make_mesh
    from gameoflifewithactors_torch.parallel.multihost import local_shards
    from gameoflifewithactors_torch.utils import checkpoint as ckpt

    spec = "B3/S23"
    start, after, _ = single[spec]
    mesh = make_mesh((MESH_BANDS, 1), [dev] * MESH_BANDS)
    engine = Engine.from_packed(start, spec, mesh=mesh)
    check(engine.backend == "cuda", f"auto picked {engine.backend}")
    root = os.path.join(work, "sharded")
    written = []
    for gens in (100, 100):
        engine.step(gens)
        gen_dir = ckpt.generation_dir(root, engine.generation)
        t0 = time.perf_counter()
        shards = local_shards(engine.sharded_state)
        ckpt.write_shards(gen_dir, 0, shards,
                          global_shape=tuple(engine.state.shape),
                          dtype=np.uint32)
        ckpt.commit_manifest(gen_dir, num_processes=1, meta={
            "rule": engine.rule.notation, "topology": engine.topology.value,
            "generation": engine.generation, "shape": list(engine.shape),
            "layout": "packed32"})
        written.append((gen_dir, time.perf_counter() - t0, len(shards)))
    newer = written[-1][0]
    npz = os.path.join(newer, "shard-p0000.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    t0 = time.perf_counter()
    arr, meta, gen_dir, skipped = ckpt.load_latest_verified(root)
    load_s = time.perf_counter() - t0
    check(str(gen_dir) == str(written[0][0])
          and [str(d) for d, _ in skipped] == [str(newer)],
          f"load_latest_verified returned {gen_dir}, skipped {skipped}")
    back = Engine.from_packed(arr, meta["rule"],
                              topology=Topology(meta["topology"]), mesh=mesh)
    back.generation = meta["generation"]
    cs.reset_launch_counts()
    back.step(MAIN_GENERATIONS - back.generation)
    slab = cs.launch_counts()["life_slab"]
    check(slab > 0 and cs.launch_counts()["life_packed"] == 0,
          f"the resumed mesh run launched {cs.launch_counts()}")
    check(back.generation == MAIN_GENERATIONS
          and torch.equal(back.state, after),
          "the resumed mesh run differs from the single-device run")
    mib = sum(os.path.getsize(os.path.join(written[0][0], f))
              for f in os.listdir(written[0][0])) / 2 ** 20
    print(f"sharded v2: {spec} on the ({MESH_BANDS}, 1) mesh, shards "
          f"({written[0][2]} per generation) written and committed at "
          f"generations 100 and 200 in {written[0][1]:.4f} and "
          f"{written[1][1]:.4f} s, {mib:.2f} MiB per generation; a byte "
          f"flipped in generation 200's shard: load_latest_verified fell back "
          f"to generation {meta['generation']} in {load_s:.4f} s (skipped: "
          f"{skipped[0][1][:80]}...), resumed onto the mesh, {slab} life_slab "
          f"launches to generation {MAIN_GENERATIONS}; == the single-device "
          f"run  [{card}]")
    shutil.rmtree(root)
    return {"write_s": written[0][1], "load_s": load_s, "mib": mib}


def cli_round_trip(repo: str, work: str) -> None:
    """The CLI's checkpoint round trip at 4096^2 on the card: 200
    generations to ``--checkpoint``, ``--resume`` for 100 more with
    ``--save-rle`` and ``--ppm``, against a straight 300-generation run;
    both files byte-equal, with and without ``--mesh bands``."""
    base = ["--grid", "4096x4096", "--seed", "random", "--rng-seed", "3"]

    def run(*args):
        return subprocess.Popen(
            [sys.executable, "-m", "gameoflifewithactors_torch", *args],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def wait(proc):
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"CLI {proc.args} exited {proc.returncode}: {err}")

    # the single-device and the mesh runs all started together, each
    # resume as soon as its checkpoint is written
    meshes = {"single": [], "mesh": ["--mesh", "bands"]}
    files, firsts, straights = {}, {}, {}
    for tag, mesh in meshes.items():
        f = files[tag] = {k: os.path.join(work, f"cli-{tag}-{k}") for k in
                          ("c.npz", "a.rle", "a.ppm", "b.rle", "b.ppm")}
        firsts[tag] = run(*base, *mesh, "--steps", "200", "--checkpoint",
                          f["c.npz"])
        straights[tag] = run(*base, *mesh, "--steps", "300", "--save-rle",
                             f["b.rle"], "--ppm", f["b.ppm"])
    resumed = {}
    for tag, mesh in meshes.items():
        f = files[tag]
        wait(firsts[tag])
        resumed[tag] = run("--resume", f["c.npz"], *mesh, "--steps", "100",
                           "--save-rle", f["a.rle"], "--ppm", f["a.ppm"])
    for tag, mesh in meshes.items():
        f = files[tag]
        wait(straights[tag])
        wait(resumed[tag])
        for kind in ("rle", "ppm"):
            with open(f[f"a.{kind}"], "rb") as a, open(f[f"b.{kind}"], "rb") as b:
                check(a.read() == b.read(),
                      f"CLI {tag}: the resumed run's --{kind} file differs "
                      "from the straight run's")
        print(f"CLI round trip 4096^2{' --mesh bands' if mesh else ''}: "
              f"--steps 200 --checkpoint, then --resume --steps 100: "
              f"--save-rle ({os.path.getsize(f['a.rle'])} bytes) and --ppm "
              f"({os.path.getsize(f['a.ppm'])} bytes) == the straight "
              "300-generation run's")
        for path in f.values():
            os.unlink(path)


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
    # count the lane-form launches and every torch.cat on the card while
    # the service steps: the lanes must launch only B2's lane form and
    # build no extended copy of a lane
    seen = {"lane": 0, "cat": 0}
    launch_lane, cat = cs._launch_lane, torch.cat

    def counted_lane(*args, **kwargs):
        seen["lane"] += 1
        return launch_lane(*args, **kwargs)

    def counted_cat(tensors, *args, **kwargs):
        tensors = list(tensors)
        if any(t.is_cuda for t in tensors):
            seen["cat"] += 1
        return cat(tensors, *args, **kwargs)

    cs.reset_launch_counts()
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
    g = cs.DEFAULT_BAND_GENS_PER_CALL
    for k, sess in enumerate(sessions):
        n = 13 if k % 2 or sess[1]["height"] == MAIN_SHAPE[0] else 8
        svc.step(sess[0], n, pump=False)
        sess[3] += n
    cs._launch_lane, torch.cat = counted_lane, counted_cat
    try:
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
    finally:
        cs._launch_lane, torch.cat = launch_lane, cat
    device_ms = start.elapsed_time(end)
    counts = cs.launch_counts()
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
    check(seen["lane"] == expected and seen["cat"] == 0,
          f"serving made {seen['lane']} lane-form launches and {seen['cat']} "
          "torch.cat calls on the card; expected only lane launches, no cat")
    cells = sum(s[1]["height"] * s[1]["width"] for s in sessions)
    rate = cells * SERVE_GENERATIONS / wall
    print(f"serving main path: {len(sessions)} sessions in {len(lanes)} lanes "
          f"(capacities {sorted(ln['capacity'] for ln in lanes)}), cursors 8/13 "
          f"then {SERVE_GENERATIONS} generations per session, {d1} + {d2} "
          f"dispatches, {counts['life_slab']} life_slab launches == planned, "
          f"all {seen['lane']} of its lane form, no torch.cat on the card, no "
          "other kernel")
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


CONFIG5_SIDE = 65536           # BASELINE.json config #5: a Gosper gun, 65536^2
CONFIG5_GENERATIONS = 2000
CONFIG5_PAGED_CAPACITY = 4096
FAMILY_SIDE = 8192             # the other families' sparse runs
PAGED_SESSIONS = 256           # mostly-empty 1024^2 sessions: gliders, guns
PAGED_GENERATIONS = 512
PAGED_POOL_TILES = 32768       # 16x1-word tiles, 64 bytes each: 2 MiB
GHOST_RUNS = ((16384, "torus", 2000), (4096, "dead", 500))  # side, topology, n
GHOST_G = 8                    # generations per exchange, ghost and deep
MESH_FAMILY_GENERATIONS = 400  # the 8192^2 brain and bosco blobs on the mesh
BATCH_MESH = (2, 2, 1)         # the batch mesh on one card
BATCH_UNIVERSES = 64           # 1024^2 B3/S23 universes (LANE_SHAPE)
BATCH_GENERATIONS = 2000


def tiled_phase(cs, card: str) -> dict:
    """Phase 3 for the activity-tiled engines (``ops/sparse.py``, ``memory/``;
    plain torch: no TPU kernel serves them, and they launch none of
    B1-B4): config #5 at its stated size on the sparse, paged and B1
    engines; Brian's Brain and Bosco blobs on the sparse engine against
    B3 and B4; a fixed capacity of 8 whose dense fallback must be exact;
    paged serving of many mostly-empty sessions. Returns the records."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.bench import config5
    from gameoflifewithactors_torch.memory import step_grids
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.obs.registry import MetricsRegistry
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.serve import (AdmissionController,
                                                  SessionService, encode_words)
    from gameoflifewithactors_torch.utils import checkpoint as ckpt

    out = {}
    # -- config #5: a word-aligned Gosper gun at the centre of 65536^2, timed
    # by the bench's config5 module (one build, one n-generation step) ------
    side, n = CONFIG5_SIDE, CONFIG5_GENERATIONS
    words = config5.seed_words(side)
    finals = {}
    for backend, capacity, kernel in (
            ("sparse", None, None),
            ("paged", CONFIG5_PAGED_CAPACITY, None),
            ("cuda", None, "life_packed")):
        cs.reset_launch_counts()
        engine, rec = config5.build_and_step(
            words, backend, n, topology="torus", capacity=capacity,
            device="cuda")
        counts = cs.launch_counts()
        check(all(v == 0 for k, v in counts.items() if k != kernel),
              f"config #5 on {backend} launched {counts}")
        state = engine._sparse
        if kernel is None:
            check(engine.state.is_cuda and (state.padded.is_cuda),
                  f"config #5 {backend} state is not on the card")
        else:
            check(counts[kernel] == math.ceil(n / cs.DEFAULT_GENS_PER_CALL),
                  f"config #5 B1 launches {counts}")
            rec["dispatches_per_gen"] = counts[kernel] / n
        finals[backend] = engine.state.contiguous()
        build_s, (wall,) = rec["build_s"], rec["repetition_seconds"]
        # after the timed run and its result: 64 more generations under the
        # profiler, for the card's share of a generation
        ops, busy = device_activity(engine, 64)
        rec["device_ops_per_gen"], rec["device_ms_per_gen"] = ops, busy
        activity = "device activity not measured (no device time in the " \
            "profile)" if busy is None else (
                f"{ops:.1f} device ops and {busy:.5f} ms of device time per "
                f"generation (profiled), {busy / (1e3 * wall / n):.1%} of "
                "the timed generation")
        out[f"config5 {backend}"] = rec
        print(f"config #5 ({side}x{side} Gosper gun, TORUS, {n} generations) "
              f"on backend {backend!r}: built in {build_s:.4f} s, stepped in "
              f"{wall:.4f} s host clock incl. sync, {1e3 * wall / n:.5f} ms "
              f"and {rec['value']:.2f} gens/s, "
              f"{rec['nominal_cell_updates_per_sec']:.4e} nominal "
              f"cell-updates/s; active tiles {rec['active_tiles']}, capacity "
              f"{rec['capacity']}; {rec['dispatches_per_gen']:.4f} dispatches "
              f"and {rec['host_syncs_per_gen']:.4f} host syncs per "
              f"generation; {activity}; peak {rec['peak_card_mib']:.1f} MiB "
              f"beyond the start  [{card}]")
        del engine, state
    check(torch.equal(finals["sparse"], finals["cuda"])
          and torch.equal(finals["paged"], finals["cuda"]),
          "config #5: the sparse, paged and B1 grids differ")
    out["config5 truth"] = finals["cuda"]   # for the mesh phase
    pop = bitpack.population(finals["cuda"])
    check(pop > 36, f"config #5 population {pop}: the gun did not fire")
    print(f"config #5 results: sparse == paged == B1 on the card after {n} "
          f"generations (torch.equal), population {pop}")
    del finals, words
    torch.cuda.empty_cache()

    # -- the other families at 8192^2, and the forced overflow ------------
    side = FAMILY_SIDE
    rng = np.random.default_rng(11)
    for spec, states, topology, gens, kernel in (
            ("brain", 3, Topology.TORUS, 600, "life_generations"),
            ("bosco", 2, Topology.DEAD, 400, "life_ltl"),
            ("B3/S23", 2, Topology.TORUS, 300, "life_packed")):
        cells = np.zeros((side, side), np.uint8)
        blob = (rng.random((512, 512)) < 0.45) * rng.integers(
            1, states, (512, 512))
        c = side // 2 - 256
        cells[c:c + 512, c:c + 512] = blob
        results = {}
        for backend, opts in (("sparse", None), ("sparse", {"capacity": 8}),
                              ("cuda", None)):
            cs.reset_launch_counts()
            engine, _, wall, _ = timed_run(lambda: Engine(
                cells, spec, topology=topology, backend=backend,
                sparse_opts=opts), gens)
            counts = cs.launch_counts()
            want = {kernel: counts[kernel]} if backend == "cuda" else {}
            check(all(v == 0 for k, v in counts.items() if k not in want),
                  f"{spec} on {backend} launched {counts}")
            label = backend if opts is None else "capacity 8"
            results[label] = (engine.state.contiguous(), wall,
                              engine.active_tiles(), engine.population(),
                              getattr(engine._sparse, "capacity", None))
            del engine
        truth = results["cuda"][0]
        for label in ("sparse", "capacity 8"):
            check(torch.equal(results[label][0], truth),
                  f"{spec} {side}^2 {label} differs from {kernel}")
        check(results["capacity 8"][4] == 8, "the fixed capacity moved")
        rec = {label: {"wall": r[1], "cell_updates": side * side * gens / r[1],
                       "active_tiles": r[2], "capacity": r[4]}
               for label, r in results.items()}
        out[f"family {spec}"] = rec
        print(f"{spec} {side}x{side} {topology.value}, 512^2 blob, {gens} "
              f"generations: sparse == capacity 8 (dense fallback) == "
              f"{kernel} (torch.equal), population {results['cuda'][3]}; "
              + "; ".join(f"{label} {r['wall']:.4f} s, {r['cell_updates']:.4e} "
                          f"nominal cell-updates/s, active tiles "
                          f"{r['active_tiles']}, capacity {r['capacity']}"
                          for label, r in rec.items()) + f"  [{card}]")
        del results, truth
    torch.cuda.empty_cache()

    # -- paged serving: mostly-empty 1024^2 sessions ------------------------
    h, w = LANE_SHAPE
    spec = {"rule": "B3/S23", "height": h, "width": w, "topology": "dead"}
    reg = MetricsRegistry()
    svc = SessionService(paged=True, registry=reg,
                         paged_opts={"capacity": PAGED_POOL_TILES},
                         admission=AdmissionController(registry=reg))
    sessions = []
    for i in range(PAGED_SESSIONS):
        pattern = "glider" if i % 2 else "gosper_gun"
        top, left = 64 + (i * 37) % 768, 64 + (i * 91) % 640
        cells = seeds.seeded((h, w), pattern, top, left)
        info = svc.create(f"tenant{i % 4}", spec,
                          cells_hex=encode_words(bitpack.pack_np(cells)))
        check(info["spec"]["backend"] == "packed" and info["lane"].endswith(
            "#paged"), f"paged service placed {info}")
        sessions.append([info["sid"], cells, 0])
    tile_pool = next(iter(svc._tile_pools.values()))
    cs.reset_launch_counts()
    for k, sess in enumerate(sessions):
        sess[2] = 37 if k % 3 else 64
        svc.step(sess[0], sess[2], pump=False)
    svc.pump()
    torch.cuda.synchronize()
    d0, s0 = tile_pool.dispatches, tile_pool.syncs
    t0 = time.perf_counter()
    for sess in sessions:
        svc.step(sess[0], PAGED_GENERATIONS - 64, pump=False)
        sess[2] += PAGED_GENERATIONS - 64
    svc.pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cs.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"paged serving launched {counts}")
    chunks = tile_pool.dispatches - d0
    pool_bytes = tile_pool.in_use() * tile_pool.tile_bytes()
    # a full 256-slot ladder lane of these sessions: (256, H, W/32) words
    ladder_bytes = PAGED_SESSIONS * h * (w // bitpack.WORD) * 4
    rate = h * w * PAGED_SESSIONS * (PAGED_GENERATIONS - 64) / wall
    print(f"paged serving: {PAGED_SESSIONS} sessions of {h}x{w} B3/S23 DEAD "
          f"({PAGED_SESSIONS // 2} gliders, {PAGED_SESSIONS // 2} Gosper guns) "
          f"on one tile pool of {tile_pool.capacity} {tile_pool.tile_rows}x"
          f"{tile_pool.tile_words}-word tiles; cursors 37/64, then "
          f"{PAGED_GENERATIONS - 64} more each: {wall:.4f} s host clock incl. "
          f"sync, {rate:.4e} nominal cell-updates/s, {chunks} pool dispatches "
          f"({tile_pool.syncs - s0} flag readbacks); pool holds "
          f"{tile_pool.in_use()} tiles = {pool_bytes / 2 ** 20:.3f} MiB "
          f"against {ladder_bytes / 2 ** 20:.1f} MiB of words in a ladder "
          f"lane of the same sessions; no kernel launched  [{card}]")
    lane = next(iter(next(iter(svc.pools.values())).lanes.values()))
    for sid, cells, gens in sessions:
        info = svc.info(sid)
        check(info["generation"] == gens and info["pending_steps"] == 0,
              f"{sid}: {info}")
        engine = Engine(cells, "B3/S23", topology=Topology.DEAD,
                        backend="cuda")
        engine.step(gens)
        check(torch.equal(lane.grids[info["slot"]].to_tensor()[0],
                          engine.state),
              f"paged session {sid} differs from its dedicated Engine run")
    print(f"paged serving results: all {PAGED_SESSIONS} sessions == their "
          "dedicated Engine(backend='cuda') runs")
    # a paged1 save and load of one grid (a gun's), continued 64 more
    sid, cells, gens = sessions[0]
    grid = lane.grids[svc.info(sid)["slot"]]
    work = tempfile.mkdtemp(prefix="chip_smoke_paged_")
    t0 = time.perf_counter()
    path = ckpt.save_paged(grid, os.path.join(work, "gun.npz"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, meta = ckpt.load_paged(path)
    load_s = time.perf_counter() - t0
    check(loaded.pages.keys() == grid.pages.keys()
          and torch.equal(loaded.to_tensor(), grid.to_tensor())
          and meta["generation"] == gens, "paged1 round trip differs")
    step_grids(loaded.pool, [loaded], 64)
    engine = Engine(cells, "B3/S23", topology=Topology.DEAD, backend="cuda")
    engine.step(gens + 64)
    check(torch.equal(loaded.to_tensor()[0], engine.state),
          "the reloaded paged grid's continuation differs")
    print(f"paged1: one gun's {len(grid.pages)} pages saved in {save_s:.4f} "
          f"s ({os.path.getsize(path)} bytes), loaded onto the card in "
          f"{load_s:.4f} s, continued 64 generations == its Engine run  "
          f"[{card}]")
    shutil.rmtree(work)
    out["paged serving"] = {"rate": rate, "wall": wall, "chunks": chunks,
                            "pool_mib": pool_bytes / 2 ** 20,
                            "ladder_mib": ladder_bytes / 2 ** 20,
                            "save_s": save_s, "load_s": load_s}
    return out


def mesh_paths_phase(cs, card: str, dev, config5_truth) -> dict:
    """Phase 3 for the rest of the single-host mesh, on meshes of this one
    card: the ghost-zone pipeline (through ``Engine(mesh=...,
    backend="packed", gens_per_exchange=8)``) and the deep runner on a (2,
    2) mesh against B1; the sharded sparse engine on config #5 against
    the tiled phase's B1 grid (``config5_truth``) and on the 8192^2 brain
    and bosco blobs against B3 and B4; the batch mesh, which launches B2's
    slab form once per chunk, against the lane form. Each path is driven with
    the launch counts set to 0 just before and read just after; the
    plain-torch paths launch no kernel. Returns the records."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.bench import config5
    from gameoflifewithactors_torch import engine as engine_lib
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.obs.registry import REGISTRY
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel import batched, halo, sharded
    from gameoflifewithactors_torch.parallel.mesh import (
        device_put_sharded_grid, make_mesh)

    mesh = make_mesh((2, 2), [dev] * 4)
    out = {}

    def plain_only(counts, what):
        check(all(v == 0 for v in counts.values()),
              f"{what} launched a kernel: {counts}")

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # -- ghost and deep, B3/S23 ---------------------------------------------
    g = GHOST_G
    for side, topo, n in GHOST_RUNS:
        topology = Topology(topo)
        gen = torch.Generator(device=dev)
        gen.manual_seed(side)
        cells = (torch.rand((side, side), generator=gen, device=dev)
                 < 0.5).to(torch.uint8)
        cs.reset_launch_counts()
        truth_engine = Engine(cells, CONWAY, topology=topology,
                              backend="cuda", device=dev)
        truth_engine.step(n)
        check(cs.launch_counts()["life_packed"] > 0, "the B1 reference launched "
              "no kernel")
        truth = truth_engine.state.contiguous()
        del truth_engine
        # the ghost pipeline through the engine
        exchanges0 = REGISTRY.counter("halo_exchanges_total").value()
        bytes0 = REGISTRY.counter("halo_bytes_total").value()
        moved0 = halo.exchanged_bytes()
        engine = Engine(cells, CONWAY, topology=topology, backend="packed",
                        mesh=mesh, gens_per_exchange=g)
        check(engine._ghost_pipeline, f"{side}^2 on (2, 2) did not take the "
              "ghost pipeline")
        cs.reset_launch_counts()
        _, wall = synced(lambda: engine.step(n))
        plain_only(cs.launch_counts(), "the ghost pipeline")
        check(torch.equal(engine.state, truth),
              f"ghost {side}^2 {topo} differs from B1")
        exchanges = REGISTRY.counter("halo_exchanges_total").value() - exchanges0
        counted = REGISTRY.counter("halo_bytes_total").value() - bytes0
        moved = halo.exchanged_bytes() - moved0
        shape = (side, side // bitpack.WORD)
        per_exchange = sharded.ghost_exchange_bytes(shape, mesh, topology, g)
        model = engine.halo_bytes_per_gen("model")
        measured = engine.halo_bytes_per_gen("measured")
        check(exchanges == n // g and counted == exchanges * per_exchange,
              f"ghost registry: {exchanges} exchanges, {counted} bytes")
        check(model == measured, f"halo_bytes_per_gen model {model} != "
              f"measured {measured}")
        rec = {"ms_per_gen": 1e3 * wall / n, "exchanges": exchanges,
               "halo_bytes_total": counted, "exchange_bytes": per_exchange,
               "moved": moved, "model": model, "measured": measured}
        out[f"ghost {side} {topo}"] = rec
        print(f"ghost pipeline (2, 2) mesh of cuda:0, {side}x{side} B3/S23 "
              f"{topo}, G {g}, {n} generations: == B1 (torch.equal); "
              f"{rec['ms_per_gen']:.5f} ms per generation (host clock incl. "
              f"sync); {exchanges:.0f} exchanges, halo_bytes_total "
              f"{counted:.0f} == {exchanges:.0f} x ghost_exchange_bytes "
              f"{per_exchange}; strips counted by the exchange {moved} "
              f"(remainder generations included); halo_bytes_per_gen model "
              f"{model} == measured {measured}  [{card}]")
        del engine
        # the deep runner, chunked as the engine chunks
        deep = sharded.make_multi_step_packed_deep(mesh, CONWAY, topology, g)
        run = engine_lib._chunked(
            deep, sharded.make_multi_step_packed(mesh, CONWAY, topology), g)
        state = device_put_sharded_grid(bitpack.pack(cells), mesh)
        moved0 = halo.exchanged_bytes()
        cs.reset_launch_counts()
        state, wall = synced(lambda: run(state, n))
        plain_only(cs.launch_counts(), "the deep runner")
        moved = halo.exchanged_bytes() - moved0
        check(torch.equal(state.gather(), truth),
              f"deep {side}^2 {topo} differs from B1")
        per_chunk = sharded.deep_exchange_bytes(shape, mesh, topology, g)
        one = device_put_sharded_grid(bitpack.pack(cells), mesh)
        moved1 = halo.exchanged_bytes()
        deep(one, 1)
        measured = -(-(halo.exchanged_bytes() - moved1) // g)
        check(measured == -(-per_chunk // g), f"deep bytes measured "
              f"{measured} != model {-(-per_chunk // g)} per generation")
        rec = {"ms_per_gen": 1e3 * wall / n, "exchanges": n // g + n % g,
               "exchange_bytes": per_chunk, "moved": moved,
               "measured": measured}
        out[f"deep {side} {topo}"] = rec
        print(f"deep runner (2, 2) mesh of cuda:0, {side}x{side} B3/S23 "
              f"{topo}, G {g}, {n} generations: == B1 (torch.equal); "
              f"{rec['ms_per_gen']:.5f} ms per generation; {n // g} chunk "
              f"exchanges of deep_exchange_bytes {per_chunk} and {n % g} "
              f"per-generation ones, {moved} bytes counted; per generation "
              f"measured {measured} == model  [{card}]")
        del state, one, truth, cells
        torch.cuda.empty_cache()

    # -- sharded sparse: config #5, then the brain and bosco blobs ----------
    side, n = CONFIG5_SIDE, CONFIG5_GENERATIONS
    words = config5.seed_words(side)
    cs.reset_launch_counts()
    engine, build_s, wall, peak = timed_run(lambda: Engine.from_packed(
        words, "B3/S23", topology=Topology.TORUS, backend="sparse",
        mesh=mesh), n)
    plain_only(cs.launch_counts(), "config #5 on the mesh")
    stats = engine._runner.stats
    check(torch.equal(engine.state, config5_truth),
          "config #5 on the (2, 2) mesh differs from the sparse and B1 runs")
    rec = {"gens_per_s": n / wall, "ms_per_gen": 1e3 * wall / n,
           "syncs_per_gen": stats["syncs"] / n,
           "active_tiles": engine.active_tiles(),
           "capacity": stats["capacity"], "tiles": engine._sparse_tiles,
           "peak_mib": peak / 2 ** 20, "build_s": build_s,
           "halo_model": engine.halo_bytes_per_gen("model"),
           "halo_measured": engine.halo_bytes_per_gen("measured")}
    check(rec["halo_model"] == rec["halo_measured"],
          f"config #5 halo bytes model {rec['halo_model']} != measured "
          f"{rec['halo_measured']}")
    out["config5 mesh"] = rec
    print(f"config #5 ({side}x{side} Gosper gun, TORUS, {n} generations) on "
          f"the sharded sparse engine, (2, 2) mesh of cuda:0, tiles "
          f"{rec['tiles']} per shard: == B1 and the one-device sparse engine "
          f"(torch.equal); built in {build_s:.4f} s, {rec['ms_per_gen']:.5f} "
          f"ms per generation, {rec['gens_per_s']:.2f} gens/s (host clock "
          f"incl. sync); {rec['syncs_per_gen']:.4f} host syncs per "
          f"generation; active tiles {rec['active_tiles']}, capacity "
          f"{rec['capacity']} per shard; peak {rec['peak_mib']:.1f} MiB "
          f"beyond the start; halo bytes per generation model "
          f"{rec['halo_model']} == measured  [{card}]")
    del engine, words, config5_truth
    torch.cuda.empty_cache()
    rng = np.random.default_rng(11)
    side, n = FAMILY_SIDE, MESH_FAMILY_GENERATIONS
    for spec, states, topology, kernel in (
            ("brain", 3, Topology.TORUS, "life_generations"),
            ("bosco", 2, Topology.DEAD, "life_ltl")):
        cells = np.zeros((side, side), np.uint8)
        blob = (rng.random((512, 512)) < 0.45) * rng.integers(
            1, states, (512, 512))
        c = side // 2 - 256
        cells[c:c + 512, c:c + 512] = blob
        cs.reset_launch_counts()
        truth = Engine(cells, spec, topology=topology, backend="cuda",
                       device=dev)
        truth.step(n)
        check(cs.launch_counts()[kernel] > 0, f"{spec} reference launched no "
              f"{kernel}")
        cs.reset_launch_counts()
        engine, _, wall, peak = timed_run(lambda: Engine(
            cells, spec, topology=topology, backend="sparse", mesh=mesh), n)
        plain_only(cs.launch_counts(), f"{spec} on the mesh")
        check(torch.equal(engine.state, truth.state),
              f"{spec} {side}^2 on the (2, 2) mesh differs from {kernel}")
        stats = engine._runner.stats
        rec = {"gens_per_s": n / wall, "syncs_per_gen": stats["syncs"] / n,
               "active_tiles": engine.active_tiles(),
               "capacity": stats["capacity"], "peak_mib": peak / 2 ** 20}
        out[f"family {spec} mesh"] = rec
        print(f"{spec} {side}x{side} {topology.value}, 512^2 blob, {n} "
              f"generations on the sharded sparse engine, (2, 2) mesh of "
              f"cuda:0: == {kernel} (torch.equal); {rec['gens_per_s']:.2f} "
              f"gens/s, {rec['syncs_per_gen']:.4f} host syncs per "
              f"generation, active tiles {rec['active_tiles']}, capacity "
              f"{rec['capacity']} per shard, peak {rec['peak_mib']:.1f} MiB "
              f"beyond the start  [{card}]")
        del engine, truth
    torch.cuda.empty_cache()

    # -- the batch mesh: B2's slab form per device and chunk ---------------
    bmesh = batched.make_batch_mesh(BATCH_MESH, [dev] * 4)
    h, w = LANE_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(64)
    grids = bitpack.pack((torch.rand((BATCH_UNIVERSES * h, w), generator=gen,
                                     device=dev) < 0.35).to(torch.uint8)
                         ).view(BATCH_UNIVERSES, h, w // bitpack.WORD)
    mask = torch.ones(BATCH_UNIVERSES, dtype=torch.int32, device=dev)
    mask[::4] = 0
    g = cs.DEFAULT_BAND_GENS_PER_CALL
    chunks = BATCH_GENERATIONS // g
    # B2's two forms share one launch count, so the run also counts each
    # form's launch function on its own, and keeps the first slab-form
    # call's input, edge codes and result to hold against the plain version
    launch_slab, launch_lane = cs._launch_slab, cs._launch_lane
    slab_entry = cs.slab_step_kernel
    seen, first = {}, []

    def counted_slab(*args, **kwargs):
        seen["slab"] += 1
        return launch_slab(*args, **kwargs)

    def counted_lane(*args, **kwargs):
        seen["lane"] += 1
        return launch_lane(*args, **kwargs)

    def kept_slab(ext, gens, **kwargs):
        result = slab_entry(ext, gens, **kwargs)
        if not first:
            first.append((ext.clone(), gens, kwargs, result.clone()))
        return result

    worst = 0
    for topology in (Topology.TORUS, Topology.DEAD):
        run = batched.make_multi_step_kernel_batched_mesh(
            bmesh, CONWAY, topology, gens_per_exchange=g, masked=True)
        placed = batched.device_put(grids, batched.batch_sharding(bmesh))
        seen.update(slab=0, lane=0)
        first.clear()
        cs._launch_slab, cs._launch_lane = counted_slab, counted_lane
        cs.slab_step_kernel = kept_slab
        try:
            cs.reset_launch_counts()
            got, wall = synced(lambda: run(placed, chunks, mask))
            counts = cs.launch_counts()
        finally:
            cs._launch_slab, cs._launch_lane = launch_slab, launch_lane
            cs.slab_step_kernel = slab_entry
        check(counts["life_slab"] == chunks * len(bmesh.groups)
              and all(v == 0 for k, v in counts.items() if k != "life_slab"),
              f"batch mesh launched {counts}, expected {chunks} slab "
              "launches")
        check(seen == {"slab": chunks * len(bmesh.groups), "lane": 0},
              f"batch mesh launched the forms {seen}, expected only "
              f"{chunks * len(bmesh.groups)} of the slab form")
        # the first chunk's launch against the plain slab form on its own
        # input: the runner's row exchange of the placed batch, with the
        # per-band codes of band_edge_codes(repeat=universes per position)
        ext, gens, kwargs, result = first[0]
        shape, code = tuple(ext.shape), kwargs["edge_code"]
        if topology is Topology.DEAD:
            bl = BATCH_UNIVERSES // BATCH_MESH[0]
            check(torch.equal(code, halo.band_edge_codes(bmesh, repeat=bl)[0]),
                  "the batch mesh's edge codes are not band_edge_codes'")
        want = cs.slab_step_reference(ext, gens, **kwargs)
        err = max_abs_err(result, want)
        check(err == 0, f"batch mesh slab launch at {shape} "
                        f"{topology.value} != slab_step_reference ({err})")
        worst = max(worst, err)
        del first[:], ext, result, want, code
        cs.reset_launch_counts()
        lane, lane_wall = synced(lambda: batched.multi_step_kernel_batched(
            grids, BATCH_GENERATIONS, mask, rule=CONWAY, topology=topology))
        lane_launches = cs.launch_counts()["life_slab"]
        check(torch.equal(got.gather(), lane),
              f"batch mesh {topology.value} differs from the lane form")
        check(torch.equal(lane[::4], grids[::4]),
              "frozen universes moved")
        rec = {"launches": seen["slab"], "ms_per_chunk":
               1e3 * wall / chunks, "lane_ms_per_chunk":
               1e3 * lane_wall / chunks, "lane_launches": lane_launches,
               "max_abs_err": err}
        out[f"batch mesh {topology.value}"] = rec
        print(f"batch mesh {BATCH_MESH} of cuda:0, {BATCH_UNIVERSES} x "
              f"{h}x{w} B3/S23 {topology.value}, a quarter masked, "
              f"{BATCH_GENERATIONS} generations: == the lane form "
              f"(torch.equal); {seen['slab']} B2 slab-form launches (one per "
              f"device and chunk) and {seen['lane']} of the lane form; the "
              f"first chunk's launch on {shape} "
              f"== slab_step_reference, max_abs_err {err}; "
              f"{rec['ms_per_chunk']:.5f} ms per "
              f"chunk of {g} (exchange, launch, crop, select; host clock "
              f"incl. sync) against the lane form's "
              f"{rec['lane_ms_per_chunk']:.5f} ms ({lane_launches} "
              f"launches)  [{card}]")
        del got, lane, placed
    return out


OBSERVE_GENERATIONS = 2000      # each observed main path: one tick
OBSERVE_CHECKPOINT_EVERY = 1000  # the supervised run: two chunks
OBSERVE_PATHS = [  # (kernel, --rule, the kernel function's name in a trace)
    ("life_packed", "B3/S23", "life_packed_kernel"),
    ("life_generations", "brain", "life_generations_kernel"),
    ("life_ltl", "bosco", "ltl_kernel")]
STALL_SHAPE = (4096, 4096)
STALL_DEADLINE = 0.5            # seconds; the induced stall sleeps 1.0


def observe_phase(cs, card: str, main_rates: dict) -> dict:
    """Phase 3 for the observed and supervised run: (a) the CLI with
    ``--telemetry-out`` and ``--profile-sample`` on the three 16384²
    main paths (the report's roofline shares, the profiler's device-track
    attribution, its top kernel, the duty cycle and idle gaps, the compile
    events; each path's launches counted from 0); (b) ``--supervise`` at
    16384² B3/S23 (its configuration through ``SimulationConfig``, the
    CLI's construction path) with one ``FaultPlan`` corrupt_region after
    generation 1000, against an unsupervised run of the same seed bit for
    bit, with the seconds of saves, restores and stepping; (c) an induced
    stall past the watchdog's deadline at 4096²: one StallEvent, one
    restart, a flight dump on disk. Returns the records."""
    import dataclasses

    import torch

    from gameoflifewithactors_torch.bench import roofline_report
    from gameoflifewithactors_torch.cli import main as cli_main
    from gameoflifewithactors_torch.config import from_args
    from gameoflifewithactors_torch.obs import flight, spans, watchdog
    from gameoflifewithactors_torch.obs.report import RunReport
    from gameoflifewithactors_torch.resilience import (
        FaultEvent, FaultPlan, RestartPolicy, Supervisor, apply_fault)
    from gameoflifewithactors_torch.utils.metrics import (BufferSink,
                                                         MetricsLogger)

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    side = f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}"
    out = {}
    # (a) telemetry on the three main paths, through the CLI in-process
    for kernel, spec, marker in OBSERVE_PATHS:
        path = os.path.join(work, f"{kernel}.json")
        cs.reset_launch_counts()
        rc = cli_main(["--device", "cuda", "--rule", spec, "--grid", side,
                       "--seed", "random", "--rng-seed", "1", "--steps",
                       str(OBSERVE_GENERATIONS), "--telemetry-out", path,
                       "--profile-sample", "5"])
        counts = cs.launch_counts()
        check(rc == 0, f"observed {spec} run exited {rc}")
        check(counts[kernel] > 0 and all(
            v == 0 for k, v in counts.items() if k != kernel),
              f"observed {spec} run launched {counts}")
        rep = RunReport.load(path)
        roof = rep.roofline or {}
        frac = roof.get("achieved_fraction") or {}
        check(set(frac) == {"of_hbm_bandwidth", "of_int_op_peak"}
              and all(0 < v <= 1.05 for v in frac.values()),
              f"{spec} roofline shares {frac}")
        prof = rep.profile or {}
        check(prof.get("source") == "device_tracks",
              f"{spec} attribution came from {prof.get('source')!r}, not "
              "the device tracks")
        shares = prof.get("op_class_fraction") or {}
        check(shares and all(0 <= v <= 1.05 for v in shares.values()),
              f"{spec} op-class shares {shares}")
        top = (prof.get("top_kernels") or [["", 0]])[0][0]
        check(marker in top, f"{spec} top kernel {top!r} is not {marker}")
        duty = prof.get("device_duty_cycle")
        check(duty is not None and 0 < duty <= 1.0, f"{spec} duty {duty}")
        gaps = prof.get("idle_gaps_us") or []
        step = rep.step_metrics[0]
        rate = step["cell_updates_per_sec"]
        kinds = {}
        for ev in rep.compile_events:
            kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        ratio = rate / main_rates[spec]
        print(f"observed {spec} {side} (CLI --telemetry-out --profile-sample "
              f"5, {OBSERVE_GENERATIONS} generations in one tick, "
              f"{counts[kernel]} {kernel} launches): roofline "
              f"{frac['of_int_op_peak']:.4f} of the integer-op peak "
              f"({roof['peak_modelled']['int_ops_per_sec']:.4e} ops/s), "
              f"{frac['of_hbm_bandwidth']:.4f} of HBM "
              f"({roof['peak_modelled']['hbm_gbps']:.1f} GB/s from the "
              f"device); stencil {shares.get('stencil', 0):.4f} of device "
              f"time ({prof['windows']} window(s)), top kernel {top}; "
              f"device busy {duty:.4f} of its span, longest idle gaps "
              f"{gaps[:3]} us; {rate:.4e} cell-updates/s, "
              f"{ratio:.4f} of phase 3's untraced tick; compile events "
              f"{kinds or 'none'} ({rep.compile_seconds_total:.3f} s)  "
              f"[{card}]")
        out[spec] = {"int_share": frac["of_int_op_peak"],
                     "hbm_share": frac["of_hbm_bandwidth"],
                     "stencil": shares.get("stencil", 0), "duty": duty,
                     "gaps": gaps, "rate": rate, "ratio": ratio}
        # the bench's roofline report over the same report: a device track
        check(roofline_report.main([path, "--check"]) == 0,
              f"roofline_report --check found no device track in the "
              f"observed {spec} report")
        with open(path) as f:
            section = roofline_report.render_roofline(json.load(f), path)
        print(f"roofline_report --check over the observed {spec} report: "
              f"exit 0; its section:\n{section.rstrip()}")
    # what the session costs a tick: one B3/S23 coordinator, 2000-generation
    # ticks with a plain metrics logger (each syncs), under a RunTelemetry
    # session without the profiler (spans, watchdog, flight tape) and
    # with a profiler window open, in turns, four of each
    from gameoflifewithactors_torch import GridCoordinator
    from gameoflifewithactors_torch.obs.report import begin_run_telemetry

    coord = GridCoordinator(MAIN_SHAPE, "B3/S23", random_fill=0.5,
                            rng_seed=1, device="cuda")
    coord.run(OBSERVE_GENERATIONS)
    walls = {"plain": [], "session": [], "profiled": []}
    for kind in ["plain", "session", "profiled", "profiled", "session",
                 "plain"] * 2:
        if kind == "plain":
            sink = BufferSink()
            coord.metrics = MetricsLogger(sink)
            coord.tick(OBSERVE_GENERATIONS)
            walls[kind].append(sink.records[-1].wall_seconds)
        else:
            coord.metrics = None
            telem = begin_run_telemetry(
                stall_deadline=60.0,
                profile_sample=5.0 if kind == "profiled" else None,
                flight_path=os.path.join(work, "overhead.flight.jsonl"))
            telem.attach(coord)
            coord.tick(OBSERVE_GENERATIONS)
            rep = telem.finish(engine=coord.engine)
            walls[kind].append(rep.step_metrics[-1]["wall_seconds"])
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"telemetry on a {side} B3/S23 tick of {OBSERVE_GENERATIONS} "
          f"generations, 4 ticks of each in turns: plain "
          f"{walls['plain']} s; RunTelemetry without the profiler "
          f"{walls['session']} s; with a profiler window open "
          f"{walls['profiled']} s; medians {med['plain']:.5f} / "
          f"{med['session']:.5f} ({med['session'] / med['plain'] - 1:+.2%})"
          f" / {med['profiled']:.5f} s "
          f"({med['profiled'] / med['plain'] - 1:+.2%})  [{card}]")
    plain_s, telem_s = med["plain"], med["profiled"]
    out["telemetry_overhead"] = telem_s / plain_s - 1
    del coord
    t_a = time.perf_counter() - t_phase

    # (b) supervision at full width: one corrupt_region after gen 1000
    ck = os.path.join(work, "supervised.npz")
    argv = ["--device", "cuda", "--grid", side, "--seed", "random",
            "--rng-seed", "1", "--steps", str(OBSERVE_GENERATIONS)]
    cfg, _ = from_args(argv + ["--supervise", "--checkpoint", ck,
                               "--checkpoint-every",
                               str(OBSERVE_CHECKPOINT_EVERY)])
    coord, _ = cfg.build()
    sink = BufferSink()
    coord.metrics = MetricsLogger(sink)   # each chunk syncs: honest seconds
    drawn = FaultPlan.generate(11, workers=1, horizon=OBSERVE_GENERATIONS,
                               faults_per_worker=0,
                               ensure_kinds=["corrupt_region"]).events[0]
    event = dataclasses.replace(drawn, at_gen=OBSERVE_CHECKPOINT_EVERY)
    sup = Supervisor(coord, checkpoint_path=cfg.checkpoint,
                     checkpoint_every=cfg.checkpoint_every,
                     policy=RestartPolicy(max_restarts=cfg.max_restarts))
    fired = []

    def before_chunk(gen):
        if gen >= event.at_gen and not fired:
            fired.append(apply_fault(sup, event))

    sup.before_chunk = before_chunk
    spans.TRACER.clear()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    stats = sup.run(cfg.steps)
    wall = time.perf_counter() - t0
    counts = cs.launch_counts()
    phases = spans.TRACER.phase_seconds()
    check(fired == ["corrupt_region"] and stats["restarts"] == 1
          and stats["restarts_by_cause"] == {"fault:corrupt_region": 1},
          f"supervised run stats {stats}")
    check(counts["life_packed"] > 0, f"supervised run launched {counts}")
    plain, _ = from_args(argv)[0].build()
    plain.run(OBSERVE_GENERATIONS)
    check(torch.equal(coord.engine.state, plain.engine.state),
          "the supervised run's grid differs from the unsupervised run's")
    saves = phases.get("supervisor.checkpoint", {})
    restores = phases.get("supervisor.restart", {})
    stepping = sum(m.wall_seconds for m in sink.records)
    print(f"supervised {side} B3/S23 TORUS, {OBSERVE_GENERATIONS} "
          f"generations, --checkpoint-every {OBSERVE_CHECKPOINT_EVERY}, "
          f"FaultPlan corrupt_region {event.params} after generation "
          f"{event.at_gen}: restarts {stats['restarts']} "
          f"{stats['restarts_by_cause']}, grid == the unsupervised run's; "
          f"{wall:.4f} s: saves {saves.get('total_s', 0):.4f} s "
          f"(x{saves.get('count', 0)}), restores "
          f"{restores.get('total_s', 0):.4f} s (x{restores.get('count', 0)}),"
          f" stepping {stepping:.4f} s ({len(sink.records)} ticks, "
          f"{counts['life_packed']} B1 launches)  [{card}]")
    out["supervised"] = {"wall": wall, "saves": saves.get("total_s", 0),
                         "n_saves": saves.get("count", 0),
                         "restores": restores.get("total_s", 0),
                         "stepping": stepping}
    del coord, plain
    t_b = time.perf_counter() - t_phase - t_a

    # (c) a stall past the watchdog's deadline at 4096^2
    dump = os.path.join(work, "stall.flight.jsonl")
    wd = watchdog.arm(watchdog.StallWatchdog(STALL_DEADLINE))
    fr = flight.FlightRecorder(dump)
    fr.install(watchdog=wd)
    flight.arm(fr)
    try:
        cfg, _ = from_args(["--device", "cuda", "--grid",
                            f"{STALL_SHAPE[0]}x{STALL_SHAPE[1]}", "--seed",
                            "random", "--steps", "300", "--supervise",
                            "--checkpoint", os.path.join(work, "stall.npz"),
                            "--checkpoint-every", "100"])
        coord, _ = cfg.build()
        coord.metrics = MetricsLogger(BufferSink())
        sup = Supervisor(coord, checkpoint_path=cfg.checkpoint,
                         checkpoint_every=cfg.checkpoint_every)
        stall = FaultEvent(worker=0, at_gen=100, kind="stall")
        sup.before_chunk = lambda gen: (
            apply_fault(sup, stall, stall_seconds=2 * STALL_DEADLINE)
            if gen == stall.at_gen and not sup.stats()["restarts"] else None)
        stats = sup.run(cfg.steps)
        check(len(wd.events) == 1 and stats["restarts"] == 1
              and stats["restarts_by_cause"] == {"fault:stall": 1},
              f"stall run: {len(wd.events)} stall events, stats {stats}")
        check(os.path.exists(dump), f"no stall flight dump at {dump}")
        header = flight.load_dump(dump)["flight"]
        check("stall" in header["reason"], f"flight dump header {header}")
        ev = wd.events[0]
        print(f"stall {STALL_SHAPE[0]}^2: one StallEvent ({ev.label}, "
              f"{ev.elapsed_seconds:.3f} s past a {ev.deadline_seconds} s "
              f"deadline, last span {ev.last_completed_span}), one restart "
              f"{stats['restarts_by_cause']}, flight dump "
              f"{os.path.getsize(dump)} bytes ({header['reason']!r})  "
              f"[{card}]")
    finally:
        flight.disarm()
        watchdog.disarm()
    shutil.rmtree(work)
    total = time.perf_counter() - t_phase
    print(f"observed and supervised run phase: {total:.1f} s (telemetry "
          f"{t_a:.1f}, supervision {t_b:.1f}, stall "
          f"{total - t_a - t_b:.1f})  [{card}]")
    out["seconds"] = total
    return out


WARM_MANIFEST = [  # four single-device 16384^2 TORUS specs, a lane ladder
    {"rule": "B3/S23", "shape": list(MAIN_SHAPE)},
    {"rule": "brain", "shape": list(MAIN_SHAPE)},
    {"rule": "bosco", "shape": list(MAIN_SHAPE)},
    {"rule": "B3/S23", "shape": list(MAIN_SHAPE), "backend": "packed"},
    {"rule": "B3/S23", "shape": list(LANE_SHAPE), "lanes": [1, 8, 64, 256]},
]
WARM_KERNELS = ["B1", "B3", "B4", None, "B2 lane"]   # what each entry builds
WARM_CLI_GENERATIONS = 2000     # the first (and only) tick of the timed run
GRAPH_GENERATIONS = 200         # the registry-served engine against B1
WARM_SESSIONS = 73              # grows the lane through 1, 8, 64 and 256


def warmstart_phase(cs, card: str, repo: str) -> dict:
    """Phase 3 for warm start, on cache roots of its own (never the
    default one): (1) ``warmup --manifest`` on an empty root D1 in a
    subprocess (B1, B3, B4 and B2's lane form built, each a
    ``cache_miss`` with nvcc seconds; the ``packed`` spec's record
    written, the ``cuda`` specs out of the registry's scope); (2) the CLI
    at 16384² B3/S23 from spawn to the end of its first 2000-generation
    tick, on an empty root (nvcc builds B1) and on D1 (no build);
    (3) in-process, ``Engine(backend="packed")`` on D1 served by the
    registry (CUDA graphs of the plain loop): 200 generations equal to
    the eager plain runner and to B1, no kernel launched, a handed-out
    state kept, ms per generation against the eager runner at 16384² and
    1024²; (4) ``serve --manifest`` on D1: the lane ladder warmed before
    the port opens, sessions grown through every rung and stepped, no
    build after.
    Returns the records."""
    import signal
    import urllib.request
    import warnings

    import torch

    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.aot import cache as aot_cache
    from gameoflifewithactors_torch.aot import registry as aot_registry
    from gameoflifewithactors_torch.bench import warm_vs_cold
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops.packed import multi_step_packed

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    warm_root = os.path.join(work, "D1")
    manifest = os.path.join(work, "manifest.json")
    with open(manifest, "w") as f:
        json.dump(WARM_MANIFEST, f)
    side = f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}"
    out = {}

    # (1) the cold warmup
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gameoflifewithactors_torch", "warmup",
         "--manifest", manifest, "--cache-dir", warm_root, "--json"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"warmup exited {proc.returncode}: {proc.stderr}")
    rows = json.loads(proc.stdout.splitlines()[-1])["specs"]
    check(len(rows) == len(WARM_MANIFEST), f"warmup rows {rows}")
    for entry, kernel, row in zip(WARM_MANIFEST, WARM_KERNELS, rows):
        label = (f"{entry['rule']} {entry['shape'][0]}x{entry['shape'][1]} "
                 f"{entry.get('backend', 'auto')}")
        if kernel is None:
            check(row["resolved_backend"] == "packed"
                  and row["aot"] == "serialized", f"warmup {label}: {row}")
        else:
            check(row["resolved_backend"] == "cuda"
                  and row["events"].get("cache_miss", 0) >= 1
                  and row["compile_seconds"] > 0
                  and row["aot"].startswith("unsupported: "),
                  f"warmup {label}: {row}")
        lanes = row.get("lanes")
        if lanes:
            check(lanes["status"].startswith("warmed the lane kernel"),
                  f"warmup {label} lanes: {lanes}")
        print(f"warmup on an empty root, {label}"
              + (f" lanes {lanes['capacities']}" if lanes else "")
              + f": builds {kernel or 'nothing'}, {row['wall_seconds']:.4f} s "
              f"wall, {row['compile_seconds']:.4f} s nvcc, events "
              f"{row['events'] or '{}'}, aot {row['aot'].split(':')[0]}  "
              f"[{card}]")
    out["warmup"] = {"wall": wall, "rows": rows}
    print(f"warmup process (spawn to exit, {len(rows)} specs): {wall:.4f} s  "
          f"[{card}]")

    # (2) time to first step through the CLI, once cold and once warm (the
    # bench's warm_vs_cold.first_step; its own tool repeats them in turns)
    def first_step(root: str, label: str):
        try:
            return warm_vs_cold.first_step(
                ["--grid", side, "--seed", "random", "--rng-seed", "1",
                 "--steps", str(WARM_CLI_GENERATIONS), "--render-every",
                 str(WARM_CLI_GENERATIONS)], root,
                os.path.join(work, f"{label}.json"), cwd=repo)
        except RuntimeError as exc:
            check(False, str(exc))

    runs = []
    for label, root in [("cold", os.path.join(work, "D2")), ("warm", warm_root)]:
        first, kinds, nvcc = first_step(root, f"{label}{len(runs)}")
        if label == "warm":
            check(kinds.get("cache_miss", 0) == 0 and nvcc == 0,
                  f"warm CLI run built: {kinds}, {nvcc} s")
        else:
            check(kinds.get("cache_miss", 0) >= 1 and nvcc > 0,
                  f"cold CLI run did not build: {kinds}, {nvcc} s")
        runs.append((label, first, kinds, nvcc))
        print(f"time to first step, CLI {side} B3/S23 50% soup TORUS, one "
              f"{WARM_CLI_GENERATIONS}-generation tick, {label} root: "
              f"{first:.4f} s from spawn (compile events {kinds}, "
              f"{nvcc:.4f} s nvcc)  [{card}]")
    for label in ("cold", "warm"):
        out[label] = [first for lab, first, _, _ in runs if lab == label]

    # (3) the registry-served engine, in this process, on D1
    home = aot_cache.resolve_cache_root()
    aot_cache.ensure_persistent_cache(warm_root)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    start = bitpack.pack(seeds.bernoulli(gen, MAIN_SHAPE, 0.5))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        engine = Engine.from_packed(start, "B3/S23", backend="packed")
    check(engine.aot_loaded, "the packed 16384^2 engine was not served from "
                             "the registry warmup wrote")
    cs.reset_launch_counts()
    engine.step(GRAPH_GENERATIONS)
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    check(not any(counts.values()),
          f"the registry-served engine launched {counts}")
    eager = multi_step_packed(start, GRAPH_GENERATIONS, rule=CONWAY)
    b1 = cs.multi_step_kernel(start, GRAPH_GENERATIONS, rule=CONWAY)
    errs = (max_abs_err(engine.state, eager), max_abs_err(engine.state, b1))
    check(errs == (0, 0), f"registry-served engine differs: max_abs_err "
                          f"{errs} against the eager runner and B1")
    held = engine.state
    copy = held.clone()
    engine.step(37)
    torch.cuda.synchronize()
    check(torch.equal(held, copy), "a later step overwrote a handed-out state")
    print(f"registry-served Engine(backend='packed') {side} B3/S23 on the "
          f"warmed root: aot_loaded, {GRAPH_GENERATIONS} generations through "
          f"CUDA graphs == the eager plain runner and B1 (max_abs_err "
          f"{errs[0]}, {errs[1]}), kernel launches {counts}, a handed-out "
          f"state kept  [{card}]")
    del engine, eager, b1, held, copy
    out["graph"] = {}
    for shape in (MAIN_SHAPE, LANE_SHAPE):
        p = bitpack.pack(seeds.bernoulli(gen, shape, 0.5))
        warm = Engine.from_packed(p, "B3/S23", backend="packed")
        if not warm.aot_loaded:   # the manifest holds no 1024^2 packed spec
            aot_registry.serialize_engine(warm)
            warm = Engine.from_packed(p, "B3/S23", backend="packed")
        check(warm.aot_loaded, f"{shape} engine not registry-served")
        os.environ[aot_registry.ENV_AOT] = "0"
        eager_engine = Engine.from_packed(p, "B3/S23", backend="packed")
        del os.environ[aot_registry.ENV_AOT]
        check(not eager_engine.aot_loaded, "GOLTPU_AOT=0 was not honoured")
        n = 64
        reps = 2 if shape == MAIN_SHAPE else 20
        ms = {}
        for kind in ["graph", "eager", "eager", "graph"]:
            eng = warm if kind == "graph" else eager_engine
            ms.setdefault(kind, []).append(
                timed_ms(lambda: eng.step(n), reps) / n)
        g_ms, e_ms = min(ms["graph"]), min(ms["eager"])
        check(torch.equal(warm.state, eager_engine.state),
              f"graph and eager engines diverged at {shape}")
        print(f"plain packed B3/S23 {shape[0]}x{shape[1]} TORUS, Engine.step"
              f"({n}): CUDA graphs {ms['graph']} ms/generation, eager "
              f"{ms['eager']} ms/generation (best of each: {g_ms:.5f} vs "
              f"{e_ms:.5f}, {e_ms / g_ms:.2f}x)  [{card}]")
        out["graph"][shape[0]] = (g_ms, e_ms)
        del warm, eager_engine, p
    aot_cache.ensure_persistent_cache(home if home is not None else "")

    # (4) serve --manifest on the warmed root
    server = start_server(repo, work, "--manifest", manifest,
                          "--cache-dir", warm_root)
    try:
        line = server.stdout.readline()
        check(line.startswith("SERVE_PORT "), f"serve announced {line!r}")
        port = int(line.split()[1])

        def req(method, path, body=None):
            data = json.dumps(body).encode() if body is not None else None
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=data, method=method),
                timeout=120)
            raw = r.read().decode()
            return json.loads(raw) if r.headers.get(
                "Content-Type", "").startswith("application/json") else raw

        spec = {"rule": "B3/S23", "height": LANE_SHAPE[0],
                "width": LANE_SHAPE[1], "topology": "torus"}
        # growth through every rung: one lane of 1, 8, 64, then 256 slots
        sids, slots = [], []
        for i in range(WARM_SESSIONS):
            sids.append(req("POST", "/sessions", {
                "tenant": "warm", "spec": spec, "fill": 0.35,
                "rng_seed": i})["sid"])
            if len(sids) in (1, 8, 64, WARM_SESSIONS):
                slots.append(req("GET", "/healthz")["lane_slots"])
        check(slots == [1, 8, 64, 256], f"lane slots while growing {slots}")
        for sid in sids[::8]:
            info = req("POST", f"/sessions/{sid}/step", {"n": 100})
            check(info["generation"] == 100, f"served step: {info}")
        health = req("GET", "/healthz")
        check(health["lane_slots_occupied"] == WARM_SESSIONS,
              f"served lanes {health}")
        text = req("GET", "/metrics")
        misses = re.findall(r'goltpu_kernel_builds\{kind="miss"\} (\S+)', text)
        hits = re.findall(r'goltpu_kernel_builds\{kind="hit"\} (\S+)', text)
        check(not misses or float(misses[0]) == 0,
              f"the warmed server built a kernel: {misses}")
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=120)
        err = server.stderr.read()
        check(rc == 0, f"serve exited {rc}: {err}")
        warmed = [ln for ln in err.splitlines() if "warmed lane ladder" in ln]
        check(len(warmed) == 1, f"serve --manifest printed {warmed}: {err}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    print(f"serve --manifest on the warmed root: {warmed[0].strip()!r}; "
          f"{WARM_SESSIONS} sessions grown through lanes of {slots} slots, "
          f"{len(sids[::8])} stepped 100 "
          f"generations; kernel builds: hit {hits}, miss {misses or 0}  "
          f"[{card}]")
    shutil.rmtree(work)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"warm start phase: {out['seconds']:.1f} s  [{card}]")
    return out


def start_server(repo: str, build_dir: str, *extra: str) -> subprocess.Popen:
    """``python -m gameoflifewithactors_torch serve`` on the card, on an
    ephemeral port, with ``extra`` flags."""
    return subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", "serve",
         "--port", "0", "--flight-dump",
         os.path.join(build_dir, "chip_smoke_serve.flight.jsonl"), *extra],
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


MP_PROCESSES = 2               # gloo processes sharing the one card
MP_MESH = (2, 2)               # flattened: two full-width bands per process
MP_GENERATIONS = 2000          # (a)'s 16384^2 B3/S23 run
FLEET_SHAPE = (4096, 4096)     # (b) the elastic fleet, B3/S23 TORUS
FLEET_GENERATIONS = 400
FLEET_CHUNK = 100
SOAK_SHAPE = (4096, 4096)      # (c) the soak worker, the packed flavor
SOAK_GENERATIONS = 400
SOAK_CHUNK = 100
BAND_RUNNERS = {  # rule -> (sharded runner, slab kernel, full-grid kernel, depth)
    "B3/S23": ("make_multi_step_kernel", "life_slab", "life_packed",
               "DEFAULT_BAND_GENS_PER_CALL"),
    "brain": ("make_multi_step_generations_kernel", "life_generations_slab",
              "life_generations", "DEFAULT_GENERATIONS_GENS_PER_CALL"),
    "bosco": ("make_multi_step_ltl_kernel", "life_ltl_slab", "life_ltl",
              "DEFAULT_LTL_GENS_PER_CALL"),
}


def _words(state) -> np.ndarray:
    """A card tensor of int32 words (or planes) as host uint32 words."""
    return state.cpu().numpy().view(np.uint32)


def _got_path(work: str, name: str) -> str:
    return os.path.join(work, f"mp_got_{name.replace('/', '')}.npy")


def band_worker(rank: int, world: int, port: int, work: str) -> int:
    """One process of a gloo group on card 0 (``chip_smoke.py
    --band-worker RANK WORLD PORT WORK``): for each run of
    ``WORK/mp_plan.json`` the band runner of its rule on the global mesh,
    counts set to 0 just before the timed run and read just after; rank 0
    writes each ``gather_global`` result, every rank its counts, seconds
    and bytes to ``WORK/mp_stats-r<rank>.json``."""
    import torch
    import torch.distributed as dist

    from gameoflifewithactors_torch.aot import cache as aot_cache
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel import halo, multihost, sharded

    with open(os.path.join(work, "mp_plan.json")) as f:
        plan = json.load(f)
    aot_cache.ensure_persistent_cache()      # the parent's builds: no nvcc
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo",
                         initialization_timeout=300)
    mesh = multihost.global_mesh(tuple(plan["mesh"]),
                                 [dev] * plan["per_process"])
    check(mesh.spans_processes and len(mesh.groups) == 1,
          f"rank {rank} holds {mesh.groups} of {mesh}")
    stats = {}
    for run in plan["runs"]:
        maker, _, _, depth = BAND_RUNNERS[run["rule"]]
        runner = getattr(sharded, maker)(mesh, parse_any(run["rule"]),
                                         Topology(run["topology"]))
        start = multihost.put_global_grid(np.load(run["start"]), mesh,
                                          banded=True)
        runner(start, 1)    # warm: the library's load, a first exchange
        torch.cuda.synchronize()
        dist.barrier()
        cs.reset_launch_counts()
        moved, crossed = halo.exchanged_bytes(), halo.crossed_bytes()
        t0 = time.perf_counter()
        out = runner(start, run["generations"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats[run["name"]] = {
            "launches": cs.launch_counts(), "wall": wall,
            "chunks": math.ceil(run["generations"] / getattr(cs, depth)),
            "exchanged": halo.exchanged_bytes() - moved,
            "crossed": halo.crossed_bytes() - crossed}
        got = multihost.gather_global(out)
        if rank == 0:
            np.save(_got_path(work, run["name"]), got)
    dist.barrier()
    with open(os.path.join(work, f"mp_stats-r{rank}.json"), "w") as f:
        json.dump(stats, f)
    multihost.shutdown()
    return 0


def run_band_group(work: str, plan: dict, world: int = MP_PROCESSES,
                   timeout: float = 600.0) -> list:
    """``world`` band workers of this script on the card, started
    together; returns each rank's stats. Fails on any worker's failure
    and kills every worker still running at the timeout."""
    import socket

    with open(os.path.join(work, "mp_plan.json"), "w") as f:
        json.dump(plan, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--band-worker", str(r),
         str(world), str(port), work], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(not errors, "; ".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(work, f"mp_stats-r{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_band_group(work: str, plan: dict, stats: list, truths: dict) -> None:
    """Every run's gathered grid equals its single-device truth bit for
    bit, and each process launched its slab kernel once per chunk and the
    full-grid kernel never."""
    for run in plan["runs"]:
        _, slab, full, _ = BAND_RUNNERS[run["rule"]]
        got = np.load(_got_path(work, run["name"]))
        check(np.array_equal(got, truths[run["name"]]),
              f"{run['name']} across processes differs from the "
              "single-device run")
        for r, rank_stats in enumerate(stats):
            s = rank_stats[run["name"]]
            check(s["launches"][slab] == s["chunks"] > 0
                  and s["launches"][full] == 0
                  and all(v == 0 for k, v in s["launches"].items()
                          if k != slab),
                  f"{run['name']} rank {r} launched {s['launches']}, expected "
                  f"{s['chunks']} of {slab} alone")
            check(0 < s["crossed"] <= s["exchanged"],
                  f"{run['name']} rank {r} bytes {s}")


def fleet_on_card(work: str, shape, generations: int, chunk: int) -> dict:
    """The elastic fleet of two gloo workers on the card, B3/S23 TORUS, a
    ``process_kill`` of worker 1 at the midpoint: the survivor detects the
    loss within the JAX package's bound, the replaced worker resumes from
    the last verified sharded checkpoint, and ``final.npy`` equals the
    single-device engine (kernel B1). Returns the fleet's report."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.resilience import (ElasticFleet,
                                                       ElasticSpec, FaultEvent)
    from gameoflifewithactors_torch.resilience.distributed import (
        EXIT_PEER_LOST, initial_grid)

    spec = ElasticSpec(shape=tuple(shape), target_gens=generations,
                       chunk=chunk, chunk_sleep_seconds=0.25)
    fleet = ElasticFleet(os.path.join(work, "fleet"), spec,
                         num_processes=MP_PROCESSES, device="cuda",
                         backend="gloo")
    report = fleet.run([FaultEvent(worker=1, at_gen=generations // 2,
                                   kind="process_kill")])
    check(report["ok"], f"fleet: {json.dumps(report['epochs'])[-3000:]}")
    fired = [e for e in report["epochs"] if e["fired"]]
    bound = (spec.heartbeat_deadline_seconds + spec.barrier_deadline_seconds
             + 20.0)
    check(len(fired) == 1 and fired[0]["detection_seconds"] <= bound
          and fired[0]["exit_codes"].count(EXIT_PEER_LOST) == 1,
          f"fleet fault epochs: {fired}")
    check(all(e["num_processes"] == MP_PROCESSES for e in report["epochs"]),
          "the killed worker was not replaced")
    truth = Engine(initial_grid(spec), spec.rule, backend="cuda",
                   device="cuda")
    truth.step(generations)
    check(np.array_equal(np.load(report["final_grid"]), truth.snapshot()),
          "the fleet's final.npy differs from the single-device engine")
    del truth
    torch.cuda.empty_cache()
    return report


def soak_on_card(work: str, shape, generations: int, every: int) -> dict:
    """The soak worker's ``packed`` flavor on the card, SIGKILLed once its
    health probe counts the first chunk's checkpoint, then relaunched with
    ``--resume``: ``final.npy`` equals an unfaulted single-device run.
    Returns the report and the seconds of both runs."""
    import signal
    import urllib.request

    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.resilience.worker import genesis

    workdir = os.path.join(work, "soak")
    spec = {"name": "chip-soak", "flavor": "packed", "shape": list(shape),
            "generations": generations, "checkpoint_every": every,
            "rng_seed": 3, "workdir": workdir, "watchdog_deadline": 30.0,
            "events": [], "device": "cuda", "chunk_sleep_seconds": 0.3}
    spec_path = os.path.join(work, "soak.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "gameoflifewithactors_torch.resilience.worker",
           "--spec", spec_path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        check(line.startswith("METRICS_PORT "), f"soak worker said {line!r}")
        url = f"http://127.0.0.1:{int(line.split()[1])}/healthz"
        deadline = time.perf_counter() + 300
        while True:
            with urllib.request.urlopen(url, timeout=30) as r:
                # the gen-0 save and the first chunk's are durable
                if json.loads(r.read()).get("checkpoints", 0) >= 2:
                    break
            check(time.perf_counter() < deadline and proc.poll() is None,
                  "the soak worker made no progress")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)
    killed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = subprocess.run(cmd + ["--resume"], capture_output=True,
                             text=True, timeout=600)
    resumed_s = time.perf_counter() - t0
    check(resumed.returncode == 0,
          f"resumed soak worker exited {resumed.returncode}: "
          f"{resumed.stderr[-3000:]}")
    with open(os.path.join(workdir, "report.json")) as f:
        report = json.load(f)
    member = report["members"][0]
    check(report["ok"] and report["resume"]
          and every <= member["resumed_generation"] < generations
          and member["final_generation"] == generations,
          f"soak report: {report}")
    truth = Engine(genesis(spec, 0), "B3/S23", backend="cuda", device="cuda")
    truth.step(generations)
    check(np.array_equal(np.load(os.path.join(workdir, "final.npy")),
                         truth.snapshot()),
          "the resumed soak worker's final grid differs from an unfaulted run")
    return {"report": report, "killed_s": killed_s, "resumed_s": resumed_s}


def multiprocess_phase(cs, card: str, dev, work: str) -> dict:
    """Phase 3 across processes, on the one card: (a) the band runners of
    B2's, B3's and B4's slab forms on a flattened (2, 2) global mesh of two
    gloo processes (two bands each): phase 3's 16384^2 B3/S23 soup from
    its 300th generation for 2000 more, equal to phase 3's single-device
    B1 run (``WORK/mp_start.npy``, ``WORK/mp_truth.npy``), timed per chunk
    against the same runner on a single-process (2, 2) mesh of the card,
    with the bytes staged through host memory; brain and Bosco at 4096^2
    DEAD equal to their engines; (b) the elastic fleet with a kill; (c)
    the soak worker killed and resumed."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel import sharded
    from gameoflifewithactors_torch.parallel.mesh import (
        device_put_sharded_grid, make_mesh)

    t_phase = time.perf_counter()
    out = {}
    truths = {"B3/S23": np.load(os.path.join(work, "mp_truth.npy"))}
    runs = [{"name": "B3/S23", "rule": "B3/S23", "topology": "torus",
             "generations": MP_GENERATIONS,
             "start": os.path.join(work, "mp_start.npy")}]
    states = {"brain": 3, "bosco": 2}
    for spec in ("brain", "bosco"):
        cells = (np.random.default_rng(5).random(MESH_DEAD_SHAPE)
                 * states[spec]).astype(np.uint8)
        alone = Engine(cells, spec, topology=Topology.DEAD, backend="cuda",
                       device=dev)
        start = os.path.join(work, f"mp_start_{spec}.npy")
        np.save(start, _words(alone.state))
        alone.step(MAIN_GENERATIONS)
        truths[spec] = _words(alone.state)
        runs.append({"name": spec, "rule": spec, "topology": "dead",
                     "generations": MAIN_GENERATIONS, "start": start})
        del alone
    plan = {"mesh": list(MP_MESH), "per_process": 2, "runs": runs}
    t0 = time.perf_counter()
    stats = run_band_group(work, plan)
    group_s = time.perf_counter() - t0
    check_band_group(work, plan, stats, truths)

    # the same B2 runner on a single-process (2, 2) mesh of the card
    smesh = make_mesh(MP_MESH, [dev] * 4)
    run = sharded.make_multi_step_kernel(smesh, CONWAY)
    placed = device_put_sharded_grid(
        torch.from_numpy(np.load(runs[0]["start"]).view(np.int32)).to(dev),
        smesh, banded=True)
    run(placed, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = run(placed, MP_GENERATIONS)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(_words(single.gather()), truths["B3/S23"]),
          "the single-process (2, 2) mesh differs from phase 3's B1 run")
    del single, placed
    for name in ("B3/S23", "brain", "bosco"):
        s = [rank_stats[name] for rank_stats in stats]
        chunks = s[0]["chunks"]
        ms = max(x["wall"] for x in s) * 1e3 / chunks
        slab = BAND_RUNNERS[name][1]
        line = (f"multi-process (a): {name} "
                + (f"{MAIN_SHAPE[0]}^2 TORUS from phase 3's generation "
                   f"{MAIN_GENERATIONS}, {MP_GENERATIONS} generations"
                   if name == "B3/S23" else
                   f"{MESH_DEAD_SHAPE[0]}^2 DEAD, {MAIN_GENERATIONS} "
                   "generations")
                + f" on a flattened {MP_MESH} global mesh of "
                f"{MP_PROCESSES} gloo processes on {dev} (two bands each): "
                f"{chunks} chunks, {[x['launches'][slab] for x in s]} {slab} "
                f"launches per process, no full-grid kernel; gather_global == "
                f"the single-device run bit for bit; {ms:.4f} ms per chunk; "
                f"host-staged bytes per chunk per process "
                f"{[x['crossed'] // chunks for x in s]} received (as many "
                f"sent), of {[x['exchanged'] // chunks for x in s]} exchanged")
        if name == "B3/S23":
            one = single_ms / chunks
            line += (f"; the same runner on a single-process {MP_MESH} mesh "
                     f"of the card: {one:.4f} ms per chunk (ratio "
                     f"{ms / one:.3f})")
            out["chunk_ms"], out["single_chunk_ms"] = ms, one
            out["staged_bytes"] = s[0]["crossed"] // chunks
        print(line + f"  [{card}]")
    print(f"multi-process (a): the group of {MP_PROCESSES} workers, spawn to "
          f"exit, {group_s:.1f} s  [{card}]")
    stamp_b = time.perf_counter()
    report = fleet_on_card(work, FLEET_SHAPE, FLEET_GENERATIONS, FLEET_CHUNK)
    fired = [e for e in report["epochs"] if e["fired"]][0]
    after = report["epochs"][-1]
    out["detection_s"] = fired["detection_seconds"]
    out["recovery_s"] = after["recovery_seconds"]
    print(f"multi-process (b): elastic fleet, {MP_PROCESSES} gloo workers on "
          f"{dev}, {FLEET_SHAPE[0]}^2 B3/S23 TORUS, chunks of {FLEET_CHUNK} "
          f"to {FLEET_GENERATIONS}, process_kill of worker 1 at generation "
          f"{fired['fired'][0]['fired_at_gen']}: detected in "
          f"{out['detection_s']:.3f} s (survivor exit codes "
          f"{fired['exit_codes']}; bound "
          f"{report['spec']['heartbeat_deadline_seconds'] + report['spec']['barrier_deadline_seconds'] + 20:.0f}"
          f" s), recovery (fault to the "
          f"rebuilt fleet's first heartbeat) {out['recovery_s']:.3f} s, "
          f"{len(report['epochs'])} epochs, startup "
          f"{[e.get('startup_seconds') for e in report['epochs']]} s; "
          f"final.npy == the single-device engine; fleet "
          f"{time.perf_counter() - stamp_b:.1f} s  [{card}]")
    soak = soak_on_card(work, SOAK_SHAPE, SOAK_GENERATIONS, SOAK_CHUNK)
    member = soak["report"]["members"][0]
    print(f"multi-process (c): soak worker, packed flavor on {dev}, "
          f"{SOAK_SHAPE[0]}^2, {SOAK_GENERATIONS} generations, checkpoint "
          f"every {SOAK_CHUNK}: SIGKILLed after {soak['killed_s']:.1f} s, "
          f"--resume from generation {member['resumed_generation']} "
          f"({soak['resumed_s']:.1f} s, exit 0); final.npy == an unfaulted "
          f"single-device run  [{card}]")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"multi-process phase: {out['seconds']:.1f} s  [{card}]")
    return out


ANALYSIS_TIMED_GENERATIONS = 2000   # B1's ms per generation, guard on and off


def analysis_phase(cs, card: str, dev, repo: str) -> dict:
    """The analysis phase (ROADMAP A17), on states of its own:

    (a) the transfer guard (``GOLTPU_SANITIZE=1``, set in this process) at
        full width: B1 (16384^2 B3/S23 TORUS, ``auto``), B3 (brain), B4
        (Bosco), B2's slab form (the 4-band mesh), B2's lane form (the
        256-session lane), the sparse engine on config #5 and the paged
        engine each step two chunks and a remainder under the guard, equal
        bit for bit to the same run unguarded, launching their kernel
        ceil(n/g) times; ``snapshot``, ``population`` and ``active_tiles``
        run inside a guard; the negative control (``int(t.sum())`` of a
        card tensor inside the guard) raises; what else trips the guard on
        this card is printed (probes); B1's ms per generation with the
        guard and without, in turns;
    (b) the contract gate on the card, ``contracts --device cuda
        --strict``, in a subprocess of its own (one line per runner);
    (c) the lint of the port tree, exit 0."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.analysis import contracts, lint, sanitizers
    from gameoflifewithactors_torch.bench import config5
    from gameoflifewithactors_torch.memory.paged import default_chunk_gens
    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.ops import bitpack, sparse
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel.batched import \
        multi_step_kernel_batched
    from gameoflifewithactors_torch.parallel.mesh import make_mesh
    from gameoflifewithactors_torch.utils.interop import host_to_device

    t_phase = time.perf_counter()
    before = os.environ.get(sanitizers.ENV_SANITIZE)
    out = {}
    try:
        os.environ[sanitizers.ENV_SANITIZE] = "1"
        # -- (a) the negative control, then what else trips the guard ------
        t = torch.ones(1024, device=dev)
        raised = False
        with sanitizers.no_implicit_host_transfers(dev):
            try:
                # goltpu: ignore[GOL001] -- the negative control: this sync must raise
                int(t.sum())
            except RuntimeError:
                raised = True
        check(raised, "int(t.sum()) of a card tensor inside the guard did "
                      "not raise: the guard has no teeth")
        check(sanitizers.guard_depth() == 0 and
              torch.cuda.get_sync_debug_mode() == 0,
              "the guard did not restore the sync debug mode")
        event = torch.cuda.Event()
        event.record()
        host = torch.ones(1 << 16, dtype=torch.int32)
        probes = {
            "torch.cuda.synchronize()": torch.cuda.synchronize,
            "Event.synchronize()": event.synchronize,
            "Stream.synchronize()": torch.cuda.current_stream().synchronize,
            "pageable .to(cuda) (blocking)": lambda: host.to(dev),
            "pageable .to(cuda, non_blocking=True) (halo's return trip)":
                lambda: host.to(dev, non_blocking=True),
            "torch.tensor(list, device=cuda)":
                lambda: torch.tensor([1, 2, 3], device=dev),
            "interop.host_to_device (pinned, async)":
                lambda: host_to_device(host, dev),
        }
        found = {}
        for name, fn in probes.items():
            with sanitizers.no_implicit_host_transfers(dev):
                try:
                    fn()
                    found[name] = "passes"
                except RuntimeError:
                    found[name] = "raises"
        torch.cuda.synchronize()
        print("analysis (a) guard probes on the card: int(t.sum()) raises "
              "(the negative control); " + "; ".join(
                  f"{k} {v}" for k, v in found.items()))
        check(found["interop.host_to_device (pinned, async)"] == "passes",
              "the pinned asynchronous copy trips the guard")
        out["probes"] = found

        # -- (a) each path twice from one start, under the guard and not ----
        def held(label, make, n, kernel=None, per_chunk=None, chunk=None):
            states = {}
            for guarded in (True, False):
                os.environ[sanitizers.ENV_SANITIZE] = "1" if guarded else "0"
                engine = make()
                cs.reset_launch_counts()
                engine.step(n)
                engine.block_until_ready()
                counts = cs.launch_counts()
                if guarded:
                    with sanitizers.no_implicit_host_transfers(dev):
                        engine.snapshot(max_shape=(40, 80))
                        pop = engine.population()
                        tiles = engine.active_tiles()
                    if kernel is not None:
                        want = per_chunk * math.ceil(n / chunk)
                        check(counts[kernel] == want and all(
                            v == 0 for k, v in counts.items() if k != kernel),
                            f"{label} under the guard launched {counts}, "
                            f"expected {want} of {kernel}")
                states[guarded] = engine.state.clone()
                del engine
            check(torch.equal(states[True], states[False]),
                  f"{label}: the guarded run differs from the unguarded one")
            print(f"analysis (a) {label}: {n} generations under the guard, "
                  "no raise, == the unguarded run (torch.equal); snapshot, "
                  f"population {pop}, active tiles {tiles} inside a guard"
                  + (f"; {per_chunk * math.ceil(n / chunk)} {kernel} launches"
                     if kernel else ""))
            del states
            torch.cuda.empty_cache()

        rng = torch.Generator(device=dev)
        rng.manual_seed(14)
        soup = seeds.bernoulli(rng, MAIN_SHAPE, 0.5)
        brain, bosco = parse_any("brain"), parse_any("bosco")
        u = torch.rand(MAIN_SHAPE, generator=rng, device=dev)
        brain_cells = (u * brain.states).to(torch.uint8)
        del u
        for label, spec, cells, kernel, g in [
                ("B1 16384^2 B3/S23 TORUS (auto)", "B3/S23", soup,
                 "life_packed", cs.DEFAULT_GENS_PER_CALL),
                ("B3 16384^2 brain", brain, brain_cells, "life_generations",
                 cs.DEFAULT_GENERATIONS_GENS_PER_CALL),
                ("B4 16384^2 Bosco", bosco, soup, "life_ltl",
                 cs.DEFAULT_LTL_GENS_PER_CALL)]:
            held(label, lambda: Engine(cells, spec, device="cuda"),
                 2 * g + 3, kernel, 1, g)
        mesh = make_mesh((MESH_BANDS, 1), [dev] * MESH_BANDS)
        g = cs.DEFAULT_BAND_GENS_PER_CALL
        held("B2 slab form, 16384^2 B3/S23 on the 4-band mesh",
             lambda: Engine(soup, "B3/S23", device="cuda", mesh=mesh),
             2 * g + 3, "life_slab", 1, g)
        del brain_cells, soup
        # the serving lane is stepped by its runner, not an Engine
        lane = torch.stack([bitpack.pack(seeds.bernoulli(rng, LANE_SHAPE, 0.35))
                            for _ in range(LANE_SESSIONS)])
        mask = np.ones(LANE_SESSIONS, np.uint32)
        mask[::7] = 0
        n = 2 * g + 3
        lanes = {}
        for guarded in (True, False):
            os.environ[sanitizers.ENV_SANITIZE] = "1" if guarded else "0"
            cs.reset_launch_counts()
            with sanitizers.no_implicit_host_transfers(dev):
                lanes[guarded] = multi_step_kernel_batched(lane, n, mask,
                                                           rule=CONWAY)
            torch.cuda.synchronize()
            check(cs.launch_counts()["life_slab"] == math.ceil(n / g),
                  f"the lane launched {cs.launch_counts()}")
        check(torch.equal(lanes[True], lanes[False]),
              "the lane: the guarded run differs from the unguarded one")
        print(f"analysis (a) B2 lane form, {LANE_SESSIONS} x "
              f"{LANE_SHAPE[0]}^2 sessions (every 7th frozen): {n} generations "
              f"under the guard, no raise, == the unguarded run; "
              f"{math.ceil(n / g)} life_slab launches")
        del lane, lanes
        side = CONFIG5_SIDE
        words = config5.seed_words(side)
        paged_chunk = default_chunk_gens(CONWAY, sparse.DEFAULT_TILE_ROWS,
                                         sparse.DEFAULT_TILE_WORDS)
        for backend, opts, chunk in (
                ("sparse", {"chunk_gens": 4}, 4),
                ("paged", {"capacity": CONFIG5_PAGED_CAPACITY}, paged_chunk)):
            held(f"config #5 on the {backend} engine (chunks of {chunk})",
                 lambda: Engine.from_packed(words, "B3/S23",
                                            topology=Topology.TORUS,
                                            backend=backend, device="cuda",
                                            sparse_opts=opts),
                 2 * chunk + 1)
        del words
        torch.cuda.empty_cache()
    finally:
        if before is None:
            os.environ.pop(sanitizers.ENV_SANITIZE, None)
        else:
            os.environ[sanitizers.ENV_SANITIZE] = before

    # -- (b) the gate, in a process of its own, after (a) ---------------------
    env = {k: v for k, v in os.environ.items() if k != sanitizers.ENV_SANITIZE}
    gate = subprocess.run(
        [sys.executable, "-m", "gameoflifewithactors_torch.analysis.contracts",
         "--device", "cuda", "--strict"], cwd=repo, env=env,
        capture_output=True, text=True, timeout=600)
    lines = gate.stdout.strip().splitlines()
    for line in lines:
        print(f"analysis (b) contracts --device cuda --strict: {line}")
    check(gate.returncode == 0,
          f"contracts --device cuda --strict exited {gate.returncode}; "
          "its lines other than ok: " + " | ".join(
              line for line in lines if not line.startswith("ok "))
          + f"; its standard error: {gate.stderr[-2000:]}")
    runners = len(contracts.load_registry())
    held_lines = sum(line.startswith(("ok ", "skipped (stale) "))
                     for line in lines)
    check(held_lines == len(lines) == runners,
          f"the gate on the card printed {len(lines)} lines for {runners} "
          f"runners, {held_lines} of them ok or stale")
    out["gate"] = lines

    # -- (c) the lint of the port tree ----------------------------------------
    rc = lint.main([])
    check(rc == 0, f"the lint of the port tree exited {rc}")
    print("analysis (c) python -m gameoflifewithactors_torch.analysis.lint: "
          "exit 0 (the package, chip_smoke.py, tests/test_torch_*.py)")

    # -- (a) B1's ms per generation, guard off and on, in turns ---------------
    rng = torch.Generator(device=dev)
    rng.manual_seed(15)
    cells = seeds.bernoulli(rng, MAIN_SHAPE, 0.5)
    n = ANALYSIS_TIMED_GENERATIONS
    times = {True: [], False: []}
    try:
        for guarded in (False, True, True, False):
            os.environ[sanitizers.ENV_SANITIZE] = "1" if guarded else "0"
            engine = Engine(cells, "B3/S23", device="cuda")
            engine.step(cs.DEFAULT_GENS_PER_CALL)     # warm
            engine.block_until_ready()
            t0 = time.perf_counter()
            engine.step(n)
            engine.block_until_ready()
            times[guarded].append((time.perf_counter() - t0) * 1e3 / n)
            del engine
    finally:
        if before is None:
            os.environ.pop(sanitizers.ENV_SANITIZE, None)
        else:
            os.environ[sanitizers.ENV_SANITIZE] = before
    out["b1_ms_per_gen"] = times
    out["seconds"] = time.perf_counter() - t_phase
    print(f"analysis (a) B1 16384^2 B3/S23, {n} generations per run, host "
          "clock incl. sync, in turns (off, on, on, off): without the guard "
          + ", ".join(f"{t:.6f}" for t in times[False]) + " ms/gen; with it "
          + ", ".join(f"{t:.6f}" for t in times[True]) + f" ms/gen  [{card}]")
    print(f"analysis phase: {out['seconds']:.1f} s  [{card}]")
    return out


# the fleet drills (gameoflifewithactors_torch.drills) at card sizes, cut
# from the batch cells' 16384^2 because each drill saves every chunk (zlib)
DRILL_FAMILIES = (  # the JAX drill's split at serving-cell widths
    {"rule": "B3/S23", "height": 1024, "width": 1024, "topology": "torus"},
    {"rule": "B36/S23", "height": 1024, "width": 1024, "topology": "torus"},
    {"rule": "B3/S23", "height": 512, "width": 1024, "topology": "dead"},
)
DRILL_SESSIONS = 100           # cut from 200 to pay for the rule sweep
DRILL_SAMPLE = 20              # oracle-checked sessions: stride 5, every tenant
DRILL_SOAK_SHAPES = {"packed": (4096, 4096), "dense": (4096, 4096),
                     "sparse": (4096, 4096), "ltl": (2048, 2048),
                     "ensemble": (1024, 1024)}
DRILL_SOAK_PROCESSES = 5       # one worker per flavor, five oracle twins
DRILL_CHAOS_SHAPE = (6144, 4096)   # rows divide by 2, 3, 4; 128 words by 2
DRILL_CHAOS_PROCESSES = 4
DRILL_CHAOS_MESH = (2, 2)


def drills_phase(card: str, dev) -> dict:
    """The fleet drills on the card, each called as a plain function whose
    failure fails the script (nothing caught, ``GOLTPU_SANITIZE=1`` in
    every drill process), every process loading this run's kernels:

    (a) ``serve_load``: 100 sessions over HTTP in the JAX drill's three
        families at 1024^2-class widths (each resolving to B2's lane
        form), ladder 1,8,64, two mixed rounds, 20 sampled grids against
        the numpy oracle, a SIGKILL and ``--resume`` of the server;
    (b) ``soak``: one worker per flavor (packed, dense, sparse at 4096^2,
        LtL at 2048^2, an ensemble of two 1024^2 members) and five oracle
        twins, 240 generations, a checkpoint every 40, the seeded plan
        with one SIGKILL and resume; the packed worker's ``final.npy``
        also equals B1;
    (c) ``chaos_multihost``: four gloo processes on a (2, 2) mesh of the
        card, k = 4, 120 generations in chunks of 20 at 6144 x 4096,
        through a preemption, checkpoint rot and a kill: all 14 verdicts
        PASS, ``final.npy`` equal to the single-device oracle and to B1."""
    import torch
    from gameoflifewithactors_torch import Engine
    from gameoflifewithactors_torch.aot import cache as aot_cache
    from gameoflifewithactors_torch.drills import (chaos_multihost,
                                                   serve_load, soak)
    from gameoflifewithactors_torch.resilience.distributed import (
        ElasticSpec, initial_grid)
    from gameoflifewithactors_torch.resilience.worker import genesis
    from gameoflifewithactors_torch.serve.lanes import SpecFamily

    t_phase = time.perf_counter()
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_drills_")
    before = os.environ.get(aot_cache.ENV_CACHE_DIR)
    os.environ[aot_cache.ENV_CACHE_DIR] = aot_cache.cache_root()
    try:
        # -- (a) serve_load ----------------------------------------------------
        for family in DRILL_FAMILIES:
            check(SpecFamily.from_spec(family, dev).backend == "cuda",
                  f"{family} does not resolve to B2's lane form")
        t0 = time.perf_counter()
        served = serve_load.run(os.path.join(work, "serve"),
                                sessions=DRILL_SESSIONS, sample=DRILL_SAMPLE,
                                device="cuda",
                                families=DRILL_FAMILIES)
        out["serve_load_s"] = time.perf_counter() - t0
        check(served["ok"], f"serve_load failed: {served['failures'][:10]}")
        out["serve_resume_s"] = served["resume_seconds"]
        print(f"drills (a) serve_load on {dev}: {served['sessions']} "
              f"sessions ({', '.join(f['rule'] + ' ' + str(f['height']) + 'x' + str(f['width']) + ' ' + f['topology'] for f in DRILL_FAMILIES)}; "
              f"B2's lane form), {served['sampled']} grids against the "
              f"numpy oracle before the kill, after the resume and after "
              f"stepping on; server SIGKILL to a live /healthz with every "
              f"session {served['resume_seconds']:.3f} s; drill "
              f"{out['serve_load_s']:.1f} s  [{card}]")

        # -- (b) soak ------------------------------------------------------------
        t0 = time.perf_counter()
        soaked = soak.run(os.path.join(work, "soak"),
                          processes=DRILL_SOAK_PROCESSES, device="cuda",
                          shapes=DRILL_SOAK_SHAPES)
        out["soak_s"] = time.perf_counter() - t0
        check(soaked["ok"],
              f"soak failed: {soaked['invariant_failures'][:10]}")
        with open(os.path.join(work, "soak", "w0", "spec.json")) as f:
            packed_spec = json.load(f)
        check(packed_spec["flavor"] == "packed", f"{packed_spec['flavor']}")
        truth = Engine(genesis(packed_spec, 0), "B3/S23", backend="cuda",
                       device=dev)
        truth.step(packed_spec["generations"])
        check(np.array_equal(
            np.load(os.path.join(work, "soak", "w0", "final.npy")),
            truth.snapshot()), "the soak's packed worker differs from B1")
        del truth
        reports = [w["report"] for w in soaked["results"]["workers"]]
        restarts = {r["name"]: sum(m["supervisor"]["restarts"]
                                   for m in r["members"]) for r in reports}
        stalls = {r["name"]: r["stalls_detected"] for r in reports}
        applied = {r["name"]: [f["kind"] for m in r["members"]
                               for f in m["faults_applied"]]
                   for r in reports}
        print(f"drills (b) soak on {dev}: {DRILL_SOAK_PROCESSES} workers "
              f"and {DRILL_SOAK_PROCESSES} oracle twins under "
              f"GOLTPU_SANITIZE=1 (shapes {DRILL_SOAK_SHAPES}), kills "
              f"{soaked['results']['killed']}, faults applied {applied}, "
              f"restarts {restarts}, stalls detected {stalls}; every final "
              f"grid == its oracle twin, the packed worker's == B1; drill "
              f"{out['soak_s']:.1f} s  [{card}]")

        # -- (c) chaos_multihost -----------------------------------------------
        t0 = time.perf_counter()
        chaos = chaos_multihost.run(
            os.path.join(work, "chaos"), processes=DRILL_CHAOS_PROCESSES,
            shape=DRILL_CHAOS_SHAPE, mesh_shape=DRILL_CHAOS_MESH,
            device="cuda")
        out["chaos_s"] = time.perf_counter() - t0
        verdicts = chaos["oracle"]["checks"]
        check(chaos["ok_with_oracle"] and len(verdicts) == 14
              and all(v["ok"] for v in verdicts),
              f"chaos drill failed: {[v for v in verdicts if not v['ok']]}")
        spec = ElasticSpec.from_dict(chaos["spec"])
        truth = Engine(initial_grid(spec), spec.rule, backend="cuda",
                       device=dev)
        truth.step(spec.target_gens)
        check(np.array_equal(np.load(chaos["final_grid"]), truth.snapshot()),
              "the chaos fleet's final grid differs from B1")
        del truth
        torch.cuda.empty_cache()
        epochs = chaos["epochs"]
        out["chaos_detection_s"] = [e.get("detection_seconds")
                                    for e in epochs]
        out["chaos_recovery_s"] = [e.get("recovery_seconds") for e in epochs]
        print(f"drills (c) chaos_multihost on {dev}: "
              f"{DRILL_CHAOS_PROCESSES} gloo processes, mesh "
              f"{DRILL_CHAOS_MESH}, k = {spec.gens_per_exchange}, "
              f"{DRILL_CHAOS_SHAPE[0]} x {DRILL_CHAOS_SHAPE[1]}, "
              f"{spec.target_gens} generations in chunks of {spec.chunk}; "
              f"faults {[(f['kind'], f['fired_at_gen'], f['epoch']) for f in chaos['faults_fired']]}; "
              f"rosters {[e['num_processes'] for e in epochs]}; detection "
              f"{out['chaos_detection_s']} s, recovery "
              f"{out['chaos_recovery_s']} s, startup "
              f"{[e.get('startup_seconds') for e in epochs]} s per epoch; "
              f"14/14 PASS, final grid == the oracle == B1; drill "
              f"{out['chaos_s']:.1f} s  [{card}]")
    finally:
        if before is None:
            os.environ.pop(aot_cache.ENV_CACHE_DIR, None)
        else:
            os.environ[aot_cache.ENV_CACHE_DIR] = before
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"drills phase: {out['seconds']:.1f} s  [{card}]")
    return out


EXAMPLE_POSITIONS = 4     # the mesh demos' positions, all on cuda:0
EXAMPLES = [  # (demo, flags beside --device, the kernel it must launch)
    ("wolfram", [], None),
    ("ltl_zoo", [], "life_ltl"),
    # the default soup dies out under both binary rules by generation 20:
    # at this fill all three rules keep live cells
    ("ltl_zoo", ["--fill", "0.55"], "life_ltl"),
    ("checkpoint_resume", [], "life_packed"),
    ("sparse_gun", [], None),
    ("ensemble", [], "life_slab"),
    ("telemetry", ["--stall-demo"], "life_packed"),
    ("unbounded_glider", [], None),
    ("long_row", ["--positions", str(EXAMPLE_POSITIONS)], None),
    ("fault_recovery", ["--positions", str(EXAMPLE_POSITIONS)], "life_slab"),
    ("distributed_bands", ["--positions", str(EXAMPLE_POSITIONS)],
     "life_slab"),
]
_EXAMPLE_MASKS = (  # what may differ between the card's run and its twin's
    (re.compile(r"\(\s*[0-9.]+ gens/s\)"), "(<rate> gens/s)"),
    (re.compile(r"[0-9.]+e[+-][0-9]+ cell-updates/s"), "<rate> cell-updates/s"),
    (re.compile(r"-> \S+"), "-> <path>"),
    (re.compile(r"backend=\S+\s*"), "backend=<backend> "),
)


def _run_example(name: str, argv):
    """(``run``'s result, its stdout, wall seconds) of one port demo."""
    import contextlib
    import importlib
    import io

    import torch

    demo = importlib.import_module(f"gameoflifewithactors_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = demo.run(list(argv))
    if "cuda" in argv:
        torch.cuda.synchronize()
    return res, buf.getvalue(), time.perf_counter() - t0


def _masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for pattern, repl in _EXAMPLE_MASKS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


def _hold_example(name: str, card: dict, twin: dict, dev) -> str:
    """Check one demo's card run against its CPU twin's (same arguments)
    and its own oracle; return what held it."""
    import torch

    eq = np.array_equal
    if name == "wolfram":
        check(eq(card["image"], twin["image"]), "wolfram: the diagram differs")
        return "diagram == CPU twin"
    if name == "ltl_zoo":
        check(card.keys() == twin.keys()
              and all(eq(card[k], twin[k]) for k in card),
              "ltl_zoo: a final grid differs from the CPU twin's")
        return "three final grids == CPU twin (B4 box, B4 diamond, plane stack)"
    if name == "checkpoint_resume":
        check(eq(card["resumed"], card["uninterrupted"])
              and eq(card["resumed"], twin["resumed"]),
              "checkpoint_resume: resumed != uninterrupted or != CPU twin")
        return "resumed == uninterrupted == CPU twin"
    if name == "sparse_gun":
        check(card["pops"] == twin["pops"]
              and eq(card["engine"].snapshot(), twin["engine"].snapshot()),
              f"sparse_gun: {card['pops']} against the CPU twin's "
              f"{twin['pops']}")
        return f"populations {card['pops']} and final grid == CPU twin"
    if name == "ensemble":
        check(eq(card["grids"], twin["grids"]),
              "ensemble: the lane form's grids differ from its plain version's")
        return "8 final grids (B2 lane form) == CPU twin (its plain version)"
    if name == "telemetry":
        reps = [json.load(open(r["report_path"])) for r in (card, twin)]
        counts = [{k: v["count"] for k, v in r["phase_seconds"].items()}
                  for r in reps]
        check(counts[0] == counts[1] and counts[0]["scheduler.run"] == 1,
              f"telemetry phase counts {counts}")
        check(len(reps[0]["step_metrics"]) == len(reps[1]["step_metrics"]) == 8,
              "telemetry: step metrics")
        check(card["stall"] is not None and card["stall"].label
              == twin["stall"].label, "telemetry: the watchdog line")
        check(os.path.exists(card["trace_path"]), "telemetry: no trace file")
        # the soup is drawn on the card: replay it through the plain path
        from gameoflifewithactors_torch import Engine
        from gameoflifewithactors_torch.models import seeds

        coord = card["coordinator"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        plain = Engine(seeds.bernoulli(gen, coord.shape, 0.5), "B3/S23",
                       backend="packed", device=dev)
        plain.step(coord.generation)
        check(eq(coord.snapshot(), plain.snapshot()),
              "telemetry: the B1 run differs from the plain packed path")
        return ("report fields == CPU twin; final grid == plain packed path "
                f"at generation {coord.generation}")
    if name == "unbounded_glider":
        check(card["rc"] == 0 == twin["rc"], f"unbounded_glider rc {card['rc']}")
        for u in ("universe", "twin"):
            a, b = card[u].snapshot_cells(), twin[u].snapshot_cells()
            check(a[0] == b[0] and eq(a[1], b[1]),
                  f"unbounded_glider: the {u}'s cells differ from the CPU twin's")
        return "restored twin bit-identical; cells == CPU twin"
    if name == "long_row":
        check(card.keys() == twin.keys()
              and all(eq(card[k], twin[k]) for k in card),
              "long_row: a final row differs from the CPU twin's")
        return "three final rows == CPU twin"
    if name == "fault_recovery":
        check(card["backend"] == "cuda",
              f"fault_recovery: auto on the mesh is {card['backend']}")
        check(eq(card["replayed"], card["unfaulted"])
              and eq(card["replayed"], twin["replayed"]),
              "fault_recovery: the replay differs")
        return "replay == unfaulted (B2 slab) == CPU twin"
    if name == "distributed_bands":
        check([b for b, _ in card.values()] == ["packed", "cuda", "cuda"],
              f"distributed_bands backends {[b for b, _ in card.values()]}")
        grids = [g for _, g in card.values()] + [g for _, g in twin.values()]
        check(all(eq(grids[0], g) for g in grids[1:]),
              "distributed_bands: a layout's grid differs")
        return "three layouts' grids equal each other and the CPU twin's"
    raise ValueError(name)


def examples_phase(cs, card: str, dev, repo: str) -> dict:
    """The ten port demos (``gameoflifewithactors_torch.examples``) on the
    card at their default (full) sizes, each through ``run`` with
    ``--device cuda`` (the mesh demos on ``--positions 4`` of cuda:0),
    every kernel's launch count set to 0 just before and read just after,
    then the same demo with ``--device cpu`` at the same arguments (its
    CPU twin): stdout equal line for line with rates, paths and
    ``backend=`` masked, final grids bit for bit, and each demo's own
    oracle (resumed == uninterrupted, replay == unfaulted, the restored
    twin, the telemetry run's grid against the plain packed path).
    checkpoint_resume and telemetry must launch B1, ensemble,
    fault_recovery and both band layouts of distributed_bands B2, and
    ltl_zoo B4. Then ``fleet_top --once`` over a live port server on the
    card."""
    import signal
    import urllib.request

    t_phase = time.perf_counter()
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    from gameoflifewithactors_torch.aot import cache as aot_cache

    before = os.environ.get(aot_cache.ENV_CACHE_DIR)
    os.environ[aot_cache.ENV_CACHE_DIR] = aot_cache.cache_root()
    server = None
    try:
        for name, flags, kernel in EXAMPLES:
            argv = list(flags)
            if name == "telemetry":
                argv_cpu = argv + ["--out", os.path.join(work, "cpu.json")]
                argv += ["--out", os.path.join(work, "card.json")]
            else:
                argv_cpu = list(argv)
            cs.reset_launch_counts()
            res, text, wall = _run_example(name, argv + ["--device", "cuda"])
            counts = {k: v for k, v in cs.launch_counts().items() if v}
            twin, twin_text, twin_wall = _run_example(
                name, argv_cpu + ["--device", "cpu"])
            # telemetry prints timings throughout: its fields are held below
            check(name == "telemetry" or _masked(text) == _masked(twin_text),
                  f"{name}: stdout differs from the CPU twin's:\n{text}\n"
                  f"-- CPU --\n{twin_text}")
            if kernel is not None:
                check(counts.get(kernel, 0) > 0,
                      f"{name} launched no {kernel}: {counts}")
            if name == "distributed_bands":
                # each band layout: one chunk to warm, gens/8 timed, one
                # to measure its halo bytes
                check(counts.get("life_slab", 0) >= 2 * (1 + 64 // 8),
                      f"distributed_bands: both band layouts must launch "
                      f"B2's slab form: {counts}")
            if name == "ltl_zoo":
                backends = re.findall(r"backend=(\S+)", text)
                check(backends == ["cuda", "cuda", "packed"],
                      f"ltl_zoo backends on the card {backends}")
            held = _hold_example(name, res, twin, dev)
            out[" ".join([name] + flags)] = {"s": wall, "cpu_s": twin_wall,
                                             "launches": counts}
            tail = text.strip().splitlines()[-1]
            print(f"examples {' '.join([name] + flags)}: {wall:.3f} s on the "
                  f"card (CPU twin {twin_wall:.3f} s), launches {counts or 0}; "
                  f"{held}; last line: {tail[:160]}  [{card}]")
            del res, twin

        # -- fleet_top --once over a live port server on the card -----------
        server = start_server(repo, work)
        line = server.stdout.readline()
        check(line.startswith("SERVE_PORT "), f"serve announced {line!r}")
        port = int(line.split()[1])

        def req(method, path, body=None):
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(), method=method), timeout=120)
            return r.status, json.loads(r.read().decode())

        spec = {"rule": "B3/S23", "height": 1024, "width": 1024}
        for i, tenant in enumerate(("acme", "acme", "initech")):
            code, info = req("POST", "/sessions", {
                "tenant": tenant, "spec": spec, "fill": 0.35, "rng_seed": i})
            check(code == 201 and info["spec"]["backend"] == "cuda",
                  f"{code} {info}")
            code, info = req("POST", f"/sessions/{info['sid']}/step",
                             {"n": 100})
            check(code == 200 and info["generation"] == 100, f"{code} {info}")
        t0 = time.perf_counter()
        top = subprocess.run(
            [sys.executable, "-m", "gameoflifewithactors_torch.obs.fleet_top",
             "--once", f"w0=127.0.0.1:{port}"], cwd=repo,
            capture_output=True, text=True, timeout=120)
        out["fleet_top_s"] = time.perf_counter() - t0
        check(top.returncode == 0, f"fleet_top --once exited "
              f"{top.returncode}: {top.stderr[-2000:]}")
        table = top.stdout.strip().splitlines()
        header, row = table[0].split(), table[1].split()
        cell = dict(zip(header, row))
        check(cell["PROC"] == "w0" and cell["UP"] == "up"
              and cell["SESS"] == "3" and cell["TENANTS"] == "2"
              and cell["SLOTS"] == "3/8", f"fleet_top row {cell}")
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=120)
        check(rc == 0, f"serve exited {rc} on SIGTERM")
        print("examples fleet_top --once over a port server on the card (3 "
              "sessions of 2 tenants, 1024^2 B3/S23, B2's lane form): "
              f"{out['fleet_top_s']:.3f} s\n  " + "\n  ".join(table)
              + f"  [{card}]")
    finally:
        if server is not None and server.poll() is None:
            server.kill()
            server.wait()
        if before is None:
            os.environ.pop(aot_cache.ENV_CACHE_DIR, None)
        else:
            os.environ[aot_cache.ENV_CACHE_DIR] = before
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"examples phase: {out['seconds']:.1f} s  [{card}]")
    return out


BENCH_GENERATIONS = 2000       # generations per timed repetition
BENCH_REPEATS = 3
BENCH_INPROCESS_REPEATS = 1    # the in-process run, profiled, against plain B1
BENCH_PATHS = [  # (--rule, --backend, the kernel its timed ticks launch)
    ("B3/S23", "auto", "life_packed"),
    ("brain", "cuda", "life_generations"),
    ("bosco", "cuda", "life_ltl")]
WEAK_POSITIONS = 4             # weak scaling: 1, 2 and 4 positions on cuda:0
WEAK_TILE = "4096x4096"


def bench_phase(cs, card: str, repo: str, main_rates: dict) -> dict:
    """The bench package on the card: (a) ``python -m
    gameoflifewithactors_torch.bench`` in a subprocess on each 16384^2 main
    path (B3/S23 on ``auto``, brain and Bosco on ``cuda``), each last line
    parsed, its launches per repetition ``ceil(gens / g)``, its rate within
    2x of phase 3's tick for the family; (b) the bench in this process on
    the B3/S23 path, one repetition under the sampling profiler: its B1
    launches counted, its final state held against ``multi_step_reference``
    from the same numpy grid, its RunReport through ``roofline_report
    --check`` with an in-kernel rate; (c) ``weak_scaling`` on 1, 2 and 4
    positions of cuda:0 at a 4096^2 tile (repetitions sized by the tool),
    the ``packed`` and ``band`` runners, every final grid held against B1
    on the global grid; (d) the gate passing (a)'s and (b)'s B3/S23
    records and failing a copy with the value halved; (e) the history
    folded into a temporary file, and the store's scoreboard. Returns the
    records."""
    import torch

    from gameoflifewithactors_torch.aot import cache as aot_cache
    from gameoflifewithactors_torch.bench import gate, history, roofline_report
    from gameoflifewithactors_torch.bench import run as bench_run
    from gameoflifewithactors_torch.bench import weak_scaling
    from gameoflifewithactors_torch.bench.timing import card_label
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.ops import bitpack

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    store = os.path.join(work, "results", "cuda_best.json")
    side = MAIN_SHAPE[0]
    depth = {"life_packed": cs.DEFAULT_GENS_PER_CALL,
             "life_generations": cs.DEFAULT_GENERATIONS_GENS_PER_CALL,
             "life_ltl": cs.DEFAULT_LTL_GENS_PER_CALL}
    env = dict(os.environ)    # the children load the kernels this run built
    if aot_cache.cache_root() is not None:
        env[aot_cache.ENV_CACHE_DIR] = aot_cache.cache_root()
    out = {"launches": {}}

    # (a) the bench's entry point on each main path
    records = {}
    report = os.path.join(work, "results", "bench_report.json")
    for spec, backend, kernel in BENCH_PATHS:
        argv = ["--rule", spec, "--backend", backend, "--size", str(side),
                "--gens", str(BENCH_GENERATIONS), "--repeats",
                str(BENCH_REPEATS), "--store", store]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gameoflifewithactors_torch.bench", *argv],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"bench --rule {spec} exited {proc.returncode}: {proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        check({"metric", "value", "unit", "vs_baseline"} <= set(rec)
              and rec["backend"] == "cuda" and rec["kernel"] == kernel
              and rec["platform"] == "cuda" and rec["side"] == side,
              f"bench --rule {spec} record: {line}")
        per_rep = math.ceil(BENCH_GENERATIONS / depth[kernel])
        reps = rec["repetitions"]
        check(len(reps) == BENCH_REPEATS and all(
            r["launches"] == per_rep and r["generations"] == BENCH_GENERATIONS
            for r in reps), f"bench --rule {spec} repetitions {reps}")
        ratio = rec["value"] / main_rates[spec]
        check(0.5 <= ratio <= 2.0,
              f"bench --rule {spec}: {rec['value']:.4e} cell-updates/s is not "
              f"within 2x of phase 3's {main_rates[spec]:.4e}")
        records[spec] = rec
        out["launches"][kernel] = (
            math.ceil(bench_run.WARMUP_GENERATIONS / depth[kernel])
            + BENCH_REPEATS * per_rep)
        print(f"bench last line ({spec}): {line}")
        print(f"bench {side}x{side} {spec} --backend {backend} -> "
              f"{rec['backend']} ({kernel}), {BENCH_REPEATS} repetitions of "
              f"{BENCH_GENERATIONS} generations (seconds "
              f"{[round(r['seconds'], 6) for r in reps]}, {per_rep} launches "
              f"each): best {rec['value']:.4e}, median {rec['median']:.4e} "
              f"cell-updates/s, spread {rec['spread']:.2%}; phase 3's tick "
              f"{main_rates[spec]:.4e} (best / phase 3 {ratio:.4f}); process "
              f"{wall:.2f} s  [{card_label(rec['device'])}]")
    stored = bench_run.load_store(store)
    check(len(stored) == len(BENCH_PATHS) and all(
        r["ok"] for r in stored.values()), f"the bench store holds {stored}")
    # (b) the bench in this process (one repetition, the sampling profiler
    # open over it), held against the plain B1; its record into a store of
    # its own with a pointer to its RunReport
    args = bench_run.parse(
        ["--size", str(side), "--gens", str(BENCH_GENERATIONS), "--repeats",
         str(BENCH_INPROCESS_REPEATS), "--store", store, "--telemetry-out",
         report, "--profile-sample", "5"])
    cs.reset_launch_counts()
    rec, coord = bench_run.run_bench(args)
    counts = cs.launch_counts()
    per_rep = math.ceil(BENCH_GENERATIONS / cs.DEFAULT_GENS_PER_CALL)
    warm = math.ceil(bench_run.WARMUP_GENERATIONS / cs.DEFAULT_GENS_PER_CALL)
    check(counts["life_packed"] == warm + BENCH_INPROCESS_REPEATS * per_rep
          and all(v == 0 for k, v in counts.items() if k != "life_packed")
          and all(r["launches"] == per_rep for r in rec["repetitions"]),
          f"the in-process bench launched {counts}, repetitions "
          f"{rec['repetitions']}")
    total = bench_run.WARMUP_GENERATIONS \
        + BENCH_INPROCESS_REPEATS * BENCH_GENERATIONS
    start = bitpack.pack(torch.from_numpy(
        bench_run.seed_grid("auto", CONWAY, side)).to("cuda"))
    want = cs.multi_step_reference(start, total, rule=CONWAY)
    err = max_abs_err(coord.engine.state, want)
    check(err == 0, f"the in-process bench's state differs from the plain "
                    f"B1 (max_abs_err {err})")
    out["launches"]["life_packed"] += counts["life_packed"]
    profiled = os.path.join(work, "profiled", "cuda_best.json")
    check(bench_run.persist_if_best(profiled, bench_run.config_key(
        args, "cuda"), rec, report) and bench_run.load_store(profiled)[
            "cuda:auto:16384:B3/S23"].get("telemetry_report")
          == os.path.join("results", "bench_report.json"),
          "the profiled record does not point at its RunReport")
    check(roofline_report.main([report, "--check"]) == 0,
          "the bench's profiled RunReport has no device track")
    with open(report) as f:
        section = roofline_report.render_roofline(json.load(f), report)
    check("In-kernel rate**: " in section and "rate**: not measured"
          not in section, "the profiled repetition's device span is not "
          f"its own: {section}")
    print(f"bench in-process {side}x{side} B3/S23 auto -> {rec['backend']} "
          f"under the profiler (--profile-sample 5): {counts['life_packed']} "
          f"B1 launches ({warm} warm-up + {BENCH_INPROCESS_REPEATS} x "
          f"{per_rep}), state after {total} generations == "
          f"multi_step_reference from the same numpy grid (max_abs_err "
          f"{err}); {rec['value']:.4e} cell-updates/s  "
          f"[{card_label(rec['device'])}]; roofline_report --check over its "
          f"RunReport: exit 0; its section:\n{section.rstrip()}")
    del coord, start, want
    base = os.path.join(work, "results", "b3s23_subprocess.json")
    fresh = os.path.join(work, "results", "b3s23_in_process.json")
    halved = os.path.join(work, "b3s23_halved.json")
    for path, r in ((base, records["B3/S23"]), (fresh, rec),
                    (halved, {**rec, "value": rec["value"] / 2})):
        with open(path, "w") as f:
            json.dump(r, f)

    # (c) weak scaling over positions of cuda:0
    out["weak"] = {}
    for runner in ("packed", "band"):
        ws_args = weak_scaling.parse(
            ["--positions", str(WEAK_POSITIONS), "--tile", WEAK_TILE,
             "--runner", runner, "--store", store])
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        ws = weak_scaling.run(ws_args)
        wall = time.perf_counter() - t0
        counts = cs.launch_counts()
        slab = sum(math.ceil(f["generations"] / 8) for f in ws["finals"])
        want_counts = {"life_slab": slab} if runner == "band" else {}
        check(all(v == want_counts.get(k, 0) for k, v in counts.items()),
              f"weak scaling {runner} launched {counts}, expected "
              f"{want_counts}")
        for fin in ws["finals"]:
            truth = cs.multi_step_kernel(fin["start"], fin["generations"],
                                         rule=CONWAY)
            check(torch.equal(fin["final"], truth),
                  f"weak scaling {runner} on {fin['devices']} positions "
                  "differs from B1 on the global grid")
        out["weak"][runner] = ws["series"]
        print(f"weak scaling {runner}, {WEAK_TILE} per position on 1, 2, "
              f"{WEAK_POSITIONS} positions of cuda:0 (every final grid == B1 "
              f"on the global grid; launches {counts}; {wall:.2f} s): "
              + "; ".join(
                  f"{r['devices']} x {r['mesh']} {r['grid'][0]}x{r['grid'][1]} "
                  f"{r['cell_updates_per_sec']:.4e} cell-updates/s, "
                  f"efficiency {r['weak_scaling_efficiency']:.4f}, "
                  f"cost_vs_single_chip {r.get('cost_vs_single_chip', 0):.4f}"
                  f" (repetitions of " + ", ".join(
                      f"{x['generations']} gens in {x['seconds']:.4f} s"
                      for x in fin["repetitions"]) + ")"
                  for r, fin in zip(ws["series"], ws["finals"]))
              + f"  [{card_label(ws['device'])}]")
        del ws
    torch.cuda.empty_cache()

    # (d) the gate, (e) the history and the scoreboard
    rc_pair = gate.main([base, fresh])
    rc_halved = gate.main([base, halved])
    check(rc_pair == 0 and rc_halved == 1,
          f"gate exits {rc_pair} on the pair (want 0), {rc_halved} on the "
          "halved copy (want 1)")
    hist = os.path.join(work, "history.jsonl")
    rc_hist = history.main(["--repo", work, "--store", store, "--history",
                            hist, "--record", report])
    with open(hist) as f:
        folded = sum(1 for _ in f)
    check(rc_hist == 0 and folded >= len(BENCH_PATHS) + 3,
          f"history exited {rc_hist}, folded {folded} entries")
    bench_run.report(store)
    shutil.rmtree(work)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"bench phase: gate 0 on the pair and 1 on the halved copy, "
          f"history {folded} entries; launches {out['launches']}; "
          f"{out['seconds']:.1f} s  [{card}]")
    return out


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
    # the kernel build cache root every process of this run resolves alike
    # (GOLTPU_CACHE_DIR, else gameoflifewithactors_torch/_build)
    from gameoflifewithactors_torch.aot import cache as aot_cache
    print(f"kernel build cache: {aot_cache.ensure_persistent_cache()}")
    t0 = time.perf_counter()
    build_seconds = _build.build_all(KERNELS)
    print(f"build of {len(KERNELS)} sources, one nvcc each, all started "
          f"together: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        built = _build.load(name)
        units = len(_build.UNITS.get(name, [()]))
        print(f"build {name}.cu: nvcc {build_seconds[name]:.2f} s, {units} "
              f"translation unit(s)  ({built.path})")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        # every instantiation of B4 (28), B3 (70), B1 (15) and B2 (20)
        # without spill or frame
        least = {"life_ltl": ("B4", 28), "life_generations": ("B3", 70),
                 "life_packed": ("B1", len(PACKED_LABELS["life_packed"])),
                 "life_slab": ("B2", len(PACKED_LABELS["life_slab"]))}
        if name in least:
            frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                r"stores, (\d+) bytes spill loads", built.log)
            check(len(frames) >= least[name][1]
                  and all(f == ("0", "0", "0") for f in frames),
                  f"{least[name][0]} instantiations with a stack frame or "
                  f"spills: {frames}")
        total, loops = sass_counts(built.path, _build.find_nvcc())
        if name in PACKED_LABELS:
            found = {label for label, _, _ in loops}
            check(set(PACKED_LABELS[name]) <= found,
                  f"{name} row loops missing: {sorted(found)}")
        if name == "life_generations":
            found = {label for label, _, _ in loops}
            check(all(f"ILi{b}ELb{s}ELi{k}EE" in found for b in (2, 8)
                      for s in (0, 1) for k in GEN_RULES),
                  f"B3 row loops missing at b = 2 or 8: {sorted(found)}")
        rows_of = {"life_ltl": ltl_rows, "life_generations": gen_rows}.get(
            name, packed_rows)
        print(f"  sass: {total} instructions; shortest shared-memory loop per "
              "kernel function: " + ("; ".join(
                  f"{label} {n} instructions, {lop3} LOP3{rows_of(label, n)}"
                  for label, n, lop3 in loops) or "none found"))
    # the kernel's rule path (life_generations_rule_path) against the
    # wrapper's encoding, for every born set and every survive set
    from gameoflifewithactors_torch.models.generations import GenRule
    rule_path = cs._library("life_generations").life_generations_rule_path
    sets = [[n for n in range(9) if (m >> n) & 1] for m in range(512)]
    bad = [(bm, sm) for bm in range(512) for sm in range(512)
           if rule_path(bm, sm) != len(cs._generations_rule_encoding(
               GenRule(born=sets[bm], survive=sets[sm], states=3)))]
    check(not bad, f"B3 rule paths differ from the wrapper's encoding: {bad[:4]}")
    print("B3 rule path == the wrapper's encoding for all 512 x 512 born and "
          "survive sets")
    # B1/B2's rule path (life_packed_rule_path) against theirs
    from gameoflifewithactors_torch.models.rules import Rule
    rule_path = cs._library("life_packed").life_packed_rule_path
    sets = [frozenset(s) for s in sets]
    bad = [(bm, sm) for bm in range(512) for sm in range(512)
           if rule_path(bm, sm) != len(cs._generations_rule_encoding(
               Rule(born=sets[bm], survive=sets[sm])))]
    check(not bad, f"B1 rule paths differ from the wrapper's encoding: {bad[:4]}")
    print("B1/B2 rule path == the wrapper's encoding for all 512 x 512 born "
          "and survive sets")
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
    # a rule on each rule path, on grids whose rows fit one warp (the row
    # forms) and grids that do not, at ragged tiles and the default one
    for name in PACKED_RULES.values():
        rule = parse_rule(name)
        for shape in [(40, 96), (72, 1024), (100, 1056), (1000, 16384)]:
            p = bitpack.pack(seeds.bernoulli(rng, shape, 0.5))
            for topology in Topology:
                for g, tile in [(8, None), (16, None), (5, (7, 3)),
                                (3, (9, 64))]:
                    n = 2 * g + 3
                    got = cs.multi_step_kernel(p, n, rule=rule, topology=topology,
                                               gens_per_call=g, tile=tile)
                    want = cs.multi_step_reference(
                        p, n, rule=rule, topology=topology, gens_per_call=g,
                        tile=tile)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B1 kernel != plain at {shape} {name} "
                                    f"{topology} g={g} tile={tile} n={n}")
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
    worst["life_slab_lane"] = check_lane_kernel(cs, rng, parse_rule, Topology)

    cases = 0
    # each rule path (GEN_RULES), C = 2^b (starwars: C = 4, b = 2; C = 256,
    # b = 8), at g = 1, 8, 16 (the default) and 32, and a tile that divides
    # neither axis
    for name in list(GEN_RULES.values()) + ["B3/S23/C256", "B1357/S02468/C17"]:
        rule = parse_any(name)
        for shape in [(2, 32), (72, 96), (1000, 1056)] + \
                ([MAIN_SHAPE] if name == "brain" else []):
            u = torch.rand(shape, generator=rng, device=dev)
            planes = pack_generations_for((u * rule.states).to(torch.uint8), rule)
            for topology in Topology:
                for g, tile in [(1, None), (8, None), (16, None), (32, None),
                                (5, (7, 3))]:
                    n = 2 * g + 3
                    got = cs.multi_step_generations_kernel(
                        planes, n, rule=rule, topology=topology, gens_per_call=g,
                        tile=tile)
                    want = cs.multi_step_generations_reference(
                        planes, n, rule=rule, topology=topology, gens_per_call=g,
                        tile=tile)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B3 kernel != plain at {shape} {name} "
                                    f"{topology} g={g} tile={tile} n={n}")
                    worst["life_generations"] = max(worst["life_generations"], err)
                    cases += 1
    print(f"B3 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst['life_generations']}")

    cases = 0
    # the named rules (HROT lists with more boundaries than the unrolled
    # comparator takes among them), then every radius, box and diamond, M0
    # and M1, at each depth of the sweep
    named = [(parse_any(name), [(64, 96), (96, 128), (1000, 1056)] + (
        [MAIN_SHAPE] if name == "bosco" else [])) for name in [
            "bosco", "majority", "R1,C0,M1,S2..3,B3..3",
            "R7,C0,M1,S20..60,B25..50,NN", "R3,C0,M0,S10..20,B12..16",
            "R2,C2,S6-9,12-14,B7-8,11"]]
    every = [(rule, [(64, 96)]) for rule in ltl_every_form()]
    for rule, shapes in named + every:
        for shape in shapes:
            p = bitpack.pack(seeds.bernoulli(rng, shape, 0.5))
            for topology in Topology:
                for g in (1, 2, 4):
                    n = 2 * g + 1        # not a multiple of g
                    got = cs.multi_step_ltl_kernel(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    want = cs.multi_step_ltl_reference(
                        p, n, rule=rule, topology=topology, gens_per_call=g)
                    err = max_abs_err(got, want)
                    check(err == 0, f"B4 kernel != plain at {shape} "
                                    f"{rule.notation} {topology} g={g} n={n}")
                    worst["life_ltl"] = max(worst["life_ltl"], err)
                    cases += 1
    print(f"B4 kernel vs plain: {cases} cases bit-identical (tolerance 0), "
          f"max_abs_err {worst['life_ltl']}")
    worst.update(check_slab_forms(cs, rng, Topology, parse_any, n_planes))

    stamp("the kernels against their plain versions")
    rule_sweep = rule_sweep_phase(cs, card, dev)
    stamp("the rule sweep")

    # -- 3. the main paths ---------------------------------------------------
    main_launches = {}
    main_rates = {}
    single = {}        # rule -> (start, state after the main path, population)
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
    # the multi-process phase's start and truth: the B3/S23 path's state
    # after its main path and after its timed tick
    mp_work = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    for kernel, spec, g, plain, plain_population in paths:
        coord = GridCoordinator(MAIN_SHAPE, spec, random_fill=0.5, rng_seed=1,
                                device="cuda", view_shape=(40, 80))
        check(coord.engine.backend == "cuda",
              f"auto picked {coord.engine.backend!r} for {spec}, not 'cuda'")
        start_state = coord.engine.state.clone()
        frames = []
        coord.subscribe(frames.append)
        cs.reset_launch_counts()
        coord.run(MAIN_GENERATIONS, render_every=MAIN_TICK)
        counts = cs.launch_counts()
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
        single[spec] = (start_state, want, pop)
        cs.reset_launch_counts()
        wall = tick_seconds(coord, 2000)
        timed = cs.launch_counts()[kernel]
        main_rates[kernel] = MAIN_SHAPE[0] * MAIN_SHAPE[1] * 2000 / wall
        main_rates[spec] = main_rates[kernel]
        if spec == "B3/S23":
            np.save(os.path.join(mp_work, "mp_start.npy"), _words(want))
            np.save(os.path.join(mp_work, "mp_truth.npy"),
                    _words(coord.engine.state))
        print(f"main path timed ({spec}): 2000 generations in one tick, "
              f"{timed} {kernel} launches, "
              f"{wall:.4f} s host clock incl. sync, {main_rates[kernel]:.4e} "
              f"cell-updates/s  [{card}]")
        del coord, start_state, want, frames
    stamp("the single-device main paths")
    mesh = mesh_phase(cs, card, dev, single, main_rates)
    for kernel in ("life_generations_slab", "life_ltl_slab"):
        main_launches[kernel] = mesh[kernel]["launches"]
    stamp("the mesh main paths")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    resumed = resume_phase(cs, card, single, work)
    sharded_v2 = sharded_v2_phase(cs, card, dev, single, work)
    del single
    stamp("checkpoint and resume")

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
        runs[spec + " --mesh bands"] = (cli(*args, "--mesh", "bands"),
                                        runs[spec][1])
    line = last_line(glider)
    check(line.endswith("pop 5"), "CLI output: " + line)
    print("CLI on the card:", line)
    cpu_lines = {}
    for spec, (card_run, cpu_run) in runs.items():
        on_card = last_line(card_run)
        if cpu_run not in cpu_lines:
            cpu_lines[cpu_run] = last_line(cpu_run)
        on_cpu = cpu_lines[cpu_run]
        check(on_card == on_cpu and re.search(r"gen 12 .*pop [1-9]", on_card),
              f"CLI --rule {spec}: card {on_card!r} vs cpu {on_cpu!r}")
        print(f"CLI --rule {spec} on the card: {on_card} (== --device cpu)")
    drive_server(server)
    stamp("the main paths and the entry points")
    elementary = elementary_phase(cs, card, dev, repo, work)
    stamp("the elementary paths")
    cli_round_trip(repo, work)
    shutil.rmtree(work)
    stamp("the CLI's checkpoint round trip")
    print("records (plain-torch paths, no TPU kernel): elementary ensemble "
          f"W110 {elementary['W110']:.4e}, W30 {elementary['W30']:.4e}, "
          f"(1, 4) mesh {elementary['sharded']:.4e} cell-updates/s; "
          + "; ".join(f"{spec} save {r['save_s']:.4f} s load {r['load_s']:.4f} "
                      f"s {r['mib']:.2f} MiB" for spec, r in resumed.items())
          + f"; sharded v2 write {sharded_v2['write_s']:.4f} s, fallback "
          f"load {sharded_v2['load_s']:.4f} s, {sharded_v2['mib']:.2f} MiB  "
          f"[{card}]")

    serving = serve_phase(cs, card)
    # B2 runs on two main paths: its lane form serves the lanes, its slab
    # form the B/S mesh
    main_launches["life_slab_lane"] = serving["launches"]
    main_launches["life_slab"] = mesh["life_slab"]["launches"]
    print(f"life_slab launches: {serving['launches']} of the lane form serving, "
          f"{mesh['life_slab']['launches']} of the slab form on the B3/S23 "
          "mesh path")
    stamp("the serving main path")
    tiled = tiled_phase(cs, card)
    stamp("the sparse and paged engines")
    paths = mesh_paths_phase(cs, card, dev, tiled.pop("config5 truth"))
    del tiled
    worst["life_slab"] = max([worst["life_slab"]] + [
        paths[f"batch mesh {t}"]["max_abs_err"] for t in ("torus", "dead")])
    stamp("ghost, deep, sharded sparse and the batch mesh")
    observe_phase(cs, card, main_rates)
    stamp("the observed and supervised run")
    warmstart_phase(cs, card, repo)
    stamp("warm start")
    multiprocess_phase(cs, card, dev, mp_work)
    shutil.rmtree(mp_work)
    stamp("the multi-process run")
    analysis_phase(cs, card, dev, repo)
    stamp("the analysis phase")
    drills_phase(card, dev)
    stamp("the fleet drills")
    examples_phase(cs, card, dev, repo)
    stamp("the examples")
    bench_phase(cs, card, repo, main_rates)
    stamp("the bench")

    # -- 4. timing at the main path's shape ------------------------------------
    # the card's peaks, read from the device (the roofline's denominators)
    from gameoflifewithactors_torch.obs.device import gpu_peaks

    peaks = gpu_peaks(0)
    op_rate = peaks["int_ops_per_sec"]
    hbm_rate = peaks["hbm_gbps"] * 1e9
    cells = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    rows = []

    def bound(nbytes: float, ops: float):
        bytes_ms = nbytes / hbm_rate * 1e3
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
    th, tw = cs.DEFAULT_TILE
    print(f"B1 kernel {MAIN_SHAPE[0]}^2 g={g} tile {th}x{tw}: {ms:.5f} ms/launch "
          f"({ms / g * 1e3:.2f} us/gen), "
          f"{cells * g / (ms / 1e3):.4e} cell-updates/s; bound {bound_ms:.5f} ms "
          f"(bytes {bytes_ms:.5f}, ops {ops_ms:.5f}: {ops_per_word(CONWAY)} "
          f"ops/word/gen, {peaks['sms']} SMs x {peaks['int32_lanes_per_sm']} "
          f"x {peaks['max_sm_clock_mhz']:.0f} MHz; HBM {peaks['hbm_gbps']:.2f} "
          f"GB/s from the memory clock and bus), {bound_ms / ms:.1%} of it  "
          f"[{card}]")
    print(f"B1 plain version (multi_step_reference, no yardstick): {plain_ms:.4f} "
          f"ms/launch; plain packed path (multi_step_packed, no yardstick): "
          f"{packed_ms:.4f} ms/generation  [{card}]")
    sweep = []
    for gs in (8, 16, 32):
        for tile in [(192, 28), (256, 28), (112, 58), (160, 58), (192, 58),
                     (128, 88)]:
            t = timed_ms(lambda: cs.multi_step_kernel(
                p, gs * 40, rule=CONWAY, gens_per_call=gs, tile=tile),
                1) / (40 * gs)
            sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B1 sweep:", "; ".join(sweep), f" [{card}]")
    paths = []
    for k, name in PACKED_RULES.items():
        rule = parse_rule(name)
        t = timed_ms(lambda: cs.multi_step_kernel(p, g * 50, rule=rule), 1) / 50
        b_ms = bound(2 * H * Wp * 4, g * H * Wp * ops_per_word(rule))[0]
        paths.append(f"{name} ({k or 'table'}{' count(s)' if k else ''}): "
                     f"{t:.5f} ms/launch, {b_ms / t:.1%} of its "
                     f"{ops_per_word(rule)}-op bound")
    print(f"B1 rule paths {MAIN_SHAPE[0]}^2 g={g}:", "; ".join(paths), f" [{card}]")
    rows.append(("life_packed", "life_packed", 160, ms, plain_ms, bound_ms,
                 ops_ms >= bytes_ms))

    # B2's lane form at the serving shapes: a full lane of 1024^2 sessions,
    # the DEAD family's 64-slot lane and the 16384^2 session, at the lanes'
    # depth, its
    # bound counting each grid's own rows; a lane chunk (the runner's
    # launch with a mask, buffers included) beside the launch alone, and
    # the slab form on the same lane's extended copy
    from gameoflifewithactors_torch.parallel.batched import \
        multi_step_kernel_batched
    g = cs.DEFAULT_BAND_GENS_PER_CALL
    lane_ms = {}
    for batch, (bh, bw), rule, topology in [
            (LANE_SESSIONS, LANE_SHAPE, CONWAY, Topology.TORUS),
            (DEAD_SESSIONS, LANE_SHAPE, parse_rule("B36/S23"), Topology.DEAD),
            (1, MAIN_SHAPE, CONWAY, Topology.TORUS)]:
        lane = torch.stack([bitpack.pack(seeds.bernoulli(rng, (bh, bw), 0.35))
                            for _ in range(batch)])
        mask = cs._lane_mask(np.ones(batch, np.uint32), lane)
        t = timed_ms(lambda: cs.multi_step_lane_kernel(
            lane, g, mask, rule=rule, topology=topology, gens_per_call=g), 50)
        chunk = timed_ms(lambda: multi_step_kernel_batched(
            lane, g * 20, np.ones(batch, np.uint32), rule=rule,
            topology=topology), 1) / 20
        code = 3 if topology is Topology.DEAD else 0
        ext = torch.cat([lane[:, -g:], lane, lane[:, :g]], dim=1)
        slab_t = timed_ms(lambda: cs.slab_step_kernel(
            ext, g, rule=rule, topology=topology, edge_code=code), 50)
        Wq = lane.shape[2]
        b_ms, by_ms, op_ms = bound(2 * batch * bh * Wq * 4,
                                   g * batch * bh * Wq * ops_per_word(rule))
        lane_ms[(batch, bh)] = t
        cu = batch * bh * bw * g / (t / 1e3)
        _, lth, ltw = cs._resolve_lane(g, bh, Wq, None)
        print(f"B2 lane form {batch} x {bh}x{bw} {rule.notation} {topology.value} "
              f"g={g} tile {lth}x{ltw}: {t:.5f} ms/launch, {cu:.4e} "
              f"cell-updates/s; bound {b_ms:.5f} ms (bytes {by_ms:.5f}, ops "
              f"{op_ms:.5f}), {b_ms / t:.1%} of it; lane chunk (the runner: "
              f"mask, buffers, launch) {chunk:.5f} ms, {chunk / t - 1:+.1%} over "
              f"the launch; the slab form on the extended copy "
              f"{tuple(ext.shape)} code={code} {slab_t:.5f} ms  [{card}]")
        if batch == LANE_SESSIONS:
            lane_row = (t, b_ms, op_ms >= by_ms, lane)
        del ext
    t, b_ms, by_ops, lane = lane_row
    plain_ms = timed_ms(lambda: cs.lane_step_reference(lane, g, rule=CONWAY), 3)
    print(f"B2 lane form plain version (lane_step_reference: exchange, slab "
          f"plain version, crop, no yardstick) at {LANE_SESSIONS} x "
          f"{LANE_SHAPE[0]}^2: {plain_ms:.4f} ms/launch  [{card}]")
    sweep = []
    for gs in (4, 8, 16):
        for rows_ in (128, 205, 256, 512):
            tt = timed_ms(lambda: cs.multi_step_lane_kernel(
                lane, gs, rule=CONWAY, gens_per_call=gs,
                tile=(rows_, LANE_SHAPE[1] // 32)), 20)
            sweep.append(f"g={gs} tile={rows_}x32: {tt / gs * 1e3:.2f} us/gen")
    print(f"B2 lane form sweep ({LANE_SESSIONS} x {LANE_SHAPE[0]}^2 lane):",
          "; ".join(sweep), f" [{card}]")
    stamp("timing B1 and B2")
    rows.append(("life_slab_lane", "life_slab", 748, t, plain_ms, b_ms, by_ops))
    del lane, lane_row
    kernel_ms = sum(
        n * lane_ms[key] for key, n in [
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
    th, tw = cs._resolve_generations(b, g, None)[1:]
    print(f"B3 default tile {th}x{tw} at b={b} g={g}: {bound_ms / ms:.1%} of the "
          f"bound  [{card}]")
    sweep = []
    for gs, tile in [(16, (192, 28)), (16, (160, 28)), (16, (128, 28)),
                     (16, (64, 28)), (16, (64, 58)), (16, (128, 58)),
                     (8, (192, 28)), (32, (160, 28)), (4, (192, 28))]:
        t = timed_ms(lambda: cs.multi_step_generations_kernel(
            planes, gs * 20, rule=brain, gens_per_call=gs, tile=tile), 1) / (20 * gs)
        sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B3 sweep:", "; ".join(sweep), f" [{card}]")
    rows.append(("life_generations", "life_generations", 218, ms, plain_ms,
                 bound_ms, ops_ms >= bytes_ms))
    del planes, u
    # each rule path at the main path's shape and depth: the lookup sized to
    # the rule's counts, and the table
    paths = []
    for k, name in GEN_RULES.items():
        rule = parse_any(name)
        u = torch.rand(MAIN_SHAPE, generator=rng, device=dev)
        planes = pack_generations_for((u * rule.states).to(torch.uint8), rule)
        del u
        t = timed_ms(lambda: cs.multi_step_generations_kernel(
            planes, g * 20, rule=rule), 1) / 20
        nb = planes.shape[0]
        b_ms = bound(2 * nb * H * Wp * 4, g * H * Wp * gen_ops_per_word(rule))[0]
        paths.append(f"{name} (b={nb}, {k or 'table'}{' count(s)' if k else ''}): "
                     f"{t:.5f} ms/launch, {b_ms / t:.1%} of its "
                     f"{gen_ops_per_word(rule)}-op bound")
        del planes
    print(f"B3 rule paths {MAIN_SHAPE[0]}^2 g={g}:", "; ".join(paths), f" [{card}]")

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
          f"{cs.DEFAULT_LTL_TILE[0]}x{cs.DEFAULT_LTL_TILE[1]} segments of at "
          f"most {cs.DEFAULT_LTL_SEGMENT} rows: {ms:.5f} ms/launch ({ms / g * 1e3:.2f} "
          f"us/gen), {cells * g / (ms / 1e3):.4e} cell-updates/s; bound "
          f"{bound_ms:.5f} ms (bytes {bytes_ms:.5f}, ops {ops_ms:.5f}: {opw} "
          f"ops/word/gen, the least of the doubling tree's "
          f"{ltl_tree_ops_per_word(bosco)} and the sliding column's "
          f"{ltl_sliding_ops_per_word(bosco)}), {bound_ms / ms:.1%} of it  "
          f"[{card}]")
    print(f"B4 plain version (multi_step_ltl_reference, no yardstick): "
          f"{plain_ms:.4f} ms/launch; plain packed path (multi_step_ltl_packed, "
          f"no yardstick): {packed_ms:.4f} ms/generation  [{card}]")
    sweep = []
    for gs in (1, 2, 4):
        for tile in [(64, 32), (128, 32), (256, 32), (128, 64), (64, 128),
                     (256, 64)]:
            t = timed_ms(lambda: cs.multi_step_ltl_kernel(
                p, gs * 10, rule=bosco, gens_per_call=gs, tile=tile), 1) / (10 * gs)
            sweep.append(f"g={gs} tile={tile[0]}x{tile[1]}: {t * 1e3:.2f} us/gen")
    print("B4 sweep:", "; ".join(sweep), f" [{card}]")
    # the diamond, off every timed main path, at the main path's shape
    nn = parse_any("R7,C0,M1,S20..60,B25..50,NN")
    nn_ms = timed_ms(lambda: cs.multi_step_ltl_kernel(p, g * 10, rule=nn), 1) / 10
    nn_opw = ltl_ops_per_word(nn)
    nn_bound, _, _ = bound(2 * H * Wp * 4, g * H * Wp * nn_opw)
    print(f"B4 kernel {MAIN_SHAPE[0]}^2 {nn.notation} (diamond r=7) g={g}: "
          f"{nn_ms:.5f} ms/launch ({nn_ms / g * 1e3:.2f} us/gen); bound "
          f"{nn_bound:.5f} ms ({nn_opw} ops/word/gen, tree "
          f"{ltl_tree_ops_per_word(nn)}), {nn_bound / nn_ms:.1%} of it  [{card}]")
    rows.append(("life_ltl", "life_ltl", 308, ms, plain_ms, bound_ms,
                 ops_ms >= bytes_ms))
    del p
    stamp("timing B3 and B4")

    # the slab kernels at the mesh main path's shapes: four 16384^2 bands,
    # TORUS (code 0), and one mesh chunk (the row exchange, the launch and
    # the crop) beside the launch alone
    from gameoflifewithactors_torch.parallel import sharded
    from gameoflifewithactors_torch.parallel.mesh import (
        device_put_sharded_grid, make_mesh)

    mesh = make_mesh((MESH_BANDS, 1), [dev] * MESH_BANDS)
    grid = bitpack.pack(seeds.bernoulli(rng, MAIN_SHAPE, 0.5))
    u = torch.rand(MAIN_SHAPE, generator=rng, device=dev)
    planes = pack_generations_for((u * brain.states).to(torch.uint8), brain)
    del u
    for name, source, line, kernel, plain, make, state, rule, g, depth, opw in [
            ("life_slab", "life_slab", 748, cs.slab_step_kernel,
             cs.slab_step_reference, sharded.make_multi_step_kernel, grid,
             CONWAY, cs.DEFAULT_BAND_GENS_PER_CALL,
             cs.DEFAULT_BAND_GENS_PER_CALL,
             ops_per_word(CONWAY)),
            ("life_generations_slab", "life_generations", 679,
             cs.slab_step_generations_kernel, cs.slab_step_generations_reference,
             sharded.make_multi_step_generations_kernel, planes, brain,
             cs.DEFAULT_GENERATIONS_GENS_PER_CALL,
             cs.DEFAULT_GENERATIONS_GENS_PER_CALL, gen_ops_per_word(brain)),
            ("life_ltl_slab", "life_ltl", 406, cs.slab_step_ltl_kernel,
             cs.slab_step_ltl_reference, sharded.make_multi_step_ltl_kernel,
             grid, bosco, cs.DEFAULT_LTL_GENS_PER_CALL,
             bosco.radius * cs.DEFAULT_LTL_GENS_PER_CALL, ltl_ops_per_word(bosco))]:
        ext = band_batch(state, MESH_BANDS, depth, Topology.TORUS)
        t = timed_ms(lambda: kernel(ext, g, rule=rule), 20)
        run = make(mesh, rule, Topology.TORUS, g)
        placed = device_put_sharded_grid(state, mesh, banded=True)
        chunk = timed_ms(lambda: run(placed, g), 10)
        bands = ext.shape[0] * ext.shape[-2] * ext.shape[-1]   # words per plane
        b_ms, by_ms, op_ms = bound(2 * ext.numel() * 4, g * bands * opw)
        print(f"{name} kernel {MESH_BANDS} x {MAIN_SHAPE[0] // MESH_BANDS}x"
              f"{MAIN_SHAPE[1]} {rule.notation} (ext {tuple(ext.shape)}) g={g}: "
              f"{t:.5f} ms/launch, {MAIN_SHAPE[0] * MAIN_SHAPE[1] * g / (t / 1e3):.4e} "
              f"cell-updates/s; bound {b_ms:.5f} ms (bytes {by_ms:.5f}, ops "
              f"{op_ms:.5f}: {opw} ops/word/gen); mesh chunk (exchange + launch "
              f"+ crop) {chunk:.5f} ms, {chunk / t - 1:+.1%} over the launch  "
              f"[{card}]")
        if line is not None:
            plain_ms = timed_ms(lambda: plain(ext, g, rule=rule), 2)
            print(f"{name} plain version ({plain.__name__}, no yardstick): "
                  f"{plain_ms:.4f} ms/launch  [{card}]")
            rows.append((name, source, line, t, plain_ms, b_ms, op_ms >= by_ms))
        del ext, placed
    stamp("timing the slab kernels at the mesh shapes")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"gameoflifewithactors_torch/csrc/{source}.cu",
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
        "sweep_cases": rule_sweep[name]["cases"],
        "sweep_rules": rule_sweep[name]["rules"],
        "sweep_refusals": rule_sweep[name]["refusals"],
    } for name, source, line, ms, plain_ms, bound_ms, by_ops in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rule-sweep"]:
        sys.exit(rule_sweep_main(int(sys.argv[2]) if sys.argv[2:] else
                                 RULE_SWEEP_SEED))
    if sys.argv[1:2] == ["--band-worker"]:
        sys.exit(band_worker(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
