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
   16384², generations per call and seam-crossing gliders.
3. The three main paths, each a ``GridCoordinator`` at 16384² with a 50%
   random soup under TORUS, stepped through ``run(...)`` with every
   kernel's launch count set to 0 just before and read just after, and the
   result held against the kernel's plain version from a copy of the start
   state: B3/S23 (kernel B1), Brian's Brain (B3) and Bosco (B4). Then the
   CLI in a subprocess for each rule family.
4. Timing with CUDA events at 16384²: each kernel per launch, its plain
   version, the plain packed path, the least time the card could take, and
   a depth and tile sweep.

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
KERNELS = ("life_packed", "life_generations", "life_ltl")
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


def launches(cs) -> dict:
    return {"life_packed": cs.KERNEL_LAUNCHES,
            "life_generations": cs.GENERATIONS_LAUNCHES,
            "life_ltl": cs.LTL_LAUNCHES}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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

    def cli(*args):
        out = subprocess.run([sys.executable, "-m", "gameoflifewithactors_torch",
                              *args], cwd=repo, capture_output=True, text=True,
                             timeout=300)
        check(out.returncode == 0, f"CLI {args} exited {out.returncode}: {out.stderr}")
        return out.stdout.splitlines()[-1]

    line = cli("--grid", "64x64", "--seed", "glider", "--steps", "10",
               "--render", "final", "--population")
    check(line.endswith("pop 5"), "CLI output: " + line)
    print("CLI on the card:", line)
    # the same seed on the card and on the CPU: a numpy soup as an RLE file
    # beside the kernels' builds (the random fill draws from each device's
    # own generator)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    soup = os.path.join(_build.BUILD_DIR, "chip_smoke_soup.rle")
    with open(soup, "w") as f:
        f.write(seeds.to_rle(
            (np.random.default_rng(7).random((64, 64)) < 0.4).astype(np.uint8)))
    for spec in ["brain", "bosco"]:
        args = ("--rule", spec, "--grid", "96x128", "--seed", "@" + soup,
                "--steps", "12", "--render", "final", "--population")
        on_card, on_cpu = cli(*args), cli(*args, "--device", "cpu")
        check(on_card == on_cpu and re.search(r"gen 12 .*pop [1-9]", on_card),
              f"CLI --rule {spec}: card {on_card!r} vs cpu {on_cpu!r}")
        print(f"CLI --rule {spec} on the card: {on_card} (== --device cpu)")

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
