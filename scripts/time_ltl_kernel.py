#!/usr/bin/env python3
"""Times kernel B4 (Larger than Life), B3 (Generations) or B1/B2 (B/S) of
a ``gameoflifewithactors_torch`` tree on one CUDA card, to compare two
versions within one run.

    python3 scripts/time_ltl_kernel.py [TREE] [--kernel b4|b3|b1]
        [--rules NAME,...] [--variant plain-lop3|constant-rule|table]

TREE (default: this repository) is a directory holding the package, such
as an unpacked ``git archive`` of another commit; its kernels are built
there at first use. The timer, the shape (16384^2, 50% soup, TORUS) and
the band batch are ``chip_smoke.py``'s. The tree's kernel is first held
against its plain version at a small shape. Prints one JSON line: the
card's name and power limit, the tree, and per case the milliseconds per
launch and microseconds per generation.

``--kernel b4`` (the default):

- Bosco on the full grid at the tree's default tile for g = 1, 2 and 4,
  with the words each launch computes (halo rows and words included), and
  the least-squares line of launch time over those words: its intercept
  is the time per launch that does not grow with the work (loading and
  storing the tiles, the launch, the last wave's tail);
- Bosco on the mesh main path's batch of four halo-extended row bands at
  the tree's default depth;
- the radius-7 diamond R7,C0,M1,S20..60,B25..50,NN on the full grid.

``--kernel b3``: Brian's Brain (or the first of ``--rules``) on the full
grid at the tree's default tile for g = 1, 4 and 16 with the same fit,
and on the mesh main path's four bands at the tree's default depth; then
every rule of ``--rules`` (default ``brain``) on the full grid at the
tree's default depth.

``--kernel b1``: B3/S23 (or the first of ``--rules``) on the full grid by
B1 at the tree's default tile for g = 4, 8 and 16 with the same fit; at
the depth of the lanes and mesh bands, B2's slab form on the mesh main
path's four bands and a lane of 256 1024^2 grids, 35% soup: a chunk of the lane runner
(``multi_step_kernel_batched``, which every tree has) and, in a tree that
has it, B2's lane form alone at its default tile and at 28-word tiles
(the halo form in place of the row form); then every rule of ``--rules``
on the full grid; then each ``--sweep`` configuration ``G:THxTW``: B1 at
g = G on TH x TW tiles, and the lane form at TH rows (where TW is 28) and
the slab form on the mesh batch at depth G (where TH is 192) beside it.

``--variant`` times a copy of TREE's package, written to
``_checkout/<variant>`` beside this repository with one edit to the
shared rule lookup or B3's source: ``plain-lop3`` leaves every
three-input step to the compiler (lop3<> as plain C); ``constant-rule``
fixes the one rule of ``--rules`` in B3 at compile time (what a build per
rule would give) and writes the steps that read the rule's masks in plain
C, so that the compiler folds them; ``table`` sends every rule of B1, B2
and B3 to the table path.

Run it for both trees in turns (A, B, B, A) to see the spread.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "gameoflifewithactors_torch"


def computed_words(H: int, Wp: int, th: int, tw: int, r: int, g: int,
                   hw: int) -> int:
    """Words one launch computes over all its generations: every
    generation but the last computes the tile's slab, shrinking ``r`` rows
    per side and generation, with ``hw`` halo words per side; the last the
    tile alone (the ragged last tiles counted whole)."""
    slab = th + 2 * r * g
    per_tile = th * tw + sum((slab - 2 * r * (k + 1)) * (tw + 2 * hw)
                             for k in range(g - 1))
    return per_tile * -(-H // th) * -(-Wp // tw)


def fit(depths) -> dict:
    """The least-squares line of ms per launch over computed words."""
    mx = sum(d["words"] for d in depths) / len(depths)
    my = sum(d["ms_per_launch"] for d in depths) / len(depths)
    slope = sum((d["words"] - mx) * (d["ms_per_launch"] - my) for d in depths) / \
        sum((d["words"] - mx) ** 2 for d in depths)
    return {"intercept_ms": my - slope * mx, "ns_per_word": slope * 1e6,
            "residuals_ms": [d["ms_per_launch"] - my - slope * (d["words"] - mx)
                             for d in depths]}


def edit(path: str, changes) -> None:
    """Replace each (old, new) of ``changes`` in the file, once each."""
    with open(path) as f:
        text = f.read()
    for old, new in changes:
        if text.count(old) != 1:
            raise SystemExit(f"{path}: {old!r} not found once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def variant_tree(tree: str, variant: str, rule) -> str:
    """A copy of ``tree``'s package and ``chip_smoke.py`` under
    ``_checkout/<variant>`` with the edit ``variant`` names (see the
    module docstring); returns its directory."""
    out = os.path.join(HERE, "..", "_checkout", variant)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(tree, PACKAGE), os.path.join(out, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(tree, "chip_smoke.py"), out)
    csrc = os.path.join(out, PACKAGE, "csrc")
    if variant == "table":
        edit(os.path.join(csrc, "life_rule.cuh"),
             [("return (counts & 0x101u) || n == 0 || n > kMaxEntries ? 0 : n;",
               "return 0;")])
        return out
    if variant == "plain-lop3":
        edit(os.path.join(csrc, "life_bits.cuh"),
             [("#ifdef __CUDA_ARCH__\n  uint32_t d;\n  asm(",
               "#if 0\n  uint32_t d;\n  asm(")])
        return out
    edit(os.path.join(csrc, "life_generations.cu"), [
        ("make_rule<K>(a.born, a.survive)",
         f"make_rule<K>({rule.birth_mask}u, {rule.survive_mask}u)"),
        ("((a.states >> j) & 1u)", f"(({rule.states}u >> j) & 1u)"),
        ("lop3<kAndNotOr>(c.nonzero, born, kept)", "(~c.nonzero & born) | kept"),
        ("eq = lop3<kAndXnor>(eq, inc[j], cbits[j]);",
         "eq = eq & ~(inc[j] ^ cbits[j]);")])
    edit(os.path.join(csrc, "life_rule.cuh"), [
        ("lop3<kAndXnor>(\n          lop3<kNotBothXnor>(r0 ^ rule.n0[i], r1, "
         "rule.n1[i]), r2, rule.n2[i])",
         "~(r0 ^ rule.n0[i]) & ~(r1 ^ rule.n1[i]) & ~(r2 ^ rule.n2[i])"),
        ("born = lop3<kOrAnd>(born, eq, rule.born[i]);",
         "born = born | (eq & rule.born[i]);"),
        ("keep = lop3<kOrAnd>(keep, eq, rule.keep[i]);",
         "keep = keep | (eq & rule.keep[i]);")])
    return out


def soup_words(gen, shape):
    """A 50% soup of packed words on the card."""
    import torch

    from gameoflifewithactors_torch.ops import bitpack

    return bitpack.pack((torch.rand(shape, generator=gen, device="cuda")
                         < 0.5).to(torch.uint8))


def soup_planes(gen, rule, shape):
    """A soup of uniformly drawn states of ``rule``, as a plane stack."""
    import torch

    from gameoflifewithactors_torch.ops.packed_generations import (
        pack_generations_for)

    u = torch.rand(shape, generator=gen, device="cuda")
    return pack_generations_for((u * rule.states).to(torch.uint8), rule)


# The tree's modules: main() puts the tree first on the path before any of
# them is imported, so these imports resolve to the tree's package.
def time_b4(out, gen) -> bool:
    import torch

    from chip_smoke import MAIN_SHAPE, MESH_BANDS, band_batch, timed_ms
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.stencil import Topology

    bosco = parse_any("bosco")
    small = soup_words(gen, (1000, 1056))
    if not torch.equal(cs.multi_step_ltl_kernel(small, 9, rule=bosco),
                       cs.multi_step_ltl_reference(small, 9, rule=bosco)):
        print("time_ltl_kernel: B4 differs from its plain version", file=sys.stderr)
        return False
    p = soup_words(gen, MAIN_SHAPE)
    H, Wp = p.shape
    out["g"] = cs.DEFAULT_LTL_GENS_PER_CALL
    tile = tuple(cs.DEFAULT_LTL_TILE)
    depths = []
    for g in (1, 2, 4):
        ms = timed_ms(lambda: cs.multi_step_ltl_kernel(
            p, g * 20, rule=bosco, gens_per_call=g, tile=tile), 1) / 20
        words = computed_words(H, Wp, *tile, bosco.radius, g,
                               -(-bosco.radius * g // 32))
        depths.append({"g": g, "tile": tile, "ms_per_launch": ms,
                       "us_per_gen": ms / g * 1e3, "words": words})
    out["bosco_depths"] = depths
    out["bosco_fit"] = fit(depths)
    g = cs.DEFAULT_LTL_GENS_PER_CALL
    nn = parse_any("R7,C0,M1,S20..60,B25..50,NN")
    ms = timed_ms(lambda: cs.multi_step_ltl_kernel(p, g * 20, rule=nn), 1) / 20
    out["r7_diamond"] = {"ms_per_launch": ms, "us_per_gen": ms / g * 1e3}
    ext = band_batch(p, MESH_BANDS, bosco.radius * g, Topology.TORUS)
    ms = timed_ms(lambda: cs.slab_step_ltl_kernel(ext, g, rule=bosco), 50)
    out["bosco_slab"] = {"shape": list(ext.shape), "ms_per_launch": ms,
                         "us_per_gen": ms / g * 1e3}
    return True


def time_b3(out, rules, gen) -> bool:
    import torch

    from chip_smoke import MAIN_SHAPE, MESH_BANDS, band_batch, timed_ms
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.stencil import Topology

    first = parse_any(rules[0])
    small = soup_planes(gen, first, (1000, 1056))
    for g in (5, 16):
        if not torch.equal(
                cs.multi_step_generations_kernel(small, 37, rule=first,
                                                 gens_per_call=g),
                cs.multi_step_generations_reference(small, 37, rule=first,
                                                    gens_per_call=g)):
            print("time_ltl_kernel: B3 differs from its plain version",
                  file=sys.stderr)
            return False
    planes = soup_planes(gen, first, MAIN_SHAPE)
    b, H, Wp = planes.shape
    gd = cs.DEFAULT_GENERATIONS_GENS_PER_CALL
    out["g"] = gd
    depths = []
    for g in (1, 4, 16):
        _, th, tw = cs._resolve_generations(b, g, None)
        ms = timed_ms(lambda: cs.multi_step_generations_kernel(
            planes, g * 20, rule=first, gens_per_call=g), 1) / 20
        depths.append({"g": g, "tile": (th, tw), "ms_per_launch": ms,
                       "us_per_gen": ms / g * 1e3,
                       "words": computed_words(H, Wp, th, tw, 1, g, 1)})
    out["depths"] = depths
    out["fit"] = fit(depths)
    ext = band_batch(planes, MESH_BANDS, gd, Topology.TORUS)
    ms = timed_ms(lambda: cs.slab_step_generations_kernel(ext, gd, rule=first), 50)
    out["slab"] = {"rule": rules[0], "shape": list(ext.shape),
                   "ms_per_launch": ms, "us_per_gen": ms / gd * 1e3}
    del ext
    out["rules"] = {}
    for name in rules:
        rule = parse_any(name)
        p = planes if name == rules[0] else soup_planes(gen, rule, MAIN_SHAPE)
        ms = timed_ms(lambda: cs.multi_step_generations_kernel(
            p, gd * 20, rule=rule), 1) / 20
        out["rules"][name] = {"ms_per_launch": ms, "us_per_gen": ms / gd * 1e3}
    return True


def time_b1(out, rules, gen, sweep=()) -> bool:
    import numpy as np
    import torch

    from chip_smoke import MAIN_SHAPE, MESH_BANDS, band_batch, timed_ms
    from gameoflifewithactors_torch.models.rules import parse_rule
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel.batched import \
        multi_step_kernel_batched

    first = parse_rule(rules[0])
    small = soup_words(gen, (1000, 1056))
    for g in (5, 8):
        if not torch.equal(
                cs.multi_step_kernel(small, 37, rule=first, gens_per_call=g),
                cs.multi_step_reference(small, 37, rule=first, gens_per_call=g)):
            print("time_ltl_kernel: B1 differs from its plain version",
                  file=sys.stderr)
            return False
    p = soup_words(gen, MAIN_SHAPE)
    H, Wp = p.shape
    gd = cs.DEFAULT_GENS_PER_CALL
    th, tw = cs.DEFAULT_TILE
    out["g"], out["tile"] = gd, (th, tw)
    depths = []
    for g in (4, 8, 16):
        ms = timed_ms(lambda: cs.multi_step_kernel(
            p, g * 40, rule=first, gens_per_call=g), 1) / 40
        depths.append({"g": g, "tile": (th, tw), "ms_per_launch": ms,
                       "us_per_gen": ms / g * 1e3,
                       "words": computed_words(H, Wp, th, tw, 1, g, 1)})
    out["depths"] = depths
    out["fit"] = fit(depths)
    # the lanes' and the mesh bands' depth (B1's before they had their own)
    gb = getattr(cs, "DEFAULT_BAND_GENS_PER_CALL", gd)
    ext = band_batch(p, MESH_BANDS, gb, Topology.TORUS)
    ms = timed_ms(lambda: cs.slab_step_kernel(ext, gb, rule=first), 50)
    out["slab"] = {"g": gb, "shape": list(ext.shape), "ms_per_launch": ms,
                   "us_per_gen": ms / gb * 1e3}
    del ext
    lane = bitpack.pack((torch.rand((256 * 1024, 1024), generator=gen,
                                    device="cuda") < 0.35).to(torch.uint8)
                        ).view(256, 1024, 32)
    ones = np.ones(256, np.uint32)
    out["lane"] = {"g": gb, "shape": list(lane.shape), "chunk_ms": timed_ms(
        lambda: multi_step_kernel_batched(lane, gb * 20, ones, rule=first),
        1) / 20}
    if hasattr(cs, "multi_step_lane_kernel"):
        for name, tile in [("launch_ms", None), ("launch_28_word_tiles_ms",
                                                  (th, 28))]:
            out["lane"][name] = timed_ms(lambda: cs.multi_step_lane_kernel(
                lane, gb, rule=first, gens_per_call=gb, tile=tile), 50)
    out["rules"] = {}
    for name in rules:
        rule = parse_rule(name)
        ms = timed_ms(lambda: cs.multi_step_kernel(p, gd * 50, rule=rule), 1) / 50
        out["rules"][name] = {"ms_per_launch": ms, "us_per_gen": ms / gd * 1e3}
    out["sweep"], out["lane_sweep"], out["slab_sweep"] = {}, {}, {}
    for g, th, tw in sweep:
        ms = timed_ms(lambda: cs.multi_step_kernel(
            p, g * 40, rule=first, gens_per_call=g, tile=(th, tw)), 1) / 40
        out["sweep"][f"g={g} {th}x{tw}"] = ms / g * 1e3
        if hasattr(cs, "multi_step_lane_kernel") and tw == 28:
            ms = timed_ms(lambda: cs.multi_step_lane_kernel(
                lane, g, rule=first, gens_per_call=g, tile=(th, 32)), 20)
            out["lane_sweep"][f"g={g} {th}x32"] = ms / g * 1e3
        if th == 192:
            ext = band_batch(p, MESH_BANDS, g, Topology.TORUS)
            ms = timed_ms(lambda: cs.slab_step_kernel(ext, g, rule=first,
                                                      tile=(th, tw)), 20)
            out["slab_sweep"][f"g={g} {th}x{tw}"] = ms / g * 1e3
            del ext
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=os.path.join(HERE, ".."))
    ap.add_argument("--kernel", choices=["b4", "b3", "b1"], default="b4")
    ap.add_argument("--rules")
    ap.add_argument("--sweep", default="",
                    help="with --kernel b1: G:THxTW,... configurations to "
                         "time B1 at (and the lane form at TH rows where TW "
                         "is 28, the slab form where TH is 192)")
    ap.add_argument("--variant", choices=["plain-lop3", "constant-rule", "table"])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    rules = (args.rules or {"b1": "B3/S23"}.get(args.kernel, "brain")).split(",")
    sweep = [tuple(int(v) for v in c.replace(":", "x").split("x"))
             for c in args.sweep.split(",") if c]
    import torch

    if not torch.cuda.is_available():
        print("time_ltl_kernel: no CUDA device available", file=sys.stderr)
        return 1
    if args.variant:
        if args.kernel == "b4" or (args.variant == "constant-rule"
                                   and (args.kernel != "b3" or len(rules) != 1)):
            ap.error("--variant takes --kernel b3 or b1 (and constant-rule "
                     "--kernel b3 and one rule)")
        sys.path.insert(0, tree)
        from gameoflifewithactors_torch.models.generations import parse_any
        rule = parse_any(rules[0]) if args.variant == "constant-rule" else None
        del sys.path[0]
        for mod in [m for m in sys.modules if m.startswith(PACKAGE)]:
            del sys.modules[mod]
        tree = os.path.abspath(variant_tree(tree, args.variant, rule))
    sys.path[:0] = [tree, os.path.join(HERE, "..")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"card": card, "tree": tree, "kernel": args.kernel,
           "variant": args.variant}
    ok = {"b3": lambda: time_b3(out, rules, gen),
          "b1": lambda: time_b1(out, rules, gen, sweep),
          "b4": lambda: time_b4(out, gen)}[args.kernel]()
    if not ok:
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
