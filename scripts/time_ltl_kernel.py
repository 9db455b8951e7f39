#!/usr/bin/env python3
"""Times kernel B4 (Larger than Life) of a ``gameoflifewithactors_torch``
tree on one CUDA card, to compare two versions within one run.

    python3 scripts/time_ltl_kernel.py [TREE]

TREE (default: this repository) is a directory holding the package, such
as an unpacked ``git archive`` of another commit; its kernels are built
there at first use. The timer, the shape (16384^2, 50% soup, TORUS) and
the band batch are ``chip_smoke.py``'s. The tree's kernel is first held
against its plain version on Bosco at a small shape. Prints one JSON
line: the card's name and power limit, the tree, and per case the
milliseconds per launch and microseconds per generation:

- Bosco on the full grid at the tree's default tile for g = 1, 2 and 4,
  with the words each launch computes (halo rows and words included), and
  the least-squares line of launch time over those words: its intercept
  is the time per launch that does not grow with the work (loading and
  storing the tiles, the launch, the last wave's tail);
- Bosco on the mesh main path's batch of four halo-extended row bands at
  the tree's default depth;
- the radius-7 diamond R7,C0,M1,S20..60,B25..50,NN on the full grid.

Run it for both trees in turns (A, B, B, A) to see the spread.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def computed_words(H: int, Wp: int, th: int, tw: int, r: int, g: int) -> int:
    """Words one launch computes over all its generations: every
    generation but the last computes the tile's shrinking slab with its
    halo words, the last the tile alone (H and Wp multiples of the tile)."""
    hw = -(-r * g // 32)
    slab = th + 2 * r * g
    per_tile = th * tw + sum((slab - 2 * r * (k + 1)) * (tw + 2 * hw)
                             for k in range(g - 1))
    return per_tile * (H // th) * (Wp // tw)


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(HERE, ".."))
    sys.path[:0] = [tree, os.path.join(HERE, "..")]
    import torch

    if not torch.cuda.is_available():
        print("time_ltl_kernel: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import MAIN_SHAPE, MESH_BANDS, band_batch, timed_ms
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.ops import bitpack
    from gameoflifewithactors_torch.ops import cuda_stencil as cs
    from gameoflifewithactors_torch.ops.stencil import Topology

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bosco = parse_any("bosco")
    small = bitpack.pack((torch.rand((1000, 1056), generator=gen, device="cuda")
                          < 0.5).to(torch.uint8))
    if not torch.equal(cs.multi_step_ltl_kernel(small, 9, rule=bosco),
                       cs.multi_step_ltl_reference(small, 9, rule=bosco)):
        print("time_ltl_kernel: B4 differs from its plain version", file=sys.stderr)
        return 1
    p = bitpack.pack((torch.rand(MAIN_SHAPE, generator=gen, device="cuda")
                      < 0.5).to(torch.uint8))
    H, Wp = p.shape
    out = {"card": card, "tree": tree, "g": cs.DEFAULT_LTL_GENS_PER_CALL}
    tile = tuple(cs.DEFAULT_LTL_TILE)
    depths = []
    for g in (1, 2, 4):
        ms = timed_ms(lambda: cs.multi_step_ltl_kernel(
            p, g * 20, rule=bosco, gens_per_call=g, tile=tile), 1) / 20
        words = computed_words(H, Wp, *tile, bosco.radius, g)
        depths.append({"g": g, "tile": tile, "ms_per_launch": ms,
                       "us_per_gen": ms / g * 1e3, "words": words})
    mx = sum(d["words"] for d in depths) / len(depths)
    my = sum(d["ms_per_launch"] for d in depths) / len(depths)
    slope = sum((d["words"] - mx) * (d["ms_per_launch"] - my) for d in depths) / \
        sum((d["words"] - mx) ** 2 for d in depths)
    out["bosco_depths"] = depths
    out["bosco_fit"] = {"intercept_ms": my - slope * mx,
                        "ns_per_word": slope * 1e6,
                        "residuals_ms": [d["ms_per_launch"] - my - slope *
                                         (d["words"] - mx) for d in depths]}
    g = cs.DEFAULT_LTL_GENS_PER_CALL
    nn = parse_any("R7,C0,M1,S20..60,B25..50,NN")
    ms = timed_ms(lambda: cs.multi_step_ltl_kernel(p, g * 20, rule=nn), 1) / 20
    out["r7_diamond"] = {"ms_per_launch": ms, "us_per_gen": ms / g * 1e3}
    ext = band_batch(p, MESH_BANDS, bosco.radius * g, Topology.TORUS)
    ms = timed_ms(lambda: cs.slab_step_ltl_kernel(ext, g, rule=bosco), 50)
    out["bosco_slab"] = {"shape": list(ext.shape), "ms_per_launch": ms,
                         "us_per_gen": ms / g * 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
