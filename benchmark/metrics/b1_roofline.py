"""B1 (life_packed, the single-card B/S kernel): its share of its
roofline over the traced window."""

from benchmark import roofline


def read(ctx):
    if ctx["driver"] != "batch":
        return None
    return roofline.whole_grid(ctx, "life_packed_kernel", "life_packed")
