"""B4 (life_ltl, the Larger than Life kernel): its share of its roofline
over the traced window."""

from benchmark import roofline


def read(ctx):
    if ctx["driver"] != "batch":
        return None
    return roofline.whole_grid(ctx, "ltl_kernel", "life_ltl")
