"""B2's slab form (life_slab stepping a mesh's row bands): its share of
its roofline over the traced window. The operations are the traced
generations of the whole grid; the bytes are one halo-extended band read
and written per launch (a (4, 1) mesh over four cards launches one band
per card and chunk), not the whole grid."""

from benchmark import roofline


def read(ctx):
    trace, w = ctx.get("trace"), ctx.get("window") or {}
    if (ctx["driver"] != "batch" or trace is None or "band_rows" not in w
            or "generations" not in trace.get("counters", {})):
        return None
    c = trace["counters"]
    launches = c["launches"].get("life_slab", 0)
    radius = ctx["config"]["neighbourhood"]["radius"]
    rows = w["band_rows"] + 2 * radius * w["gens_per_exchange"]
    band_words = rows * (ctx["traffic"]["shape"][1] // 32)
    return roofline.share(
        ctx, "life_packed_kernel", launches,
        float(c["generations"]) * ctx["words"] * roofline.ops_per_word(ctx),
        float(launches) * 2 * band_words * 4)
