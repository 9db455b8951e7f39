"""B2's lane form (life_slab on a serving lane): its share of its
roofline over the traced window, counting only the work of the live
slots: the frozen slots' copies are not work the requests need."""

from benchmark import roofline


def read(ctx):
    trace = ctx.get("trace")
    if ctx["driver"] != "sessions" or trace is None:
        return None
    dispatches = trace["counters"]["dispatches"]
    launches = trace["counters"]["launches"]["life_slab"]
    if not dispatches or not launches:
        return None
    words = ctx["words"]
    slot_gens = sum(d["slots"] * d["generations"] for d in dispatches)
    per_dispatch = launches / len(dispatches)
    slot_launches = sum(d["slots"] for d in dispatches) * per_dispatch
    return roofline.share(
        ctx, "life_packed_kernel", launches,
        float(slot_gens) * words * roofline.ops_per_word(ctx),
        float(slot_launches) * 2 * words * 4)
