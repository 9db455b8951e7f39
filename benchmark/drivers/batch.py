"""The batch driver: one universe, ticks back to back through the façade.

Set-up makes the soup from the seed on the card, builds an ``Engine``
(``backend`` from the traffic, ``auto`` by default) wrapped in a
``GridCoordinator``, and runs one tick of ``tick_generations``: it
builds or loads the kernel and is the start that the reference checks
from the soup. The window then runs ``GridCoordinator.tick`` back to
back, each closed by ``engine.block_until_ready()``, as a batch user of
the CLI does, until ``--seconds`` have passed; it spans the host clock
from the first tick's start to the last tick's sync. One tick of the
window, drawn from the seed (reservoir sampling), is kept with the state
before it for the reference. The card's peak memory is read from the
window's start. With ``--trace 1`` the profiled slices open and close
between ticks, where no launch is in flight.

Where the traffic names a ``mesh`` shape, the universe is one torus over
the cell's cards: ``make_mesh`` lays them out, and the engine steps
full-width row bands through B2's band runner, one row exchange of
``gens_per_exchange`` rows a chunk. The kept tick is then each band as
its card holds it, never gathered; the window records the halo bytes the
exchanges moved (``halo.exchanged_bytes``), the band's rows and the chunk
depth; the peak is the fullest card's. The reference steps each band on
its own card with its neighbours' rows around it
(:func:`..check.compare_bands`).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from .. import check, hostspans, inputs
from ..reference import box_rule
from ..trace import TracedWindow

RESERVOIR_SALT = 0x71C4


def run(spec) -> dict:
    from gameoflifewithactors_torch.coordinator import GridCoordinator
    from gameoflifewithactors_torch.engine import Engine
    from gameoflifewithactors_torch.obs import compile as obs_compile
    from gameoflifewithactors_torch.ops import cuda_stencil
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel import halo
    from gameoflifewithactors_torch.parallel.mesh import make_mesh

    traffic, config = spec.traffic, spec.config
    h, w = traffic["shape"]
    gens = int(traffic["tick_generations"])
    dev = spec.devices[0]
    mesh_shape = traffic.get("mesh")
    log = hostspans.SpanLog().start()
    compile_mark = len(obs_compile.COMPILE_LOG.events())

    with log.span("benchmark.build"):
        cells = inputs.soup((h, w), traffic["fill"], spec.seed, dev)
        placement = ({"device": dev} if mesh_shape is None else
                     {"mesh": make_mesh(tuple(mesh_shape), spec.devices),
                      "gens_per_exchange": traffic["gens_per_exchange"]})
        engine = Engine(cells, config["rule"], topology=Topology.TORUS,
                        backend=traffic.get("backend", "auto"), **placement)
        del cells
        coord = GridCoordinator.from_engine(engine)
    warm0 = cuda_stencil.launch_counts()
    with log.span("benchmark.warmup_tick"):
        coord.tick(gens)
        engine.block_until_ready()
    if mesh_shape is not None:
        launched = {k for k, v in cuda_stencil.launch_counts().items()
                    if v != warm0[k]}
        # B2's band runner, whose launches are all life_slab's; the
        # control, the reference in the program's place, launches none
        if engine.backend != "cuda" or launched - {"life_slab"}:
            raise RuntimeError(
                f"the mesh engine stepped on backend {engine.backend!r}, "
                f"launching {sorted(launched)}, not B2's band runner")
    start_out = snapshot(engine)
    traced = TracedWindow(spec.devices, log) if spec.trace else None
    if traced is not None:
        with log.span("benchmark.trace_warmup"):
            traced.warm()
    setup_events = [e.to_dict() for e in
                    obs_compile.COMPILE_LOG.events()[compile_mark:]]

    rng = random.Random(spec.seed ^ RESERVOIR_SALT)
    for d in spec.devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    launches0 = cuda_stencil.launch_counts()
    halo0 = halo.exchanged_bytes()
    ticks = 0
    kept = None
    slice_ticks = 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if (traced is not None and traced.wanted()
                and elapsed >= traffic["trace_skip_seconds"]
                and (traced.attempts == 0 or elapsed
                     + traffic["trace_seconds"] <= spec.seconds)):
            slice_ticks = ticks
            traced.start(cuda_stencil.launch_counts())
        keep = rng.random() * (ticks + 1) < 1.0
        before = snapshot(engine) if keep else None
        with log.span("benchmark.tick"):
            coord.tick(gens)
        with log.span("benchmark.sync"):
            engine.block_until_ready()
        now = time.perf_counter()
        ticks += 1
        if traced is not None and traced.open and (
                now - traced.t_start >= traffic["trace_seconds"]
                or now - t0 >= spec.seconds):
            traced.stop(cuda_stencil.launch_counts())
            got = traced.reduce()
            if got is not None:
                got["counters"]["generations"] = (ticks - slice_ticks) * gens
        if keep:
            kept = (ticks, before, snapshot(engine))
        if now - t0 >= spec.seconds:
            break
    t1 = now
    launches1 = cuda_stencil.launch_counts()
    halo1 = halo.exchanged_bytes()
    peak = max((torch.cuda.max_memory_allocated(d) for d in spec.devices
                if d.type == "cuda"), default=None)
    window_spans = log.between(t0, t1)
    setup_spans = log.between(spec.t_process, t0)
    log.stop()
    trace = traced.trace if traced is not None else None

    # the window has closed: free the program's state, then the reference.
    # ``words``: the 32-cell words of one plane
    words = h * (w // box_rule.WORD)
    window = {"seconds": t1 - t0, "ticks": ticks,
              "generations": ticks * gens, "cells": h * w,
              "launches": {k: launches1[k] - launches0[k]
                           for k in launches1}}
    if mesh_shape is not None:
        window.update(exchanged_bytes=halo1 - halo0,
                      band_rows=h // engine.mesh.size,
                      gens_per_exchange=engine.gens_per_exchange)
    del coord, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = check.Reference(config)
    soup = reference.encode(
        inputs.soup((h, w), traffic["fill"], spec.seed, dev))
    tick_index, before, after = kept
    if mesh_shape is None:
        start_bad = check.compare(reference, soup, start_out, gens)
        del soup, start_out
        sampled_bad = check.compare(reference, before, after, gens)
    else:
        radius = config["neighbourhood"]["radius"]
        start_bad = check.compare_bands(
            reference, list(soup.split(h // len(start_out), dim=-2)),
            start_out, gens, radius)
        del soup, start_out
        sampled_bad = check.compare_bands(reference, before, after, gens,
                                          radius)
    spec.note(f"checked the start tick and window tick {tick_index} of "
              f"{ticks} in {time.perf_counter() - t_ref:.3f} s")
    checks = {"start_mismatched_cells": (start_bad, check.LIMIT),
              "tick_mismatched_cells": (sampled_bad, check.LIMIT)}

    return {
        "attempted": ticks,
        "failed": 0,
        "checks": checks,
        "memory_peak_bytes": peak,
        "trace": trace,
        "ctx": {
            "driver": "batch",
            "setup_s": t0 - spec.t_process,
            "setup_spans": hostspans.summary(setup_spans),
            "setup_compile_events": setup_events,
            "window": window,
            "spans": hostspans.summary(window_spans),
            "words": words,
            "planes": reference.planes,
            "trace": trace,
        },
    }


def snapshot(engine):
    """A copy of the engine's state where it lies: one tensor on the card,
    or on a mesh each band on its own card, in order down the torus."""
    if engine.mesh is None:
        return engine.state.clone()
    return [band.clone() for band in engine.sharded_state.blocks()]
