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

    traffic, config = spec.traffic, spec.config
    h, w = traffic["shape"]
    gens = int(traffic["tick_generations"])
    dev = spec.devices[0]
    log = hostspans.SpanLog().start()
    compile_mark = len(obs_compile.COMPILE_LOG.events())

    with log.span("benchmark.build"):
        cells = inputs.soup((h, w), traffic["fill"], spec.seed, dev)
        engine = Engine(cells, config["rule"], topology=Topology.TORUS,
                        backend=traffic.get("backend", "auto"), device=dev)
        del cells
        coord = GridCoordinator.from_engine(engine)
    with log.span("benchmark.warmup_tick"):
        coord.tick(gens)
        engine.block_until_ready()
    start_out = engine.state.clone()
    traced = TracedWindow(spec.devices, log) if spec.trace else None
    if traced is not None:
        with log.span("benchmark.trace_warmup"):
            traced.warm()
    setup_events = [e.to_dict() for e in
                    obs_compile.COMPILE_LOG.events()[compile_mark:]]

    rng = random.Random(spec.seed ^ RESERVOIR_SALT)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = cuda_stencil.launch_counts()
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
        before = engine.state.clone() if keep else None
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
            kept = (ticks, before, engine.state.clone())
        if now - t0 >= spec.seconds:
            break
    t1 = now
    launches1 = cuda_stencil.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    window_spans = log.between(t0, t1)
    setup_spans = log.between(spec.t_process, t0)
    log.stop()
    trace = traced.trace if traced is not None else None

    # the window has closed: free the program's state, then the reference
    words = h * (w // box_rule.WORD)
    del coord, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = check.Reference(config)
    soup = box_rule.pack_cells(
        inputs.soup((h, w), traffic["fill"], spec.seed, dev))
    start_bad = check.compare(reference, soup, start_out, gens)
    del soup, start_out
    tick_index, before, after = kept
    sampled_bad = check.compare(reference, before, after, gens)
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
            "window": {"seconds": t1 - t0, "ticks": ticks,
                       "generations": ticks * gens, "cells": h * w,
                       "launches": {k: launches1[k] - launches0[k]
                                    for k in launches1}},
            "spans": hostspans.summary(window_spans),
            "words": words,
            "trace": trace,
        },
    }
