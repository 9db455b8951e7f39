"""The runner contract gate: prove runner invariants from what one call does.

Counterpart of ``gameoflifewithactors_tpu.analysis.contracts``. There, each
registered runner is lowered to HLO and its compiled text is read; here
there is no compiler to ask, so each registered runner
(:mod:`..ops._builders`) is built on its example, called once to warm
(kernel builds, caches), then called once more on the first call's
result under ``torch.profiler``, and that call is held to:

- **host syncs** -- the ``aten::_local_scalar_dense`` (under ``int()``,
  ``bool()``, ``.item()``) and ``aten::nonzero`` ops of the call, and on
  CUDA its ``Memcpy DtoH`` copies (which also catch ``.cpu()``,
  ``.tolist()`` and ``.numpy()``, invisible to the CPU profiler). The
  count is 0 unless the builder declares a budget with a reason.
- **in place** -- whether the call wrote its arguments (clone before,
  compare after) equals what the builder declares: the torch form of
  "donation applied".
- **halo bytes** -- the change of :func:`..parallel.halo.exchanged_bytes`
  over the call equals the closed-form model (``ghost_exchange_bytes``,
  ``deep_exchange_bytes``) exactly for the communication-avoiding
  runners; the other runners' bytes are pinned.
- **gathers** -- index and gather ops of the call; the paged runner must
  have some (its halos come from the page table).
- **kernel launches** (CUDA only) -- the launches of each kernel of
  :mod:`..ops.cuda_stencil` (its wrappers' counters) and of every other
  kernel (the profiler's kernel events beyond those). A runner tagged
  ``cuda`` launches ``ceil(n/g)`` of its own kernel and no other.

Measurements without a closed form are pinned in
``contracts_manifest.json`` beside this module, one section per
platform, each stamped with the torch version that wrote it. A section
pinned under another torch version gates as **"skipped (stale)"**, never
"ok", while the invariants above stay enforced; a ``cuda`` runner on the
CPU reads **"needs CUDA"**, never "ok". Failures name the runner.

The tracer now and then drops records. On the card each measured call's
trace is held whole first: the card's records in the range (kernels,
copies, fills) must account for the host's launch, copy and fill calls
in it. A call whose trace falls short is measured again from a fresh
build, ``TRACE_ATTEMPTS`` calls in all, and the runner fails if none
was whole; a whole trace after a lost one shows as ``traces=N``.

The fault-injection seam: ``GOLTPU_CONTRACT_INJECT=<name>`` makes that
runner's measured call run one extra row exchange, and the gate must fail
naming it. The CLI::

    python -m gameoflifewithactors_torch.analysis.contracts [--strict]
        [--only NAME] [--write] [--device cuda|cpu] [--manifest PATH]

runs on the card unless ``--device cpu`` is given; it exits 0 for ok or
stale, 1 for a violation, 2 for bad input.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "contracts_manifest.json")
ENV_INJECT = "GOLTPU_CONTRACT_INJECT"

_SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero")
_GATHER_OPS = ("aten::index", "aten::gather", "aten::index_select",
               "aten::take")
# the wrappers' launch counters of ops/cuda_stencil.py, one per kernel form
KERNEL_COUNTERS = ("KERNEL_LAUNCHES", "SLAB_LAUNCHES", "GENERATIONS_LAUNCHES",
                   "GENERATIONS_SLAB_LAUNCHES", "LTL_LAUNCHES",
                   "LTL_SLAB_LAUNCHES")
# the kernels of csrc/ as the profiler names them (B1 and B2 share a body)
OWN_KERNELS = ("life_packed_kernel", "life_generations_kernel", "ltl_kernel")


@dataclasses.dataclass
class RunnerContracts:
    """One runner's measured facts plus its invariant violations."""

    name: str
    tags: tuple
    platform: str
    ran: bool = True               # False: a cuda runner on the CPU
    host_syncs: int = 0
    sync_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    sync_budget: int = 0
    sync_reason: str = ""
    in_place: bool = False
    in_place_declared: bool = False
    halo_bytes: int = 0
    expected_halo_bytes: Optional[int] = None
    halo_model: str = ""
    gathers: int = 0
    require_gather: bool = False
    launches: Optional[Dict[str, int]] = None   # CUDA: counter -> launches
    profiled: Optional[int] = None      # CUDA: those launches the profiler saw
    traces: int = 1                     # profiled calls until one was whole
    other_kernels: Optional[int] = None         # CUDA: every other kernel
    errors: List[str] = dataclasses.field(default_factory=list)

    def to_manifest_entry(self) -> dict:
        return {
            "tags": list(self.tags),
            "host_syncs": self.host_syncs,
            "sync_budget": self.sync_budget,
            "in_place": self.in_place,
            "halo_bytes": self.halo_bytes,
            "expected_halo_bytes": self.expected_halo_bytes,
            "halo_model": self.halo_model,
            "gathers": self.gathers,
            "require_gather": self.require_gather,
            "launches": self.launches,
            "other_kernels": self.other_kernels,
        }

    def summary(self) -> str:
        out = (f"syncs={self.host_syncs} in_place={self.in_place} "
               f"halo_bytes={self.halo_bytes} gathers={self.gathers}")
        if self.halo_model:
            out += f" model={self.halo_model}"
        if self.launches is not None:
            out += f" launches={self.launches} other_kernels=" \
                   f"{self.other_kernels}"
        if self.traces > 1:
            out += f" traces={self.traces}"
        return out


def load_registry() -> Dict[str, object]:
    """Import every builder module so ``BUILDERS`` is fully populated,
    and return it."""
    from ..memory import pool  # noqa: F401  (register on import)
    from ..ops import cuda_stencil, packed, stencil  # noqa: F401
    from ..ops._builders import BUILDERS
    from ..parallel import batched, sharded  # noqa: F401

    return BUILDERS


def _tensors(obj) -> list:
    """The tensors inside a runner's arguments (a ShardedGrid's parts)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    parts = getattr(obj, "parts", None)
    return list(parts) if parts is not None else []


def _next_args(built, out, args) -> tuple:
    if built.chain is not None:
        return tuple(built.chain(out, args))
    return (out,) + tuple(args[1:])


def _with_injected_exchange(runner):
    """The runner with one extra one-row exchange of its output grid per
    call: the seam the fails-closed test uses."""
    from ..ops.stencil import Topology
    from ..parallel.halo import exchange_rows

    def run(*args):
        out = runner(*args)
        grid = out[0] if isinstance(out, tuple) else out
        if getattr(grid, "mesh", None) is None:
            raise ValueError(
                "contract injection needs a runner whose output is placed "
                "on a mesh; this runner has no injection seam")
        exchange_rows(grid.parts, grid.mesh, Topology.TORUS, depth=1)
        return out

    return run


_MEASURED = "goltpu.contract.measured_call"


def _on_card(event) -> bool:
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def _in_range(events) -> list:
    """The profiler's events inside the measured call's range: host events
    inside its host range; device events inside its device range (the
    span of the device work launched from it), where the card's
    timestamps need not line up with the host's."""
    marks = {card: [e for e in events
                    if e.name == _MEASURED and _on_card(e) == card]
             for card in (False, True)}
    if len(marks[False]) != 1 or len(marks[True]) > 1:
        raise RuntimeError(f"expected one {_MEASURED} range, found "
                           f"{len(marks[False])} on the host, "
                           f"{len(marks[True])} on the card")
    out = []
    for e in events:
        mark = marks[_on_card(e)]
        if e.name != _MEASURED and mark and mark[0].time_range.start <= \
                e.time_range.start <= mark[0].time_range.end:
            out.append(e)
    return out


def _counters(cs) -> Dict[str, int]:
    return {k: getattr(cs, k) for k in KERNEL_COUNTERS}


# the host-side CUDA calls that each leave one record on the card: a
# kernel launch, a copy or a fill
_DEVICE_WORK_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                      "cudaMemset")
# profiled calls of one runner before its trace counts as lost
TRACE_ATTEMPTS = 3


def _measure(spec, device, inject: bool):
    """Build the runner, warm it, and run the measured call under the
    profiler. Returns the built runner, the events of the measured range,
    the facts of the call and, on the card, ``(calls, records)``: the host's kernel-launch, copy and fill
    calls in the measured range and the card's records of them. A trace
    whose records fall short of its calls lost records (the tracer drops
    some, now and then) and says nothing about the runner."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..ops import cuda_stencil as cs
    from ..parallel.halo import exchanged_bytes

    built = spec.factory(device)
    runner = _with_injected_exchange(built.runner) if inject \
        else built.runner
    args = tuple(built.example_args)
    args = _next_args(built, runner(*args), args)
    before = [t.clone() for t in _tensors(args)]
    held = _tensors(args)
    counters = _counters(cs)
    bytes0 = exchanged_bytes()
    activities = [ProfilerActivity.CPU]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        # the tracer's first moments can drop kernel records: fence work
        # first, then only what lies inside the measured range counts
        fence = torch.zeros(256, device=device)
        for _ in range(8):
            fence.add_(1)
        if on_card:
            torch.cuda.synchronize(device)
        with record_function(_MEASURED):
            runner(*args)
            if on_card:
                torch.cuda.synchronize(device)
    events = _in_range(prof.events())
    facts = {
        "halo_bytes": exchanged_bytes() - bytes0,
        "in_place": any(not torch.equal(t, c) for t, c in zip(held, before)),
        "launches": {k: v - counters[k] for k, v in _counters(cs).items()
                     if v != counters[k]},
    }
    trace = None
    if on_card:
        trace = (sum(not _on_card(e) and e.name.startswith(_DEVICE_WORK_CALLS)
                     for e in events),
                 sum(_on_card(e) for e in events))
    return built, events, facts, trace


def check_runner(spec, device, *, inject: bool = False) -> RunnerContracts:
    """Build one registered runner on ``device``, run its example twice
    (warm, measured) and return the measured call's facts with every
    invariant violation spelled out (each leads with the runner name).
    On the card a measured call whose trace lost records is measured
    again from a fresh build, up to ``TRACE_ATTEMPTS`` calls in all."""
    import torch

    device = torch.device(device)
    platform = device.type
    res = RunnerContracts(name=spec.name, tags=tuple(spec.tags),
                          platform=platform)
    if "cuda" in spec.tags and platform != "cuda":
        res.ran = False
        return res
    lost = []       # (calls, records) of each trace that lost records
    for res.traces in range(1, TRACE_ATTEMPTS + 1):
        built, events, facts, trace = _measure(spec, device, inject)
        if trace is None or trace[1] >= trace[0]:
            break
        lost.append(trace)
    res.halo_bytes = facts["halo_bytes"]
    res.in_place = facts["in_place"]
    res.in_place_declared = bool(built.in_place)
    names: Dict[str, int] = {}
    own = other = 0
    for e in events:
        if _on_card(e) and not e.name.startswith(("Memcpy", "Memset")):
            if any(k in e.name for k in OWN_KERNELS):
                own += 1
            else:
                other += 1
        names[e.name] = names.get(e.name, 0) + 1
    dtoh = sum(v for k, v in names.items() if k.startswith("Memcpy DtoH"))
    res.sync_ops = {k: names.get(k, 0) for k in
                    ("aten::item",) + _SYNC_OPS}
    res.sync_ops["Memcpy DtoH"] = dtoh
    # on the card every device-to-host read is one DtoH copy; the CPU
    # profiler sees only the scalar reads and nonzero
    res.host_syncs = dtoh if platform == "cuda" else sum(
        names.get(k, 0) for k in _SYNC_OPS)
    res.sync_budget, res.sync_reason = built.host_syncs, \
        built.host_sync_reason
    res.gathers = sum(names.get(k, 0) for k in _GATHER_OPS)
    res.require_gather = built.require_gather
    res.expected_halo_bytes = built.expected_halo_bytes
    res.halo_model = built.halo_model
    if platform == "cuda":
        res.launches = facts["launches"]
        res.profiled, res.other_kernels = own, other

    err = res.errors.append
    if len(lost) == TRACE_ATTEMPTS:
        err(f"{spec.name}: the profiler lost records in each of "
            f"{TRACE_ATTEMPTS} measured calls (the card recorded "
            + ", ".join(f"{r} of {c}" for c, r in lost)
            + " kernel launches, copies and fills): nothing was measured")
        return res
    if res.host_syncs > res.sync_budget:
        err(f"{spec.name}: {res.host_syncs} host sync(s) in one call "
            f"({res.sync_ops}), budget {res.sync_budget}"
            + (f" ({res.sync_reason})" if res.sync_reason
               else ": a runner's dispatch must not read the device back"))
    if res.in_place != res.in_place_declared:
        err(f"{spec.name}: the call "
            + ("wrote" if res.in_place else "did not write")
            + " its arguments in place, but the runner declares "
            + ("in-place stepping" if res.in_place_declared
               else "none (@steps_in_place)"))
    if res.expected_halo_bytes is not None and \
            res.halo_bytes != res.expected_halo_bytes:
        err(f"{spec.name}: halo bytes {res.halo_bytes} != closed-form "
            f"{res.expected_halo_bytes} ({res.halo_model or 'model'})")
    if res.require_gather and res.gathers == 0:
        err(f"{spec.name}: no index or gather op in the call: the paged "
            "runner resolves its halos through the page table")
    if built.kernel is not None and platform == "cuda":
        want = {built.kernel: built.launches}
        if res.launches != want:
            err(f"{spec.name}: launched {res.launches}, expected {want} "
                "(ceil(n/g) of its own kernel)")
        if res.other_kernels != 0:
            err(f"{spec.name}: {res.other_kernels} launch(es) of other "
                "kernels (a plain-torch pass on the card)")
    if res.launches is not None and res.profiled != sum(
            res.launches.values()):
        err(f"{spec.name}: the profiler saw {res.profiled} launch(es) of "
            f"the port's kernels, the wrappers counted {res.launches}")
    return res


def check_all(device, only: Optional[Sequence[str]] = None,
              inject: Optional[str] = None) -> List[RunnerContracts]:
    """Check every registered runner (or the ``only`` subset) on
    ``device``, in name order. ``inject`` names one runner to run through
    the fault-injection seam."""
    registry = load_registry()
    names = sorted(registry)
    if only:
        unknown = [n for n in only if n not in registry]
        if unknown:
            raise KeyError(
                f"unknown runner(s) {unknown}; registered: {names}")
        names = sorted(only)
    return [check_runner(registry[n], device, inject=(n == inject))
            for n in names]


# -- the manifest --------------------------------------------------------------


def torch_version() -> str:
    import torch

    return torch.__version__


def load_manifest(path: str = MANIFEST_PATH) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or not isinstance(
            data.get("platforms", {}), dict):
        raise ValueError(f"{path}: expected {{'platforms': {{...}}}}")
    return data


def updated_manifest(frozen: Optional[dict],
                     results: Sequence[RunnerContracts],
                     platform: str, *, merge: bool = False) -> dict:
    """``frozen`` with this platform's section replaced by ``results``
    (``merge``: updated by them), the other platforms' sections kept."""
    import torch

    doc = dict(frozen or {})
    doc["generated_by"] = ("python -m gameoflifewithactors_torch.analysis."
                           "contracts --write")
    platforms = dict(doc.get("platforms", {}))
    runners = dict(platforms.get(platform, {}).get("runners", {})) \
        if merge else {}
    runners.update({r.name: r.to_manifest_entry() for r in results if r.ran})
    section = {"torch": torch_version(), "runners": runners}
    if platform == "cuda":
        section["device"] = torch.cuda.get_device_name(0)
    platforms[platform] = section
    doc["platforms"] = platforms
    return doc


def write_manifest(manifest: dict, path: str = MANIFEST_PATH) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")


_PINNED = ("host_syncs", "in_place", "halo_bytes", "gathers", "launches",
           "other_kernels")


def gate(results: Sequence[RunnerContracts], frozen: Optional[dict],
         platform: str, *, strict: bool = False,
         complete: bool = True) -> List[str]:
    """Per-runner status lines: ``ok NAME (...)``, ``skipped (stale)
    NAME: ...``, ``needs CUDA NAME: ...``, ``unpinned NAME (...)`` or
    ``FAIL NAME: reason``. The invariants fail whatever the manifest;
    pinned values are compared only against a section written under this
    torch version. ``strict`` fails runners the section does not pin."""
    section = ((frozen or {}).get("platforms") or {}).get(platform)
    pinned = (section or {}).get("runners", {})
    fresh = section is not None and section.get("torch") == torch_version()
    lines: List[str] = []
    for r in results:
        if not r.ran:
            lines.append(f"needs CUDA {r.name}: a kernel runner, held on "
                         "the card only (--device cuda)")
            continue
        for e in r.errors:
            lines.append(f"FAIL {e}")
        if r.errors:
            continue
        entry = pinned.get(r.name)
        if entry is None:
            if strict:
                lines.append(
                    f"FAIL {r.name}: not pinned in the {platform} manifest "
                    "-- regenerate with --write and review the diff")
            else:
                lines.append(f"unpinned {r.name} ({r.summary()})")
            continue
        if not fresh:
            lines.append(
                f"skipped (stale) {r.name}: the {platform} manifest was "
                f"pinned under torch {section.get('torch', '<unknown>')}, "
                f"running {torch_version()} -- invariants enforced, pinned "
                "values not comparable; regenerate with --write")
            continue
        got = r.to_manifest_entry()
        diff = [f"{k} {got[k]!r} != pinned {entry.get(k)!r}"
                for k in _PINNED if got[k] != entry.get(k)]
        if diff:
            lines.append(f"FAIL {r.name}: " + "; ".join(diff))
            continue
        lines.append(f"ok {r.name} ({r.summary()})")
    # a runner the manifest pins but the registry lost is a contract
    # silently un-proved
    have = {r.name for r in results}
    for name in sorted(set(pinned) - have) if complete else ():
        lines.append(
            f"FAIL {name}: pinned in the {platform} manifest but no longer "
            "registered -- if it was removed on purpose, regenerate with "
            "--write")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI: 0 ok or stale, 1 a violation, 2 bad input."""
    import argparse
    import sys

    import torch

    ap = argparse.ArgumentParser(
        prog="python -m gameoflifewithactors_torch.analysis.contracts",
        description="hold every registered runner to its contracts (host "
                    "syncs, in place, halo bytes, gathers, kernel "
                    "launches)")
    ap.add_argument("--strict", action="store_true",
                    help="fail runners the manifest does not pin")
    ap.add_argument("--only", action="append", default=[], metavar="NAME",
                    help="check only this runner (repeatable)")
    ap.add_argument("--write", action="store_true",
                    help="pin this platform's measurements in the manifest")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runners run (default: the card)")
    ap.add_argument("--manifest", default=MANIFEST_PATH, metavar="PATH",
                    help="the manifest to gate against (and --write)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("contracts: no CUDA device is available; pass --device cpu "
              "to hold the runners on the CPU", file=sys.stderr)
        return 2
    try:
        frozen = load_manifest(args.manifest)
    except (OSError, ValueError) as exc:
        print(f"contracts: unusable manifest: {exc}", file=sys.stderr)
        return 2
    inject = os.environ.get(ENV_INJECT) or None
    try:
        results = check_all(args.device, only=args.only or None,
                            inject=inject)
    except KeyError as exc:
        print(f"contracts: {exc.args[0]}", file=sys.stderr)
        return 2
    lines = gate(results, frozen, args.device, strict=args.strict,
                 complete=not args.only)
    for line in lines:
        print(line)
    failed = any(line.startswith("FAIL") for line in lines)
    if args.write:
        if any(r.errors for r in results):
            print("contracts: invariant violations; manifest not written",
                  file=sys.stderr)
            return 1
        write_manifest(updated_manifest(frozen, results, args.device,
                                        merge=bool(args.only)),
                       args.manifest)
        print(f"contracts: pinned {sum(r.ran for r in results)} runner(s) "
              f"under torch {torch_version()} ({args.device}) in "
              f"{args.manifest}")
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
