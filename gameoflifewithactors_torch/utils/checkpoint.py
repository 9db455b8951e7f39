"""Checkpoint/resume: exact simulation state, single-file or sharded.

Counterpart of ``gameoflifewithactors_tpu.utils.checkpoint``, with its
on-disk formats exactly: a file either package writes loads in the other.
The whole simulation state is (packed grid, rule, topology, generation),
so save is one device->host transfer of 1 bit/cell and resume is
bit-exact. Files are self-describing, so a checkpoint reloads onto a
different mesh, backend or device than it was saved from (sharding is an
execution detail, not simulation state).

Two on-disk families:

- **single-file** (:func:`save` / :func:`load_grid` / :func:`load_engine`):
  one NPZ holding the whole grid. Internal NPZ versions 1-3 all load.
  Packed words go to disk as uint32 by a view of the int32 words (no
  arithmetic) and come back through :func:`..utils.interop.state_from_numpy`.
- **sharded v2** (:func:`write_shards` / :func:`commit_manifest` /
  :func:`load_sharded`): a per-generation *directory* where each process
  writes only the shards it owns (:func:`..parallel.multihost.local_shards`),
  each with a CRC32, committed atomically by a ``MANIFEST.json`` rename.
  Restore verifies every checksum and refuses torn or corrupt shards
  (:class:`CheckpointCorruptError`); :func:`load_latest_verified` falls
  back generation by generation to the newest *complete* one.

Any unreadable checkpoint -- truncated zip, corrupt member, bad metadata
-- surfaces as :class:`CheckpointCorruptError` (a ``ValueError``), never a
raw ``zipfile``/``zlib`` traceback, so recovery layers can treat
"checkpoint rotted" as a routine fall-back-to-previous event.

The paged form (:func:`save_paged` / :func:`load_paged`, format
``"paged1"``) stores a paged grid's bound pages: their tile coordinates
and words, never a dense detour. Slot ids follow the JAX package's
allocator, so a file either package writes loads in the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import zipfile
import zlib
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..engine import Engine
from ..models.generations import parse_any
from ..ops import bitpack
from ..ops.packed_generations import unpack_generations_np
from ..ops.stencil import Topology
from ..parallel.mesh import Mesh
from .interop import paged_grid_from_numpy, state_to_numpy

FORMAT_VERSION = 3  # v3 adds device-layout checkpoints (no dense detour)
_READABLE_VERSIONS = (1, 2, 3)  # older files load unchanged
_PACKED_LAYOUTS = ("packed32", "genplanes32")  # words, plane stacks


class CheckpointCorruptError(ValueError):
    """A checkpoint exists but cannot be trusted: truncated archive,
    CRC mismatch, missing shard, or undecodable metadata. Subclasses
    ``ValueError`` so ``except ValueError`` call sites keep working;
    recovery layers catch it specifically and fall back to the previous
    checkpoint instead of dying on a raw ``zipfile``/``zlib`` error."""


@contextlib.contextmanager
def _unreadable_as_corrupt(path: Path) -> Iterator[None]:
    """Map every failure mode of reading an on-disk NPZ to
    :class:`CheckpointCorruptError`; a missing file stays
    ``FileNotFoundError`` (absence is not damage)."""
    try:
        yield
    except (FileNotFoundError, CheckpointCorruptError):
        raise
    except (zipfile.BadZipFile, zlib.error, ValueError, KeyError, OSError,
            EOFError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable "
            f"({type(exc).__name__}: {exc})") from exc


def _write_atomically(path: Path, write) -> None:
    """``write(f)`` into a pid-qualified temp file beside ``path``, then
    ``os.replace`` it into place: a crash mid-write never leaves a torn
    file where a whole one used to be, and two processes writing the same
    path never interleave."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def save(engine: Engine, path: "str | Path") -> Path:
    """Write the engine's exact state; returns the path written.

    Packed engines (binary words and multi-state bit-plane stacks) save
    their device layout directly -- the v3 "packed32"/"genplanes32"
    layouts -- so no dense copy is materialised: a 16384² universe moves
    32 MiB of words, not a 256 MiB byte grid. Byte-layout engines keep the
    v1 (packbits) / v2 (multistate cells) forms. A mesh engine saves its
    gathered state. All versions reload onto any mesh/backend/device.
    Crash-safe: temp file + ``os.replace``.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    base = dict(
        rule=engine.rule.notation,
        topology=engine.topology.value,
        generation=engine.generation,
        shape=list(engine.shape),
    )
    layout = engine._layout
    if layout == "words":
        meta = dict(version=FORMAT_VERSION, layout="packed32",
                    multistate=False, **base)
        arrays = dict(words=state_to_numpy(engine.state))
    elif layout == "planes":
        meta = dict(version=FORMAT_VERSION, layout="genplanes32",
                    multistate=True, **base)
        arrays = dict(planes=state_to_numpy(engine.state))
    else:
        grid = engine.snapshot()
        multistate = bool(grid.max(initial=0) > 1)  # Generations states
        # byte-layout files keep their historical stamps (v1 binary
        # packbits / v2 multistate cells) so old readers still load them
        meta = dict(version=2 if multistate else 1, multistate=multistate,
                    **base)
        arrays = (dict(cells=grid) if multistate
                  else dict(bits=np.packbits(grid, axis=1)))
    _write_atomically(path, lambda f: np.savez_compressed(
        f, **arrays, meta=json.dumps(meta)))
    return path


def _read(path: Path) -> Tuple[dict, np.ndarray]:
    """(meta, the stored array as it is on disk) of a single-file
    checkpoint; call inside :func:`_unreadable_as_corrupt`."""
    with np.load(path, allow_pickle=False) as z:
        if "meta" not in z:
            raise CheckpointCorruptError(
                f"checkpoint {path} has no 'meta' member — not a "
                "goltpu checkpoint or a torn write")
        meta = json.loads(str(z["meta"]))
        if meta.get("version") not in _READABLE_VERSIONS:
            raise CheckpointCorruptError(
                f"unsupported checkpoint version "
                f"{meta.get('version')!r} in {path}")
        layout = meta.get("layout")
        if layout == "packed32":
            raw = np.asarray(z["words"], dtype=np.uint32)
        elif layout == "genplanes32":
            raw = np.asarray(z["planes"], dtype=np.uint32)
        elif meta.get("multistate"):
            raw = np.asarray(z["cells"], dtype=np.uint8)
        else:
            raw = np.asarray(z["bits"])
    return meta, raw


def _decode(meta: dict, raw: np.ndarray) -> np.ndarray:
    """The dense (H, W) uint8 grid of a stored array."""
    w = meta["shape"][1]
    layout = meta.get("layout")
    if layout == "packed32":
        return bitpack.unpack_np(raw)[:, :w]
    if layout == "genplanes32":
        return unpack_generations_np(raw)[:, :w]
    if meta.get("multistate"):
        return raw
    return np.unpackbits(raw, axis=1)[:, :w].astype(np.uint8)


def load_grid(path: "str | Path") -> Tuple[np.ndarray, dict]:
    """Read (grid, metadata) from a checkpoint without building an engine.

    A missing file stays ``FileNotFoundError``; every other failure mode
    of an on-disk NPZ raises :class:`CheckpointCorruptError`."""
    path = Path(path)
    with _unreadable_as_corrupt(path):
        meta, raw = _read(path)
        grid = _decode(meta, raw)
    return grid, meta


def load_engine(
    path: "str | Path",
    *,
    mesh: Optional[Mesh] = None,
    backend: str = "auto",
    device=None,
) -> Engine:
    """Rebuild an Engine bit-exactly from a checkpoint onto any mesh,
    backend and device (``"cuda"`` unless the caller asks for the CPU).
    Packed layouts go straight to :meth:`Engine.from_packed`, with no
    dense detour."""
    path = Path(path)
    with _unreadable_as_corrupt(path):
        meta, raw = _read(path)
        h, w = meta["shape"]
        rule = parse_any(meta["rule"])
        topology = Topology(meta["topology"])
        generation = int(meta["generation"])
        packed = (meta.get("layout") in _PACKED_LAYOUTS
                  and raw.shape[-2:] == (h, w // bitpack.WORD)
                  and w % bitpack.WORD == 0)
        grid = None if packed else _decode(meta, raw)
    if packed:
        engine = Engine.from_packed(raw, rule, topology=topology,
                                    backend=backend, device=device, mesh=mesh)
    else:
        engine = Engine(grid, rule, topology=topology, backend=backend,
                        device=device, mesh=mesh)
    engine.generation = generation
    return engine


PAGED_FORMAT = "paged1"


def save_paged(grid, path: "str | Path") -> Path:
    """Checkpoint a paged grid (:mod:`..memory.paged`) in its sparse form:
    the bound pages' coordinates and tile words, never a dense detour (an
    unbounded glider a million tiles out saves as its handful of pages).
    Accepts a :class:`~..memory.PagedGrid` or anything carrying one as
    ``.grid`` (:class:`~..memory.PagedUniverse`). Crash-safe like
    :func:`save`; the file is the JAX package's ``paged1``."""
    grid = getattr(grid, "grid", grid)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pool = grid.pool
    host = pool.tiles_host()
    coords = sorted(grid.pages)
    tiles = (np.stack([host[grid.pages[c]] for c in coords])
             if coords else
             np.zeros((0, pool.planes, pool.tile_rows, pool.tile_words),
                      np.uint32))
    meta = dict(
        format=PAGED_FORMAT,
        rule=pool.rule.notation,
        topology=grid.topology.value,
        bounds=list(grid.bounds) if grid.bounds is not None else None,
        planes=pool.planes,
        tile_rows=pool.tile_rows,
        tile_words=pool.tile_words,
        generation=grid.generation,
        active=sorted([int(y), int(x)] for y, x in grid.active),
    )
    _write_atomically(path, lambda f: np.savez_compressed(
        f, coords=np.asarray(coords, np.int64).reshape(-1, 2),
        tiles=tiles, meta=json.dumps(meta)))
    return path


def load_paged(path: "str | Path", *, pool=None,
               capacity: Optional[int] = None, registry=None, device=None):
    """Rebuild a paged grid bit-exactly from a :func:`save_paged` file
    (either package's): returns ``(grid, meta)``. Pages re-allocate into
    ``pool`` (which must match the checkpoint's slab geometry) or into a
    fresh pool on ``device`` (``"cuda"`` unless the caller asks for the
    CPU) sized ``capacity`` (default: twice the page count plus one, at
    least 16). Unreadable files raise :class:`CheckpointCorruptError`."""
    path = Path(path)
    with _unreadable_as_corrupt(path):
        with np.load(path, allow_pickle=False) as z:
            if "meta" not in z:
                raise CheckpointCorruptError(
                    f"checkpoint {path} has no 'meta' member — not a "
                    "goltpu checkpoint or a torn write")
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != PAGED_FORMAT:
                raise CheckpointCorruptError(
                    f"{path} is not a paged checkpoint "
                    f"(format={meta.get('format')!r})")
            coords = np.asarray(z["coords"], np.int64)
            tiles = np.asarray(z["tiles"], np.uint32)
            if tiles.shape != (len(coords), meta["planes"],
                               meta["tile_rows"], meta["tile_words"]):
                raise CheckpointCorruptError(
                    f"{path}: tiles shape {tiles.shape} does not match "
                    f"{len(coords)} pages of the declared slab geometry")
    rule = parse_any(meta["rule"])
    if pool is not None and (pool.planes != meta["planes"]
                             or pool.tile_rows != meta["tile_rows"]
                             or pool.tile_words != meta["tile_words"]):
        raise ValueError(
            f"pool slab ({pool.planes}, {pool.tile_rows}, "
            f"{pool.tile_words}) does not match checkpoint "
            f"({meta['planes']}, {meta['tile_rows']}, {meta['tile_words']})")
    grid = paged_grid_from_numpy(
        coords, tiles, rule, topology=Topology(meta["topology"]),
        bounds=meta["bounds"], tile_rows=meta["tile_rows"],
        tile_words=meta["tile_words"], active=meta["active"],
        generation=meta["generation"], pool=pool, capacity=capacity,
        registry=registry, device=device)
    return grid, meta


def rotate_previous(path: "str | Path", suffix: str = ".prev") -> Optional[Path]:
    """Publish the current checkpoint at ``path`` as ``path + suffix``
    (atomically) so the next :func:`save` can overwrite ``path`` without
    destroying the last restore point. Hard-links where the filesystem
    allows (zero-copy), copies otherwise; a crash at any instant leaves
    both names pointing at *complete* files. Returns the previous-path,
    or None when ``path`` does not exist yet."""
    path = Path(path)
    if not path.exists():
        return None
    prev = path.with_name(path.name + suffix)
    tmp = path.with_name(f"{path.name}{suffix}.tmp{os.getpid()}")
    with contextlib.suppress(OSError):
        os.unlink(tmp)
    try:
        os.link(path, tmp)
    except OSError:  # cross-device / no-hardlink filesystem
        shutil.copyfile(path, tmp)
    os.replace(tmp, prev)
    return prev


# -- sharded v2: per-process shards + CRCs under an atomic manifest -----------

SHARDED_FORMAT = "goltpu-sharded"
SHARDED_FORMAT_VERSION = 2
MANIFEST_NAME = "MANIFEST.json"
_GEN_DIR_RE = re.compile(r"^gen-(\d{8})$")


def generation_dir(root: "str | Path", generation: int) -> Path:
    """``<root>/gen-<generation, zero-padded>`` — one directory per
    checkpointed generation; lexicographic order is generation order."""
    return Path(root) / f"gen-{int(generation):08d}"


def list_generations(root: "str | Path") -> List[Tuple[int, Path]]:
    """All generation dirs under ``root``, oldest first (committed or
    not — callers that need trust go through :func:`verify_sharded`)."""
    root = Path(root)
    if not root.is_dir():
        return []
    out = []
    for child in root.iterdir():
        m = _GEN_DIR_RE.match(child.name)
        if m and child.is_dir():
            out.append((int(m.group(1)), child))
    return sorted(out)


def _index_to_json(index: Sequence, shape: Sequence[int]) -> List[List[int]]:
    """Normalise a shard's global index (tuple of slices, possibly with
    None bounds) to JSON-plain ``[[start, stop], ...]``."""
    out = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError(f"strided shard index {sl} is not supported")
        out.append([start, stop])
    return out


def _check_index_bounds(index: Sequence[Sequence[int]],
                        shard_shape: Sequence[int],
                        global_shape: Sequence[int],
                        what: str) -> None:
    """A shard's ``[[start, stop], ...]`` index must lie inside the
    global array and span exactly the shard's own shape, per dimension:
    ``slice.indices`` in :func:`_index_to_json` clamps out-of-range
    bounds, and :func:`_check_exact_cover` stops masking past 2^26
    elements, so a re-tiling bug shows up here instead of as silently
    clamped slices."""
    if len(index) != len(global_shape) or len(shard_shape) != len(global_shape):
        raise CheckpointCorruptError(
            f"{what}: index {list(index)} / shape {list(shard_shape)} rank "
            f"!= global array rank {len(global_shape)}")
    for d, ((start, stop), n, dim) in enumerate(
            zip(index, shard_shape, global_shape)):
        if not (0 <= start <= stop <= dim):
            raise CheckpointCorruptError(
                f"{what}: dim {d} index [{start}, {stop}) out of bounds "
                f"for global extent {dim}")
        if stop - start != n:
            raise CheckpointCorruptError(
                f"{what}: dim {d} index [{start}, {stop}) covers "
                f"{stop - start} elements but shard shape has {n}")


def _crc32(data: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(data).tobytes()) & 0xFFFFFFFF


def _shard_npz(gen_dir: Path, process_id: int) -> Path:
    return gen_dir / f"shard-p{int(process_id):04d}.npz"


def _shard_sidecar(gen_dir: Path, process_id: int) -> Path:
    return gen_dir / f"shard-p{int(process_id):04d}.json"


def write_shards(
    gen_dir: "str | Path",
    process_id: int,
    shards: Sequence[Tuple[Sequence, np.ndarray]],
    *,
    global_shape: Sequence[int],
    dtype: "str | np.dtype",
) -> Path:
    """Write THIS process's shards of one global array: an NPZ with the
    shard payloads plus a JSON sidecar carrying per-shard CRC32s and
    global indices. ``shards`` is ``[(global_index, data), ...]`` — for a
    :class:`..parallel.mesh.ShardedGrid` use
    :func:`..parallel.multihost.local_shards`. Both files land via temp +
    ``os.replace`` (the sidecar last, so a visible sidecar implies a
    durable payload). Nothing here is a commit point: the generation only
    becomes loadable when :func:`commit_manifest` publishes the
    manifest."""
    gen_dir = Path(gen_dir)
    gen_dir.mkdir(parents=True, exist_ok=True)
    dtype = np.dtype(dtype)
    arrays, entries = {}, []
    for j, (index, data) in enumerate(shards):
        data = np.asarray(data)
        if data.dtype != dtype:
            raise ValueError(
                f"shard {j} dtype {data.dtype} != checkpoint dtype {dtype}")
        key = f"s{j}"
        arrays[key] = data
        idx = _index_to_json(index, global_shape)
        _check_index_bounds(idx, data.shape, global_shape,
                            f"process {process_id} shard {j}")
        entries.append({
            "key": key,
            "index": idx,
            "shape": list(data.shape),
            "crc32": _crc32(data),
        })
    npz = _shard_npz(gen_dir, process_id)
    _write_atomically(npz, lambda f: np.savez_compressed(f, **arrays))
    sidecar = json.dumps({
        "process_id": int(process_id),
        "file": npz.name,
        "global_shape": list(global_shape),
        "dtype": dtype.name,
        "shards": entries,
    })
    _write_atomically(_shard_sidecar(gen_dir, process_id),
                      lambda f: f.write(sidecar.encode()))
    return npz


def commit_manifest(
    gen_dir: "str | Path",
    *,
    meta: dict,
    num_processes: int,
) -> Path:
    """Fold every process's sidecar into one ``MANIFEST.json`` and
    publish it atomically — THE commit point of a sharded generation.
    Exactly one process calls this, after every ``num_processes``
    sidecar is durable. Verifies the shards jointly tile the global array
    exactly once (a silent gap would reassemble as zeros — worse than
    failing)."""
    gen_dir = Path(gen_dir)
    sidecars = []
    for p in range(num_processes):
        sc = _shard_sidecar(gen_dir, p)
        try:
            sidecars.append(json.loads(sc.read_text()))
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"cannot commit {gen_dir}: process {p}'s shard sidecar "
                f"is missing ({num_processes} expected)")
        except (ValueError, OSError) as exc:
            raise CheckpointCorruptError(
                f"cannot commit {gen_dir}: sidecar {sc.name} unreadable "
                f"({exc})") from exc
    global_shape = tuple(sidecars[0]["global_shape"])
    dtype = sidecars[0]["dtype"]
    for sc in sidecars[1:]:
        if tuple(sc["global_shape"]) != global_shape or sc["dtype"] != dtype:
            raise CheckpointCorruptError(
                f"cannot commit {gen_dir}: processes disagree on the "
                f"global array ({sc['global_shape']}/{sc['dtype']} vs "
                f"{list(global_shape)}/{dtype})")
    _check_exact_cover(gen_dir, sidecars, global_shape)
    manifest = {
        "format": SHARDED_FORMAT,
        "version": SHARDED_FORMAT_VERSION,
        "meta": dict(meta),
        "global_shape": list(global_shape),
        "dtype": dtype,
        "num_processes": int(num_processes),
        "processes": sidecars,
    }
    path = gen_dir / MANIFEST_NAME
    text = json.dumps(manifest, indent=1)
    _write_atomically(path, lambda f: f.write(text.encode()))
    return path


def _check_exact_cover(gen_dir: Path, sidecars: List[dict],
                       global_shape: Tuple[int, ...]) -> None:
    """Every element covered exactly once. Counted with a uint8 mask for
    grids a host can hold; beyond that (> 2^26 elements) only the total
    element count is checked — overlap and gap can then only cancel
    exactly, which a CRC-verified replay would still catch."""
    total = int(np.prod(global_shape))
    n_elems = sum(int(np.prod(e["shape"]))
                  for sc in sidecars for e in sc["shards"])
    if n_elems != total:
        raise CheckpointCorruptError(
            f"cannot commit {gen_dir}: shards cover {n_elems} elements, "
            f"global array has {total}")
    if total > (1 << 26):
        return
    mask = np.zeros(global_shape, np.uint8)
    for sc in sidecars:
        for e in sc["shards"]:
            mask[tuple(slice(a, b) for a, b in e["index"])] += 1
    if not (mask == 1).all():
        raise CheckpointCorruptError(
            f"cannot commit {gen_dir}: shard indices gap or overlap")


def read_manifest(gen_dir: "str | Path") -> dict:
    """The manifest of a committed generation; an absent manifest means
    an uncommitted (torn) generation — :class:`CheckpointCorruptError`."""
    path = Path(gen_dir) / MANIFEST_NAME
    try:
        manifest = json.loads(path.read_text())
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"{gen_dir} has no {MANIFEST_NAME} — generation was never "
            "committed (torn write)")
    except (ValueError, OSError) as exc:
        raise CheckpointCorruptError(
            f"{gen_dir}/{MANIFEST_NAME} unreadable ({exc})") from exc
    if manifest.get("format") != SHARDED_FORMAT:
        raise CheckpointCorruptError(
            f"{gen_dir}/{MANIFEST_NAME} is not a {SHARDED_FORMAT} manifest")
    if manifest.get("version") != SHARDED_FORMAT_VERSION:
        raise CheckpointCorruptError(
            f"unsupported sharded checkpoint version "
            f"{manifest.get('version')!r} in {gen_dir}")
    return manifest


def verify_sharded(gen_dir: "str | Path") -> dict:
    """Verify a committed generation end to end — manifest present,
    every shard file readable, every payload matching its manifest CRC32
    and shape — and return the manifest. Raises
    :class:`CheckpointCorruptError` naming the first bad shard."""
    gen_dir = Path(gen_dir)
    manifest = read_manifest(gen_dir)
    global_shape = tuple(manifest["global_shape"])
    for sc in manifest["processes"]:
        path = gen_dir / sc["file"]
        try:
            with np.load(path, allow_pickle=False) as z:
                for e in sc["shards"]:
                    _check_index_bounds(
                        e["index"], e["shape"], global_shape,
                        f"{path.name}[{e['key']}]")
                    data = np.asarray(z[e["key"]])
                    if list(data.shape) != list(e["shape"]):
                        raise CheckpointCorruptError(
                            f"{path.name}[{e['key']}] shape {data.shape} "
                            f"!= manifest {e['shape']}")
                    crc = _crc32(data)
                    if crc != e["crc32"]:
                        raise CheckpointCorruptError(
                            f"{path.name}[{e['key']}] CRC32 {crc:#010x} != "
                            f"manifest {e['crc32']:#010x} — shard is "
                            "corrupt")
        except CheckpointCorruptError:
            raise
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f"{gen_dir}: shard file {sc['file']} is missing")
        except (zipfile.BadZipFile, zlib.error, ValueError, KeyError,
                OSError, EOFError) as exc:
            raise CheckpointCorruptError(
                f"{gen_dir}: shard file {sc['file']} unreadable "
                f"({type(exc).__name__}: {exc})") from exc
    return manifest


def load_sharded(gen_dir: "str | Path",
                 *, verify: bool = True) -> Tuple[np.ndarray, dict]:
    """Reassemble the global array of one committed generation on the
    host; returns ``(array, meta)``. ``verify=True`` (the default)
    checks every CRC first — restore NEVER silently accepts a corrupt
    shard. Host cost is O(global array)."""
    gen_dir = Path(gen_dir)
    manifest = verify_sharded(gen_dir) if verify else read_manifest(gen_dir)
    out = np.zeros(tuple(manifest["global_shape"]),
                   np.dtype(manifest["dtype"]))
    for sc in manifest["processes"]:
        with np.load(gen_dir / sc["file"], allow_pickle=False) as z:
            for e in sc["shards"]:
                out[tuple(slice(a, b) for a, b in e["index"])] = z[e["key"]]
    return out, dict(manifest["meta"])


def load_sharded_grid(gen_dir: "str | Path",
                      *, verify: bool = True) -> Tuple[np.ndarray, dict]:
    """:func:`load_sharded`, decoded to a dense cell grid per the meta's
    ``layout`` — the sharded counterpart of :func:`load_grid`."""
    arr, meta = load_sharded(gen_dir, verify=verify)
    layout = meta.get("layout")
    if layout == "packed32":
        w = meta["shape"][1]
        return bitpack.unpack_np(arr.astype(np.uint32))[:, :w], meta
    if layout == "genplanes32":
        w = meta["shape"][1]
        return unpack_generations_np(arr.astype(np.uint32))[:, :w], meta
    return arr, meta


def load_latest_verified(
    root: "str | Path",
) -> Tuple[np.ndarray, dict, Path, List[Tuple[Path, str]]]:
    """Newest generation that verifies clean, falling back generation by
    generation past torn or corrupt ones. Returns ``(array, meta,
    gen_dir, skipped)`` where ``skipped`` lists ``(dir, why)`` for every
    newer generation that was refused. Raises
    :class:`CheckpointCorruptError` when no generation verifies."""
    gens = list_generations(root)
    skipped: List[Tuple[Path, str]] = []
    for _gen, gen_dir in reversed(gens):
        try:
            arr, meta = load_sharded(gen_dir, verify=True)
        except CheckpointCorruptError as exc:
            skipped.append((gen_dir, str(exc)))
            continue
        return arr, meta, gen_dir, skipped
    raise CheckpointCorruptError(
        f"no complete sharded checkpoint generation under {root} "
        f"({len(gens)} candidate dirs, all refused)")


def prune_sharded(root: "str | Path", keep: int = 2) -> List[Path]:
    """Delete all but the newest ``keep`` *committed* generations (and
    any uncommitted debris older than them). Never touches dirs newer
    than the newest manifest — those may be mid-write. Returns what was
    removed. ``keep >= 2`` preserves the corrupt-shard fallback target."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    gens = list_generations(root)
    committed = [(g, d) for g, d in gens if (d / MANIFEST_NAME).exists()]
    if len(committed) <= keep:
        return []
    cutoff = committed[-keep][0]
    removed = []
    for g, d in gens:
        if g < cutoff:
            shutil.rmtree(d, ignore_errors=True)
            removed.append(d)
    return removed
