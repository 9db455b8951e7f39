"""The port's checkpoints against the JAX package's on the CPU: every
single-file layout (``packed32``, ``genplanes32``, v1 ``bits``, v2
``cells``) and the sharded v2 format written by one package load in the
other, bit for bit and with the same meta; corrupt, torn and missing
pieces raise ``CheckpointCorruptError``; the fallback, pruning and
rotation behave as the JAX package's. Grids are made with numpy from a
seed at 48x96 (never the 64x64 B3/S23 packed JAX runner that the
cold-cache tests expect to compile)."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch.parallel import mesh as t_mesh
from gameoflifewithactors_torch.parallel import multihost as t_multihost
from gameoflifewithactors_torch.utils import checkpoint as t_ck
from gameoflifewithactors_torch.utils import interop
import gameoflifewithactors_tpu as jg
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import multihost as j_multihost
from gameoflifewithactors_tpu.utils import checkpoint as j_ck

SHAPE = (48, 96)
# (rule, states, backend) -> the layout each engine saves
LAYOUTS = {
    "packed32": ("conway", 2, "packed"),
    "genplanes32": ("brain", 3, "packed"),
    "bits": ("highlife", 2, "dense"),
    "cells": ("brain", 3, "dense"),
}


def _cells(states, seed, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, states, size=shape,
                                                dtype=np.uint8)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _stored(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_single_file_layouts_cross_load(layout, tmp_path):
    """Port -> JAX (load_grid, load_engine, then both step on) and JAX ->
    port (load_grid, load_engine), same meta, same stored members."""
    rule, states, backend = LAYOUTS[layout]
    grid = _cells(states, seed=len(layout))
    te = tg.Engine(grid, rule, backend=backend, device="cpu")
    te.step(3)
    port_file = t_ck.save(te, tmp_path / "port.npz")
    je = jg.Engine(grid, rule, backend=backend)
    je.step(3)
    jax_file = j_ck.save(je, tmp_path / "jax.npz")
    assert sorted(_stored(port_file)) == sorted(_stored(jax_file))
    for name, got in _stored(port_file).items():
        np.testing.assert_array_equal(got, _stored(jax_file)[name], err_msg=name)

    j_grid, j_meta = j_ck.load_grid(port_file)
    t_grid, t_meta = t_ck.load_grid(jax_file)
    assert j_meta == t_meta == t_ck.load_grid(port_file)[1]
    assert (t_meta.get("layout")
            or {1: "bits", 2: "cells"}[t_meta["version"]]) == layout
    np.testing.assert_array_equal(j_grid, te.snapshot())
    np.testing.assert_array_equal(t_grid, te.snapshot())

    je2 = j_ck.load_engine(port_file)
    te2 = t_ck.load_engine(jax_file, device="cpu")
    assert je2.generation == te2.generation == 3
    je2.step(4)
    te2.step(4)
    te.step(4)
    np.testing.assert_array_equal(np.asarray(je2.snapshot()), te.snapshot())
    np.testing.assert_array_equal(te2.snapshot(), te.snapshot())
    # packed layouts reload through Engine.from_packed, words untouched
    if layout in ("packed32", "genplanes32"):
        back = t_ck.load_engine(port_file, device="cpu")
        assert back._layout == te._layout
        member = "words" if layout == "packed32" else "planes"
        np.testing.assert_array_equal(interop.state_to_numpy(back.state),
                                      _stored(port_file)[member])


def test_load_engine_onto_a_mesh_backend_and_device(tmp_path):
    """A mesh engine saves its gathered state; the file reloads onto
    another mesh and backend (and the CPU only when asked)."""
    grid = _cells(3, seed=8, shape=(48, 128))   # whole words per mesh column
    m = t_mesh.make_mesh((2, 2), ["cpu"] * 4)
    te = tg.Engine(grid, "brain", mesh=m, device="cpu")
    te.step(5)
    path = t_ck.save(te, tmp_path / "mesh.npz")
    assert t_ck.load_grid(path)[1]["layout"] == "genplanes32"
    te.step(3)
    for mesh, backend in [(t_mesh.make_mesh((4, 1), ["cpu"] * 4), "packed"),
                          (None, "dense")]:
        back = t_ck.load_engine(path, mesh=mesh, backend=backend, device="cpu")
        assert back.generation == 5 and back.backend == backend
        back.step(3)
        np.testing.assert_array_equal(back.snapshot(), te.snapshot())


def _port_placed(arr, mesh, banded):
    return t_mesh.device_put_sharded_grid(interop.state_from_numpy(arr),
                                          mesh, banded=banded)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_v2_cross_loads(shape, tmp_path):
    """Words and a plane stack, tiled and banded: the port writes through
    local_shards and JAX verifies and loads; JAX writes through its
    local_shards and the port verifies and loads."""
    n = shape[0] * shape[1]
    tm = t_mesh.make_mesh(shape, ["cpu"] * n)
    jm = j_mesh.make_mesh(shape, jax.devices()[:n])
    cases = [(_words((48, 4), 1), "packed32", False),
             (_words((48, 4), 2), "packed32", True),
             (_words((2, 48, 4), 3), "genplanes32", False)]
    for k, (arr, layout, banded) in enumerate(cases):
        meta = {"rule": "brain" if arr.ndim == 3 else "B3/S23",
                "topology": "torus", "generation": k, "shape": [48, 128],
                "layout": layout}
        shards = t_multihost.local_shards(_port_placed(arr, tm, banded))
        assert len(shards) == n
        t_ck.write_shards(tmp_path / "port" / f"g{k}", 0, shards,
                          global_shape=arr.shape, dtype=np.uint32)
        t_ck.commit_manifest(tmp_path / "port" / f"g{k}", meta=meta,
                             num_processes=1)
        placed = j_mesh.device_put_sharded_grid(jnp.asarray(arr), jm,
                                                banded=banded)
        j_ck.write_shards(tmp_path / "jax" / f"g{k}", 0,
                          j_multihost.local_shards(placed),
                          global_shape=arr.shape, dtype=np.uint32)
        j_ck.commit_manifest(tmp_path / "jax" / f"g{k}", meta=meta,
                             num_processes=1)
        assert j_ck.verify_sharded(tmp_path / "port" / f"g{k}")["meta"] == meta
        assert t_ck.verify_sharded(tmp_path / "jax" / f"g{k}")["meta"] == meta
        for got, got_meta in (j_ck.load_sharded(tmp_path / "port" / f"g{k}"),
                              t_ck.load_sharded(tmp_path / "jax" / f"g{k}")):
            assert got_meta == meta and got.dtype == np.uint32
            np.testing.assert_array_equal(got, arr)
        j_grid, _ = j_ck.load_sharded_grid(tmp_path / "port" / f"g{k}")
        t_grid, _ = t_ck.load_sharded_grid(tmp_path / "jax" / f"g{k}")
        np.testing.assert_array_equal(j_grid, t_grid)


def _commit_generation(root, engine):
    gen_dir = t_ck.generation_dir(root, engine.generation)
    t_ck.write_shards(gen_dir, 0, t_multihost.local_shards(engine.sharded_state),
                      global_shape=tuple(engine.state.shape), dtype=np.uint32)
    t_ck.commit_manifest(gen_dir, num_processes=1, meta={
        "rule": engine.rule.notation, "topology": engine.topology.value,
        "generation": engine.generation, "shape": list(engine.shape),
        "layout": "packed32"})
    return gen_dir


def _two_generations(root):
    m = t_mesh.make_mesh((4, 1), ["cpu"] * 4)
    te = tg.Engine(_cells(2, seed=4), "conway", mesh=m, device="cpu")
    dirs = []
    for _ in range(2):
        te.step(6)
        dirs.append(_commit_generation(root, te))
    return te, dirs


def _flip_byte(gen_dir):
    npz = gen_dir / "shard-p0000.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))


def _drop_shard(gen_dir):
    (gen_dir / "shard-p0000.npz").unlink()


def _tear_manifest(gen_dir):
    manifest = gen_dir / t_ck.MANIFEST_NAME
    manifest.write_text(manifest.read_text()[:40])


@pytest.mark.parametrize("damage", [_flip_byte, _drop_shard, _tear_manifest])
def test_damage_raises_checkpoint_corrupt_error(damage, tmp_path):
    _, (old, new) = _two_generations(tmp_path)
    damage(new)
    for ck in (t_ck, j_ck):
        with pytest.raises(ck.CheckpointCorruptError):
            ck.load_sharded(new)
    assert issubclass(t_ck.CheckpointCorruptError, ValueError)
    t_ck.verify_sharded(old)


def test_load_latest_verified_falls_back_and_resumes_on_the_mesh(tmp_path):
    te, (old, new) = _two_generations(tmp_path)
    _flip_byte(new)
    for ck in (t_ck, j_ck):
        arr, meta, gen_dir, skipped = ck.load_latest_verified(tmp_path)
        assert gen_dir == old and [d for d, _ in skipped] == [new]
        assert meta["generation"] == 6
    # resume the older generation onto a mesh and catch up with the run
    arr, meta, _, _ = t_ck.load_latest_verified(tmp_path)
    m = t_mesh.make_mesh((2, 2), ["cpu"] * 4)
    back = tg.Engine.from_packed(arr, meta["rule"],
                                 topology=tg.Topology(meta["topology"]),
                                 mesh=m, device="cpu")
    back.generation = meta["generation"]
    back.step(6)
    np.testing.assert_array_equal(back.snapshot(), te.snapshot())
    shutil.rmtree(old)
    with pytest.raises(t_ck.CheckpointCorruptError, match="all refused"):
        t_ck.load_latest_verified(tmp_path)


def test_commit_refuses_gaps_overlaps_and_bad_indices(tmp_path):
    arr = _words((8, 4), 9)
    halves = [((slice(0, 4), slice(0, 4)), arr[:4]),
              ((slice(4, 8), slice(0, 4)), arr[4:])]
    t_ck.write_shards(tmp_path / "gap", 0, halves[:1], global_shape=(8, 4),
                      dtype=np.uint32)
    t_ck.write_shards(tmp_path / "overlap", 0, [halves[0], halves[0]],
                      global_shape=(8, 4), dtype=np.uint32)
    for name in ("gap", "overlap"):
        for ck in (t_ck, j_ck):
            with pytest.raises(ck.CheckpointCorruptError):
                ck.commit_manifest(tmp_path / name, meta={}, num_processes=1)
    with pytest.raises(t_ck.CheckpointCorruptError, match="missing"):
        t_ck.commit_manifest(tmp_path / "gap", meta={}, num_processes=2)
    with pytest.raises(t_ck.CheckpointCorruptError, match="covers"):
        t_ck.write_shards(tmp_path / "wide", 0,
                          [((slice(4, 8), slice(0, 4)), arr)],
                          global_shape=(8, 4), dtype=np.uint32)
    with pytest.raises(ValueError, match="dtype"):
        t_ck.write_shards(tmp_path / "dtype", 0, [halves[0]],
                          global_shape=(8, 4), dtype=np.uint8)
    with pytest.raises(t_ck.CheckpointCorruptError, match="torn write"):
        t_ck.read_manifest(tmp_path / "gap")


def test_prune_and_rotate_previous(tmp_path):
    te, dirs = _two_generations(tmp_path / "ck")
    te.step(6)
    dirs.append(_commit_generation(tmp_path / "ck", te))
    debris = t_ck.generation_dir(tmp_path / "ck", 99)   # newer, uncommitted
    debris.mkdir()
    assert [g for g, _ in t_ck.list_generations(tmp_path / "ck")] == [6, 12, 18, 99]
    assert t_ck.prune_sharded(tmp_path / "ck", keep=2) == [dirs[0]]
    assert t_ck.prune_sharded(tmp_path / "ck", keep=2) == []
    assert debris.exists() and dirs[1].exists()
    with pytest.raises(ValueError, match="keep"):
        t_ck.prune_sharded(tmp_path / "ck", keep=0)

    path = tmp_path / "one.npz"
    assert t_ck.rotate_previous(path) is None
    t_ck.save(tg.Engine(_cells(2, seed=5), "conway", device="cpu"), path)
    first = path.read_bytes()
    prev = t_ck.rotate_previous(path)
    assert prev == tmp_path / "one.npz.prev" and prev.read_bytes() == first
    te2 = tg.Engine(_cells(2, seed=6), "conway", device="cpu")
    te2.step(1)
    t_ck.save(te2, path)
    assert prev.read_bytes() == first and t_ck.load_grid(path)[1]["generation"] == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck", "one.npz",
                                                          "one.npz.prev"]


def test_unreadable_single_files(tmp_path):
    path = t_ck.save(tg.Engine(_cells(2, seed=7), "conway", device="cpu"),
                     tmp_path / "a.npz")
    with pytest.raises(FileNotFoundError):
        t_ck.load_grid(tmp_path / "missing.npz")
    (tmp_path / "torn.npz").write_bytes(path.read_bytes()[:100])
    np.savez(tmp_path / "nometa.npz", words=np.zeros((2, 1), np.uint32))
    bad = dict(_stored(path))
    bad["meta"] = json.dumps(dict(json.loads(str(bad["meta"])), version=9))
    np.savez(tmp_path / "v9.npz", **bad)
    for name in ("torn.npz", "nometa.npz", "v9.npz"):
        for ck in (t_ck, j_ck):
            with pytest.raises(ck.CheckpointCorruptError):
                ck.load_grid(tmp_path / name)
        with pytest.raises(t_ck.CheckpointCorruptError):
            t_ck.load_engine(tmp_path / name, device="cpu")
    # the paged loader (tests/test_torch_paged.py) maps the same damage
    with pytest.raises(FileNotFoundError):
        t_ck.load_paged(tmp_path / "p.npz", device="cpu")
    for name in ("torn.npz", "nometa.npz", "v9.npz"):
        with pytest.raises(t_ck.CheckpointCorruptError):
            t_ck.load_paged(tmp_path / name, device="cpu")
