"""The port's multi-process layer against the JAX package, on the CPU.

The multi-slice device order and the elastic runtime's mesh decision
against the JAX package's functions on the same inputs; then 2 and 3 real
OS processes (this file run as a script: the worker imports torch and
the port only) forming a gloo group, two CPU positions each, running
every runner the JAX package drives across processes
(``tests/multihost_worker.py``, ``resilience/distributed.py``): each
worker writes ``gather_global``'s result, and the parent holds every
process's result bit for bit against the JAX package's single-device
``multi_step_packed``, ``multi_step_packed_generations``,
``multi_step_ltl_packed``, ``multi_step_ltl_planes`` or
``multi_step_elementary`` (tolerance 0: integer words). The workers'
``local_shards`` commit one sharded v2 generation together.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENS = 40                    # B/S runs: deep and ghost take 5 chunks of 8
LTL_BOX = "R2,C0,M1,S9..16,B8..12"
PLANES_RULE = "R2,C4,M1,S3..8,B5..9"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(n: int) -> dict:
    """The grids every worker and the parent start from, made with numpy
    (and the port's numpy seeds and packers): uint32 words, a Generations
    plane stack, or uint8 cells."""
    import torch

    from gameoflifewithactors_torch.models import seeds
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.ops.bitpack import pack_np
    from gameoflifewithactors_torch.ops.packed_generations import \
        pack_generations_for

    def planes(cells, rule):
        return pack_generations_for(torch.from_numpy(cells), parse_any(
            rule)).numpy().view(np.uint32)

    rng = np.random.default_rng(9)
    elem = np.zeros((4, 64 * n), np.uint8)
    elem[:, ::7] = 1
    return {
        # gliders and the gun's stream cross the boundary between the
        # first processes' positions
        "glider": pack_np(seeds.seeded((64, 64 * n), "glider", 26, 26)),
        "bands": pack_np(seeds.seeded((16 * n, 64), "glider", 10, 1)),
        "gun": pack_np(seeds.seeded((64, 64 * n), "gosper_gun", 22, 40)),
        "brain": planes(rng.integers(0, 3, size=(16 * n, 64), dtype=np.uint8),
                        "brain"),
        "ltl": pack_np((rng.random((32 * n, 64)) < 0.4).astype(np.uint8)),
        "planes": planes(rng.integers(0, 4, size=(32, 64 * n),
                                      dtype=np.uint8), PLANES_RULE),
        "elem": pack_np(elem),
    }


def _worker(rank: int, n: int, port: int, out: str) -> None:
    """One process of the group: every cross-process runner on a (2, n)
    global mesh (and a (2n, 1) band mesh) of two CPU positions per
    process; writes each gathered result and a JSON of checks."""
    import torch
    import torch.distributed as dist

    from gameoflifewithactors_torch.models.elementary import parse_elementary
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.models.rules import CONWAY
    from gameoflifewithactors_torch.ops.stencil import Topology
    from gameoflifewithactors_torch.parallel import halo, multihost, sharded
    from gameoflifewithactors_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", n, rank, backend="gloo",
                         initialization_timeout=60)
    cpu = ["cpu", "cpu"]
    mesh = multihost.global_mesh((2, n), cpu)
    bmesh = multihost.global_mesh((2 * n, 1), cpu)
    x = _inputs(n)
    put, gather = multihost.put_global_grid, multihost.gather_global
    T, D = Topology.TORUS, Topology.DEAD
    got, checks = {}, {}

    glider = put(x["glider"], mesh)
    state = sharded.make_multi_step_packed(mesh, CONWAY, T)(glider, GENS)
    got["packed"] = gather(state)
    try:
        state.gather()
    except ValueError as exc:
        checks["gather_refused"] = "gather_global" in str(exc)
    got["deep"] = gather(sharded.make_multi_step_packed_deep(
        mesh, CONWAY, T, 8)(glider, GENS // 8))
    got["ghost"] = gather(sharded.make_multi_step_packed_ghost(
        mesh, CONWAY, T, 8)(glider, GENS // 8))
    run = sharded.make_multi_step_packed_sparse(mesh, CONWAY, T)
    got["flagged"] = gather(run(glider, sharded.initial_flags(mesh), GENS)[0])
    gun = put(x["gun"], mesh)
    run = sharded.make_multi_step_packed_sparse_tiled(
        mesh, CONWAY, T, tile_rows=16, tile_words=1)
    sout, sact = run(gun, sharded.initial_tile_activity(gun, mesh, 16, 1),
                     GENS)
    got["sparse"] = gather(sout)
    checks["awake"] = [int(gather(sact).sum()), int(sact.parts[0].numel()) * n]
    got["band"] = gather(sharded.make_multi_step_kernel(bmesh, CONWAY, T, 8)(
        put(x["bands"], bmesh, banded=True), GENS))
    got["band_flat"] = gather(sharded.make_multi_step_kernel(
        mesh, CONWAY, T, 8)(put(x["bands"], mesh, banded=True), GENS))
    got["brain"] = gather(sharded.make_multi_step_generations_kernel(
        mesh, parse_any("brain"), D, 4)(put(x["brain"], mesh, banded=True),
                                         12))
    got["ltl"] = gather(sharded.make_multi_step_ltl_kernel(
        mesh, parse_any(LTL_BOX), T, 4)(put(x["ltl"], mesh, banded=True), 12))
    got["planes"] = gather(sharded.make_multi_step_ltl_planes(
        mesh, parse_any(PLANES_RULE), T)(put(x["planes"], mesh), 6))
    got["elem"] = gather(sharded.make_multi_step_elementary_sharded(
        mesh, parse_elementary("W110"), T, 8)(put(x["elem"], mesh), 3))
    checks["bytes"] = [halo.exchanged_bytes(), halo.crossed_bytes()]

    # this process's shards of the per-generation run; rank 0 commits once
    # every process's sidecar is durable
    gen_dir = ckpt.generation_dir(os.path.join(out, "ckpt"), GENS)
    ckpt.write_shards(gen_dir, rank, multihost.local_shards(state),
                      global_shape=x["glider"].shape, dtype=np.uint32)
    dist.barrier()
    if rank == 0:
        ckpt.commit_manifest(gen_dir, meta={"generation": GENS},
                             num_processes=n)
    for name, arr in got.items():
        np.save(os.path.join(out, f"{name}-r{rank}.npy"), arr)
    with open(os.path.join(out, f"checks-r{rank}.json"), "w") as f:
        json.dump(checks, f)
    multihost.shutdown()


def _jax_oracles(x: dict) -> dict:
    """The JAX package's single-device runs of every case."""
    import jax.numpy as jnp

    from gameoflifewithactors_tpu.models.elementary import parse_elementary
    from gameoflifewithactors_tpu.models.generations import parse_any
    from gameoflifewithactors_tpu.models.rules import CONWAY
    from gameoflifewithactors_tpu.ops.elementary import multi_step_elementary
    from gameoflifewithactors_tpu.ops.packed import multi_step_packed
    from gameoflifewithactors_tpu.ops.packed_generations import \
        multi_step_packed_generations
    from gameoflifewithactors_tpu.ops.packed_ltl import (
        multi_step_ltl_packed, multi_step_ltl_planes)
    from gameoflifewithactors_tpu.ops.stencil import Topology

    T, D = Topology.TORUS, Topology.DEAD

    def packed(words, gens):
        return np.asarray(multi_step_packed(jnp.asarray(words), gens,
                                            rule=CONWAY, topology=T))

    glider = packed(x["glider"], GENS)
    bands = packed(x["bands"], GENS)
    return {
        "packed": glider, "deep": glider, "ghost": glider, "flagged": glider,
        "sparse": packed(x["gun"], GENS), "band": bands, "band_flat": bands,
        "brain": np.asarray(multi_step_packed_generations(
            jnp.asarray(x["brain"]), 12, rule=parse_any("brain"),
            topology=D)),
        "ltl": np.asarray(multi_step_ltl_packed(
            jnp.asarray(x["ltl"]), 12, rule=parse_any(LTL_BOX), topology=T)),
        "planes": np.asarray(multi_step_ltl_planes(
            jnp.asarray(x["planes"]), 6, rule=parse_any(PLANES_RULE),
            topology=T)),
        "elem": np.asarray(multi_step_elementary(
            jnp.asarray(x["elem"]), 24, rule=parse_elementary("W110"),
            topology=T)),
    }


def _spawn_group(n: int, out, timeout: float = 150.0) -> list:
    """Run ``n`` workers of this file to their end; returns (rc, stderr)
    per rank, killing any worker still running at the timeout."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(n), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("n_procs", [2, 3])
def test_cross_process_runners_equal_jax(tmp_path, n_procs):
    from gameoflifewithactors_torch.utils import checkpoint as ckpt

    outs = _spawn_group(n_procs, tmp_path)
    for r, (rc, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-3000:]}"
    x = _inputs(n_procs)
    oracles = _jax_oracles(x)
    for name, want in oracles.items():
        for r in range(n_procs):
            got = np.load(tmp_path / f"{name}-r{r}.npy")
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")
        assert want.any(), name
    for r in range(n_procs):
        checks = json.loads((tmp_path / f"checks-r{r}.json").read_text())
        assert checks["gather_refused"] is True
        awake, tiles = checks["awake"]
        assert 0 < awake < tiles            # the gun's corner only
        exchanged, crossed = checks["bytes"]
        assert 0 < crossed < exchanged      # some strips stayed local
    arr, meta = ckpt.load_sharded(ckpt.generation_dir(tmp_path / "ckpt", GENS))
    np.testing.assert_array_equal(arr, oracles["packed"])
    assert meta == {"generation": GENS}


# -- the multi-slice order and the mesh decision ------------------------------


def test_factor2d_sliced_equals_jax():
    from gameoflifewithactors_torch.parallel import mesh as t_mesh
    from gameoflifewithactors_tpu.parallel import mesh as j_mesh

    for n, s in [(32, 8), (8, 2), (8, 1), (12, 3), (6, 2), (16, 4), (7, 1)]:
        assert t_mesh.factor2d_sliced(n, s) == j_mesh.factor2d_sliced(n, s)
    for mod in (t_mesh, j_mesh):
        with pytest.raises(ValueError, match="do not split"):
            mod.factor2d_sliced(8, 3)


@pytest.mark.parametrize("shape, ids", [
    ((4, 2), [0, 0, 0, 0, 1, 1, 1, 1]),
    ((2, 4), [0, 1, 0, 1, 0, 1, 0, 1]),
    ((4, 2), [1, 1, 0, 0, 1, 1, 0, 0]),
    ((2, 4), [0] * 8),
    ((1, 8), [0, 0, 0, 0, 1, 1, 1, 1]),          # a slice cuts a mesh row
    ((4, 2), [0, 0, 0, 1, 1, 1, 1, 1]),          # uneven slices
    ((4, 2), [0, 1]),                            # id count mismatch
    ((8, 1), [0, 0, 1, 1, 2, 2, 3, 3]),
])
def test_order_devices_for_slices_equals_jax(shape, ids):
    """The same layout, or the same refusal, as the JAX package's on its
    8 CPU devices (compared as device indices)."""
    import jax

    from gameoflifewithactors_torch.parallel import mesh as t_mesh
    from gameoflifewithactors_tpu.parallel import mesh as j_mesh

    devs = jax.devices()[:8]
    try:
        want = j_mesh.order_devices_for_slices(devs, shape, ids)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            t_mesh.order_devices_for_slices(list(range(8)), shape, ids)
        assert str(got.value).split(":")[0] == str(exc).split(":")[0]
        return
    got = t_mesh.order_devices_for_slices(list(range(8)), shape, ids)
    index = {d: i for i, d in enumerate(devs)}
    assert got.tolist() == [[index[d] for d in row] for row in want]


def test_make_mesh_slice_ids_equal_jax():
    """The default shape over slices, explicit ids that cannot band (a
    raise in both), and the port's own positions as slices falling back
    to x-major with a warning."""
    import jax

    from gameoflifewithactors_torch.parallel import mesh as t_mesh
    from gameoflifewithactors_torch.parallel import multihost
    from gameoflifewithactors_tpu.parallel import mesh as j_mesh

    ids = [0, 0, 0, 0, 1, 1, 1, 1]
    jm = j_mesh.make_mesh(devices=jax.devices()[:8], slice_ids=ids)
    tm = t_mesh.make_mesh(devices=["cpu"] * 8, slice_ids=ids)
    assert tuple(tm.shape.values()) == jm.devices.shape == (2, 4)
    for make, devs in ((j_mesh.make_mesh, jax.devices()[:8]),
                       (t_mesh.make_mesh, ["cpu"] * 8)):
        for shape, bad in (((1, 8), ids), ((4, 2), [0, 1])):
            with pytest.raises(ValueError):
                make(shape, devs, slice_ids=bad)
    # without a process group a global mesh is this process's; its one
    # rank is one slice, so any shape is a plain x-major layout
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gm = multihost.global_mesh((2, 3), ["cpu"] * 6)
    assert gm.owner_of == (0,) * 6 and not gm.spans_processes
    assert t_mesh.arrange((2, 2), 4, [0, 0, 1, 1], explicit=True).tolist() \
        == [[0, 1], [2, 3]]
    with pytest.warns(UserWarning, match="slice-banded layout impossible"):
        order = t_mesh.arrange((2, 3), 6, [0, 0, 1, 1, 2, 2], explicit=False)
    assert order.tolist() == [[0, 1, 2], [3, 4, 5]]


def test_global_mesh_for_grid_decisions_equal_jax():
    """The elastic runtime's re-tiling decision on a table of (positions,
    packed grid, preferred shape, k): the port's mesh shape is the JAX
    package's on as many of its CPU devices."""
    import jax

    from gameoflifewithactors_torch.parallel import multihost as t_mh
    from gameoflifewithactors_tpu.parallel import multihost as j_mh

    table = [
        (4, (96, 2), None, 1), (4, (96, 2), (2, 2), 1),
        (4, (96, 2), (2, 2), 8), (4, (96, 4), (2, 2), 8),
        (4, (96, 4), None, 8), (3, (96, 2), (3, 1), 1),
        (3, (96, 2), None, 8), (8, (64, 8), (2, 4), 4),
        (8, (64, 8), (4, 2), 40), (6, (48, 3), (2, 3), 1),
        (2, (7, 3), None, 1), (8, (64, 4), None, 16),
    ]
    for n, shape, preferred, k in table:
        want = j_mh.global_mesh_for_grid(
            shape, preferred, gens_per_exchange=k,
            devices=jax.devices()[:n]).devices.shape
        got = t_mh.global_mesh_for_grid(shape, preferred, gens_per_exchange=k,
                                        devices=["cpu"] * n)
        assert tuple(got.shape.values()) == want, (n, shape, preferred, k)
        assert t_mh.mesh_shape_for_grid(n, shape, preferred,
                                        gens_per_exchange=k) == want


def test_mesh_of_another_process_positions():
    """A mesh whose positions belong to two ranks, seen from rank 1: its
    groups, slots and placed parts cover rank 1's positions only, band
    edge codes keep their global index, and ``gather`` refuses."""
    import torch

    from gameoflifewithactors_torch.parallel import halo
    from gameoflifewithactors_torch.parallel import mesh as t_mesh

    devs = np.array([["cpu"] * 2] * 2, dtype=object)
    m = t_mesh.Mesh(devs, owners=[[0, 0], [1, 1]], rank=1)
    assert m.positions == (2, 3) and set(m.slot_of) == {2, 3}
    assert m.owner_of == (0, 0, 1, 1) and m.spans_processes
    grid = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4)
    placed = t_mesh.device_put_sharded_grid(grid, m, banded=True)
    assert [tuple(p.shape) for p in placed.parts] == [(2, 2, 4)]
    assert torch.equal(placed.parts[0].reshape(4, 4), grid[4:])
    assert halo.band_edge_codes(m)[0].tolist() == [0, 2]
    with pytest.raises(ValueError, match="gather_global"):
        placed.gather()
    with pytest.raises(ValueError, match="holds no position"):
        t_mesh.Mesh(devs, owners=[[0, 0], [0, 0]], rank=1)


def test_initialize_refuses_what_cannot_run():
    """An unknown backend, and NCCL on a CPU device, raise before any
    process group is formed; nothing falls back to another backend."""
    import torch.distributed as dist

    from gameoflifewithactors_torch.parallel import multihost

    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize("localhost:1", 1, 0, backend="mpi")
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("localhost:1", 1, 0, backend="nccl",
                             device="cpu")
    assert not dist.is_initialized()
    multihost.shutdown()                  # idempotent without a group
    assert multihost.process_index() == 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
