"""`parallel.collectives` and `parallel.mesh.build_mesh` over gloo ranks,
held against the JAX package's collectives inside ``shard_map``.

Four port ranks (`torch.multiprocessing.spawn`) build
``MeshSpec(dp=2, fsdp=2)`` and run every wrapper on their block of one
seeded numpy array, over the whole world (4 ranks) and over each mesh dim
(2 ranks). The JAX side runs the same wrappers in ``shard_map`` over 4
virtual CPU devices, laid out as the same mesh, on the same array: rank r
is device r of the row-major mesh, whose output block it must equal. The
sums are of f32 blocks in another order in each package: 1e-6.

JAX is imported inside the functions only: the ranks import this module
by name to find their program.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 4
BLOCK = (4, 6)  # each rank's block; the global array stacks 4 of them
# (op name, axis over the world or a mesh dim, keyword)
CASES = [
    ("all_reduce_sum", axis, {}) for axis in ("x", "dp", "fsdp")
] + [
    ("all_reduce_mean", axis, {}) for axis in ("x", "dp", "fsdp")
] + [
    ("reduce_scatter", axis, {}) for axis in ("x", "fsdp")
] + [
    ("reduce_scatter", "dp", {"scatter_axis": 1}),
    ("all_gather", "x", {}), ("all_gather", "fsdp", {}),
    ("all_gather", "dp", {"gather_axis": 1}),
    ("ring_shift", "x", {}), ("ring_shift", "x", {"shift": 3}),
    ("ring_shift", "fsdp", {}), ("ring_shift", "dp", {"shift": 2}),
    # jax.lax.all_to_all(..., tiled=True), which the JAX package calls
    # inline in ulysses.py.
    ("all_to_all", "x", {"split_axis": 0, "concat_axis": 1}),
    ("all_to_all", "fsdp", {"split_axis": 1, "concat_axis": 0}),
    ("all_to_all", "dp", {"split_axis": 0, "concat_axis": 0}),
]
AXIS_KW = {"reduce_scatter": "scatter_axis", "all_gather": "gather_axis",
           "ring_shift": "shift"}


def global_array():
    rng = np.random.RandomState(0)
    return rng.randn(WORLD * BLOCK[0], BLOCK[1]).astype(np.float32)


def _rank_program(rank, world, port, out_dir):
    import torch.distributed as dist

    from tf_yarn_tpu_torch.parallel import collectives as coll
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(dp=2, fsdp=2), "cpu")
        mesh_lib.set_current_mesh(mesh)
        x = torch.from_numpy(global_array()).chunk(world)[rank].contiguous()
        before = x.clone()
        out = {"mesh": {"dims": list(mesh.mesh_dim_names),
                        "shape": list(mesh.shape),
                        "dp_group": dist.get_process_group_ranks(
                            mesh["dp"].get_group()),
                        "fsdp_group": dist.get_process_group_ranks(
                            mesh["fsdp"].get_group())}}
        for i, (name, axis, kwargs) in enumerate(CASES):
            out[i] = getattr(coll, name)(x, None if axis == "x" else axis,
                                         **kwargs)
        out["untouched"] = torch.equal(x, before)
        out["bandwidth"] = coll.allreduce_bandwidth(size_mb=1.0, iters=2,
                                                    device="cpu")
        torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("collectives"))
    torch.multiprocessing.spawn(_rank_program,
                                args=(WORLD, _free_port(), out_dir),
                                nprocs=WORLD, join=True)
    return [torch.load(os.path.join(out_dir, f"rank-{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def jax_blocks(name, axis, kwargs):
    """Each device's output block of the JAX wrapper in shard_map."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from tf_yarn_tpu.parallel import collectives as j_coll

    devices = np.asarray(jax.devices("cpu")[:WORLD])
    if axis == "x":
        mesh, spec = Mesh(devices, ("x",)), P("x")
    else:
        mesh = Mesh(devices.reshape(2, 2), ("dp", "fsdp"))
        spec = P(("dp", "fsdp"))
    if name == "all_to_all":
        call = lambda s: jax.lax.all_to_all(  # noqa: E731
            s, axis, kwargs["split_axis"], kwargs["concat_axis"], tiled=True)
    else:
        fn = getattr(j_coll, name)
        key = AXIS_KW.get(name)
        call = (lambda s: fn(s, axis, kwargs[key])) if key in kwargs else (
            lambda s: fn(s, axis))
    out = j_coll.shard_map(call, mesh=mesh, in_specs=spec, out_specs=spec)(
        global_array())
    return np.split(np.asarray(out), WORLD)


def test_build_mesh_over_four_ranks(ranks):
    for rank, out in enumerate(ranks):
        mesh = out["mesh"]
        # JAX's order; pp, sp, tp and ep of size 1 here.
        assert mesh["dims"] == ["pp", "dp", "fsdp", "sp", "tp", "ep"]
        assert mesh["shape"] == [1, 2, 2, 1, 1, 1]
        # Row-major: dp is the outer dim.
        assert mesh["fsdp_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert mesh["dp_group"] == [rank % 2, rank % 2 + 2]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{a}-{'-'.join(map(str, k.values()))}"
                              for n, a, k in CASES])
def test_collective_matches_jax_shard_map(ranks, case):
    name, axis, kwargs = CASES[case]
    want = jax_blocks(name, axis, kwargs)
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out[case].numpy(), want[rank], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")
        assert out["untouched"]


def test_allreduce_bandwidth_labels_its_wire(ranks):
    from tf_yarn_tpu_torch.parallel import collectives as coll

    for out in ranks:
        bw = out["bandwidth"]
        assert bw["mode"] == "gloo_allreduce" and bw["n_devices"] == 4.0
        assert bw["gbps"] > 0 and bw["size_mb"] == 1.0
    # No process group in this process: an on-chip copy, not a wire.
    alone = coll.allreduce_bandwidth(size_mb=1.0, iters=2, device="cpu")
    assert alone["mode"] == "single_chip_hbm_copy"
    assert alone["n_devices"] == 1.0
