"""`parallel.mesh` held against the JAX package's, and the rank's card.

`MeshSpec`, `resize_mesh_spec` and `order_devices_for_slices` are pure
logic in both packages: one grid of inputs, the same outputs or the same
error. `build_mesh` over 4 gloo ranks is in tests/test_torch_collectives.py
(one spawn there builds the mesh and runs the collectives on it).
"""

import dataclasses

import pytest
import torch

from tf_yarn_tpu.parallel import mesh as j_mesh
from tf_yarn_tpu_torch import _device
from tf_yarn_tpu_torch.parallel import mesh as t_mesh

SPECS = [dict(), dict(dp=2), dict(fsdp=4), dict(dp=2, fsdp=2),
         dict(dp=4, fsdp=2, tp=2), dict(tp=2, sp=2), dict(pp=2, dp=3),
         dict(ep=2, fsdp=3)]


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out


@pytest.mark.parametrize("fields", SPECS)
def test_mesh_spec_json_and_axes_match_jax(fields):
    port, ref = t_mesh.MeshSpec(**fields), j_mesh.MeshSpec(**fields)
    assert port.to_json() == ref.to_json()
    assert t_mesh.MeshSpec.from_json(ref.to_json()) == port
    assert port.axis_names == ref.axis_names
    assert port.axis_sizes == ref.axis_sizes
    assert port.total_devices == ref.total_devices
    for n in (1, 2, 3, 8):
        assert dataclasses.asdict(t_mesh.MeshSpec.auto(n)) == \
            dataclasses.asdict(j_mesh.MeshSpec.auto(n))


@pytest.mark.parametrize("fields", SPECS)
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 6, 8])
def test_resize_mesh_spec_matches_jax(fields, n):
    assert _outcome(t_mesh.resize_mesh_spec, t_mesh.MeshSpec(**fields), n) \
        == _outcome(j_mesh.resize_mesh_spec, j_mesh.MeshSpec(**fields), n)


SLICES = [
    (dict(dp=2, fsdp=2), [0, 0, 1, 1]),
    (dict(dp=2, fsdp=2), [1, 0, 1, 0]),
    (dict(dp=2, fsdp=2), [0, 0, 0, 0]),
    (dict(fsdp=4), [0, 0, 1, 1]),          # pp*dp not divisible: error
    (dict(dp=4), [0, 1, 2, 3]),
    (dict(dp=2, fsdp=2), [0, 0, 0, 1]),    # unequal groups: error
    (dict(dp=2, fsdp=2), [0, 0, 1]),       # length mismatch: error
    (dict(pp=2, dp=2), [2, 2, 5, 5]),
]


@pytest.mark.parametrize("fields,slice_ids", SLICES)
def test_order_devices_for_slices_matches_jax(fields, slice_ids):
    devices = ["d0", "d1", "d2", "d3"]
    assert _outcome(t_mesh.order_devices_for_slices,
                    t_mesh.MeshSpec(**fields), devices, slice_ids) == \
        _outcome(j_mesh.order_devices_for_slices, j_mesh.MeshSpec(**fields),
                 devices, slice_ids)


@pytest.mark.parametrize("axis,item", [("ep", "8d")])
def test_model_axes_refuse_naming_their_item(axis, item):
    """Every axis is built now (ep since expert parallelism): alone it
    passes the check at its world size and is the size error at one
    rank; beside tp, sp or pp it refuses naming its item."""
    assert t_mesh.UNPORTED_AXES == {}
    spec = t_mesh.MeshSpec(**{axis: 2})
    t_mesh.check_mesh_spec(spec, 2)
    with pytest.raises(ValueError, match="MeshSpec wants 2 devices"):
        t_mesh.build_mesh(spec, "cpu")
    for other in ("tp", "sp", "pp"):
        spec = t_mesh.MeshSpec(**{axis: 2, other: 2})
        with pytest.raises(NotImplementedError,
                           match=f"Queue 1 item {item}"):
            t_mesh.check_mesh_spec(spec, 4)


@pytest.mark.parametrize("fields", [dict(tp=2), dict(dp=2, tp=2),
                                    dict(fsdp=2, tp=2), dict(dp=2, fsdp=2,
                                                             tp=2)])
def test_tp_meshes_are_built_for_training(fields):
    """tp is ported (tensor-parallel training): a spec with it passes the
    check at its world size, and a mesh of one rank still needs its
    devices (the JAX package's size error)."""
    spec = t_mesh.MeshSpec(**fields)
    t_mesh.check_mesh_spec(spec, spec.total_devices)
    with pytest.raises(ValueError, match="MeshSpec wants"):
        t_mesh.build_mesh(spec, "cpu")
    assert t_mesh.MESH_DIMS == ("pp", "dp", "fsdp", "sp", "tp", "ep")
    assert "tp" not in t_mesh.UNPORTED_AXES
    assert t_mesh.data_group(None) == (0, 1)
    assert t_mesh.mesh_coordinate(None, "tp") == 0


@pytest.mark.parametrize("fields", [dict(sp=2), dict(pp=2), dict(dp=2, sp=2),
                                    dict(sp=2, tp=2), dict(dp=2, pp=2),
                                    dict(fsdp=2, sp=2)])
def test_sp_and_pp_meshes_are_built_for_training(fields):
    """sp and pp are ported (sequence parallelism, the pipeline): a spec
    with them passes the check at its world size and is the JAX package's
    size error at one rank; their dims are in the mesh in JAX's order
    (mesh.py:63), and they share the data group of their dp x fsdp
    coordinate."""
    spec = t_mesh.MeshSpec(**fields)
    t_mesh.check_mesh_spec(spec, spec.total_devices)
    with pytest.raises(ValueError, match="MeshSpec wants"):
        t_mesh.build_mesh(spec, "cpu")
    assert t_mesh.MESH_DIMS == j_mesh.MeshSpec().axis_names
    assert not {"sp", "pp"} & set(t_mesh.UNPORTED_AXES)


@pytest.mark.parametrize("fields,item", [
    (dict(fsdp=2, pp=2), "7d"), (dict(sp=2, pp=2), "7d"),
    (dict(tp=2, pp=2), "7d"), (dict(ep=2, tp=2), "8d"),
    (dict(ep=2, sp=2), "8d"), (dict(ep=2, pp=2), "8d")])
def test_uncombined_axes_refuse_naming_their_items(fields, item):
    spec = t_mesh.MeshSpec(**fields)
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        t_mesh.check_mesh_spec(spec, spec.total_devices)


@pytest.mark.parametrize("fields", [dict(ep=2), dict(dp=2, ep=2),
                                    dict(fsdp=2, ep=2),
                                    dict(dp=2, fsdp=2, ep=4)])
def test_ep_meshes_are_built_for_training(fields):
    """ep is ported (expert parallelism) beside dp and fsdp: the spec
    passes the check at its world size, ep is the innermost dim (JAX's
    order), and the data group leaves it out (its ranks read the same
    rows)."""
    spec = t_mesh.MeshSpec(**fields)
    t_mesh.check_mesh_spec(spec, spec.total_devices)
    with pytest.raises(ValueError, match="MeshSpec wants"):
        t_mesh.build_mesh(spec, "cpu")
    assert t_mesh.MESH_DIMS[-1] == "ep"
    assert t_mesh.BATCH_AXES == ("dp", "fsdp")


def test_mesh_size_must_be_the_world():
    with pytest.raises(ValueError, match="MeshSpec wants 2 devices"):
        t_mesh.build_mesh(t_mesh.MeshSpec(dp=2), "cpu")
    # One rank and no process group: no mesh, no collective.
    assert t_mesh.build_mesh(t_mesh.MeshSpec(), "cpu") is None
    assert t_mesh.mesh_axis_size(None, "dp") == 1
    t_mesh.set_current_mesh("m")
    assert t_mesh.current_mesh() == "m"
    t_mesh.set_current_mesh(None)
    assert t_mesh.local_device_count() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)


@pytest.mark.parametrize("primaries,cards,want", [
    (1, 1, [(0, "nccl")]),
    (2, 2, [(0, "nccl"), (1, "nccl")]),
    (2, 4, [(0, "nccl"), (1, "nccl")]),
    # More primaries than cards: shared round robin, over gloo.
    (2, 1, [(0, "gloo"), (0, "gloo")]),
    (3, 2, [(0, "gloo"), (1, "gloo"), (0, "gloo")]),
])
def test_rank_card_rule(primaries, cards, want):
    assert [_device.rank_card(i, primaries, cards)
            for i in range(primaries)] == want


def test_rank_card_needs_a_card():
    with pytest.raises(ValueError, match="no card"):
        _device.rank_card(0, 1, 0)


@pytest.mark.parametrize("primaries,cards,backend", [(2, 2, "nccl"),
                                                     (2, 1, "gloo")])
def test_assign_rank_device_sets_the_card(monkeypatch, caplog, primaries,
                                          cards, backend):
    """On stub cards: the rank's card is set and named by task_device; a
    shared card logs the reason for gloo at WARNING."""
    chosen = []
    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(_device, "_RANK_CARD", None)
    with caplog.at_level("INFO", logger="tf_yarn_tpu_torch._device"):
        device, got = _device.assign_rank_device(1, primaries)
    assert got == backend
    assert device == torch.device("cuda", 1 % cards) == _device.task_device()
    assert chosen == [1 % cards]
    warned = [r for r in caplog.records if r.levelname == "WARNING"]
    assert bool(warned) == (backend == "gloo")
    if warned:
        assert "NCCL refuses two ranks on one device" in warned[0].getMessage()


def test_cpu_ranks_stay_on_gloo(monkeypatch):
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert _device.assign_rank_device(1, 2) == (torch.device("cpu"), "gloo")
