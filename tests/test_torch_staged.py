"""Staged checkpoints across ranks (the JAX package's
tests/test_staged_multihost_unit.py on the port): `_plan_gather_batches`
equals JAX's on hypothesis inputs, and two gloo ranks on the CPU, spawned
here, agree before every save and wait — a failed upload on rank 0, a
local error on rank 1 and rank 0's RAM gate each raise on both ranks at
once, within a deadline, with no rank left in a collective — then train
BERT at `MeshSpec(dp=2)` with its model_dir on a registered scheme.

The rank program lives at module level and this module imports JAX only
inside a test: the spawned ranks import the module by name."""

import json
import os
import time
from pathlib import Path

import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tf_yarn_tpu_torch import checkpoint as t_ckpt

DEADLINE_S = 150


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=1 << 12), max_size=40),
       st.integers(min_value=1, max_value=1 << 13))
def test_plan_gather_batches_equals_jax(sizes, budget):
    from tf_yarn_tpu import checkpoint as j_ckpt

    sized = list(enumerate(sizes))
    plan = t_ckpt._plan_gather_batches(sized, budget)
    assert plan == j_ckpt._plan_gather_batches(sized, budget)
    assert [i for batch in plan for i in batch] == list(range(len(sizes)))
    for batch in plan:
        assert len(batch) == 1 or sum(sizes[i] for i in batch) <= budget


def _register(root):
    from pyarrow import fs as pafs

    from tf_yarn_tpu_torch import fs as t_fs

    t_fs.register_scheme("peerfs", lambda uri: (
        pafs.SubTreeFileSystem(root, pafs.LocalFileSystem()),
        uri[len("peerfs://"):]))


def _state(value):
    return {"params": {"w": torch.full((4, 4), float(value))},
            "optimizer": {}, "step": value}


def _outcome(call):
    """(exception type name or "ok", seconds) of `call()`."""
    started = time.perf_counter()
    try:
        call()
        name = "ok"
    except Exception as exc:  # recorded for the driver's asserts
        name = type(exc).__name__
    return name, time.perf_counter() - started


def _staged_ranks(rank, world, port, root):
    import torch.distributed as dist

    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import fs as t_fs
    from tf_yarn_tpu_torch import telemetry
    from tf_yarn_tpu_torch import training as t_training
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    _register(root)
    out = {}
    real_upload = t_fs.upload_dir

    def failing_at(step):
        def upload(local_dir, uri, *args, **kwargs):
            if f".staging-ckpt-{step}" in uri:
                raise OSError("link down")
            return real_upload(local_dir, uri, *args, **kwargs)
        return upload

    try:
        model_dir = "peerfs://agree"
        writer = t_ckpt.CheckpointWriter(rank=rank, world=world)
        out["save_1"] = _outcome(lambda: writer.save(model_dir, 1, _state(1)))
        out["wait_1"] = _outcome(writer.wait)
        if rank == 0:
            t_fs.upload_dir = failing_at(2)
        out["save_2"] = _outcome(lambda: writer.save(model_dir, 2, _state(2)))
        # Rank 0's upload of step 2 fails on its writer thread: the next
        # save raises on both ranks, once.
        out["save_3"] = _outcome(lambda: writer.save(model_dir, 3, _state(3)))
        out["save_4"] = _outcome(lambda: writer.save(model_dir, 4, _state(4)))
        if rank == 0:
            t_fs.upload_dir = failing_at(5)
        out["save_5"] = _outcome(lambda: writer.save(model_dir, 5, _state(5)))
        out["wait_5"] = _outcome(writer.wait)
        t_fs.upload_dir = real_upload
        # Rank 1's state lacks a part: its error, agreed.
        broken = {"params": {}, "optimizer": {}} if rank == 1 else _state(6)
        out["save_6"] = _outcome(lambda: writer.save(model_dir, 6, broken))
        # Rank 0's host RAM cannot take the snapshot.
        real_ram = t_ckpt._host_available_ram
        if rank == 0:
            t_ckpt._host_available_ram = lambda: 64
        out["save_7"] = _outcome(lambda: writer.save(model_dir, 7, _state(7)))
        t_ckpt._host_available_ram = real_ram
        out["save_8"] = _outcome(lambda: writer.save(model_dir, 8, _state(8)))
        out["close"] = _outcome(writer.close)
        if rank == 0:
            out["steps"] = t_ckpt.list_checkpoint_steps(model_dir)

        # The train loop: BERT at dp=2, the model_dir on peerfs.
        telemetry.get_tracer().clear()
        exp = t_bert.make_experiment(
            t_bert.BertConfig.tiny(dtype=torch.float32), batch_size=4,
            seq_len=16, model_dir="peerfs://run", train_steps=4,
            checkpoint_every_steps=2, keep_last_n=1, log_every_steps=2,
            mesh_spec=MeshSpec(dp=2))
        made, init = [], exp.init_fn
        exp.init_fn = lambda device, seed: made.append(init(device, seed)) \
            or made[-1]
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
        stored = t_ckpt.restore_checkpoint("peerfs://run", 4,
                                           map_location="cpu")["params"]
        mine = made[0].state_dict()
        out["train"] = {
            "steps": t_ckpt.list_checkpoint_steps("peerfs://run"),
            "verified": t_ckpt.latest_verified_step("peerfs://run"),
            "ckpt_equals_rank": sorted(stored) == sorted(mine) and all(
                torch.equal(stored[k], mine[k]) for k in mine),
            "spans": sorted({s.name for s in telemetry.get_tracer().records()
                             if s.name.startswith("checkpoint/")}),
        }
    finally:
        with open(os.path.join(root, f"out-{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()


def test_peer_failures_raise_on_every_rank_without_a_hang(tmp_path):
    from tests._parallel_jobs import free_port

    ctx = torch.multiprocessing.spawn(
        _staged_ranks, args=(2, free_port(), str(tmp_path)), nprocs=2,
        join=False)
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=2):
            assert time.monotonic() < deadline, "a rank hung"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = [json.loads((tmp_path / f"out-{r}.json").read_text())
             for r in range(2)]
    outcomes = [{key: value[0] for key, value in r.items()
                 if key.startswith(("save", "wait", "close"))} for r in ranks]
    ok = {"save_1": "ok", "wait_1": "ok", "save_2": "ok", "save_4": "ok",
          "save_8": "ok", "close": "ok"}
    assert outcomes[0] == dict(ok, save_3="OSError", wait_5="OSError",
                               save_5="ok", save_6="PeerStagedFailure",
                               save_7="ValueError")
    assert outcomes[1] == dict(ok, save_3="PeerStagedFailure",
                               wait_5="PeerStagedFailure", save_5="ok",
                               save_6="KeyError", save_7="ValueError")
    # Every agreed failure left both ranks well inside the deadline.
    assert max(r[key][1] for r in ranks for key in r
               if key.startswith(("save", "wait"))) < 30
    assert ranks[0]["steps"] == [1, 4, 8]
    assert not [p.name for p in (tmp_path / "agree").iterdir()
                if p.name.startswith(".")]
    for rank, record in enumerate(ranks):
        train = record["train"]
        # keep_last_n=1 prunes before each save (JAX's retention), so
        # ckpt-2 stays beside ckpt-4 until a later save.
        assert train["steps"] == [2, 4] and train["verified"] == 4
        assert train["ckpt_equals_rank"], rank
        assert ("checkpoint/save_submit" in train["spans"]) == (rank == 0)
        assert "checkpoint/wait" in train["spans"]
    assert "checkpoint/agree" in ranks[1]["train"]["spans"]
    assert not [p.name for p in (tmp_path / "run").iterdir()
                if p.name.startswith(".")]
    assert (tmp_path / "run" / "tb").is_dir() or \
        not _tensorboard_imports()


def _tensorboard_imports():
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception:
        return False
    return True


def test_writer_of_one_rank_never_agrees(tmp_path, monkeypatch):
    """world=1 (every local model_dir, and one rank): no collective is
    made, so no process group is needed."""
    def no_collective(*args, **kwargs):
        raise AssertionError("a one-rank writer made a collective")

    monkeypatch.setattr(t_ckpt, "_all_reduce_max", no_collective)
    _register(str(tmp_path))
    try:
        with t_ckpt.CheckpointWriter(keep_last_n=1) as writer:
            for step in (1, 2, 3):
                writer.save("peerfs://solo", step, _state(step))
            writer.wait()
    finally:
        from tf_yarn_tpu_torch import fs as t_fs

        t_fs.unregister_scheme("peerfs")
    # Retention runs before each save, as in the JAX writer.
    assert sorted(p.name for p in (Path(tmp_path) / "solo").iterdir()) == \
        ["ckpt-2", "ckpt-3"]
