"""The train loop's elastic mesh refit and `DataParallel.reshard_state` on
gloo ranks (the port's mirror of tests/test_elastic.py:200 at its
rank scale, and of the JAX package's elastic resume through
`reshard_state`).

Four ranks train first: mnist at a declared ``MeshSpec(dp=4)``, and tiny
f32 BERT (dropout 0) at ``MeshSpec(dp=2, fsdp=2)`` and at
``MeshSpec(dp=2, tp=2)``, 4 steps each, a checkpoint every 2. Then two
ranks, under the driver's elastic environment (1 of 2 workers): the same
declared mnist mesh refits to dp=2 and resumes to step 8, with
``train/mesh_devices`` 2 and ``train/degraded`` 1; without the
environment the declared mesh raises "... devices"; and each BERT run
resumes from its ckpt-2 on the refit mesh (dp=1 x fsdp=2, dp=1 x tp=2).
There the state each rank loaded, gathered back to the one-device
format, is bitwise ckpt-2, and steps 3-4 are within 1e-5 of the
uninterrupted four-rank run.

BERT's key biases are left out of the parameter check, as in
tests/test_torch_data_parallel.py: softmax cannot see them, so their
gradient is rounding noise that Adam moves by up to the learning rate.

The ranks are spawned with `torch.multiprocessing.spawn` and import this
module by name: it imports JAX only inside functions.
"""

import json
import logging
import os
import shutil
import socket

import numpy as np
import pytest
import torch

STEPS = 4
GLOBAL_BATCH = 8
BERT_SHAPE = dict(batch_size=8, seq_len=16)
RTOL, ATOL = 1e-5, 1e-6
ELASTIC_ENV = {"TPU_YARN_ELASTIC_WORKERS": "1",
               "TPU_YARN_ELASTIC_MAX_WORKERS": "2"}


def share(batch, host_index, num_hosts):
    rows = len(next(iter(batch.values()))) // num_hosts
    return {k: v[host_index * rows:(host_index + 1) * rows]
            for k, v in batch.items()}


def mnist_input_fn(start_step=0, host_index=0, num_hosts=1):
    from tf_yarn_tpu_torch.models import common

    stream = common.synthetic_classification_iter(GLOBAL_BATCH, 16, 4)
    for i, batch in enumerate(stream):
        if i >= start_step:
            yield share(batch, host_index, num_hosts)


def bert_input_fn(start_step=0, host_index=0, num_hosts=1):
    rng = np.random.RandomState(0)
    i = 0
    while True:
        tokens = rng.randint(0, 128, (BERT_SHAPE["batch_size"],
                                      BERT_SHAPE["seq_len"]))
        batch = {"x": tokens.astype(np.int32),
                 "y": (tokens[:, 0] % 2).astype(np.int32)}
        if i >= start_step:
            yield share(batch, host_index, num_hosts)
        i += 1


def experiment(job):
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch.models import bert, mnist
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(**job["mesh"])
    params = dict(train_steps=job["steps"], log_every_steps=1,
                  checkpoint_every_steps=2, keep_last_n=None, seed=0)
    if job["model"] == "mnist":
        exp = mnist.make_experiment(
            model_dir=job["model_dir"], feature_dim=16, num_classes=4,
            hidden_sizes=(16,), learning_rate=1e-2, mesh_spec=mesh,
            input_fn=mnist_input_fn, **params)
    else:
        cfg = bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True,
                                   dropout_rate=0.0)
        exp = bert.make_experiment(cfg, model_dir=job["model_dir"],
                                   mesh_spec=mesh, input_fn=bert_input_fn,
                                   **BERT_SHAPE, **params)
    return t_experiment.as_core_experiment(exp)


class _Log(logging.Handler):
    """Each "step N: loss=" line and the mesh, refit and reshard lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses, self.lines = {}, []

    def emit(self, record):
        if record.msg.startswith("step %d: loss=%s"):
            self.losses[int(record.args[0])] = float(record.args[1])
        elif record.msg.startswith(("mesh %s", "elastic:", "resharding")):
            self.lines.append(record.getMessage())


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree.detach().cpu()
    elif isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _tensors(tree[key], f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _tensors(item, f"{prefix}/{i}")


def _roundtrip(job, record):
    """Wrap `DataParallel.load_rank_state` so that, once the rank has
    loaded its part of the checkpoint, the gathered one-device state is
    compared with the checkpoint on disk, tensor for tensor, bitwise
    (rank 0 holds the gathered state)."""
    from tf_yarn_tpu_torch import checkpoint as t_ckpt
    from tf_yarn_tpu_torch.parallel import data_parallel

    original = data_parallel.DataParallel.load_rank_state

    def load(self, state):
        original(self, state)
        gathered = self.full_state()
        if not torch.distributed.get_rank() == 0:
            return
        stored = t_ckpt.restore_checkpoint(job["model_dir"], job["resume"],
                                           map_location="cpu")
        mismatched = []
        for part in ("params", "optimizer"):
            want = dict(_tensors(stored[part]))
            got = dict(_tensors(gathered[part]))
            if sorted(want) != sorted(got):
                mismatched.append(f"{part}: keys")
            mismatched += [f"{part}{key}" for key in want
                           if key in got and not torch.equal(want[key],
                                                             got[key])]
            record[f"{part}_tensors"] = len(want)
        record["roundtrip_mismatched"] = mismatched

    data_parallel.DataParallel.load_rank_state = load
    return original


def _rank_jobs(rank, world, port, jobs_path):
    import torch.distributed as dist

    from tf_yarn_tpu_torch import telemetry
    from tf_yarn_tpu_torch import training as t_training
    from tf_yarn_tpu_torch.parallel import data_parallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    handler = _Log()
    for name in ("tf_yarn_tpu_torch.training",
                 "tf_yarn_tpu_torch.parallel.data_parallel"):
        logging.getLogger(name).setLevel(logging.INFO)
        logging.getLogger(name).addHandler(handler)
    try:
        with open(jobs_path) as fh:
            jobs = json.load(fh)
        for job in jobs:
            handler.losses, handler.lines = {}, []
            telemetry.get_registry().clear()
            os.environ.update(job.get("env", {}))
            record = {}
            original = _roundtrip(job, record) if job.get("resume") else None
            try:
                record["final"] = t_training.train_and_evaluate(
                    experiment(job), device="cpu")
            except ValueError as exc:
                record["error"] = str(exc)
            finally:
                for key in job.get("env", {}):
                    os.environ.pop(key)
                if original is not None:
                    data_parallel.DataParallel.load_rank_state = original
            gauges = telemetry.get_registry().snapshot()
            record.update(losses=handler.losses, lines=handler.lines,
                          mesh_devices=gauges.get("train/mesh_devices"),
                          degraded=gauges.get("train/degraded"))
            with open(f"{job['out']}-{rank}.json", "w") as fh:
                json.dump(record, fh)
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(tmp, world, jobs):
    path = os.path.join(tmp, f"jobs-{world}.json")
    with open(path, "w") as fh:
        json.dump(jobs, fh)
    torch.multiprocessing.spawn(_rank_jobs, args=(world, free_port(), path),
                                nprocs=world, join=True)
    return {job["name"]: [json.load(open(f"{job['out']}-{r}.json"))
                          for r in range(world)] for job in jobs}


FULL = {"mnist": ("mnist", {"dp": 4}),
        "fsdp": ("bert", {"dp": 2, "fsdp": 2}),
        "tp": ("bert", {"dp": 2, "tp": 2})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("reshard"))

    def job(name, model, mesh, steps, model_dir, **extra):
        return dict(name=name, model=model, mesh=mesh, steps=steps,
                    model_dir=model_dir, out=os.path.join(tmp, name), **extra)

    four = [job(f"{key}_full", model, mesh, STEPS,
                os.path.join(tmp, f"{key}_full"))
            for key, (model, mesh) in FULL.items()]
    results = run_ranks(tmp, 4, four)
    resumed = {}
    for key in ("fsdp", "tp"):
        # The resumed run starts from the full run's ckpt-2 alone.
        resumed[key] = os.path.join(tmp, f"{key}_resumed")
        os.makedirs(resumed[key])
        shutil.copytree(os.path.join(tmp, f"{key}_full", "ckpt-2"),
                        os.path.join(resumed[key], "ckpt-2"))
    model, mesh = FULL["mnist"]
    two = [job("mnist_short", model, mesh, 2 * STEPS,
               os.path.join(tmp, "mnist_full"), env=ELASTIC_ENV),
           job("mnist_refused", model, mesh, 2 * STEPS,
               os.path.join(tmp, "mnist_refused"))]
    two += [job(f"{key}_resumed", *FULL[key], STEPS, resumed[key],
                env=ELASTIC_ENV, resume=2) for key in ("fsdp", "tp")]
    results.update(run_ranks(tmp, 2, two))
    dirs = {name: os.path.join(tmp, name)
            for name in ("fsdp_full", "tp_full", "mnist_full")}
    dirs.update({f"{key}_resumed": path for key, path in resumed.items()})
    return {"ranks": results, "dirs": dirs}


def _params(model_dir, step):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    return t_ckpt.restore_checkpoint(model_dir, step, "cpu")["params"]


def test_full_capacity_run_reports_its_mesh(runs):
    for rank in runs["ranks"]["mnist_full"]:
        assert rank["mesh_devices"] == 4.0 and rank["degraded"] == 0.0
        assert not any(line.startswith("elastic:") for line in rank["lines"])
        assert np.isfinite(rank["final"]["loss"])


def test_elastic_relaunch_refits_the_declared_mesh(runs):
    """tests/test_elastic.py:200 at two ranks: the declared dp=4 mesh
    refits to dp=2 (the JAX package's `resize_mesh_spec`), the run
    resumes at step 4 and ends at 8, and the gauges read the refit mesh
    and the degraded attempt."""
    from tf_yarn_tpu.parallel.mesh import MeshSpec, resize_mesh_spec

    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    refit = resize_mesh_spec(MeshSpec(dp=4), 2)
    for rank in runs["ranks"]["mnist_short"]:
        assert rank["mesh_devices"] == 2.0 and rank["degraded"] == 1.0
        assert np.isfinite(rank["final"]["loss"])
        assert sorted(rank["losses"]) == [str(s) for s in range(5, 9)]
        refits = [line for line in rank["lines"]
                  if line.startswith("elastic:")]
        assert refits == [f"elastic: declared mesh {MeshSpec(dp=4)} refit "
                          f"onto 2 ranks -> {refit}"]
        assert any("'dp': 2" in line for line in rank["lines"]
                   if line.startswith("mesh"))
    assert t_ckpt.latest_verified_step(runs["dirs"]["mnist_full"]) == 8


def test_mismatch_without_the_elastic_env_still_raises(runs):
    for rank in runs["ranks"]["mnist_refused"]:
        assert "devices" in rank["error"]
        assert "final" not in rank


@pytest.mark.parametrize("key", ["fsdp", "tp"])
def test_resume_on_the_refit_mesh_restores_ckpt_bitwise(runs, key):
    """The declared dp=2 x fsdp=2 (tp=2) mesh refits to dp=1 x fsdp=2
    (tp=2) on two ranks; each rank's part of ckpt-2, gathered back, is
    the checkpoint bit for bit, and the resize is logged."""
    ranks = runs["ranks"][f"{key}_resumed"]
    first = ranks[0]
    assert first["roundtrip_mismatched"] == []
    assert first["params_tensors"] > 10 and first["optimizer_tensors"] > 10
    want = {"fsdp": "{'pp': 1, 'dp': 1, 'fsdp': 2, 'sp': 1, 'tp': 1, "
                    "'ep': 1}",
            "tp": "{'pp': 1, 'dp': 1, 'fsdp': 1, 'sp': 1, 'tp': 2, "
                  "'ep': 1}"}[key]
    for rank in ranks:
        assert rank["mesh_devices"] == 2.0 and rank["degraded"] == 1.0
        assert any(line.startswith("resharding state: MeshSpec(")
                   and line.endswith(want) for line in rank["lines"]), \
            rank["lines"]


@pytest.mark.parametrize("key", ["fsdp", "tp"])
def test_resumed_steps_match_the_uninterrupted_run(runs, key):
    full = runs["ranks"][f"{key}_full"][0]
    for rank in runs["ranks"][f"{key}_resumed"]:
        assert sorted(rank["losses"]) == ["3", "4"]
        np.testing.assert_allclose(
            [rank["losses"][s] for s in ("3", "4")],
            [full["losses"][s] for s in ("3", "4")], rtol=RTOL, atol=ATOL)
    got = _params(runs["dirs"][f"{key}_resumed"], STEPS)
    want = _params(runs["dirs"][f"{key}_full"], STEPS)
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith("wk.bias"):
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    before = _params(runs["dirs"][f"{key}_full"], 2)
    assert any(not torch.equal(before[name], want[name]) for name in want)
