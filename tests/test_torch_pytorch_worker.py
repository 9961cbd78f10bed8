"""The port's PyTorch experiment (`pytorch`, `tasks.pytorch_worker`,
`utils.model_ckpt`) held against the JAX package's.

Both packages' pytorch workers are launched with 2 gloo workers (the JAX
package's `test_pytorch_ddp_e2e_two_workers` is the pattern) on the same
seeded `nn.Linear`, `TensorDataset` and `DataLoaderArgs`; each rank 0
saves through its package's `model_ckpt`, and the final parameters must
be bitwise equal (the same DDP over gloo on the same CPU inputs). The
launches run with ``TPU_YARN_PLATFORM=cpu`` (tests/conftest.py), and
this directory on the tasks' PYTHONPATH: the experiment fn is this
module's, pickled by reference.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch import pytorch as t_pytorch
from tf_yarn_tpu_torch.tasks import pytorch_worker
from tf_yarn_tpu_torch.tasks.distributed import TaskParameters
from tf_yarn_tpu_torch.utils import model_ckpt as t_model_ckpt


def seeded_experiment(package, out_dir, epochs=3):
    """The same experiment for `package` ("tf_yarn_tpu" or
    "tf_yarn_tpu_torch"): an nn.Linear from torch's seed 0, 64 rows from
    numpy's seed 0, SGD, rank 0 saving model_<epochs>.pt; each rank
    writes rank-<r>.json (its world, backend, device and wrapper)."""
    import importlib

    import torch as t
    import torch.distributed as dist

    pt = importlib.import_module(f"{package}.pytorch")
    model_ckpt = importlib.import_module(f"{package}.utils.model_ckpt")
    t.manual_seed(0)
    rng = np.random.RandomState(0)
    x = t.from_numpy(rng.randn(64, 4).astype(np.float32))
    y = (x.sum(dim=1, keepdim=True) > 0).float()

    def main_fn(model, loader, device, rank, tb_writer):
        opt = t.optim.SGD(model.parameters(), lr=0.05)
        loss_fn = t.nn.BCEWithLogitsLoss()
        for epoch in range(epochs):
            loader.sampler.set_epoch(epoch)
            for xb, yb in loader:
                opt.zero_grad()
                loss = loss_fn(model(xb.to(device)), yb.to(device))
                loss.backward()
                opt.step()
        if rank == 0:
            model_ckpt.save_ckpt(out_dir, model, opt, epoch=epochs)
        with open(os.path.join(out_dir, f"rank-{rank}.json"), "w") as fh:
            json.dump({"world": dist.get_world_size(),
                       "backend": dist.get_backend(), "device": str(device),
                       "wrapper": type(model).__name__,
                       "tb_writer": tb_writer is not None}, fh)

    return pt.PytorchExperiment(
        model=t.nn.Linear(4, 1), main_fn=main_fn,
        train_dataset=t.utils.data.TensorDataset(x, y),
        dataloader_args=pt.DataLoaderArgs(batch_size=8, shuffle=True))


TASK_ENV = {"PYTHONPATH": os.pathsep.join(
    [os.path.dirname(os.path.abspath(__file__)),
     os.environ.get("PYTHONPATH", "")])}


def _records(out_dir, world):
    return [json.load(open(os.path.join(out_dir, f"rank-{r}.json")))
            for r in range(world)]


def test_two_ddp_workers_end_bitwise_equal_to_jax(tmp_path):
    from tf_yarn_tpu import pytorch as j_pytorch
    from tf_yarn_tpu.topologies import TaskSpec as JTaskSpec
    from tf_yarn_tpu.utils import model_ckpt as j_model_ckpt
    from tf_yarn_tpu_torch.topologies import TaskSpec

    dirs = {p: str(tmp_path / p) for p in ("tf_yarn_tpu", "tf_yarn_tpu_torch")}
    for d in dirs.values():
        os.makedirs(d)
    j_pytorch.run_on_tpu(
        lambda: seeded_experiment("tf_yarn_tpu", dirs["tf_yarn_tpu"]),
        {"worker": JTaskSpec(instances=2)}, env=TASK_ENV,
        poll_every_secs=0.3)
    metrics = t_pytorch.run_on_gpu(
        lambda: seeded_experiment("tf_yarn_tpu_torch",
                                  dirs["tf_yarn_tpu_torch"]),
        {"worker": TaskSpec(instances=2)}, env=TASK_ENV,
        poll_every_secs=0.3)
    assert metrics.total_training_duration is not None
    assert sorted(os.listdir(dirs["tf_yarn_tpu"])) == sorted(
        os.listdir(dirs["tf_yarn_tpu_torch"])) == [
            "model_3.pt", "rank-0.json", "rank-1.json"]
    port = t_model_ckpt.load_latest_ckpt(dirs["tf_yarn_tpu_torch"])
    ref = j_model_ckpt.load_latest_ckpt(dirs["tf_yarn_tpu"])
    assert sorted(port) == sorted(ref) == ["epoch", "model", "optimizer"]
    assert port["epoch"] == ref["epoch"] == 3
    assert sorted(port["model"]) == sorted(ref["model"]) == ["bias", "weight"]
    for name, value in port["model"].items():
        assert torch.equal(value, ref["model"][name]), name
    # The DDP wrapper is unwrapped on save: the plain Linear's keys.
    assert port["optimizer"]["param_groups"] == ref["optimizer"]["param_groups"]
    assert _records(dirs["tf_yarn_tpu_torch"], 2) == [
        {"world": 2, "backend": "gloo", "device": "cpu",
         "wrapper": "DistributedDataParallel", "tb_writer": False}] * 2


def test_two_local_ranks_in_one_worker(tmp_path):
    """nb_proc_per_worker=2: the worker starts both ranks itself
    (`tasks.distributed.parallel_run`)."""
    from tf_yarn_tpu_torch.topologies import TaskSpec

    out = str(tmp_path)
    t_pytorch.run_on_gpu(
        lambda: seeded_experiment("tf_yarn_tpu_torch", out, epochs=1),
        {"worker": TaskSpec(instances=1, nb_proc_per_worker=2)},
        env=TASK_ENV, poll_every_secs=0.3)
    assert [r["world"] for r in _records(out, 2)] == [2, 2]
    assert t_model_ckpt.load_latest_ckpt(out)["epoch"] == 1


def test_data_loader_args_refuse_drop_last_as_jax_does():
    from tf_yarn_tpu import pytorch as j_pytorch

    with pytest.raises(ValueError) as port:
        t_pytorch.DataLoaderArgs(drop_last=False)
    with pytest.raises(ValueError) as ref:
        j_pytorch.DataLoaderArgs(drop_last=False)
    assert str(port.value) == str(ref.value)
    assert t_pytorch.DataLoaderArgs() == t_pytorch.DataLoaderArgs(
        **vars(j_pytorch.DataLoaderArgs()))
    assert vars(t_pytorch.DistributedDataParallelArgs()) == vars(
        j_pytorch.DistributedDataParallelArgs())


def test_iterable_dataset_without_ranks_warns(caplog):
    class Stream(torch.utils.data.IterableDataset):
        def __iter__(self):
            return iter(torch.arange(8.0))

    class Sharded(Stream):
        shards_by_rank = True

    def params(world):
        return TaskParameters("worker", 0, 0, 0, world, "127.0.0.1", 1, 1)

    def experiment(dataset):
        return t_pytorch.PytorchExperiment(
            model=None, main_fn=None, train_dataset=dataset,
            dataloader_args=t_pytorch.DataLoaderArgs(batch_size=4))

    with caplog.at_level(logging.WARNING, logger=pytorch_worker.__name__):
        loader = pytorch_worker.make_loader(experiment(Stream()), params(2))
        pytorch_worker.make_loader(experiment(Sharded()), params(2))
        pytorch_worker.make_loader(experiment(Stream()), params(1))
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 1
    assert "Stream exposes no rank/world_size attributes; every rank will " \
        "iterate the whole dataset" in warned[0]
    assert [b.tolist() for b in loader] == [[0.0, 1.0, 2.0, 3.0],
                                            [4.0, 5.0, 6.0, 7.0]]


def test_backend_and_device_on_the_cpu(monkeypatch):
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert t_pytorch.collective_backend() == "gloo"
    assert t_pytorch.get_device() == torch.device("cpu")
    assert t_pytorch.PYTORCH_TASK_MODULE == "tf_yarn_tpu_torch.tasks.pytorch_worker"
    monkeypatch.delenv("TPU_YARN_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_pytorch.get_device()


def test_remote_paths_name_item_5_4(tmp_path, monkeypatch):
    """Item 5.4 is ported: a remote tensorboard_remote_dir and model_dir
    go through fs (here a registered scheme over a local subtree)."""
    from pyarrow import fs as pafs

    from tf_yarn_tpu_torch import fs as t_fs
    from tf_yarn_tpu_torch.tasks import pytorch_worker as t_worker

    remote = tmp_path / "remote"
    remote.mkdir()
    monkeypatch.setitem(t_fs._REGISTRY, "workerfs", lambda uri: (
        pafs.SubTreeFileSystem(str(remote), pafs.LocalFileSystem()),
        uri[len("workerfs://"):]))
    exp = t_pytorch.PytorchExperiment(model=None, main_fn=None,
                                      train_dataset=None,
                                      tensorboard_remote_dir="workerfs://tb")
    assert exp.tensorboard_remote_dir == "workerfs://tb" and exp.backend is None
    spool = tmp_path / "spool"
    (spool / "run").mkdir(parents=True)
    (spool / "run" / "events.out").write_bytes(b"e" * 10)
    t_worker._upload_tb_logs(str(spool), exp.tensorboard_remote_dir)
    assert (remote / "tb" / "run" / "events.out").read_bytes() == b"e" * 10

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    assert t_model_ckpt.find_latest_ckpt("workerfs://model") is None
    for epoch in (3, 11):
        t_model_ckpt.save_ckpt("workerfs://model", model, opt, epoch)
    assert t_model_ckpt.find_latest_ckpt("workerfs://model") == \
        "workerfs://model/model_11.pt"
    state = t_model_ckpt.load_latest_ckpt("workerfs://model")
    assert state["epoch"] == 11
    assert torch.equal(state["model"]["weight"], model.weight)


def test_model_ckpt_layout_matches_jax(tmp_path):
    from tf_yarn_tpu.utils import model_ckpt as j_model_ckpt

    class Wrapped(torch.nn.Module):  # stands for the DDP wrapper
        def __init__(self, module):
            super().__init__()
            self.module = module

    for package, mod in (("port", t_model_ckpt), ("jax", j_model_ckpt)):
        model_dir = str(tmp_path / package)
        os.makedirs(model_dir)
        assert mod.find_latest_ckpt(model_dir) is None
        assert mod.load_latest_ckpt(model_dir) is None
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for epoch in (2, 10, 9):
            mod.save_ckpt(model_dir, Wrapped(model), opt, epoch, tag="x")
    for package, mod in (("port", t_model_ckpt), ("jax", j_model_ckpt)):
        model_dir = str(tmp_path / package)
        assert sorted(os.listdir(model_dir)) == [
            "model_10.pt", "model_2.pt", "model_9.pt"]
        assert mod.find_latest_ckpt(model_dir).endswith("model_10.pt")
        state = mod.load_latest_ckpt(model_dir)
        assert state["epoch"] == 10 and state["tag"] == "x"
        assert sorted(state["model"]) == ["bias", "weight"]
    port = t_model_ckpt.load_latest_ckpt(str(tmp_path / "port"))
    ref = j_model_ckpt.load_latest_ckpt(str(tmp_path / "jax"))
    for name in port["model"]:
        assert torch.equal(port["model"][name], ref["model"][name])
