"""The port's worker task program launched by `run_on_gpu` on the CPU
(``TPU_YARN_PLATFORM=cpu``): a port experiment trains in the task as it
does in process, the KV store and the Metrics see it, a task without
that setting never falls back to the CPU, and two primaries join a gloo
process group — batch inference shards its stream as the JAX package
does, and training runs data-parallel (one model, never independent
replicas)."""

import json
import os

import numpy as np
import pytest
import torch

from tf_yarn_tpu.inference import _call_input_fn as jax_shard_stream
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import inference as t_inference
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.resilience import FailureKind
from tf_yarn_tpu_torch.topologies import TaskSpec

STEPS = 3


def _bert_experiment_fn(model_dir):
    """A tiny f32 BERT fine-tune (dropout 0) writing to `model_dir`."""

    def experiment_fn():
        import torch

        from tf_yarn_tpu_torch.models import bert

        return bert.make_experiment(
            bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True),
            model_dir=model_dir, train_steps=STEPS, batch_size=4, seq_len=16,
            learning_rate=1e-3, log_every_steps=1)

    return experiment_fn


def _workers(n=1):
    return {"worker": TaskSpec(instances=n)}


class _KVAtTheEnd:
    """Reads keys of the run's KV store as the attempt ends (before the
    driver stops the server)."""

    def __init__(self, monkeypatch, keys):
        self.values = {}
        original = t_client.handle_events

        def reading(kv, tasks):
            self.values.update({key: kv.get_str(key) for key in keys})
            return original(kv, tasks)

        monkeypatch.setattr(t_client, "handle_events", reading)


def test_a_port_experiment_trains_in_the_worker_as_in_process(
        tmp_path, monkeypatch):
    launched, local = str(tmp_path / "launched"), str(tmp_path / "local")
    kv = _KVAtTheEnd(monkeypatch, ["worker:0/last_training_step",
                                   "worker:0/metrics"])
    metrics = t_client.run_on_gpu(
        _bert_experiment_fn(launched), _workers(),
        env={"TPU_YARN_PLATFORM": "cpu"}, poll_every_secs=0.2)
    assert metrics.train_eval_time_per_node["worker:0"] is not None
    assert metrics.total_training_duration is not None
    assert set(metrics.container_duration) == {"worker:0"}
    assert kv.values["worker:0/last_training_step"] == str(STEPS)
    assert json.loads(kv.values["worker:0/metrics"])["train/steps_total"] \
        == STEPS

    t_training.train_and_evaluate(
        t_experiment.as_core_experiment(_bert_experiment_fn(local)()),
        device="cpu")
    # Beside the checkpoint, the loop's TensorBoard events where
    # tensorboard imports (`tb/`).
    assert sorted(os.listdir(launched)) == sorted(os.listdir(local))
    assert [name for name in sorted(os.listdir(launched)) if name != "tb"] \
        == [f"ckpt-{STEPS}"]
    got = torch.load(f"{launched}/ckpt-{STEPS}/params.pt")
    ref = torch.load(f"{local}/ckpt-{STEPS}/params.pt")
    assert got.keys() == ref.keys()
    for name in ref:
        # f32 on the CPU in two processes: the same arithmetic, up to the
        # thread count's reduction order.
        torch.testing.assert_close(got[name], ref[name], rtol=1e-5, atol=1e-6)


def test_without_the_cpu_setting_the_task_never_falls_back(
        tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    with pytest.raises(t_client.RunFailed) as err:
        t_client.run_on_gpu(_bert_experiment_fn(str(tmp_path / "model")),
                            _workers(), poll_every_secs=0.2)
    assert "no CUDA device is available" in str(err.value)
    # The kind the JAX package gives its own missing-accelerator error
    # (tests/test_torch_launcher.py, case "no_device").
    assert err.value.kind is FailureKind.TRANSIENT
    assert not os.path.exists(tmp_path / "model")


CFG = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                kv_cache_dtype="int8")


def _make_stream():
    """The input_fn: four [2, 7] prompt batches with an id column, batch i
    to shard i % num_shards. A local function, so cloudpickle sends it
    to the tasks by value."""

    def stream(shard=0, num_shards=1):
        rng = np.random.RandomState(5)
        for b in range(4):
            batch = {"tokens": rng.randint(0, 256, (2, 7)).astype(np.int32),
                     "id": np.array([10 * b, 10 * b + 1])}
            if b % num_shards == shard:
                yield batch

    return stream


def _inference_fn(model_dir, output_path, stream):
    def experiment_fn():
        import torch

        from tf_yarn_tpu_torch._device import task_device
        from tf_yarn_tpu_torch.experiment import InferenceExperiment
        from tf_yarn_tpu_torch.models import transformer as tt

        cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                        kv_cache_dtype="int8")
        return InferenceExperiment(
            model=tt.Transformer(cfg, device=task_device()),
            model_dir=model_dir, input_fn=stream, output_path=output_path,
            max_new_tokens=4)

    return experiment_fn


@pytest.fixture(scope="module")
def decoder_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder"))
    exp = tt.make_experiment(CFG, model_dir=path, train_steps=1, batch_size=2,
                             seq_len=16, log_every_steps=1)
    t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                  device="cpu")
    return path


def test_two_inference_workers_write_the_jax_shards(decoder_dir, tmp_path):
    out = str(tmp_path / "records.jsonl")
    stream = _make_stream()
    t_client.run_on_gpu(_inference_fn(decoder_dir, out, stream), _workers(2),
                        env={"TPU_YARN_PLATFORM": "cpu"}, poll_every_secs=0.2)
    shards = [[json.loads(line) for line in open(f"{out}-{i}")]
              for i in range(2)]
    for i, records in enumerate(shards):
        expected_ids = [int(x) for batch in jax_shard_stream(stream, i, 2)
                        for x in batch["id"]]
        assert [r["id"] for r in records] == expected_ids
    alone = str(tmp_path / "alone.jsonl")
    t_inference.run_inference(_inference_fn(decoder_dir, alone, stream)())
    ref = sorted((json.loads(line) for line in open(alone)),
                 key=lambda r: r["id"])
    assert sorted(shards[0] + shards[1], key=lambda r: r["id"]) == ref


def test_two_training_workers_refuse_independent_replicas(tmp_path,
                                                         monkeypatch):
    """Two workers train one model (MeshSpec.auto(2): FSDP2 over 2 gloo
    ranks). The input_fn declares no host_index, so each rank reads the
    whole synthetic batch: their mean gradient is one device's, and the
    checkpoint rank 0 alone writes equals the in-process run's (f32,
    dropout 0; 1e-5)."""
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    launched, local = str(tmp_path / "model"), str(tmp_path / "local")
    kv = _KVAtTheEnd(monkeypatch, ["worker:0/last_training_step",
                                   "worker:1/last_training_step"])
    metrics = t_client.run_on_gpu(_bert_experiment_fn(launched), _workers(2),
                                  env={"TPU_YARN_PLATFORM": "cpu"},
                                  poll_every_secs=0.2)
    assert set(metrics.container_duration) == {"worker:0", "worker:1"}
    # Rank 0 broadcasts the step; rank 1 does not.
    assert kv.values == {"worker:0/last_training_step": str(STEPS),
                         "worker:1/last_training_step": None}
    t_training.train_and_evaluate(
        t_experiment.as_core_experiment(_bert_experiment_fn(local)()),
        device="cpu")
    assert t_ckpt.list_checkpoint_steps(launched) == [STEPS]
    got = t_ckpt.restore_checkpoint(launched, STEPS, "cpu")
    want = t_ckpt.restore_checkpoint(local, STEPS, "cpu")
    assert sorted(got["params"]) == sorted(want["params"])
    for name, value in got["params"].items():
        if name.endswith("wk.bias"):  # rounding noise moved by Adam
            continue
        np.testing.assert_allclose(value.numpy(), want["params"][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
