"""The port's batch inference (`inference.run_inference` with an
`InferenceExperiment`) over a checkpoint the port's `train_and_evaluate`
wrote, on the CPU."""

import json
import types

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import inference as t_inference
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import generate as t_generate
from tf_yarn_tpu_torch.models import transformer as tt

CFG = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                kv_cache_dtype="int8")
EOS = 7


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt"))
    exp = tt.make_experiment(CFG, model_dir=path, train_steps=2, batch_size=2,
                             seq_len=16, checkpoint_every_steps=1,
                             log_every_steps=1)
    t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                  device="cpu")
    return path


def _batches():
    """Two batches of shape [2, 9] with an id column to echo."""
    rng = np.random.RandomState(4)
    for b in range(2):
        yield {"tokens": rng.randint(0, CFG.vocab_size, (2, 9)).astype(np.int32),
               "id": np.array([10 * b, 10 * b + 1])}


def _experiment(model_dir, output_path, **overrides):
    kwargs = dict(model=tt.Transformer(CFG, device="cpu"), model_dir=model_dir,
                  input_fn=_batches, output_path=str(output_path),
                  max_new_tokens=5, eos_token=EOS)
    kwargs.update(overrides)
    return t_experiment.InferenceExperiment(**kwargs)


def test_run_inference_writes_records_in_order(model_dir, tmp_path):
    out = tmp_path / "out.jsonl"
    exp = _experiment(model_dir, out)
    stats = t_inference.run_inference(exp)
    assert stats["records"] == 4 and stats["batches"] == 2
    assert stats["ckpt_step"] == 2
    assert 0 < stats["tokens_per_sec"] <= stats["padded_tokens_per_sec"]
    assert set(stats["stage_seconds"]) == {"input_wait", "decode",
                                           "writer_put", "write"}
    assert stats["decode_engine"]["calls"] >= 2
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in records] == [0, 1, 10, 11]
    # The restored params: the newest checkpoint's, and generate over
    # them reproduces every record.
    restored = tt.Transformer(CFG, device="cpu")
    restored.load_state_dict(torch.load(f"{model_dir}/ckpt-2/params.pt"))
    for batch, pair in zip(_batches(), (records[:2], records[2:])):
        expected = t_generate.generate_legacy(restored, batch["tokens"], 5,
                                              eos_token=EOS).numpy()
        for row, record in enumerate(pair):
            assert record["prompt"] == batch["tokens"][row].tolist()
            assert record["tokens"] == expected[row, 9:].tolist()


def test_run_inference_explicit_step_and_missing_checkpoint(model_dir,
                                                            tmp_path):
    stats = t_inference.run_inference(
        _experiment(model_dir, tmp_path / "one.jsonl", step=1))
    assert stats["ckpt_step"] == 1 and stats["records"] == 4
    with pytest.raises(FileNotFoundError, match="ckpt"):
        t_inference.run_inference(
            _experiment(str(tmp_path / "empty"), tmp_path / "none.jsonl"))
    with pytest.raises(ValueError, match="prefetch_depth"):
        _experiment(model_dir, tmp_path / "x", prefetch_depth=0)


def test_multi_shard_stream_needs_shard_keywords(model_dir, tmp_path):
    def runtime(task_id):
        key = types.SimpleNamespace(type="inference", id=task_id)
        tasks = [types.SimpleNamespace(key=types.SimpleNamespace(
            type="inference", id=i)) for i in range(2)]
        return types.SimpleNamespace(task_key=key, cluster_tasks=tasks)

    with pytest.raises(ValueError, match="shard, num_shards"):
        t_inference.run_inference(_experiment(model_dir, tmp_path / "o"),
                                  runtime(0))

    def sharded(shard, num_shards):
        for i, batch in enumerate(_batches()):
            if i % num_shards == shard:
                yield batch

    stats = t_inference.run_inference(
        _experiment(model_dir, tmp_path / "o", input_fn=sharded), runtime(1))
    assert stats["records"] == 2
    records = [json.loads(line)
               for line in (tmp_path / "o-1").read_text().splitlines()]
    assert [r["id"] for r in records] == [10, 11]
