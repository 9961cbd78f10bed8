"""The port's train loop held against the JAX package's on the CPU:
input prefetch and throughput on ragged batches, both on the tiny f32
BERT classifier."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import bert as t_bert


def _batches(sizes, seq_len=8, seed=0):
    """{"x", "y"} batches of the given sizes, tokens from a seed, labels
    the first token modulo the tiny config's 2 classes."""
    rng = np.random.RandomState(seed)
    out = []
    for size in sizes:
        tokens = rng.randint(0, 128, (size, seq_len)).astype(np.int32)
        out.append({"x": tokens, "y": (tokens[:, 0] % 2).astype(np.int32)})
    return out


def _recording_input(batches, threads):
    """An input_fn over `batches` that notes the thread each is pulled on."""
    def input_fn():
        for batch in batches:
            threads.append(threading.current_thread().name)
            yield batch
    return input_fn


def _run_jax(batches, threads, **params):
    from tf_yarn_tpu import telemetry as j_telemetry
    from tf_yarn_tpu.experiment import as_core_experiment
    from tf_yarn_tpu.models import bert as j_bert
    from tf_yarn_tpu.parallel.mesh import select_devices
    from tf_yarn_tpu.training import train_and_evaluate

    cfg = j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False)
    exp = j_bert.make_experiment(
        cfg, input_fn=_recording_input(batches, threads), **params)
    train_and_evaluate(as_core_experiment(exp),
                       devices=select_devices(1, platform="cpu"))
    return j_telemetry.get_registry()


def _run_port(batches, threads, **params):
    cfg = t_bert.BertConfig.tiny(dtype=torch.float32, fused_norms=False)
    exp = t_bert.make_experiment(
        cfg, input_fn=_recording_input(batches, threads), **params)
    t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                  device="cpu")
    return telemetry.get_registry()


RUNS = {"jax": _run_jax, "port": _run_port}


@pytest.mark.parametrize("package", sorted(RUNS))
def test_train_input_is_prefetched_off_the_loop_thread(package):
    """The first batch is pulled where the loop starts; every later one
    on the prefetch thread, whose queue depth is published under
    ``prefetch/queue_depth{pipeline=train}``, in both packages."""
    threads = []
    registry = RUNS[package](_batches([2] * 5), threads, train_steps=4,
                             log_every_steps=2)
    assert len(threads) >= 4
    assert threads[0] == "MainThread"
    assert "MainThread" not in threads[1:]
    assert "prefetch/queue_depth{pipeline=train}" in registry.snapshot()


@pytest.mark.parametrize("package", sorted(RUNS))
def test_ragged_batches_weight_the_throughput(package):
    """Batches of 4, 4 and 2 in one 3-step log interval: 10 of the 12
    full-batch samples ran, so samples/s is steps/s x 4 x 10/12 and
    ``train/samples_total`` grows by 10, in both packages."""
    from tf_yarn_tpu import telemetry as j_telemetry

    registry = {"jax": j_telemetry, "port": telemetry}[package].get_registry()
    before = registry.counter("train/samples_total").value
    registry = RUNS[package](_batches([4, 4, 2]), [], train_steps=3,
                             log_every_steps=3)
    steps_per_sec = registry.gauge("train/steps_per_sec").value
    samples_per_sec = registry.gauge("train/samples_per_sec").value
    assert samples_per_sec / steps_per_sec == pytest.approx(10 / 3)
    assert registry.counter("train/samples_total").value - before == 10


# The elastic launcher's worker counts: unset (not an elastic run), an
# attempt short of its reservation, and a full one.
ELASTIC = {"unset": None, "short": ("2", "4"), "full": ("4", "4")}


@pytest.mark.parametrize("elastic", sorted(ELASTIC))
def test_capacity_gauges_and_placement_timing_match_jax(elastic, monkeypatch):
    """4 steps of batch 2 on one CPU device: both registries hold the same
    keys, among them ``train/mesh_devices`` (1.0), ``train/degraded``
    (1.0 only for an elastic attempt below its full worker count) and
    the ``train/globalize_seconds`` histogram of batch placement. The
    JAX package's async checkpoint writer (``checkpoint/seconds{op=
    save_submit|wait}``) is not ported yet; no checkpoint is written
    here."""
    from tf_yarn_tpu import constants
    from tf_yarn_tpu import telemetry as j_telemetry

    for name in (constants.ENV_ELASTIC_WORKERS,
                 constants.ENV_ELASTIC_MAX_WORKERS):
        monkeypatch.delenv(name, raising=False)
    if ELASTIC[elastic]:
        workers, most = ELASTIC[elastic]
        monkeypatch.setenv(constants.ENV_ELASTIC_WORKERS, workers)
        monkeypatch.setenv(constants.ENV_ELASTIC_MAX_WORKERS, most)
    assert (t_training.ENV_ELASTIC_WORKERS,
            t_training.ENV_ELASTIC_MAX_WORKERS) == (
        constants.ENV_ELASTIC_WORKERS, constants.ENV_ELASTIC_MAX_WORKERS)
    snapshots = {}
    for package, module in (("jax", j_telemetry), ("port", telemetry)):
        module.get_registry().clear()
        RUNS[package](_batches([2] * 4), [], train_steps=4, log_every_steps=2)
        snapshots[package] = {
            key: value for key, value in module.get_registry().snapshot().items()
            if not key.startswith("checkpoint/seconds")}
    assert sorted(snapshots["port"]) == sorted(snapshots["jax"])
    degraded = 1.0 if elastic == "short" else 0.0
    for snapshot in snapshots.values():
        assert snapshot["train/mesh_devices"] == 1.0
        assert snapshot["train/degraded"] == degraded
        assert snapshot["train/globalize_seconds_count"] >= 4
