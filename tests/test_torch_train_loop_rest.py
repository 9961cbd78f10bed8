"""The rest of the port's train loop held against the JAX package's on the
CPU: ``steps_per_loop`` chunks, the preemption drain, the async
`CheckpointWriter`, the profile window and the TensorBoard scalars.

Both packages train the tiny f32 BERT classifier from the same weights
(flax variables bridged with `models/weights.bert_from_flax`) on the
same numpy batches, without dropout (each package draws its own masks),
on one CPU device. Losses and TensorBoard values are held at 1e-5
relative: f32 sums in another order.
"""

import functools
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import bert as t_bert
from tf_yarn_tpu_torch.models import weights as t_weights

LOOP_SPANS = ("train/step_dispatch", "train/checkpoint_save", "train/eval")


def _stream(seed=0):
    def input_fn(start_step=0):
        rng = np.random.RandomState(seed)
        drawn = 0
        while True:
            x = rng.randint(0, 128, (4, 16)).astype(np.int32)
            drawn += 1
            if drawn > start_step:
                yield {"x": x, "y": (x[:, 0] % 2).astype(np.int32)}
    return input_fn


@functools.lru_cache(maxsize=None)
def _variables():
    """The tiny BERT's flax variables (both packages start from them)."""
    import flax.linen as nn
    from tf_yarn_tpu.models import bert as j_bert

    cfg = j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False)
    variables = nn.meta.unbox(j_bert.BertClassifier(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((4, 16), jnp.int32)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_experiment(model_dir=None, dropout=0.0, eval_input=False,
                     **params):
    cfg = t_bert.BertConfig.tiny(dtype=torch.float32, dropout_rate=dropout)

    def init_fn(device, seed):
        model = t_bert.make_model(cfg, seed, device)
        if not dropout:
            model.load_state_dict(t_weights.bert_from_flax(_variables(), cfg))
        return model

    exp = t_bert.make_experiment(
        cfg, model_dir=model_dir, batch_size=4, seq_len=16,
        learning_rate=1e-3, input_fn=_stream(), **params)
    exp.init_fn = init_fn
    if eval_input:
        exp.eval_input_fn = _stream(seed=1)
    return exp


def _jax_experiment(model_dir=None, eval_input=False, **params):
    from tf_yarn_tpu.models import bert as j_bert

    cfg = j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False)
    exp = j_bert.make_experiment(
        cfg, model_dir=model_dir, batch_size=4, seq_len=16,
        learning_rate=1e-3, input_fn=_stream(), **params)
    exp.init_fn = lambda rng, batch: _variables()
    if eval_input:
        exp.eval_input_fn = _stream(seed=1)
    return exp


def _train(package, exp):
    """(final metrics, [(span, args)] of the loop's spans) of one run."""
    if package == "jax":
        from tf_yarn_tpu import telemetry as j_telemetry
        from tf_yarn_tpu.experiment import as_core_experiment
        from tf_yarn_tpu.parallel.mesh import select_devices
        from tf_yarn_tpu.training import train_and_evaluate

        tracer = j_telemetry.get_tracer()
        tracer.clear()
        metrics = train_and_evaluate(as_core_experiment(exp),
                                     devices=select_devices(1, platform="cpu"))
    else:
        tracer = telemetry.get_tracer()
        tracer.clear()
        metrics = t_training.train_and_evaluate(
            t_experiment.as_core_experiment(exp), device="cpu")
    spans = [(r.name, dict(r.args)) for r in tracer.records()
             if r.name in LOOP_SPANS]
    return metrics, spans


def _recorded_losses(exp):
    losses, loss_fn = [], exp.loss_fn

    def recording(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(float(loss.detach()))
        return loss, aux

    exp.loss_fn = recording
    return losses


# -- steps_per_loop ------------------------------------------------------------

def test_chunks_are_bitwise_the_single_step_loop():
    """N = 2 and 3 give N = 1's losses bit for bit, dropout on: a chunk is
    N step calls, each reseeding the masks from its step."""
    runs = {}
    for n in (1, 2, 3):
        exp = _port_experiment(dropout=0.1, train_steps=6, log_every_steps=6,
                               steps_per_loop=n)
        runs[n] = _recorded_losses(exp)
        _, spans = _train("port", exp)
        dispatch = [args.get("steps", 1) for name, args in spans
                    if name == "train/step_dispatch"]
        assert dispatch == [n] * (6 // n)
    assert runs[2] == runs[1] and runs[3] == runs[1]


@pytest.mark.parametrize("steps_per_loop", [2, 3])
def test_chunked_final_loss_matches_jax(steps_per_loop):
    got, spans = _train("port", _port_experiment(
        train_steps=6, log_every_steps=6, steps_per_loop=steps_per_loop))
    want, j_spans = _train("jax", _jax_experiment(
        train_steps=6, log_every_steps=6, steps_per_loop=steps_per_loop))
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    assert spans == j_spans


def _tb_scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_cadences_chunks_checkpoints_evals_and_tensorboard_match_jax(
        tmp_path, caplog):
    """train_steps=7 with log 3, checkpoint 2, eval 4 and steps_per_loop
    3: both loops clamp N to 2 with the same warning, and dispatch,
    checkpoint at, evaluate at the same steps; the final loss and eval
    agree; the ``tb/`` events hold the same tags at the same steps with
    values within 1e-5; the registries hold the same
    ``checkpoint/seconds`` keys (the async writer's save_submit and
    wait)."""
    from tf_yarn_tpu import telemetry as j_telemetry

    params = dict(train_steps=7, log_every_steps=3, checkpoint_every_steps=2,
                  eval_every_steps=4, eval_steps=2, steps_per_loop=3,
                  keep_last_n=None)
    results = {}
    for package, make, registry in (
            ("port", _port_experiment, telemetry.get_registry()),
            ("jax", _jax_experiment, j_telemetry.get_registry())):
        registry.clear()
        caplog.clear()
        model_dir = tmp_path / package
        with caplog.at_level(logging.WARNING):
            metrics, spans = _train(package, make(
                str(model_dir), eval_input=True, **params))
        results[package] = dict(
            metrics=metrics, spans=spans,
            warnings=[r.getMessage() for r in caplog.records
                      if "steps_per_loop" in r.getMessage()],
            tb=_tb_scalars(model_dir / "tb"),
            checkpoint_keys=sorted(
                key for key in registry.snapshot()
                if key.startswith("checkpoint/seconds")),
            steps=(t_ckpt.list_checkpoint_steps(str(model_dir))))
    port, ref = results["port"], results["jax"]
    assert port["warnings"] == ref["warnings"] == [
        "steps_per_loop=3 exceeds the smallest host cadence / remaining "
        "steps (2); clamping"]
    assert port["spans"] == ref["spans"]
    assert [args.get("steps", 1) for name, args in port["spans"]
            if name == "train/step_dispatch"] == [2, 1, 1, 2, 1]
    assert port["steps"] == ref["steps"] == [2, 4, 6, 7]
    assert sorted(port["metrics"]) == sorted(ref["metrics"])
    for key, value in port["metrics"].items():
        np.testing.assert_allclose(value, float(ref["metrics"][key]),
                                   rtol=1e-5, err_msg=key)
    assert sorted(port["tb"]) == sorted(ref["tb"]) == [
        "eval/accuracy", "eval/loss", "train/accuracy", "train/loss"]
    for tag, points in port["tb"].items():
        assert [s for s, _ in points] == [s for s, _ in ref["tb"][tag]]
        np.testing.assert_allclose([v for _, v in points],
                                   [v for _, v in ref["tb"][tag]],
                                   rtol=1e-5, err_msg=tag)
    assert port["checkpoint_keys"] == ref["checkpoint_keys"]
    assert any("op=save_submit" in k for k in port["checkpoint_keys"])
    assert any("op=wait" in k for k in port["checkpoint_keys"])


# -- the preemption drain ------------------------------------------------------

@pytest.fixture
def flag_after(monkeypatch):
    """flag_after(step): both packages' hooks raise the preemption flag
    once the loop has logged `step` (log_every_steps=1)."""
    from tf_yarn_tpu import preemption as j_preemption
    from tf_yarn_tpu import training as j_training

    def arm(step):
        for module, flag in ((t_training, t_preemption),
                             (j_training, j_preemption)):
            original = module._StepsPerSecondHook.after_step

            def after_step(self, at, *args, _original=original, _flag=flag,
                           **kwargs):
                _original(self, at, *args, **kwargs)
                if at == step:
                    _flag.request()

            monkeypatch.setattr(module._StepsPerSecondHook, "after_step",
                                after_step)

    yield arm
    t_preemption.reset()
    j_preemption.reset()


def test_drain_saves_the_step_and_raises_as_jax_does(tmp_path, flag_after):
    from tf_yarn_tpu import preemption as j_preemption

    flag_after(2)
    messages, steps = {}, {}
    for package, make, preempted in (
            ("port", _port_experiment, t_preemption.Preempted),
            ("jax", _jax_experiment, j_preemption.Preempted)):
        model_dir = str(tmp_path / package)
        with pytest.raises(preempted) as err:
            _train(package, make(model_dir, train_steps=5, log_every_steps=1,
                                 checkpoint_every_steps=2))
        messages[package] = str(err.value).replace(model_dir, "<model_dir>")
        steps[package] = t_ckpt.list_checkpoint_steps(model_dir)
    assert messages["port"] == messages["jax"] == (
        "preempted at step 3; checkpoint saved to <model_dir>")
    assert steps["port"] == steps["jax"] == [2, 3]
    t_preemption.reset()
    j_preemption.reset()
    with pytest.raises(t_preemption.Preempted,
                       match=r"^preempted at step 3 \(no model_dir: "
                             r"progress lost\)$"):
        _train("port", _port_experiment(train_steps=5, log_every_steps=1))


def test_flag_on_the_final_step_completes(tmp_path, flag_after):
    flag_after(3)
    for package, make in (("port", _port_experiment),
                          ("jax", _jax_experiment)):
        model_dir = str(tmp_path / package)
        metrics, _ = _train(package, make(model_dir, train_steps=4,
                                          log_every_steps=1))
        assert np.isfinite(float(metrics["loss"]))
        assert t_ckpt.list_checkpoint_steps(model_dir) == [4]


def test_drain_poll_every_steps_is_validated_as_in_jax():
    from tf_yarn_tpu.experiment import TrainParams as JTrainParams

    for value in (0, -2):
        messages = []
        for cls in (t_experiment.TrainParams, JTrainParams):
            with pytest.raises(ValueError) as err:
                cls(train_steps=3, drain_poll_every_steps=value)
            messages.append(str(err.value))
        assert messages[0] == messages[1] == (
            f"drain_poll_every_steps must be >= 1, got {value}")
    for value in (None, 1, 5):
        assert t_experiment.TrainParams(
            train_steps=3, drain_poll_every_steps=value
        ).drain_poll_every_steps == JTrainParams(
            train_steps=3, drain_poll_every_steps=value
        ).drain_poll_every_steps == value


# -- the async CheckpointWriter ------------------------------------------------

def _state(step):
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return t_training.TrainState(step, model, optimizer).state_dict()


class _Gate:
    """Hold `checkpoint._write_tree` until released; note each call."""

    def __init__(self, monkeypatch):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = []
        original = t_ckpt._write_tree

        def gated(model_dir, step, state):
            self.calls.append(step)
            self.entered.set()
            assert self.release.wait(30)
            return original(model_dir, step, state)

        monkeypatch.setattr(t_ckpt, "_write_tree", gated)


def test_save_returns_before_the_write_lands(tmp_path, monkeypatch):
    gate = _Gate(monkeypatch)
    state = _state(1)
    with t_ckpt.CheckpointWriter() as writer:
        writer.save(str(tmp_path), 1, state)
        assert gate.entered.wait(30)
        # The snapshot is taken: the caller may move on and mutate.
        before = state["params"]["weight"].clone()
        with torch.no_grad():
            state["params"]["weight"].add_(1.0)
        assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == []
        gate.release.set()
        writer.wait()
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [1]
    saved = t_ckpt.restore_checkpoint_host(str(tmp_path), 1)
    assert torch.equal(saved["params"]["weight"], before)
    assert saved["step"] == 1


def test_manifest_is_written_last_and_marks_completion(tmp_path, monkeypatch):
    order, seen = [], {}
    save, manifest = torch.save, t_ckpt.write_manifest

    def recording_save(obj, path, *args, **kwargs):
        order.append(os.path.basename(str(path)))
        return save(obj, path, *args, **kwargs)

    def recording_manifest(ckpt_dir, step=None):
        order.append(t_ckpt.MANIFEST_NAME)
        # The tree is written but not manifested: discovery skips it.
        seen["listed"] = t_ckpt.list_checkpoint_steps(str(tmp_path))
        seen["raw"] = t_ckpt.list_checkpoint_steps(str(tmp_path),
                                                   require_manifest=False)
        return manifest(ckpt_dir, step=step)

    monkeypatch.setattr(torch, "save", recording_save)
    monkeypatch.setattr(t_ckpt, "write_manifest", recording_manifest)
    os.makedirs(tmp_path / "ckpt-7")  # debris without a manifest
    with t_ckpt.CheckpointWriter() as writer:
        writer.save(str(tmp_path), 3, _state(3))
    assert order == ["params.pt", "optimizer.pt", t_ckpt.MANIFEST_NAME]
    assert seen == {"listed": [], "raw": [7]}
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [3]
    t_ckpt.verify_checkpoint(t_ckpt.checkpoint_path(str(tmp_path), 3))


def test_retention_keeps_the_newest_as_jax_does(tmp_path):
    """keep_last_n=2, saves at 1..4 with a wait after each: the same
    completed steps after each save as the JAX writer keeps."""
    from tf_yarn_tpu import checkpoint as j_ckpt

    listings = {"port": [], "jax": []}
    writer = t_ckpt.CheckpointWriter(keep_last_n=2)
    j_writer = j_ckpt.CheckpointWriter(keep_last_n=2)
    try:
        for step in range(1, 5):
            writer.save(str(tmp_path / "port"), step, _state(step))
            writer.wait()
            listings["port"].append(
                t_ckpt.list_checkpoint_steps(str(tmp_path / "port")))
            j_writer.save(str(tmp_path / "jax"), step,
                          {"w": np.full(3, step, np.float32)})
            j_writer.wait()
            listings["jax"].append(
                j_ckpt.list_checkpoint_steps(str(tmp_path / "jax")))
    finally:
        writer.close()
        j_writer.close()
    assert listings["port"] == listings["jax"] == [
        [1], [1, 2], [1, 2, 3], [2, 3, 4]]


def test_a_second_save_of_a_step_waits_for_the_first(tmp_path, monkeypatch):
    gate = _Gate(monkeypatch)
    writer = t_ckpt.CheckpointWriter()
    writer.save(str(tmp_path), 2, _state(2))
    assert gate.entered.wait(30)
    second = threading.Thread(
        target=writer.save, args=(str(tmp_path), 2, _state(2)))
    second.start()
    second.join(0.5)
    assert second.is_alive()  # blocked behind the first write
    gate.release.set()
    second.join(30)
    assert not second.is_alive()
    writer.close()
    assert gate.calls == [2, 2]
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [2]


def test_a_background_failure_is_raised_once(tmp_path, monkeypatch):
    calls = []

    def failing(model_dir, step, state):
        calls.append(step)
        if step == 1:
            raise OSError("disk full")
        return original(model_dir, step, state)

    original = t_ckpt._write_tree
    monkeypatch.setattr(t_ckpt, "_write_tree", failing)
    writer = t_ckpt.CheckpointWriter()
    writer.save(str(tmp_path), 1, _state(1))
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()  # reported once
    writer.save(str(tmp_path), 2, _state(2))
    writer.close()
    assert calls == [1, 2]
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [2]
    writer = t_ckpt.CheckpointWriter()
    monkeypatch.setattr(t_ckpt, "_write_tree", failing)
    writer.save(str(tmp_path), 1, _state(1))
    with pytest.raises(OSError, match="disk full"):  # from the next save
        writer.save(str(tmp_path), 3, _state(3))
    writer.close()


# -- the profile window --------------------------------------------------------

PROFILE_WINDOWS = ["", "2:5", ":4", "3:", "5:5", "7:2", "x:3", "1:2:3"]


@pytest.mark.parametrize("window", PROFILE_WINDOWS)
def test_profile_window_parses_as_jax_does(window, monkeypatch, caplog,
                                           tmp_path):
    from tf_yarn_tpu import training as j_training

    parsed = {}
    for package, make in (
            ("port", lambda: t_training._ProfileWindow(torch.device("cpu"))),
            ("jax", j_training._ProfileWindow)):
        parsed[package] = []
        for directory in (None, str(tmp_path)):
            monkeypatch.setenv("TPU_YARN_PROFILE_STEPS", window)
            if directory:
                monkeypatch.setenv("TPU_YARN_PROFILE", directory)
            else:
                monkeypatch.delenv("TPU_YARN_PROFILE", raising=False)
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                profile = make()
            parsed[package].append((
                profile.start_step, profile.stop_step, profile.boundaries(),
                [r.getMessage() for r in caplog.records]))
    assert parsed["port"] == parsed["jax"]


def test_profile_window_writes_one_trace(tmp_path, monkeypatch):
    """TPU_YARN_PROFILE_STEPS="1:3" over 4 steps with steps_per_loop 2:
    the window's edges are host boundaries (a single step, a chunk of 2,
    a single step) and one Chrome trace lands in the directory."""
    monkeypatch.setenv("TPU_YARN_PROFILE", str(tmp_path / "profile"))
    monkeypatch.setenv("TPU_YARN_PROFILE_STEPS", "1:3")
    _, spans = _train("port", _port_experiment(
        train_steps=4, log_every_steps=4, steps_per_loop=2))
    assert [args.get("steps", 1) for name, args in spans
            if name == "train/step_dispatch"] == [1, 2, 1]
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].startswith("torch_profile_1-3_")
    with open(tmp_path / "profile" / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names, sorted(names)[:40]
