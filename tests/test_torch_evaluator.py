"""The port's side-car evaluator and the Estimator and Keras experiment
shapes, held against the JAX package on the CPU.

Both packages train the tiny f32 BERT classifier from the same weights
(flax variables bridged with `models/weights.bert_from_flax`) on the
same numpy batches, each writing its own checkpoints; then each
package's `continuous_eval` evaluates its own checkpoint stream with a
stand-in task runtime (an in-process KV store). Metrics are held at
1e-5: f32 sums in another order.
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import evaluation as t_evaluation
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.coordination import kv as t_kv
from tf_yarn_tpu_torch.models import bert as t_bert
from tf_yarn_tpu_torch.models import weights as t_weights
from tf_yarn_tpu_torch.tasks import _bootstrap as t_bootstrap
from tf_yarn_tpu_torch import topologies as t_topo

HEALTH = ("awake_time_ratio", "eval_step_mean_duration",
          "last_training_step", "nb_eval_steps")


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
    import flax.linen as nn
    from tf_yarn_tpu.models import bert as j_bert

    cfg = j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False)
    variables = nn.meta.unbox(j_bert.BertClassifier(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((4, 16), jnp.int32)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_cfg():
    return t_bert.BertConfig.tiny(dtype=torch.float32)


def _port_init(device, seed):
    model = t_bert.make_model(_port_cfg(), seed, device)
    model.load_state_dict(t_weights.bert_from_flax(_variables(), _port_cfg()))
    return model


def _experiments(model_dir, exporters=None, **params):
    """{package: experiment} of the same run."""
    from tf_yarn_tpu.models import bert as j_bert

    kwargs = dict(batch_size=4, seq_len=16, learning_rate=1e-3,
                  input_fn=_stream(), **params)
    port = t_bert.make_experiment(_port_cfg(),
                                  model_dir=str(model_dir / "port"), **kwargs)
    port.init_fn = _port_init
    ref = j_bert.make_experiment(
        j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False),
        model_dir=str(model_dir / "jax"), **kwargs)
    ref.init_fn = lambda rng, batch: _variables()
    for exp in (port, ref):
        exp.eval_input_fn = _stream(seed=1)
        exp.exporters = exporters
    return {"port": port, "jax": ref}


def _train(package, exp):
    if package == "jax":
        from tf_yarn_tpu.experiment import as_core_experiment
        from tf_yarn_tpu.parallel.mesh import select_devices
        from tf_yarn_tpu.training import train_and_evaluate

        return train_and_evaluate(as_core_experiment(exp),
                                  devices=select_devices(1, platform="cpu"))
    return t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")


def _runtime(package, cluster=()):
    """A stand-in evaluator runtime over an in-process KV store; `cluster`
    names the training tasks."""
    if package == "jax":
        from tf_yarn_tpu import topologies as topo
        from tf_yarn_tpu.coordination import kv as kv_mod
        from tf_yarn_tpu.tasks import _bootstrap as bootstrap
    else:
        topo, kv_mod, bootstrap = t_topo, t_kv, t_bootstrap
    tasks = [topo.TaskInstance(topo.TaskKey(t, 0), 1) for t in cluster]
    return bootstrap.TaskRuntime(kv_mod.InProcessKV(),
                                 topo.TaskKey("evaluator", 0), "evaluator:0",
                                 tasks, 0)


def _continuous_eval(package, runtime, exp, **kwargs):
    if package == "jax":
        from tf_yarn_tpu.evaluation import continuous_eval
    else:
        continuous_eval = t_evaluation.continuous_eval
    return continuous_eval(runtime, exp, poll_secs=0.02, **kwargs)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained 4 steps, a checkpoint every 2 (ckpt-2,
    ckpt-4), from the same weights; their final metrics."""
    root = tmp_path_factory.mktemp("trained")
    exps = _experiments(root, train_steps=4, checkpoint_every_steps=2,
                        log_every_steps=2, eval_steps=2, keep_last_n=None)
    return root, {package: _train(package, exp)
                  for package, exp in exps.items()}


def _markers(model_dir):
    directory = os.path.join(model_dir, "eval-done")
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as fh:
            out[name] = json.load(fh)
    return out


def test_continuous_eval_matches_jax(trained, tmp_path):
    """Every checkpoint evaluated once, to the final step: the same
    markers with metrics within 1e-5, the exporters called with each
    checkpoint's parameters, metrics and step, the same health keys in
    the KV store, and the last checkpoint's metrics equal to the train
    loop's final eval."""
    root, final = trained
    results = {}
    for package in ("port", "jax"):
        model_dir = tmp_path / package
        shutil.copytree(root / package, model_dir)
        exported = []
        exp = _experiments(tmp_path, exporters=lambda *args, _e=exported:
                           _e.append(args), train_steps=4, eval_steps=2)[package]
        runtime = _runtime(package)
        last = _continuous_eval(package, runtime, exp, idle_timeout_secs=60)
        results[package] = dict(
            last=last, markers=_markers(model_dir), exported=exported,
            keys=sorted(k for k in runtime.kv.keys()
                        if k.startswith("evaluator:0/")),
            health={key: runtime.kv.get_str(f"evaluator:0/{key}")
                    for key in HEALTH})
    port, ref = results["port"], results["jax"]
    assert sorted(port["markers"]) == sorted(ref["markers"]) == [
        "eval-done-2.json", "eval-done-4.json"]
    for name, metrics in port["markers"].items():
        assert sorted(metrics) == sorted(ref["markers"][name])
        for key, value in metrics.items():
            np.testing.assert_allclose(value, ref["markers"][name][key],
                                       rtol=1e-5, err_msg=f"{name} {key}")
    for key, value in port["last"].items():
        np.testing.assert_allclose(value, float(ref["last"][key]), rtol=1e-5)
        np.testing.assert_allclose(value, final["port"][f"eval_{key}"],
                                   rtol=1e-6)
    assert [step for _, _, step in port["exported"]] \
        == [step for _, _, step in ref["exported"]] == [2, 4]
    for (params, metrics, step), (j_params, j_metrics, _) in zip(
            port["exported"], ref["exported"]):
        assert metrics == port["markers"][f"eval-done-{step}.json"]
        want = t_weights.bert_from_flax({"params": j_params["params"]},
                                        _port_cfg())
        assert sorted(params) == sorted(want)
        for name, value in params.items():
            if name.endswith("wk.bias"):
                continue  # rounding noise Adam scales to ±lr steps
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       atol=2e-5, rtol=1e-4, err_msg=name)
    assert port["keys"] == ref["keys"] == sorted(
        f"evaluator:0/{key}" for key in HEALTH)
    for health in (port["health"], ref["health"]):
        assert (health["last_training_step"], health["nb_eval_steps"]) == (
            "4", "4")


@pytest.mark.parametrize("stop", ["training_finished", "idle_timeout"])
def test_continuous_eval_stops_as_jax_does(stop, trained, tmp_path):
    """Only ckpt-2 of a 4-step experiment exists. With every training
    task's stop event published the evaluator stops once nothing is
    pending; without a runtime it stops after the idle timeout."""
    root, _ = trained
    results = {}
    for package in ("port", "jax"):
        model_dir = tmp_path / package
        os.makedirs(model_dir)
        shutil.copytree(root / package / "ckpt-2", model_dir / "ckpt-2")
        exp = _experiments(tmp_path, train_steps=4, eval_steps=2)[package]
        if stop == "training_finished":
            runtime = _runtime(package, cluster=("worker",))
            runtime.kv.put_str("worker:0/stop", "")
            last = _continuous_eval(package, runtime, exp,
                                    idle_timeout_secs=600)
        else:
            last = _continuous_eval(package, None, exp, idle_timeout_secs=0.2)
        results[package] = (last, sorted(_markers(model_dir)))
    assert results["port"][1] == results["jax"][1] == ["eval-done-2.json"]
    for key, value in results["port"][0].items():
        np.testing.assert_allclose(value, float(results["jax"][0][key]),
                                   rtol=1e-5)


def test_markers_at_the_model_dir_root_count(trained, tmp_path):
    """A marker where older runs wrote it (the model_dir's root) marks its
    step evaluated in both packages."""
    from tf_yarn_tpu import evaluation as j_evaluation

    root, _ = trained
    for package in ("port", "jax"):
        shutil.copytree(root / package, tmp_path / package)
        with open(tmp_path / package / "eval-done-2.json", "w") as fh:
            json.dump({"loss": 0.0}, fh)
        os.makedirs(tmp_path / package / "eval-done")
        with open(tmp_path / package / "eval-done" / "eval-done-4.json",
                  "w") as fh:
            json.dump({"loss": 0.0}, fh)
    assert t_evaluation.evaluated_steps(str(tmp_path / "port")) \
        == j_evaluation._evaluated_steps(str(tmp_path / "jax")) == {2, 4}
    exp = _experiments(tmp_path, train_steps=4, eval_steps=2)["port"]
    assert t_evaluation.continuous_eval(
        None, exp, poll_secs=0.01, idle_timeout_secs=600) == {}


# -- the Estimator and Keras shapes -------------------------------------------

def _shapes(package):
    if package == "jax":
        from tf_yarn_tpu import experiment as mod
    else:
        mod = t_experiment
    return mod


def _spec_kwargs(package, model_dir, exporters):
    """The Estimator pieces of one BERT fine-tune in `package`."""
    from tf_yarn_tpu.models import bert as j_bert

    if package == "port":
        exp = t_bert.make_experiment(_port_cfg(), learning_rate=1e-3)
        return dict(model=None, loss_fn=exp.loss_fn, optimizer=exp.optimizer,
                    model_dir=str(model_dir), init_fn=_port_init)
    exp = j_bert.make_experiment(
        j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=False),
        learning_rate=1e-3)
    return dict(model=exp.model, loss_fn=exp.loss_fn, optimizer=exp.optimizer,
                model_dir=str(model_dir),
                init_fn=lambda rng, batch: _variables())


def test_as_core_experiment_normalises_the_shapes_as_jax_does(tmp_path):
    exporters, train, valid = object(), _stream(), _stream(seed=1)
    cores = {}
    for package in ("port", "jax"):
        mod = _shapes(package)
        pieces = _spec_kwargs(package, tmp_path, exporters)
        estimator = mod.Estimator(**pieces)
        assert estimator.config == {"model_dir": str(tmp_path)}
        spec = mod.ExperimentSpec(
            estimator=estimator,
            train_spec=mod.TrainSpec(input_fn=train, max_steps=7),
            eval_spec=mod.EvalSpec(input_fn=valid, steps=3, every_steps=2,
                                   exporters=exporters))
        assert spec.config == estimator.config
        assert spec.model_dir == str(tmp_path)
        bare = mod.ExperimentSpec(
            estimator=estimator,
            train_spec=mod.TrainSpec(input_fn=train, max_steps=5))
        keras = mod.KerasExperiment(
            model=pieces["model"], model_dir=None,
            train_params=mod.TrainParams(train_steps=4, log_every_steps=2),
            input_data_fn=train, optimizer=pieces["optimizer"],
            loss_fn=pieces["loss_fn"], validation_data_fn=valid)
        cores[package] = [mod.as_core_experiment(x)
                          for x in (spec, bare, keras)]
        assert isinstance(spec, mod.EXPERIMENT_TYPES)
        assert isinstance(keras, mod.EXPERIMENT_TYPES)
    for port, ref in zip(cores["port"], cores["jax"]):
        assert dataclasses.asdict(port.train_params) == dataclasses.asdict(
            ref.train_params)
        assert (port.model_dir, port.eval_input_fn, port.exporters) == (
            ref.model_dir, ref.eval_input_fn, ref.exporters)
        assert port.train_input_fn is ref.train_input_fn or (
            port.train_input_fn.__name__ == ref.train_input_fn.__name__)
    spec_core = cores["port"][0]
    assert (spec_core.train_params.train_steps,
            spec_core.train_params.eval_every_steps,
            spec_core.train_params.eval_steps,
            spec_core.exporters) == (7, 2, 3, exporters)
    assert cores["port"][1].eval_input_fn is None


def test_keras_streams_are_merged_as_jax_merges_them():
    from tf_yarn_tpu import experiment as j_experiment

    def features_dict():
        for i in range(4):
            yield {"x": np.full(2, i), "mask": np.ones(2)}

    def features_bare():
        for i in range(3):
            yield np.full(2, i)

    def targets():  # one short: the epoch ends with it
        for i in range(3):
            yield np.full(2, 10 + i)

    for features, target in ((features_dict, targets),
                             (features_bare, None)):
        merged = {}
        for package, mod in (("port", t_experiment), ("jax", j_experiment)):
            keras = mod.KerasExperiment(
                model=None, model_dir=None,
                train_params=mod.TrainParams(train_steps=1),
                input_data_fn=features, optimizer=None, loss_fn=None,
                target_data_fn=target)
            merged[package] = list(mod._merge_input_targets(keras)())
        assert len(merged["port"]) == len(merged["jax"]) == 3
        for got, want in zip(merged["port"], merged["jax"]):
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])


def test_estimator_train_and_evaluate_match_jax(tmp_path, monkeypatch):
    """`Estimator.train` (3 steps) then `.evaluate` of the checkpoint it
    wrote: the same final loss and eval metrics within 1e-5; an unknown
    train param and a model_dir without checkpoints raise in both."""
    from tf_yarn_tpu import training as j_training
    from tf_yarn_tpu.parallel.mesh import select_devices

    monkeypatch.setattr(j_training, "train_and_evaluate", functools.partial(
        j_training.train_and_evaluate,
        devices=select_devices(1, platform="cpu")))
    got = {}
    for package in ("port", "jax"):
        mod = _shapes(package)
        estimator = mod.Estimator(**_spec_kwargs(package, tmp_path / package,
                                                 None))
        device = {"device": "cpu"} if package == "port" else {}
        with pytest.raises(ValueError, match="no checkpoints"):
            estimator.evaluate(_stream(seed=1), steps=2, **device)
        with pytest.raises(TypeError):
            estimator.train(_stream(), max_steps=3, no_such_param=1, **device)
        trained = estimator.train(_stream(), max_steps=3, log_every_steps=1,
                                  **device)
        evaluated = estimator.evaluate(_stream(seed=1), steps=2, **device)
        got[package] = (trained, evaluated)
        with pytest.raises(ValueError, match="needs a model_dir"):
            mod.Estimator(**dict(_spec_kwargs(package, tmp_path, None),
                                 model_dir=None)).evaluate(_stream(), **device)
    for port, ref in zip(got["port"], got["jax"]):
        assert sorted(port) == sorted(ref)
        for key, value in port.items():
            np.testing.assert_allclose(value, float(ref[key]), rtol=1e-5,
                                       err_msg=key)


def test_exporters_ride_every_training_shape():
    fn = object()
    exp = t_bert.make_experiment(_port_cfg())
    exp.exporters = fn
    assert t_experiment.as_core_experiment(exp).exporters is fn
    core = t_experiment.as_core_experiment(exp)
    assert t_experiment.as_core_experiment(core) is core
