"""`models.linear` — the hashed linear classifier, BASELINE.json config 2 —
held against the JAX package on the CPU: `hash_features` equal to JAX's,
the logit on bridged weights (ids outside the table read as jnp's gather
reads them), a `train_and_evaluate` run of `make_experiment` step for
step against JAX's on the same stream (adagrad, the binary logistic
loss), and the JAX test's learning bar (tests/test_models.py:387-394).
f32 throughout: the tolerances cover sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import linear as t_linear
from tf_yarn_tpu_torch.models.weights import linear_from_flax

TOL = 1e-5


@pytest.mark.parametrize("n_buckets", [128, 2**20, 7])
def test_hash_features_equal_jax(n_buckets):
    from tf_yarn_tpu.models import linear as j_linear

    rows = [["a", "b", "c"], ["a", 12, 3.5], ["", "ünï", "None"]]
    got = t_linear.hash_features(rows, n_buckets)
    np.testing.assert_array_equal(got, j_linear.hash_features(rows,
                                                              n_buckets))
    assert got.dtype == np.int32 and got.shape == (3, 3)
    assert got[0, 0] == got[1, 0]


@pytest.mark.parametrize("n_dense", [0, 3])
def test_logits_equal_jax_with_ids_outside_the_table(n_dense):
    import flax.linen as nn

    from tf_yarn_tpu.models import linear as j_linear

    cfg = dict(n_buckets=64, n_features=5, n_dense=n_dense)
    model = j_linear.HashedLinearClassifier(j_linear.LinearConfig(**cfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (6, 5)).astype(np.int32)
    ids[0, :3] = [-1, -64, -200]  # from the end, then clamped
    ids[1, :2] = [64, 1000]  # past the end: the last row
    dense = rng.randn(6, n_dense).astype(np.float32) if n_dense else None
    args = (jnp.asarray(ids),) + ((jnp.asarray(dense),) if n_dense else ())
    variables = nn.meta.unbox(model.init(jax.random.PRNGKey(0), *args))
    # Nonzero weights (the init is zeros), as a trained table holds.
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)),
        variables)
    want = model.apply(variables, *args)
    port = t_linear.HashedLinearClassifier(t_linear.LinearConfig(**cfg),
                                           device="cpu")
    port.load_state_dict(linear_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), port.config))
    got = port(torch.as_tensor(ids).long(),
               torch.as_tensor(dense) if n_dense else None)
    assert got.shape == (6, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)


def _steps_log(logger_name):
    import logging

    losses = {}

    class Handler(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("step %d: loss=%s"):
                losses[int(record.args[0])] = float(record.args[1])

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    handler = Handler(logging.INFO)
    logger.addHandler(handler)
    return losses, lambda: logger.removeHandler(handler)


def test_make_experiment_trains_as_jax(tmp_path):
    """The same synthetic stream, zero init, adagrad 0.5: 5 steps' losses
    and the final table, bias equal to JAX's one-device run."""
    from tf_yarn_tpu import checkpoint as j_ckpt
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu import training as j_training
    from tf_yarn_tpu.models import linear as j_linear
    from tf_yarn_tpu.parallel.mesh import select_devices

    cfg = dict(n_buckets=1024, n_features=8)
    common = dict(train_steps=5, batch_size=64, learning_rate=0.5,
                  log_every_steps=1)
    losses, done = _steps_log("tf_yarn_tpu_torch.training")
    try:
        exp = t_linear.make_experiment(t_linear.LinearConfig(**cfg),
                                       model_dir=str(tmp_path / "port"),
                                       **common)
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    finally:
        done()
    want, done = _steps_log("tf_yarn_tpu.training")
    try:
        j_exp = j_linear.make_experiment(j_linear.LinearConfig(**cfg),
                                         model_dir=str(tmp_path / "jax"),
                                         **common)
        j_training.train_and_evaluate(j_experiment.as_core_experiment(j_exp),
                                      devices=select_devices(1,
                                                             platform="cpu"))
    finally:
        done()
    assert sorted(losses) == sorted(want) == [1, 2, 3, 4, 5]
    for step, loss in want.items():
        assert losses[step] == pytest.approx(loss, rel=TOL), step
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    got = t_ckpt.restore_checkpoint(str(tmp_path / "port"), 5,
                                    map_location="cpu")["params"]
    ref = j_ckpt.restore_checkpoint_host(str(tmp_path / "jax"), 5)["params"]
    ref = linear_from_flax(ref, t_linear.LinearConfig(**cfg))
    assert sorted(got) == sorted(ref) == ["bias", "weights"]
    for key, value in ref.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=TOL,
                                   err_msg=key)
    assert float(got["weights"].abs().max()) > 0.1


def test_linear_classifier_learns():
    """JAX tests/test_models.py:387-394's bar, at one device."""
    exp = t_linear.make_experiment(
        t_linear.LinearConfig(n_buckets=1024, n_features=8), train_steps=60,
        batch_size=256, learning_rate=0.5)
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert metrics["accuracy"] > 0.6


def test_synthetic_stream_equals_jax():
    from tf_yarn_tpu.models import linear as j_linear

    cfg = t_linear.LinearConfig(n_buckets=4096, n_features=6)
    j_exp = j_linear.make_experiment(
        j_linear.LinearConfig(n_buckets=4096, n_features=6), batch_size=16)
    t_exp = t_linear.make_experiment(cfg, batch_size=16)
    for got, want in zip(t_exp.train_input_fn(), j_exp.train_input_fn()):
        for key in ("x", "y"):
            np.testing.assert_array_equal(got[key], want[key])
        break
    assert t_exp.train_params.log_every_steps == 20
