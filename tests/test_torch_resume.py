"""A resumed run draws the dropout masks of an uninterrupted one (ROADMAP
Queue 3 fault 8), held against the JAX package on the CPU.

The JAX step folds the step into its dropout key (training.py:135); the
port reseeds the model's dropout generator, and the global generator of
its device that a plain ``nn.Dropout`` draws from, from ``(seed, step)``
before each step. So a run that trains 2 steps and resumes from ckpt-2 to step
4, or drains at step 3 on the preemption flag and is run again, gives
the losses of 4 steps straight: bitwise in the port, and equal in the
JAX package. Tiny f32 BERT and ViT with dropout 0.1, and a user's MLP
with ``nn.Dropout(0.5)``, batches of 4 from a
numpy seed, an input_fn that declares ``start_step``. The masks are each
package's own bits, so the packages' losses are not compared here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import bert as t_bert
from tf_yarn_tpu_torch.models import vit as t_vit

STEPS = 4
DROPOUT = 0.1


def _stream(family):
    """The input: batches of 4 from RandomState(0); a resumed run skips
    the ones its steps consumed."""
    def input_fn(start_step=0):
        rng = np.random.RandomState(0)
        drawn = 0
        while True:
            if family == "bert":
                x = rng.randint(0, 128, (4, 16)).astype(np.int32)
                y = (x[:, 0] % 2).astype(np.int32)
            else:
                x = rng.randn(4, 32, 32, 3).astype(np.float32)
                y = rng.randint(0, 10, 4).astype(np.int32)
            drawn += 1
            if drawn > start_step:
                yield {"x": x, "y": y}
    return input_fn


def _port_run(family, model_dir, train_steps, dropout=DROPOUT,
              drain_after=None, **params):
    """The port's losses of one `train_and_evaluate` (device cpu); with
    `drain_after`, the preemption flag is set after that many steps."""
    module = {"bert": t_bert, "vit": t_vit}[family]
    config = (t_bert.BertConfig if family == "bert" else t_vit.ViTConfig).tiny(
        dtype=torch.float32, dropout_rate=dropout)
    extra = dict(seq_len=16) if family == "bert" else {}
    exp = module.make_experiment(
        config, model_dir=str(model_dir), train_steps=train_steps,
        batch_size=4, input_fn=_stream(family), log_every_steps=1,
        checkpoint_every_steps=2, **extra, **params)
    losses, loss_fn = [], exp.loss_fn

    def recording(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(float(loss.detach()))
            if len(losses) == drain_after:
                t_preemption.request()
        return loss, aux

    exp.loss_fn = recording
    try:
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    finally:
        t_preemption.reset()
    return losses


def _jax_run(family, model_dir, train_steps):
    """The JAX package's final loss, one CPU device."""
    from tf_yarn_tpu.experiment import as_core_experiment
    from tf_yarn_tpu.models import bert as j_bert
    from tf_yarn_tpu.models import vit as j_vit
    from tf_yarn_tpu.parallel.mesh import select_devices
    from tf_yarn_tpu.training import train_and_evaluate

    module = {"bert": j_bert, "vit": j_vit}[family]
    config = (j_bert.BertConfig if family == "bert" else j_vit.ViTConfig).tiny(
        dtype=jnp.float32, fused_norms=False, dropout_rate=DROPOUT)
    extra = dict(seq_len=16) if family == "bert" else {}
    exp = module.make_experiment(
        config, model_dir=str(model_dir), train_steps=train_steps,
        batch_size=4, input_fn=_stream(family), log_every_steps=1,
        checkpoint_every_steps=2, **extra)
    return train_and_evaluate(as_core_experiment(exp),
                              devices=select_devices(1, platform="cpu"))["loss"]


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_resumed_run_equals_the_uninterrupted_one(family, tmp_path):
    straight = _port_run(family, tmp_path / "straight", STEPS)
    first = _port_run(family, tmp_path / "resumed", 2)
    rest = _port_run(family, tmp_path / "resumed", STEPS)
    assert first + rest == straight
    # Dropout is on: without it the same steps give other losses.
    assert _port_run(family, tmp_path / "still", STEPS, dropout=0.0) != straight
    # The JAX package: the same equality (its step folds the step into
    # its key).
    j_straight = _jax_run(family, tmp_path / "j_straight", STEPS)
    _jax_run(family, tmp_path / "j_resumed", 2)
    j_resumed = _jax_run(family, tmp_path / "j_resumed", STEPS)
    np.testing.assert_allclose(j_resumed, j_straight, rtol=1e-6)


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_drained_and_relaunched_run_equals_the_uninterrupted_one(
        family, tmp_path):
    straight = _port_run(family, tmp_path / "straight", STEPS)
    with pytest.raises(t_preemption.Preempted, match="preempted at step 3"):
        _port_run(family, tmp_path / "drained", STEPS, drain_after=3)
    rest = _port_run(family, tmp_path / "drained", STEPS)
    assert rest == straight[3:]


def test_microbatches_draw_their_own_masks_and_resume(tmp_path):
    """Under grad_accum_steps the masks are a function of (seed, step,
    microbatch): a resumed run still equals a straight one, and the two
    microbatches of a step do not share a mask."""
    straight = _port_run("bert", tmp_path / "straight", STEPS,
                         grad_accum_steps=2)
    first = _port_run("bert", tmp_path / "resumed", 2, grad_accum_steps=2)
    rest = _port_run("bert", tmp_path / "resumed", STEPS, grad_accum_steps=2)
    assert first + rest == straight
    seeds = {t_training.step_seed(0, 1, 0), t_training.step_seed(0, 1, 1),
             t_training.step_seed(0, 1), t_training.step_seed(1, 1)}
    assert len(seeds) == 4


def _mlp_stream(start_step=0):
    rng = np.random.RandomState(0)
    drawn = 0
    while True:
        x = rng.randn(8, 16).astype(np.float32)
        drawn += 1
        if drawn > start_step:
            yield {"x": x, "y": x.sum(axis=1, keepdims=True)}


def _mlp_params(train_steps):
    return dict(train_steps=train_steps, log_every_steps=1,
                checkpoint_every_steps=2)


def _port_mlp_run(model_dir, train_steps, drain_after=None):
    """A user's TorchExperiment whose model draws from ``nn.Dropout`` (the
    device's global generator): its per-step losses."""
    losses = []

    def init_fn(device, seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return torch.nn.Sequential(
                torch.nn.Linear(16, 32), torch.nn.ReLU(),
                torch.nn.Dropout(0.5), torch.nn.Linear(32, 1)).to(device)

    def loss_fn(model, batch, train=True):
        model.train(train)
        loss = torch.mean((model(batch["x"]) - batch["y"]) ** 2)
        if train:
            losses.append(float(loss.detach()))
            if len(losses) == drain_after:
                t_preemption.request()
        return loss, {}

    exp = t_experiment.TorchExperiment(
        model=None, init_fn=init_fn,
        optimizer=lambda model: torch.optim.SGD(model.parameters(), lr=0.01),
        loss_fn=loss_fn, train_input_fn=_mlp_stream, model_dir=str(model_dir),
        train_params=t_experiment.TrainParams(**_mlp_params(train_steps)))
    try:
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    finally:
        t_preemption.reset()
    return losses


def _jax_mlp_run(model_dir, train_steps):
    """The same user model in the JAX package (flax ``nn.Dropout`` on the
    step's key): its final loss."""
    import flax.linen as nn
    import optax
    from tf_yarn_tpu.experiment import JaxExperiment, TrainParams
    from tf_yarn_tpu.experiment import as_core_experiment
    from tf_yarn_tpu.parallel.mesh import select_devices
    from tf_yarn_tpu.training import train_and_evaluate

    class Mlp(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = nn.relu(nn.Dense(32)(x))
            x = nn.Dropout(0.5, deterministic=not train)(x)
            return nn.Dense(1)(x)

    def loss_fn(model, params, batch, rng, train=True):
        out = model.apply(params, batch["x"], train=train,
                          rngs={"dropout": rng})
        return jnp.mean((out - batch["y"]) ** 2), {}

    exp = JaxExperiment(
        model=Mlp(), optimizer=optax.sgd(0.01), loss_fn=loss_fn,
        train_input_fn=_mlp_stream, model_dir=str(model_dir),
        init_fn=lambda rng, batch: Mlp().init(rng, batch["x"]),
        train_params=TrainParams(**_mlp_params(train_steps)))
    return train_and_evaluate(as_core_experiment(exp),
                              devices=select_devices(1, platform="cpu"))["loss"]


def test_a_plain_dropout_model_resumes_and_drains_to_the_straight_run(
        tmp_path):
    """A model without a ``generator`` (``nn.Dropout`` draws from the
    device's global generator) resumes, and drains and relaunches, to an
    uninterrupted run's losses, bitwise; the JAX package's user model
    shows the same equality. The loop leaves the global stream as it
    found it."""
    state = torch.get_rng_state()
    straight = _port_mlp_run(tmp_path / "straight", STEPS)
    assert torch.equal(torch.get_rng_state(), state)
    first = _port_mlp_run(tmp_path / "resumed", 2)
    torch.manual_seed(1234)  # a resumed process starts from its own state
    rest = _port_mlp_run(tmp_path / "resumed", STEPS)
    assert first + rest == straight
    with pytest.raises(t_preemption.Preempted, match="preempted at step 3"):
        _port_mlp_run(tmp_path / "drained", STEPS, drain_after=3)
    assert _port_mlp_run(tmp_path / "drained", STEPS) == straight[3:]
    j_straight = _jax_mlp_run(tmp_path / "j_straight", STEPS)
    _jax_mlp_run(tmp_path / "j_resumed", 2)
    j_resumed = _jax_mlp_run(tmp_path / "j_resumed", STEPS)
    np.testing.assert_allclose(j_resumed, j_straight, rtol=1e-6)
