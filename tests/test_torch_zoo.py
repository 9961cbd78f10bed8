"""The port's model zoo (BERT, ViT, ResNet) held against the JAX package
on the CPU.

Tiny f32 configs cross from flax to the port through
`models/weights.{bert,vit,resnet}_from_flax`; the JAX side runs with
``fused_norms=True``, its Pallas norms in interpret mode, and the port's
norms take their plain versions. Each tolerance covers f32 sums taken in
another order (and, over training steps, what the optimizer makes of
them). Dropout is 0 in the tiny configs: `jax.random` and torch draw
different masks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import bert as t_bert
from tf_yarn_tpu_torch.models import resnet as t_resnet
from tf_yarn_tpu_torch.models import vit as t_vit
from tf_yarn_tpu_torch.models import weights as t_weights
from tf_yarn_tpu_torch.utils import flops as t_flops


def _families():
    from tf_yarn_tpu.models import bert as j_bert
    from tf_yarn_tpu.models import resnet as j_resnet
    from tf_yarn_tpu.models import vit as j_vit

    return {
        "bert": (j_bert, t_bert, j_bert.BertClassifier, t_bert.BertClassifier,
                 t_weights.bert_from_flax, "BertConfig"),
        "vit": (j_vit, t_vit, j_vit.ViT, t_vit.ViT, t_weights.vit_from_flax,
                "ViTConfig"),
        "resnet": (j_resnet, t_resnet, j_resnet.ResNet, t_resnet.ResNet,
                   t_weights.resnet_from_flax, "ResNetConfig"),
    }


def _configs(family, **overrides):
    j_mod, t_mod, _, _, _, name = _families()[family]
    return (getattr(j_mod, name).tiny(dtype=jnp.float32, fused_norms=True,
                                      **overrides),
            getattr(t_mod, name).tiny(dtype=torch.float32, fused_norms=True,
                                      **overrides))


@functools.lru_cache(maxsize=None)
def _jax_variables(family, jcfg, example_shape, seed=0):
    """Flax variables (cached: JAX initialises in interpret mode)."""
    import flax.linen as nn

    j_cls = _families()[family][2]
    dtype = jnp.int32 if family == "bert" else jnp.float32
    variables = nn.meta.unbox(j_cls(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros(example_shape, dtype)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_model(family, variables, pcfg):
    _, _, _, t_cls, bridge, _ = _families()[family]
    model = t_cls(pcfg, device="cpu")
    model.load_state_dict(bridge(variables, pcfg))
    return model


def _inputs(family, shape, seed=0):
    rng = np.random.RandomState(seed)
    if family == "bert":
        return rng.randint(0, 128, shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _to_torch(value):
    tensor = torch.tensor(np.asarray(value))
    return tensor if tensor.is_floating_point() else tensor.long()


def _logits_match(family, jcfg, pcfg, shape, **kwargs):
    variables = _jax_variables(family, jcfg, shape)
    x = _inputs(family, shape, seed=sum(shape))
    j_cls = _families()[family][2]
    want = np.asarray(j_cls(jcfg).apply(
        variables, jnp.asarray(x),
        **{k: jnp.asarray(v) for k, v in kwargs.items()}))
    model = _port_model(family, variables, pcfg)
    with torch.no_grad():
        got = model(_to_torch(x), **{k: _to_torch(v) for k, v in kwargs.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # f32, sums in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["xla", "xla_mask", "flash"])
def test_bert_logits_match_jax(case):
    """Padded batch (key-padding mask) on the xla path; the flash path
    (the port's plain flash version, the JAX kernel in interpret mode)
    takes no mask."""
    impl = "flash" if case == "flash" else "xla"
    jcfg, pcfg = _configs("bert", attention_impl=impl)
    kwargs = {}
    if case == "xla_mask":
        mask = np.ones((2, 16), np.int32)
        mask[1, 9:] = 0
        kwargs["attention_mask"] = mask
    _logits_match("bert", jcfg, pcfg, (2, 16), **kwargs)


def test_vit_logits_match_jax():
    jcfg, pcfg = _configs("vit")
    _logits_match("vit", jcfg, pcfg, (2, 32, 32, 3))


# Image 37 gives odd sizes at every stride-2 op: SAME pads (2, 3) for
# the 7x7 stem, (1, 1) for the pool on 19, then (0, 1)-style shifts on
# the even sizes; the space-to-depth stem needs sizes divisible by 4.
@pytest.mark.parametrize("stem, size", [("conv", 32), ("conv", 37),
                                        ("space_to_depth", 32),
                                        ("space_to_depth", 36)])
def test_resnet_logits_match_jax(stem, size):
    jcfg, pcfg = _configs("resnet", stem=stem)
    _logits_match("resnet", jcfg, pcfg, (2, size, size, 3))


def test_same_padding_is_flax_padding():
    """Flax's SAME rule puts the odd pixel last: the stride-2 stem, pool
    and conv pads are asymmetric."""
    assert t_resnet.same_pads(224, 7, 2) == (2, 3)
    assert t_resnet.same_pads(56, 3, 2) == (0, 1)
    assert t_resnet.same_pads(112, 3, 2) == (0, 1)
    assert t_resnet.same_pads(56, 2, 1) == (0, 1)
    assert t_resnet.same_pads(56, 3, 1) == (1, 1)
    assert t_resnet.same_pads(56, 1, 2) == (0, 0)


# (family, JAX make_experiment kwargs): the JAX synthetic batches at
# tiny sizes and each package's own optimizer (BERT AdamW wd 1e-4 at a
# larger learning rate so every parameter moves; ViT AdamW wd 0.05;
# ResNet SGD 0.1 with momentum 0.9).
TRAIN_CASES = {
    "bert": dict(batch_size=4, seq_len=16, learning_rate=1e-3),
    "vit": dict(batch_size=4),
    "resnet": dict(batch_size=4, image_size=32),
    "resnet_s2d": dict(batch_size=4, image_size=32),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_jax(case):
    """Three steps of the port's `build_train_step` against the JAX one,
    from the same weights and batches, with each package's
    `make_experiment` optimizer and loss."""
    from tf_yarn_tpu.training import TrainState, build_train_step

    family = case.split("_")[0]
    overrides = dict(stem="space_to_depth") if case == "resnet_s2d" else {}
    jcfg, pcfg = _configs(family, **overrides)
    j_mod, t_mod = _families()[family][:2]
    j_exp = j_mod.make_experiment(jcfg, **TRAIN_CASES[case])
    t_exp = t_mod.make_experiment(pcfg, **TRAIN_CASES[case])
    batches = j_exp.train_input_fn()
    first = next(batches)
    t_first = next(t_exp.train_input_fn())
    for key in first:  # the port's synthetic stream is the JAX one
        np.testing.assert_array_equal(t_first[key], first[key])
    variables = _jax_variables(family, jcfg, first["x"].shape)
    j_state = TrainState(np.int32(0), variables,
                         j_exp.optimizer.init(variables))
    j_step = jax.jit(build_train_step(j_exp.model, j_exp.loss_fn,
                                      j_exp.optimizer))
    model = _port_model(family, variables, pcfg)
    optimizer = t_exp.optimizer(model)
    state = t_training.TrainState(0, model, optimizer)
    step = t_training.build_train_step(model, t_exp.loss_fn, optimizer)
    batch = first
    for _ in range(3):
        j_state, j_metrics = j_step(j_state, batch, jax.random.PRNGKey(0))
        state, metrics = step(state, {k: _to_torch(v) for k, v in batch.items()})
        # f32; the optimizers turn reordered sums into ~1e-6 drift.
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(metrics["accuracy"]),
                                   float(j_metrics["accuracy"]))
        batch = next(batches)
    expected = _families()[family][4](
        jax.tree_util.tree_map(np.asarray, j_state.params), pcfg)
    start = _families()[family][4](variables, pcfg)
    lr = TRAIN_CASES[case].get("learning_rate",
                               dict(vit=3e-4).get(family, 0.1))
    moved = 0
    for name, param in model.named_parameters():
        if name.endswith("wk.bias"):
            # Softmax cannot see a key bias (it adds q·b to every key's
            # logit alike): its gradient is 0 up to rounding noise, which
            # Adam scales to steps of ±lr. Hold it to that bound.
            assert np.abs(param.detach().numpy() - start[name].numpy()).max() \
                <= 3 * lr * 1.001, name
            continue
        np.testing.assert_allclose(param.detach().numpy(),
                                   expected[name].numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=name)
        moved += not np.array_equal(param.detach().numpy(),
                                    start[name].numpy())
    assert moved > len(expected) // 2


def test_unused_parameter_decays_as_in_optax():
    """BERT's segment_embedding gets no gradient without segments;
    optax's AdamW still decays it by lr·wd a step, and so does the port."""
    _, pcfg = _configs("bert")
    model = t_bert.make_model(pcfg, seed=1, device="cpu")
    exp = t_bert.make_experiment(pcfg, batch_size=2, seq_len=8,
                                 learning_rate=1e-2)
    optimizer = exp.optimizer(model)
    step = t_training.build_train_step(model, exp.loss_fn, optimizer)
    before = model.encoder.segment_embedding.detach().clone()
    batch = next(exp.train_input_fn())
    step(t_training.TrainState(0, model, optimizer),
         {k: _to_torch(v) for k, v in batch.items()})
    torch.testing.assert_close(model.encoder.segment_embedding.detach(),
                               before * (1 - 1e-2 * 1e-4))


def test_make_experiment_recipes_match_jax():
    from tf_yarn_tpu.models import bert as j_bert

    big = t_bert.make_experiment(train_steps=4)
    assert big.train_params.log_every_steps == 1
    assert big.loss_fn is t_bert.loss_fn
    recipes = {"bert": (t_bert, 1e-4, "AdamW"), "vit": (t_vit, 0.05, "AdamW"),
               "resnet": (t_resnet, 0.0, "SGD")}
    for family, (t_mod, decay, kind) in recipes.items():
        _, pcfg = _configs(family)
        exp = t_mod.make_experiment(pcfg, train_steps=50)
        assert exp.train_params.log_every_steps == 5
        model = exp.init_fn("cpu", 0)
        optimizer = exp.optimizer(model)
        assert type(optimizer).__name__ == kind
        (group,) = optimizer.param_groups
        assert len(group["params"]) == len(list(model.parameters()))
        assert group["weight_decay"] == decay
        if kind == "SGD":
            assert (group["momentum"], group["dampening"],
                    group["nesterov"]) == (0.9, 0, False)
    # BERT's labels are the first token modulo the classes, as in JAX.
    _, pcfg = _configs("bert")
    batch = next(t_bert.make_experiment(pcfg, batch_size=3,
                                        seq_len=5).train_input_fn())
    want = next(j_bert.make_experiment(_configs("bert")[0], batch_size=3,
                                       seq_len=5).train_input_fn())
    np.testing.assert_array_equal(batch["y"], want["y"])


def test_bert_dropout_draws_from_the_model_generator():
    _, pcfg = _configs("bert", dropout_rate=0.5)
    tokens = torch.tensor(_inputs("bert", (2, 8))).long()
    outs = []
    for _ in range(2):
        model = t_bert.make_model(pcfg, seed=3, device="cpu")
        with torch.no_grad():
            outs.append([model(tokens, deterministic=d) for d in
                         (False, False, True, True)])
    a, b = outs
    for x, y in zip(a, b):  # same seed, same masks
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[1])  # the generator advances
    assert not torch.equal(a[0], a[2])
    assert torch.equal(a[2], a[3])  # deterministic: no dropout


@pytest.mark.parametrize("family", ["bert", "vit", "resnet"])
def test_train_and_evaluate_reports_mfu(family, tmp_path, monkeypatch):
    """`train_and_evaluate` on the CPU counts one step's FLOPs with
    FlopCounterMode and reports MFU against the peak it is given (the
    card's on CUDA; a stand-in here); checkpoints resume."""
    monkeypatch.setattr(t_training, "_peak_flops", lambda device: 1e12)
    _, pcfg = _configs(family)
    t_mod = _families()[family][1]
    kwargs = dict(bert=dict(seq_len=16), resnet=dict(image_size=32)).get(
        family, {})
    exp = t_mod.make_experiment(pcfg, model_dir=str(tmp_path), train_steps=2,
                                batch_size=2, log_every_steps=1,
                                checkpoint_every_steps=2, **kwargs)
    registry = telemetry.get_registry()
    registry.gauge("train/mfu").set(0.0)
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert np.isfinite(metrics["loss"]) and "accuracy" in metrics
    assert registry.gauge("train/mfu").value > 0
    assert registry.gauge("train/samples_per_sec").value > 0
    exp.train_params.train_steps = 3
    resumed = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert np.isfinite(resumed["loss"])


def test_count_flops_and_batch_counts_match_their_definitions():
    from tf_yarn_tpu.utils import flops as j_flops

    layer = torch.nn.Linear(16, 8, bias=False)
    x = torch.randn(4, 16, requires_grad=True)
    out, flops = t_flops.count_flops(lambda: layer(x).sum().backward())
    # Forward 2·B·in·out, backward twice that (dx and dW).
    assert out is None and flops == 3 * 2 * 4 * 16 * 8
    for batch in ({"x": np.zeros((3, 5), np.int32), "y": np.zeros(3)},
                  {"input_ids": np.zeros((2, 7), np.int32)},
                  {"tokens": np.zeros((4, 9), np.int32)},
                  {"token_ids": np.zeros((6,), np.int32)}):
        assert t_flops.batch_counts(batch) == j_flops.batch_counts(batch)
    model = t_resnet.ResNet(_configs("resnet")[1], device="cpu")
    assert t_flops.model_train_flops(model, {"x": np.zeros((2, 32, 32, 3))}) is None


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_counted_flops_are_a_train_step_and_leave_the_model_alone(
        grad_accum_steps):
    """The pass `train_and_evaluate` counts before its loop sees the FLOPs
    of one whole train step (one microbatch times their count) and moves
    no parameter, leaving no grad behind."""
    _, pcfg = _configs("resnet")
    exp = t_resnet.make_experiment(pcfg, batch_size=4, image_size=32)
    model = exp.init_fn("cpu", 0)
    batch = {k: _to_torch(v) for k, v in next(exp.train_input_fn()).items()}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    counted = t_training._count_train_flops(model, exp.loss_fn, batch,
                                            grad_accum_steps)
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name
    assert all(p.grad is None for p in model.parameters())
    optimizer = exp.optimizer(model)
    step = t_training.build_train_step(model, exp.loss_fn, optimizer)
    _, flops = t_flops.count_flops(step, t_training.TrainState(0, model,
                                                               optimizer), batch)
    assert counted == flops > 0


@pytest.mark.parametrize("stem", ["conv", "space_to_depth"])
def test_resnet_norms_see_channels_last_activations(stem):
    """Every activation reaching a GroupNorm is channels-last, so its NHWC
    view is the contiguous slab the card kernel takes without a copy (the
    wrapper raises on any other layout); the cotangents reaching the dx
    kernel are too, so they need no copy either."""
    _, pcfg = _configs("resnet", stem=stem)
    model = t_resnet.make_experiment(pcfg).init_fn("cpu", 0)
    seen = []

    def check(module, args, out):
        seen.append(args[0].permute(0, 2, 3, 1).is_contiguous())
        out.register_hook(lambda g: seen.append(
            g.permute(0, 2, 3, 1).is_contiguous()) or None)

    for module in model.modules():
        if isinstance(module, t_resnet.GroupNormOp):
            module.register_forward_hook(check)
    x = torch.tensor(_inputs("resnet", (2, 32, 32, 3)))
    model(x).sum().backward()
    assert seen and all(seen), seen
