"""The port's training path held against the JAX package on the CPU.

One tiny f32 decoder (flash attention, fused norms, unrolled layers)
crosses from flax to the port through `models.weights.from_flax`; the
JAX side runs its Pallas kernels in interpret mode. f32 throughout, so
each tolerance covers sums taken in another order (and, over training
steps, what those differences become through Adam).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import common as t_common
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.weights import from_flax
from tf_yarn_tpu_torch.utils import flops as t_flops

SEQ = 16
BATCH = 2
LORA = 4


def _jax_config(lora_rank=LORA, **overrides):
    from tf_yarn_tpu.models import transformer as jt

    kwargs = dict(dtype=jnp.float32, attention_impl="flash", fused_norms=True,
                  scan_layers=False, remat=False, max_seq_len=64,
                  lora_rank=lora_rank)
    kwargs.update(overrides)
    return jt.TransformerConfig.tiny(**kwargs)


def _port_config(lora_rank=LORA, **overrides):
    kwargs = dict(dtype=torch.float32, attention_impl="flash", fused_norms=True,
                  scan_layers=False, remat=True, max_seq_len=64,
                  lora_rank=lora_rank)
    kwargs.update(overrides)
    return tt.TransformerConfig.tiny(**kwargs)


@functools.lru_cache(maxsize=None)
def _jax_variables(cfg, seed=0):
    """Flax variables (cached: JAX initialises the tiny model in interpret
    mode once per config), with nonzero lora_b (zeros would leave every LoRA-A
    gradient zero)."""
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    variables = nn.meta.unbox(jt.Transformer(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32)))
    rng = np.random.RandomState(seed + 11)

    def fill(path, leaf):
        if path[-1].key == "lora_b":
            return jnp.asarray(rng.randn(*leaf.shape).astype(np.float32) * 0.05)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


def _port_model(variables, cfg):
    model = tt.Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                           variables), cfg))
    return model


def _tokens(seed=0):
    return next(t_common.synthetic_token_iter(BATCH, SEQ, 256, seed=seed))


@pytest.fixture(scope="module")
def lora_pair():
    jcfg = _jax_config()
    variables = _jax_variables(jcfg)
    return jcfg, variables, _port_model(variables, _port_config())


def test_lora_model_matches_jax_logits_and_hidden(lora_pair):
    from tf_yarn_tpu.models import transformer as jt

    jcfg, variables, model = lora_pair
    tokens = _tokens()["tokens"]
    logits = jt.Transformer(jcfg).apply(variables, jnp.asarray(tokens))
    hidden = jt.Transformer(jcfg).apply(variables, jnp.asarray(tokens),
                                        return_hidden=True)
    t_tokens = torch.tensor(tokens).long()
    with torch.no_grad():
        got = model(t_tokens)
        got_hidden = model(t_tokens, return_hidden=True)
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, 256)
    # f32, sums in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden),
                               atol=1e-4, rtol=1e-4)


def test_unfused_norm_config_matches_jax_plain_norm():
    """fused_norms=False is accepted and every norm still goes through
    ops.rmsnorm, whose numbers are the JAX package's plain f32 norm."""
    from tf_yarn_tpu.models import transformer as jt

    jcfg = _jax_config(fused_norms=False)
    variables = _jax_variables(jcfg)
    model = _port_model(variables, _port_config(fused_norms=False))
    tokens = _tokens(seed=3)["tokens"]
    logits = jt.Transformer(jcfg).apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.tensor(tokens).long())
    # f32, sums in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4,
                               rtol=1e-4)


def test_lora_parameters_dtypes_and_trainability(lora_pair):
    _, _, model = lora_pair
    labels = tt.lora_label_tree(model)
    for name, param in model.named_parameters():
        assert param.requires_grad == (labels[name] == "lora"), name
        assert param.dtype == torch.float32
    assert labels["layers.0.attn.wq.lora_a"] == "lora"
    assert labels["embedding"] == "frozen"
    # A served (frozen) bf16 LoRA model stores its base in the compute
    # dtype and its norm scales in f32.
    frozen = tt.Transformer(_port_config(dtype=torch.bfloat16), device="cpu")
    assert frozen.layers[0].attn.wq.kernel.dtype == torch.bfloat16
    assert frozen.layers[0].attn_norm.scale.dtype == torch.float32
    trained = tt.Transformer(_port_config(dtype=torch.bfloat16), device="cpu",
                             trainable=True)
    assert trained.layers[0].attn.wq.lora_a.dtype == torch.float32
    assert trained.layers[0].attn.wq.kernel.dtype == torch.bfloat16


@pytest.mark.parametrize("loss, mask", [("full", False), ("full", True),
                                        ("chunked", False), ("chunked", True)])
def test_lm_losses_match_jax_value_and_grads(loss, mask):
    """Full fine-tune config so every parameter has a gradient; chunk
    size 96 over a 256 vocab forces a padded last chunk."""
    from tf_yarn_tpu.models import common as j_common
    from tf_yarn_tpu.models import transformer as jt

    jcfg = _jax_config(lora_rank=0)
    variables = _jax_variables(jcfg, seed=1)
    model = _port_model(variables, _port_config(lora_rank=0))
    batch = _tokens(seed=2)
    if mask:
        m = np.ones((BATCH, SEQ), np.int32)
        m[0, 10:] = 0
        batch["mask"] = m
    j_loss_fn = (functools.partial(j_common.lm_loss_chunked, chunk_size=96)
                 if loss == "chunked" else j_common.lm_loss)
    t_loss_fn = (functools.partial(t_common.lm_loss_chunked, chunk_size=96)
                 if loss == "chunked" else t_common.lm_loss)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_value, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jt.Transformer(jcfg), p, jbatch,
                            jax.random.PRNGKey(0)),
        has_aux=True))(variables)
    tbatch = {k: torch.tensor(v).long() for k, v in batch.items()}
    value, aux = t_loss_fn(model, tbatch)
    value.backward()
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-6)
    np.testing.assert_allclose(float(aux["perplexity"]),
                               float(j_aux["perplexity"]), rtol=1e-5)
    expected = from_flax(jax.tree_util.tree_map(np.asarray, j_grads),
                         _port_config(lora_rank=0))
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), expected[name].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=name)


def test_remat_changes_no_number():
    cfg = _port_config(lora_rank=0)
    model = tt.make_model(cfg, seed=3, device="cpu", trainable=True)
    batch = {"tokens": torch.tensor(_tokens(seed=4)["tokens"]).long()}
    grads = []
    for remat in (True, False):
        model.config = dataclasses.replace(cfg, remat=remat)
        for block in model.layers:  # every submodule reads its config
            for module in block.modules():
                if hasattr(module, "config"):
                    module.config = model.config
        model.zero_grad()
        t_common.lm_loss(model, batch)[0].backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["lora_chunked", "full_accum2"])
def test_train_step_trajectory_matches_jax(mode):
    """Five steps of the port's `build_train_step` against the JAX one,
    from the same weights and batches, with each package's own
    `make_experiment` optimizer (LoRA: frozen base, AdamW on the
    adapters; full: AdamW with the 1-D decay mask)."""
    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.training import TrainState, build_train_step

    lora = mode.startswith("lora")
    chunk = 96 if lora else None
    accum = 1 if lora else 2
    jcfg = _jax_config(lora_rank=LORA if lora else 0)
    pcfg = _port_config(lora_rank=LORA if lora else 0)
    variables = _jax_variables(jcfg, seed=5)
    j_exp = jt.make_experiment(jcfg, batch_size=BATCH, seq_len=SEQ,
                               learning_rate=1e-3, loss_chunk_size=chunk)
    t_exp = tt.make_experiment(pcfg, batch_size=BATCH, seq_len=SEQ,
                               learning_rate=1e-3, loss_chunk_size=chunk)
    j_state = TrainState(np.int32(0), variables,
                         j_exp.optimizer.init(variables))
    j_step = jax.jit(build_train_step(j_exp.model, j_exp.loss_fn,
                                      j_exp.optimizer, grad_accum_steps=accum))
    model = _port_model(variables, pcfg)
    optimizer = t_exp.optimizer(model)
    state = t_training.TrainState(0, model, optimizer)
    step = t_training.build_train_step(model, t_exp.loss_fn, optimizer,
                                       grad_accum_steps=accum)
    batches = t_common.synthetic_token_iter(BATCH, SEQ, 256, seed=6)
    for _ in range(5):
        batch = next(batches)
        j_state, j_metrics = j_step(j_state, batch, jax.random.PRNGKey(0))
        state, metrics = step(state, {"tokens": torch.tensor(
            batch["tokens"]).long()})
        # f32; Adam turns reordered sums into ~1e-6 relative drift.
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(metrics["perplexity"]),
                                   float(j_metrics["perplexity"]), rtol=5e-5)
    assert state.step == 5
    expected = from_flax(jax.tree_util.tree_map(np.asarray, j_state.params), pcfg)
    moved = 0
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   expected[name].numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=name)
        moved += not np.array_equal(param.detach().numpy(),
                                    from_flax(jax.tree_util.tree_map(
                                        np.asarray, variables), pcfg)[name]
                                    .numpy())
    assert moved > 0


def _tiny_experiment(model_dir, **overrides):
    kwargs = dict(model_dir=str(model_dir), train_steps=4, batch_size=BATCH,
                  seq_len=SEQ, learning_rate=1e-3, checkpoint_every_steps=2,
                  keep_last_n=1, log_every_steps=1)
    kwargs.update(overrides)
    return tt.make_experiment(_port_config(), **kwargs)


def test_train_and_evaluate_checkpoints_quarantine_and_resume(tmp_path):
    registry = telemetry.get_registry()
    core = t_experiment.as_core_experiment(_tiny_experiment(tmp_path))
    metrics = t_training.train_and_evaluate(core, device="cpu")
    assert np.isfinite(metrics["loss"])
    # Saves at steps 2 and 4; retention (keep_last_n=1, before each save)
    # leaves the two newest; step 4 is the final step, saved once.
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [2, 4]
    for step in (2, 4):
        path = t_ckpt.checkpoint_path(str(tmp_path), step)
        assert os.path.exists(os.path.join(path, t_ckpt.MANIFEST_NAME))
        t_ckpt.verify_checkpoint(path)
    assert registry.gauge("train/tokens_per_sec").value > 0
    state4 = t_ckpt.restore_checkpoint(str(tmp_path), 4)
    assert state4["step"] == 4
    assert set(state4["params"]) == set(tt.Transformer(
        _port_config(), device="cpu").state_dict())

    # Corrupt the newest checkpoint: it is quarantined and the run
    # resumes from step 2, handing that step to an input_fn that asks.
    params = os.path.join(t_ckpt.checkpoint_path(str(tmp_path), 4), "params.pt")
    with open(params, "r+b") as fh:
        fh.seek(100)
        byte = fh.read(1)
        fh.seek(100)
        fh.write(bytes([byte[0] ^ 0xFF]))
    seen = []

    def input_fn(start_step=0):
        seen.append(start_step)
        return t_common.synthetic_token_iter(BATCH, SEQ, 256, seed=start_step)

    quarantined = registry.counter("checkpoint/quarantined_total").value
    resumed = t_experiment.as_core_experiment(_tiny_experiment(
        tmp_path, train_steps=6, input_fn=input_fn))
    t_training.train_and_evaluate(resumed, device="cpu")
    assert seen == [2]
    assert os.path.isdir(t_ckpt.checkpoint_path(str(tmp_path), 4) + ".corrupt")
    assert registry.counter("checkpoint/quarantined_total").value == quarantined + 1
    assert t_ckpt.list_checkpoint_steps(str(tmp_path)) == [4, 6]
    assert t_ckpt.restore_checkpoint(str(tmp_path), 6)["step"] == 6

    # Restored at train_steps: nothing to run, the loss is still reported.
    done = t_training.train_and_evaluate(t_experiment.as_core_experiment(
        _tiny_experiment(tmp_path, train_steps=6)), device="cpu")
    assert np.isfinite(done["loss"])


def test_train_and_evaluate_resume_equals_uninterrupted(tmp_path):
    """Four steps straight equal two steps, a checkpoint, and two more."""
    straight = t_training.train_and_evaluate(t_experiment.as_core_experiment(
        _tiny_experiment(tmp_path / "a", checkpoint_every_steps=None)),
        device="cpu")
    t_training.train_and_evaluate(t_experiment.as_core_experiment(
        _tiny_experiment(tmp_path / "b", train_steps=2)), device="cpu")
    # The synthetic stream restarts from its beginning on resume (no
    # start_step), so feed the two batches the straight run took next.
    def input_fn(start_step=0):
        stream = t_common.synthetic_token_iter(BATCH, SEQ, 256)
        for _ in range(start_step):
            next(stream)
        return stream

    resumed = t_training.train_and_evaluate(t_experiment.as_core_experiment(
        _tiny_experiment(tmp_path / "b", input_fn=input_fn)), device="cpu")
    a = t_ckpt.restore_checkpoint(str(tmp_path / "a"), 4)["params"]
    b = t_ckpt.restore_checkpoint(str(tmp_path / "b"), 4)["params"]
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert resumed["loss"] == straight["loss"]


def test_eval_cadence_reports_eval_metrics(tmp_path):
    exp = _tiny_experiment(tmp_path, train_steps=2, eval_every_steps=1,
                           eval_steps=2, checkpoint_every_steps=None)
    exp.eval_input_fn = lambda: t_common.synthetic_token_iter(BATCH, SEQ, 256,
                                                              seed=9)
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert np.isfinite(metrics["eval_loss"]) and "eval_perplexity" in metrics


def test_merge_lora_loads_into_rank0_with_the_same_logits(lora_pair):
    from tf_yarn_tpu.models import transformer as jt

    jcfg, variables, model = lora_pair
    merged = tt.merge_lora(model.state_dict(), model.config)
    assert not any("lora" in name for name in merged)
    plain = tt.Transformer(dataclasses.replace(model.config, lora_rank=0),
                           device="cpu")
    plain.load_state_dict(merged)
    tokens = torch.tensor(_tokens(seed=7)["tokens"]).long()
    with torch.no_grad():
        torch.testing.assert_close(plain(tokens), model(tokens), atol=1e-4,
                                   rtol=1e-4)
    # The same fold as the JAX package's merge_lora.
    j_merged = jt.merge_lora(jax.tree_util.tree_map(np.asarray, variables),
                             jcfg)
    expected = from_flax(j_merged, plain.config)
    for name, value in merged.items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_make_experiment_matches_the_jax_recipe():
    big = tt.TransformerConfig.llama3_8b(lora_rank=16)
    exp = tt.make_experiment(big, batch_size=1, seq_len=2048, train_steps=4)
    assert exp.loss_fn.func is t_common.lm_loss_chunked
    assert exp.loss_fn.keywords == {"chunk_size": 16384}
    assert exp.train_params.log_every_steps == 1
    small = tt.make_experiment(_port_config(lora_rank=0), train_steps=50)
    assert small.loss_fn is t_common.lm_loss
    assert small.train_params.log_every_steps == 5
    model = tt.make_model(_port_config(lora_rank=0), seed=0, device="cpu",
                          trainable=True)
    optimizer = small.optimizer(model)
    decays = sorted((g["weight_decay"], len(g["params"]))
                    for g in optimizer.param_groups)
    # 1-D norm scales (2 per layer + final) get no decay.
    assert decays == [(0.0, 5), (1e-4, 2 * 7 + 2)]
    # optax.adafactor (models/adafactor.py; tests/test_torch_adafactor.py),
    # wrapped by the frozen-base LoRA optimizer as AdamW is.
    from tf_yarn_tpu_torch.models import adafactor

    exp = tt.make_experiment(_port_config(lora_rank=0), optimizer="adafactor")
    assert isinstance(exp.optimizer(model), adafactor.Adafactor)
    lora = tt.make_model(_port_config(), seed=0, device="cpu", trainable=True)
    optimizer = tt.make_experiment(_port_config(),
                                   optimizer="adafactor").optimizer(lora)
    assert isinstance(optimizer, adafactor.Adafactor)
    assert all(tt.is_lora_param(part.name) for leaf in optimizer.leaves
               for part in leaf.parts)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tt.make_experiment(_port_config(), optimizer="lamb")


def test_refusals_name_their_roadmap_items(tmp_path):
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    # MoE trains (tests/test_torch_moe.py): its knobs construct; serving
    # an MoE decoder refuses, naming its item.
    for knob in ("moe_experts", "moe_capacity_factor", "moe_aux_weight"):
        config = _port_config(**{knob: 2})
        assert tt.Transformer(config, device="cpu").config == config
    moe_model = tt.make_model(_port_config(moe_experts=2), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8e"):
        moe_model.prefill(torch.zeros((1, 4), dtype=torch.long))
    # GPipe is ported (tests/test_torch_pipeline.py): a GPipe config
    # builds, and at one rank its pp=2 mesh is the size error.
    assert tt.Transformer(_port_config(gpipe_microbatches=2), device="cpu")
    exp = _tiny_experiment(tmp_path, mesh_spec=MeshSpec(pp=2))
    with pytest.raises(ValueError, match="MeshSpec wants 2 devices"):
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")

    class Mesh:
        total_devices = 2

    # A 2-device mesh at one rank: the JAX package's mesh size error.
    exp = _tiny_experiment(tmp_path, mesh_spec=Mesh())
    with pytest.raises(ValueError, match="MeshSpec wants 2 devices"):
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    # tp, sp and ep train (tests/test_torch_tensor_parallel.py,
    # tests/test_torch_sequence_parallel.py,
    # tests/test_torch_expert_parallel.py); at one rank a tp=2, sp=2 or
    # ep=2 mesh is the size error, and ep beside tp is refused.
    for spec in (MeshSpec(tp=2), MeshSpec(sp=2), MeshSpec(ep=2)):
        exp = _tiny_experiment(tmp_path, mesh_spec=spec)
        with pytest.raises(ValueError, match="MeshSpec wants 2 devices"):
            t_training.train_and_evaluate(
                t_experiment.as_core_experiment(exp), device="cpu")
    exp = _tiny_experiment(tmp_path, mesh_spec=MeshSpec(ep=2, tp=2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8d"):
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    with pytest.raises(TypeError):
        t_experiment.as_core_experiment(object())


def test_train_params_validation():
    for bad in (dict(train_steps=0), dict(train_steps=1, steps_per_loop=0),
                dict(train_steps=1, grad_accum_steps=0),
                dict(train_steps=1, keep_last_n=0),
                dict(train_steps=1, log_every_steps=-1),
                dict(train_steps=1, eval_steps=0),
                dict(train_steps=1, checkpoint_every_steps=0)):
        with pytest.raises(ValueError):
            t_experiment.TrainParams(**bad)


def test_flops_and_mfu_match_jax():
    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.utils import flops as j_flops

    for b, s in ((1, 2048), (4, 512)):
        assert t_flops.transformer_train_flops(
            tt.TransformerConfig.llama3_8b(), b, s) == \
            j_flops.transformer_train_flops(jt.TransformerConfig.llama3_8b(), b, s)
    assert t_flops.peak_flops_per_device("NVIDIA H100 80GB HBM3") == 989e12
    assert t_flops.peak_flops_per_device("cpu") is None
    assert t_flops.mfu(989e12, 0.5, 989e12) == 0.5
    assert t_flops.mfu(None, 1.0, 989e12) is None
