"""`models.moe.MoEMlp` and the MoE decoder held against the JAX package on
the CPU.

The same seeded numpy inputs and bridged weights go through JAX
``MoEMlp.apply(..., mutable=["intermediates"])`` and the port's layer,
with enough capacity and at ``moe_capacity_factor=0.5`` (tokens
dropped): output, aux loss and every gradient. Then the decoder's
``lm_loss`` and ``lm_loss_chunked`` with ``moe_experts=2`` in both layer
layouts, as JAX tests/test_models.py:197-221 runs them; no aux at
``moe_aux_weight=0``; the aux collected once under remat; an MoE + LoRA
run that trains only the adapters; the serving refusal. f32 throughout:
the tolerances cover sums taken in another order. Routing is discrete,
so each routing case asserts that its smallest top-1 margin exceeds
ROUTE_MARGIN: a near-tie fails loudly instead of passing by luck.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.models import common as t_common
from tf_yarn_tpu_torch.models import moe as t_moe
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.weights import from_flax

# f32 outputs and gradients (measured within 1e-7).
TOL = 1e-5
ROUTE_MARGIN = 1e-4
SEQ = 16


def _margin(x, router):
    probs = torch.softmax(torch.as_tensor(np.asarray(x)).reshape(
        -1, router.shape[0]).float() @ torch.as_tensor(np.asarray(router)),
        -1)
    top = probs.topk(2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_mlp_matches_jax(capacity_factor):
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.models.moe import MoEMlp

    jcfg = jt.TransformerConfig.tiny(moe_experts=4, dtype=jnp.float32,
                                     moe_capacity_factor=capacity_factor)
    cfg = tt.TransformerConfig.tiny(moe_experts=4, dtype=torch.float32,
                                    moe_capacity_factor=capacity_factor)
    x = np.random.RandomState(0).randn(2, 8, cfg.d_model).astype(np.float32)
    layer = MoEMlp(jcfg)
    params = nn.meta.unbox(layer.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))["params"]
    assert _margin(x, params["router"]) > ROUTE_MARGIN

    def apply(p, inputs):
        out, mods = layer.apply({"params": p}, inputs,
                                mutable=["intermediates"])
        return out, jax.tree_util.tree_leaves(mods["intermediates"])[0]

    def objective(p, inputs):
        out, aux = apply(p, inputs)
        return (out ** 2).sum() + aux

    want_out, want_aux = apply(params, jnp.asarray(x))
    want_dp, want_dx = jax.grad(objective, argnums=(0, 1))(params,
                                                           jnp.asarray(x))
    port = t_moe.MoEMlp(cfg, device="cpu", trainable=True)
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(port, name).copy_(torch.from_numpy(
                np.array(params[name])))
    inputs = torch.from_numpy(x).requires_grad_(True)
    with t_moe.collecting() as losses:
        out = port(inputs)
    assert len(losses) == 1
    ((out ** 2).sum() + losses[0]).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=TOL)
    assert float(losses[0]) == pytest.approx(float(want_aux), rel=TOL)
    np.testing.assert_allclose(inputs.grad.numpy(), np.asarray(want_dx),
                               atol=TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(want_dp[name]), atol=TOL,
                                   err_msg=name)
    # Capacity 0.5 drops tokens: their outputs are exactly zero.
    cap = t_moe.capacity(cfg, x.shape[0] * x.shape[1])
    dropped = (out.detach().reshape(-1, cfg.d_model) == 0).all(-1)
    assert cap == max(1, int(capacity_factor * 16 / 4))
    assert bool(dropped.any()) == (capacity_factor < 1.0)


def _jax_decoder(scan, **overrides):
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    kwargs = dict(moe_experts=2, scan_layers=scan, remat=False,
                  dtype=jnp.float32, fused_norms=False)
    kwargs.update(overrides)
    cfg = jt.TransformerConfig.tiny(**kwargs)
    model = jt.Transformer(cfg)
    tokens = jnp.asarray(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, SEQ)), jnp.int32)
    params = nn.meta.unbox(model.init(jax.random.PRNGKey(0), tokens))
    return model, params, tokens


def _port_decoder(params, scan, **overrides):
    kwargs = dict(moe_experts=2, scan_layers=scan, dtype=torch.float32)
    kwargs.update(overrides)
    cfg = tt.TransformerConfig.tiny(**kwargs)
    model = tt.Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params),
                                    cfg))
    return model


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_lm_losses_collect_the_moe_aux_as_jax(scan):
    """JAX tests/test_models.py:197-221: both losses report the aux loss
    and fold it in; here also against JAX's values and gradients."""
    from tf_yarn_tpu.models import common as j_common

    model, params, tokens = _jax_decoder(scan)
    rng = jax.random.PRNGKey(1)
    full, aux_full = j_common.lm_loss(model, params, {"tokens": tokens}, rng)
    chunked, aux_chunk = j_common.lm_loss_chunked(
        model, params, {"tokens": tokens}, rng, chunk_size=100)
    grads = jax.grad(lambda p: j_common.lm_loss(
        model, p, {"tokens": tokens}, rng)[0])(params)
    port = _port_decoder(params, scan)
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)).long()}
    t_full, t_aux = t_common.lm_loss(port, batch)
    t_full.backward()
    with torch.no_grad():
        t_chunked, t_aux_chunk = t_common.lm_loss_chunked(port, batch,
                                                          chunk_size=100)
    for got, want in ((t_full, full), (t_chunked, chunked)):
        assert float(got) == pytest.approx(float(want), rel=TOL)
    for got, want in ((t_aux, aux_full), (t_aux_chunk, aux_chunk)):
        assert float(got["moe_aux_loss"]) == pytest.approx(
            float(want["moe_aux_loss"]), rel=TOL)
        assert float(got["perplexity"]) == pytest.approx(
            float(want["perplexity"]), rel=TOL)
    want_grads = from_flax(jax.tree_util.tree_map(np.asarray, grads),
                           port.config)
    for name, param in port.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   want_grads[name].numpy(), atol=TOL,
                                   err_msg=name)


def test_no_aux_at_zero_weight():
    _, params, tokens = _jax_decoder(True, moe_aux_weight=0.0)
    port = _port_decoder(params, True, moe_aux_weight=0.0)
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)).long()}
    for loss_fn in (t_common.lm_loss, t_common.lm_loss_chunked):
        loss, aux = loss_fn(port, batch)
        assert "moe_aux_loss" not in aux
        assert float(aux["perplexity"]) == pytest.approx(
            float(torch.exp(loss)), rel=1e-6)


def test_remat_collects_the_aux_once():
    """Each block recomputed in the backward (remat) appends no second aux:
    the loss, the aux and every gradient equal the run without remat."""
    _, params, tokens = _jax_decoder(True)
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)).long()}
    out = []
    for remat in (True, False):
        port = _port_decoder(params, True, remat=remat)
        seen = []
        for layer in port.layers:
            layer.moe.register_forward_pre_hook(lambda *_: seen.append(1))
        loss, aux = t_common.lm_loss(port, batch)
        loss.backward()
        out.append((float(loss), float(aux["moe_aux_loss"]), len(seen),
                    {n: p.grad.clone() for n, p in port.named_parameters()}))
    (loss_r, aux_r, calls_r, grads_r), (loss_p, aux_p, calls_p, grads_p) = out
    assert (loss_r, aux_r) == (loss_p, aux_p)
    assert calls_p == 2 and calls_r == 4  # each MoE forward entered again
    for name, grad in grads_p.items():
        torch.testing.assert_close(grads_r[name], grad, rtol=0, atol=0)


def test_moe_lora_trains_only_the_adapters(tmp_path):
    """The MoE weights are no LoraDense in JAX: under LoRA they are
    frozen (lora_label_tree marks them so) and stored in the compute
    dtype; two train steps move the adapters only."""
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training

    cfg = tt.TransformerConfig.tiny(moe_experts=2, lora_rank=4,
                                    dtype=torch.float32)
    labels = tt.lora_label_tree(tt.Transformer(cfg, device="cpu",
                                               trainable=True))
    assert {labels[f"layers.0.moe.{n}"] for n in
            ("router", "w_gate", "w_up", "w_down")} == {"frozen"}
    before = {}

    def init(device, seed):
        model = tt.make_model(cfg, seed, device, trainable=True)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if name.endswith("lora_b"):
                    param.normal_(0.0, 0.05)
        before.update({n: p.detach().clone()
                       for n, p in model.named_parameters()})
        before["model"] = model
        return model

    exp = tt.make_experiment(cfg, train_steps=2, batch_size=2, seq_len=SEQ,
                             learning_rate=1e-2)
    exp.init_fn = init
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert "moe_aux_loss" in metrics and np.isfinite(metrics["loss"])
    model = before.pop("model")
    for name, param in model.named_parameters():
        same = torch.equal(param.detach(), before[name])
        assert same != tt.is_lora_param(name), name
        if ".moe." in name:
            assert param.dtype == cfg.dtype and not param.requires_grad


def test_moe_decoder_trains_and_reports_the_aux(tmp_path):
    """JAX tests/test_models.py:223-230 at one device: the aux loss flows
    into training and into the returned metrics."""
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training

    cfg = tt.TransformerConfig.tiny(moe_experts=4, dtype=torch.float32)
    exp = tt.make_experiment(cfg, train_steps=3, batch_size=4, seq_len=32)
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert np.isfinite(metrics["loss"]) and "moe_aux_loss" in metrics


def test_moe_dispatch_capacity():
    """JAX tests/test_models.py:233-247: with generous capacity every
    token reaches one expert, the output is nonzero and the aux finite."""
    cfg = tt.TransformerConfig.tiny(moe_experts=2, moe_capacity_factor=2.0,
                                    dtype=torch.float32)
    layer = t_moe.MoEMlp(cfg, device="cpu", trainable=True)
    with torch.no_grad():  # the decoder's initialiser's scales
        layer.router.normal_(0.0, 0.02)
        for name in ("w_gate", "w_up", "w_down"):
            param = getattr(layer, name)
            param.normal_(0.0, (param.numel() // param.shape[-1]) ** -0.5)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 8, cfg.d_model).astype(np.float32))
    with t_moe.collecting() as losses:
        out = layer(x)
    assert out.shape == x.shape
    assert bool((out.reshape(-1, cfg.d_model) != 0).any(-1).all())
    assert np.isfinite(float(losses[0]))


def test_serving_an_moe_decoder_is_refused():
    from tf_yarn_tpu_torch.models import decode_engine

    model = tt.make_model(tt.TransformerConfig.tiny(moe_experts=2,
                                                    dtype=torch.float32),
                          device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8e"):
        model.prefill(tokens)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8e"):
        model.decode(tokens, model.make_cache(1, 8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8e"):
        decode_engine.DecodeEngine(model)


def test_moe_flops_match_jax():
    """An MoE layer counts as the dense layer per token (JAX
    utils/flops.py:93-96)."""
    import dataclasses

    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.utils import flops as j_flops
    from tf_yarn_tpu_torch.utils import flops as t_flops

    port = dataclasses.replace(tt.TransformerConfig.llama3_8b(moe_experts=8),
                               n_layers=1)
    ref = dataclasses.replace(jt.TransformerConfig.llama3_8b(moe_experts=8),
                              n_layers=1)
    for b, s in ((1, 2048), (4, 512)):
        assert t_flops.transformer_train_flops(port, b, s) == \
            j_flops.transformer_train_flops(ref, b, s)
