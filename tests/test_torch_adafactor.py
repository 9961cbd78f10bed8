"""`models.adafactor` held against ``optax.adafactor`` on the CPU.

Step by step on hand-made leaves (the same seeded gradients fed to
both): a stacked ``[L, 256, 384]`` leaf (factored, its block RMS over
the L layers), a ``[3, 130]`` leaf (not factored: 3 < 128) and a 1-D
leaf whose RMS is under the 1e-3 floor. Then ``make_experiment(
optimizer="adafactor")`` against JAX's ``train_and_evaluate`` at a width
whose leaves factor (d_model 128, d_ff 256), at one device, with LoRA,
and over two gloo ranks at ``fsdp=2`` (FSDP2's DTensor shards) and
``ep=2`` (the MoE experts cut), the JAX side on virtual CPU devices.
f32 throughout: the tolerances cover sums in another order, and
``rsqrt`` against XLA's power.
"""

import numpy as np
import pytest
import torch
from torch import nn

import _parallel_jobs as pj

# One step's parameters, relative to the leaf's largest entry; the
# second moments, relative.
STEP_RTOL = 1e-6
STATE_RTOL = 1e-5
# Training runs (as tests/test_torch_expert_parallel.py).
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
LR = 1e-2


class _Layer(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))


class _Stacked(nn.Module):
    """A model with a ``layers`` stack, as the decoder annotates it."""

    def __init__(self, stack, a, b, scan):
        super().__init__()
        self.config = type("Config", (), {"scan_layers": scan})()
        self.layers = nn.ModuleList([_Layer(w) for w in stack])
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))
        self.stack_axes = {"layers": "layers"}


def _leaves(seed, n_layers=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n_layers, 256, 384).astype(np.float32) * 0.02,
            rng.randn(3, 130).astype(np.float32),
            rng.randn(7).astype(np.float32) * 1e-4)


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "unstacked"])
def test_adafactor_matches_optax_step_by_step(scan):
    import jax
    import jax.numpy as jnp
    import optax

    from tf_yarn_tpu_torch.models import adafactor

    stack, a, b = _leaves(0)
    model = _Stacked(stack, a, b, scan)
    optimizer = adafactor.adafactor(LR)(model)
    assert sorted(leaf.name for leaf in optimizer.leaves) == ["a", "b"] + (
        ["layers.*.w"] if scan else [f"layers.{i}.w" for i in range(3)])
    layers = jnp.asarray(stack) if scan else [jnp.asarray(w) for w in stack]
    params = {"layers": layers, "a": jnp.asarray(a), "b": jnp.asarray(b)}
    tx = optax.adafactor(LR)
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for step in range(4):
        grads = {"layers": rng.randn(*stack.shape).astype(np.float32),
                 "a": rng.randn(*a.shape).astype(np.float32),
                 "b": rng.randn(*b.shape).astype(np.float32)}
        j_grads = dict(grads, layers=jnp.asarray(grads["layers"]) if scan
                       else [jnp.asarray(g) for g in grads["layers"]])
        updates, state = tx.update(jax.tree.map(jnp.asarray, j_grads), state,
                                   params)
        params = optax.apply_updates(params, updates)
        for i, layer in enumerate(model.layers):
            layer.w.grad = torch.from_numpy(grads["layers"][i].copy())
        model.a.grad = torch.from_numpy(grads["a"])
        model.b.grad = torch.from_numpy(grads["b"])
        optimizer.step()
        got = {"layers": np.stack([layer.w.detach().numpy()
                                   for layer in model.layers]),
               "a": model.a.detach().numpy(), "b": model.b.detach().numpy()}
        want = {k: np.asarray(jnp.stack(v) if isinstance(v, list) else v)
                for k, v in params.items()}
        for key in got:
            scale = np.abs(want[key]).max()
            np.testing.assert_allclose(got[key], want[key],
                                       atol=STEP_RTOL * scale, rtol=0,
                                       err_msg=f"step {step} {key}")
    # The moments: the stacked leaf's v_row/v_col keep the layer axis.
    factored = state[0]
    v_row = np.asarray(jnp.stack(factored.v_row["layers"]) if not scan
                       else factored.v_row["layers"])
    v_col = np.asarray(jnp.stack(factored.v_col["layers"]) if not scan
                       else factored.v_col["layers"])
    np.testing.assert_allclose(
        np.stack([optimizer.state[l.w]["v_row"].numpy()
                  for l in model.layers]), v_row, rtol=STATE_RTOL)
    np.testing.assert_allclose(
        np.stack([optimizer.state[l.w]["v_col"].numpy()
                  for l in model.layers]), v_col, rtol=STATE_RTOL)
    np.testing.assert_allclose(optimizer.state[model.a]["v"].numpy(),
                               np.asarray(factored.v["a"]), rtol=STATE_RTOL)
    assert int(optimizer.state[model.b]["step"]) == int(factored.count) == 4


@pytest.mark.parametrize("shape", [(7,), (3, 130), (130, 3), (256, 384),
                                   (3, 256, 384), (384, 256), (128, 128),
                                   (8, 128, 130), (200, 2, 300), (127, 500)])
def test_factored_dims_match_optax(shape):
    from optax._src import factorized

    from tf_yarn_tpu_torch.models import adafactor

    assert adafactor.factored_dims(shape) == factorized._factored_dims(
        shape, True, 128)


def test_the_decoder_leaves_are_the_flax_leaves():
    """A scanned MoE LoRA-free decoder's leaves, as the optimizer groups
    them, are the shapes of the JAX tree's leaves; unscanned, each
    layer's."""
    import flax.linen as nn_flax
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu_torch.models import adafactor
    from tf_yarn_tpu_torch.models import transformer as tt

    for scan in (True, False):
        knobs = dict(moe_experts=2, scan_layers=scan, d_model=128, d_ff=256)
        j_vars = nn_flax.meta.unbox(jt.Transformer(jt.TransformerConfig.tiny(
            **knobs)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
        want = sorted(tuple(leaf.shape)
                      for leaf in jax.tree_util.tree_leaves(j_vars))
        model = tt.Transformer(tt.TransformerConfig.tiny(
            dtype=torch.float32, **knobs), device="cpu", trainable=True)
        leaves = adafactor.adafactor(LR)(model).leaves
        assert sorted(leaf.shape for leaf in leaves) == want, scan


def test_adafactor_refuses_tp_and_pp():
    from tf_yarn_tpu_torch.models import adafactor
    from tf_yarn_tpu_torch.models import transformer as tt

    for axis in ("tp", "pp"):
        model = tt.Transformer(tt.TransformerConfig.tiny(dtype=torch.float32),
                               device="cpu", trainable=True)
        if axis == "tp":
            model.layers[0].attn.tp = object()
        else:
            model.pp = object()
        with pytest.raises(NotImplementedError, match="Queue 1 item 8f"):
            adafactor.adafactor(LR)(model)


WIDE = dict(model="decoder", impl="xla", wide=True, optimizer="adafactor",
            scan=True)
ONE = {
    "one": dict(WIDE, lora=0),
    "one_unscanned_moe": dict(WIDE, lora=0, scan=False, moe=2),
    "one_lora": dict(WIDE, lora=pj.LORA),
}
JOBS_2 = {
    "fsdp2": dict(WIDE, lora=0, mesh={"fsdp": 2}),
    "ep2": dict(WIDE, lora=0, moe=4, cf=1.0, mesh={"ep": 2}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("adafactor"))
    jobs, boxed = pj.prepare(tmp, {**ONE, **JOBS_2})
    port = pj.run_port(tmp, 2, [jobs[n] for n in JOBS_2])
    for name in ONE:
        losses, state = pj.world_one(jobs[name])
        port[name] = [{"losses": losses, "state": state}]
    ref = {name: pj.jax_run(job, boxed[name]) for name, job in jobs.items()}
    return {"jobs": jobs, "port": port, "ref": ref}


@pytest.mark.parametrize("name", list(ONE) + list(JOBS_2))
def test_make_experiment_adafactor_matches_jax(runs, name):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    job, ranks, ref = runs["jobs"][name], runs["port"][name], runs["ref"][name]
    steps = pj.train_params(job)["train_steps"]
    for rank, out in enumerate(ranks):
        assert sorted(out["losses"]) == sorted(ref["losses"]), rank
        for step, loss in ref["losses"].items():
            assert out["losses"][step] == pytest.approx(loss, rel=LOSS_RTOL), \
                (rank, step)
    saved = t_ckpt.restore_checkpoint(job["model_dir"], steps,
                                      map_location="cpu")["params"]
    assert sorted(saved) == sorted(ref["params"])
    for key, value in ref["params"].items():
        torch.testing.assert_close(saved[key].float(), value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, msg=key)
    # Every trained leaf moved by much more than the tolerance; under
    # LoRA the base did not move at all.
    init = torch.load(job["init"])
    for key, value in saved.items():
        moved = float((value.float() - init[key]).abs().max())
        if job["lora"] and "lora_" not in key:
            assert moved == 0.0, key
        else:
            assert moved > 100 * PARAM_ATOL, key


# All-reduce rounds a step: FSDP2 cuts dim 0 of every leaf, a factored
# one's row or column sums too (three rounds: those sums, v_row's means,
# the update's squares); ep cuts only the experts' leading dim, which
# adafactor does not factor (two: the parameters' and the update's
# squares).
ROUNDS = {"fsdp2": 3, "ep2": 2}


@pytest.mark.parametrize("name", list(JOBS_2))
def test_sharded_leaves_sum_over_their_ranks(runs, name):
    """The block RMS (and a cut dim's factored means) summed over the
    ranks that hold the leaf, in ROUNDS all-reduces a step."""
    steps = pj.train_params(runs["jobs"][name])["train_steps"]
    for out in runs["port"][name]:
        spans = out["spans"]["train/adafactor_allreduce"]
        assert sum(spans.values()) == ROUNDS[name] * steps
