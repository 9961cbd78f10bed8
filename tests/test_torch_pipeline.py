"""The pipeline (the GPipe schedule over ``pp``) held against the JAX
package.

(a) `parallel.pipeline.pipeline_apply`: four gloo ranks at ``dp=2 x
pp=2`` (one spawn for the module's cases) run a stack of two tanh stages
on their data group's rows with 2 and 4 microbatches; the outputs and
the stacked parameters' gradients (each rank's stage, summed over the
data groups) against JAX's `pipeline_apply` at the same mesh on its
virtual CPU devices. The errors (leading dims, a batch the microbatches
do not divide, a microbatch smaller than the data sharding, layers that
do not divide over the stages) with JAX's texts; ``pp == 1`` runs the
stages in sequence.

(b) The decoder under the GPipe schedule: its logits at ``dp=2 x pp=2``
with 4 microbatches equal to the plain stack's (one rank) and to JAX's
GPipe forward; the refusals of a GPipe config (``scan_layers=False``,
an attention other than xla) with JAX's texts.

(c) `train_and_evaluate` at ``dp=2 x pp=2`` and ``pp=2`` (2 and 4
microbatches, full weights and LoRA; the naive schedule, gpipe 0, with
the flash backend) against JAX's at the same MeshSpec
(`tests/_parallel_jobs.py`): losses, the parameters of rank 0's
one-device checkpoint (every stage's layers gathered to it), the ranks'
replicated parameters bitwise equal (the embedding, read by stage 0
alone, summed over pp), the ``train/pp_send`` spans. A pp=2 checkpoint
resumed at one rank, and a one-rank checkpoint resumed at pp=2, each
finish equal to JAX's straight run.

Tolerances (f32; the ranks run the same sums in other shapes than XLA):
outputs 1e-5 absolute, losses 1e-5 relative, gradients 1e-4 absolute,
the final parameters 1e-5 relative and 1e-6 absolute.

This module imports JAX only inside functions: the spawned ranks import
it by name to find their program.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import _parallel_jobs as pj

OUT_ATOL, GRAD_ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
WORLD, D, BATCH = 4, 8, 16
MICRO = (2, 4)
GPIPE_TOKENS = (8, 16)  # the decoder forward's batch and length


def stage_params(n_stages, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n_stages, D, D) * 0.5).astype(np.float32),
            "b": (rng.randn(n_stages, D) * 0.1).astype(np.float32)}


def stage_inputs(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, D).astype(np.float32),
            rng.randn(BATCH, D).astype(np.float32))


def _stage_fn(params, x):
    """The JAX test's stage (tests/test_pipeline.py), in torch."""
    return torch.tanh(x @ params["w"] + params["b"])


def _decoder_config(**overrides):
    from tf_yarn_tpu_torch.models import transformer as t_tt

    return t_tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                       remat=False, **overrides)


def _gpipe_tokens():
    return np.random.RandomState(0).randint(
        0, 256, GPIPE_TOKENS).astype(np.int64)


def _apply_ranks(rank, world, port, out_dir):
    import torch.distributed as dist

    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
    from tf_yarn_tpu_torch.parallel import pipeline

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {"errors": {}}
    try:
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(dp=2, pp=2), "cpu")
        index, count = mesh_lib.data_group(mesh)
        rows = slice(index * BATCH // count, (index + 1) * BATCH // count)
        x, w_out = (torch.from_numpy(a) for a in stage_inputs())
        for n_micro in MICRO:
            params = {k: torch.from_numpy(v).requires_grad_()
                      for k, v in stage_params(2).items()}
            got = pipeline.pipeline_apply(_stage_fn, params, x[rows], mesh,
                                          num_microbatches=n_micro)
            (got * w_out[rows]).sum().backward()
            out[n_micro] = {"out": got.detach(),
                            "grads": {k: p.grad for k, p in params.items()}}
        errors = {
            "leading": lambda: pipeline.pipeline_apply(
                _stage_fn, {k: torch.from_numpy(v)
                            for k, v in stage_params(3).items()},
                x[rows], mesh, num_microbatches=2),
            "divisible": lambda: pipeline.pipeline_apply(
                _stage_fn, {k: torch.from_numpy(v)
                            for k, v in stage_params(2).items()},
                torch.ones(5, D), mesh, num_microbatches=4),
            "data_sharding": lambda: pipeline.pipeline_apply(
                _stage_fn, {k: torch.from_numpy(v)
                            for k, v in stage_params(2).items()},
                torch.ones(4, D), mesh, num_microbatches=8),
            "n_layers": lambda: pipeline.parallelize(
                t_tt.Transformer(_decoder_config(n_layers=3), device="cpu"),
                mesh),
        }
        for name, call in errors.items():
            try:
                call()
            except ValueError as err:
                out["errors"][name] = str(err)
        # The GPipe decoder against the plain stack, the same weights.
        state = torch.load(os.path.join(out_dir, "gpipe-init.pt"))
        model = t_tt.Transformer(_decoder_config(gpipe_microbatches=4),
                                 device="cpu")
        model.load_state_dict(state)
        tokens = torch.from_numpy(_gpipe_tokens())[rows.start // 2:
                                                   rows.stop // 2]
        with torch.no_grad():
            out["plain_logits"] = model(tokens)
            pipeline.parallelize(model, mesh)
            out["gpipe_logits"] = model(tokens)
        out["stage_params"] = sorted(model.state_dict())
        torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gpipe_variables():
    """The JAX GPipe decoder's variables (its scanned layers) and the
    port's state dict of them."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as j_tt
    from tf_yarn_tpu_torch.models import weights as t_weights

    cfg = j_tt.TransformerConfig.tiny(dtype=jnp.float32, max_seq_len=64,
                                      remat=False, gpipe_microbatches=4)
    model = j_tt.Transformer(cfg)
    variables = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.asarray(_gpipe_tokens(), jnp.int32)))
    flat = jax.tree_util.tree_map(np.asarray, variables)
    return model, variables, t_weights.from_flax(flat, _decoder_config())


@pytest.fixture(scope="module")
def apply_ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("pipeline_apply"))
    _, _, state = _gpipe_variables()
    torch.save(state, os.path.join(out_dir, "gpipe-init.pt"))
    torch.multiprocessing.spawn(_apply_ranks,
                                args=(WORLD, pj.free_port(), out_dir),
                                nprocs=WORLD, join=True)
    return [torch.load(os.path.join(out_dir, f"rank-{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def _jax_mesh(**fields):
    from tf_yarn_tpu.parallel import mesh as j_mesh

    spec = j_mesh.MeshSpec(**fields)
    return j_mesh.build_mesh(spec, j_mesh.select_devices(
        spec.total_devices, platform="cpu"))


def jax_apply(n_micro):
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.parallel.pipeline import pipeline_apply

    mesh = _jax_mesh(dp=2, pp=2)
    params = {k: jnp.asarray(v) for k, v in stage_params(2).items()}
    x, w_out = (jnp.asarray(a) for a in stage_inputs())

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(params):
        out = pipeline_apply(stage, params, x, mesh,
                             num_microbatches=n_micro)
        return (out * w_out).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _coords(rank):
    """(pp, dp) of a rank of the row-major ``pp=2, dp=2`` mesh."""
    return rank // 2, rank % 2


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_apply_matches_jax(apply_ranks, n_micro):
    want, grads = jax_apply(n_micro)
    for rank, out in enumerate(apply_ranks):
        _, d = _coords(rank)
        rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
        np.testing.assert_allclose(out[n_micro]["out"].numpy(), want[rows],
                                   atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_apply_gradients_match_jax(apply_ranks, n_micro):
    """A rank's stacked parameters get a gradient at its stage only; over
    the data groups they sum to JAX's."""
    _, grads = jax_apply(n_micro)
    for stage in range(2):
        for key, want in grads.items():
            ranks = [r for r in range(WORLD) if _coords(r)[0] == stage]
            total = sum(apply_ranks[r][n_micro]["grads"][key] for r in ranks)
            np.testing.assert_allclose(total[stage].numpy(), want[stage],
                                       atol=GRAD_ATOL, rtol=0)
            other = total[1 - stage]
            assert not other.any(), (stage, key)


def test_pipeline_errors_match_jax(apply_ranks):
    import jax.numpy as jnp

    from tf_yarn_tpu.parallel.pipeline import pipeline_apply

    mesh = _jax_mesh(dp=2, pp=2)

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    want = {}
    for name, params, rows, n_micro in (("leading", stage_params(3), 16, 2),
                                        ("divisible", stage_params(2), 10, 4),
                                        ("data_sharding", stage_params(2), 8,
                                         8)):
        with pytest.raises(ValueError) as err:
            pipeline_apply(stage, {k: jnp.asarray(v)
                                   for k, v in params.items()},
                           jnp.ones((rows, D)), mesh,
                           num_microbatches=n_micro)
        want[name] = str(err.value)
    want["n_layers"] = "n_layers=3 must divide over pp=2 stages"
    for out in apply_ranks:
        assert out["errors"] == want


def test_pipeline_pp1_runs_the_stages_in_sequence():
    import jax.numpy as jnp

    from tf_yarn_tpu.parallel.pipeline import pipeline_apply as j_apply
    from tf_yarn_tpu_torch.parallel import pipeline

    params = stage_params(3)
    x = np.ones((8, D), np.float32)
    got = pipeline.pipeline_apply(
        _stage_fn, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), None, num_microbatches=2)
    want = j_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                   {k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(x), _jax_mesh(dp=8), num_microbatches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)


def test_gpipe_decoder_equals_the_plain_stack_and_jax(apply_ranks):
    """Each rank's logits under the schedule (4 microbatches of its data
    group's rows) equal the one-rank stack's on the same weights, and
    JAX's GPipe forward at the same mesh."""
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.parallel import mesh as j_mesh

    model, variables, _ = _gpipe_variables()
    mesh = _jax_mesh(dp=2, pp=2)
    j_mesh.set_current_mesh(mesh)
    try:
        with mesh:
            want = np.asarray(jax.jit(model.apply)(
                variables, jnp.asarray(_gpipe_tokens(), jnp.int32)))
    finally:
        j_mesh.set_current_mesh(None)
    half = GPIPE_TOKENS[0] // 2
    for rank, out in enumerate(apply_ranks):
        pp, d = _coords(rank)
        torch.testing.assert_close(out["gpipe_logits"], out["plain_logits"],
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(out["gpipe_logits"].numpy(),
                                   want[d * half:(d + 1) * half],
                                   atol=OUT_ATOL, rtol=0)
        # The rank holds its stage's layer and the replicated leaves.
        layers = {name.split(".")[1] for name in out["stage_params"]
                  if name.startswith("layers.")}
        assert layers == {str(pp)}


@pytest.mark.parametrize("overrides,match", [
    (dict(scan_layers=False), "gpipe_microbatches requires scan_layers=True"),
    (dict(attention_impl="ring"),
     "gpipe_microbatches supports dense blocks with xla attention"),
    (dict(attention_impl="flash"),
     "gpipe_microbatches supports dense blocks with xla attention"),
])
def test_gpipe_refusals_match_jax(overrides, match):
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as j_tt
    from tf_yarn_tpu_torch.models import transformer as t_tt

    tokens = jnp.zeros((4, 8), jnp.int32)
    with pytest.raises(ValueError) as want:
        j_tt.Transformer(j_tt.TransformerConfig.tiny(
            gpipe_microbatches=2, remat=False, **overrides)).init(
                jax.random.PRNGKey(0), tokens)
    model = t_tt.Transformer(_decoder_config(gpipe_microbatches=2,
                                             **overrides), device="cpu")
    with pytest.raises(ValueError) as got:
        model(torch.zeros(4, 8, dtype=torch.long))
    assert str(got.value) == str(want.value) == match


# -- (c) train_and_evaluate -------------------------------------------------

DEC = dict(model="decoder", lora=0, impl="xla", scan=True)
JOBS_4 = {
    "dp2_pp2_gpipe2": dict(DEC, gpipe=2, mesh={"dp": 2, "pp": 2}),
    "dp2_pp2_gpipe2_lora": dict(DEC, lora=pj.LORA, gpipe=2,
                                mesh={"dp": 2, "pp": 2}),
}
JOBS_2 = {
    "pp2_gpipe4": dict(DEC, gpipe=4, mesh={"pp": 2}),
    "pp2_naive_flash": dict(DEC, lora=pj.LORA, impl="flash",
                            mesh={"pp": 2}),
    "pp2_chunked": dict(DEC, gpipe=2, chunk=96, mesh={"pp": 2}),
    # Four steps, a checkpoint every two: the straight run, and the
    # reference of both resumes.
    "pp2_four": dict(DEC, gpipe=2, mesh={"pp": 2}, steps=4, checkpoint=2),
    # ckpt-2 written at one rank (this process), resumed at pp=2.
    "pp2_from_one": dict(DEC, gpipe=2, mesh={"pp": 2}, steps=4, checkpoint=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    jobs, boxed = pj.prepare(tmp, {**JOBS_4, **JOBS_2})
    pj.world_one(dict(jobs["pp2_from_one"], steps=2))
    port = pj.run_port(tmp, 4, [jobs[n] for n in JOBS_4])
    port.update(pj.run_port(tmp, 2, [jobs[n] for n in JOBS_2]))
    ref = {name: pj.jax_run(job, boxed[name]) for name, job in jobs.items()
           if name != "pp2_from_one"}
    ref["pp2_from_one"] = ref["pp2_four"]
    # pp2_four's ckpt-2 (written by the pp=2 ranks) resumed at one rank.
    to_one = dict(jobs["pp2_four"], name="to_one",
                  model_dir=os.path.join(tmp, "port-to_one"))
    os.makedirs(to_one["model_dir"])
    shutil.copytree(os.path.join(jobs["pp2_four"]["model_dir"], "ckpt-2"),
                    os.path.join(to_one["model_dir"], "ckpt-2"))
    _, one_state = pj.world_one(to_one)
    return {"jobs": jobs, "port": port, "ref": ref, "to_one": one_state}


def _check_params(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key].float(), value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, msg=key)


@pytest.mark.parametrize("name", list(JOBS_4) + list(JOBS_2))
def test_train_matches_jax(runs, name):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    job, ranks, ref = runs["jobs"][name], runs["port"][name], runs["ref"][name]
    steps = pj.train_params(job)["train_steps"]
    for rank, out in enumerate(ranks):
        want = {s: v for s, v in ref["losses"].items()
                if name != "pp2_from_one" or s > 2}
        assert sorted(out["losses"]) == sorted(want), rank
        for step, loss in want.items():
            assert out["losses"][step] == pytest.approx(loss, rel=LOSS_RTOL), \
                (rank, step)
    saved = t_ckpt.restore_checkpoint(job["model_dir"], steps,
                                      map_location="cpu")["params"]
    _check_params(saved, ref["params"])


@pytest.mark.parametrize("name", list(JOBS_4) + ["pp2_gpipe4"])
def test_replicated_parameters_bitwise_equal(runs, name):
    """Every parameter two ranks both hold is bitwise the same: the
    data groups' replicas of a stage, and the embedding, final norm and
    head on every stage (the embedding's gradient summed over pp)."""
    ranks = runs["port"][name]
    for a in range(len(ranks)):
        for b in range(a + 1, len(ranks)):
            shared = set(ranks[a]["state"]) & set(ranks[b]["state"])
            assert {"embedding", "lm_head", "final_norm.scale"} <= shared
            for key in shared:
                assert torch.equal(ranks[a]["state"][key],
                                   ranks[b]["state"][key]), (a, b, key)


def test_pp_checkpoint_resumes_at_one_rank(runs):
    """pp2_four's ckpt-2, the stages gathered by rank 0, resumed by one
    rank to step 4: JAX's straight run."""
    _check_params(runs["to_one"], runs["ref"]["pp2_four"]["params"])


@pytest.mark.parametrize("name", ["dp2_pp2_gpipe2", "pp2_naive_flash"])
def test_pipeline_telemetry(runs, name):
    job, ranks = runs["jobs"][name], runs["port"][name]
    micro = max(job.get("gpipe", 0), 1)
    ticks = micro + 2 - 1
    for out in ranks:
        assert out["mesh"]["pp"] == 2
        assert "train/pp_send_seconds" in out["histograms"]
        # Each step: a shift between ticks, forward and backward.
        assert out["spans"]["train/pp_send"] == {"ring_shift":
                                                 3 * 2 * (ticks - 1)}
        summed = out["spans"].get("train/grad_allreduce", {}).get("pp", 0)
        assert summed == (3 if not job["lora"] else 0)


def test_layer_stack_is_placed_over_pp_as_jax():
    """JAX's scanned layers carry the ``"layers"`` axis, which its rules
    place over pp (every leaf of the stack leads with ``pp``); the port's
    list of blocks carries the same logical axis as a stack, placed by
    the same rules."""
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as j_tt
    from tf_yarn_tpu.parallel import sharding as j_sharding
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.parallel import sharding as t_sharding

    boxed = j_tt.Transformer(j_tt.TransformerConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    specs = j_sharding.tree_partition_specs(boxed, 1)["params"]
    leads = {spec[0] for spec in jax.tree_util.tree_leaves(
        specs["layers"], is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))}
    assert leads == {"pp"}
    model = t_tt.Transformer(_decoder_config(), device="cpu")
    assert t_sharding.stack_placement(model) == {"layers": leads.pop()}
    assert t_sharding.stack_placement(
        model, t_sharding.RANKING_RULES) == {"layers": "pp"}
