"""The MoE decoder trained across ranks (`parallel.expert_parallel`) held
against the JAX package's `train_and_evaluate` at the same `MeshSpec`,
on the CPU.

The port's ranks are gloo processes (`tests/_parallel_jobs.py`); the JAX
side places the same flax variables on virtual CPU devices, where GSPMD
puts the experts over ``ep`` and runs the MoE layer on the global batch.
Each case starts from the same weights and the same seeded global
batches:

* ``ep2`` — the experts cut over two ranks (capacity factor 1.0: tokens
  are dropped), and its resume at two ranks from its own ckpt-2;
* ``dp2`` — two data ranks at capacity factor 0.5: rank 1's tokens are
  dropped where rank 0's filled their expert, so the global capacity,
  the offsets and the global aux loss are pinned;
* ``dp2_ep2`` — both, on four ranks;
* the ``ep2`` checkpoint (whole expert leaves) resumed at one rank.

Full weights train at lr 2e-5 (`_parallel_jobs.LR_FULL`). Routing is
discrete: each run asserts that its smallest top-1 margin at the initial
weights exceeds ROUTE_MARGIN, so a near-tie, which the other package
could route the other way, fails loudly instead of passing by luck.

This module imports JAX only inside functions: the spawned ranks import
it by name.
"""

import os
import shutil

import pytest
import torch

import _parallel_jobs as pj

# f32 on both sides: the losses and parameters agree to the sums' order
# (measured within 1e-6 and 2e-7 here).
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
# The smallest gap between a token's top two router probabilities at the
# initial weights that the routing tests accept.
ROUTE_MARGIN = 1e-4

MOE = dict(model="decoder", lora=0, impl="xla", moe=4)
JOBS_2 = {
    "ep2": dict(MOE, cf=1.0, mesh={"ep": 2}, steps=4, checkpoint=2),
    "dp2": dict(MOE, cf=0.5, mesh={"dp": 2}),
    # ep2's ckpt-2 resumed at ep=2 (copied in before the spawn).
    "ep2_resume": dict(MOE, cf=1.0, mesh={"ep": 2}, steps=4, checkpoint=2),
}
JOBS_4 = {
    "dp2_ep2": dict(MOE, cf=0.5, mesh={"dp": 2, "ep": 2}),
}


def route_margins(job, state):
    """The smallest top-1 margin of each MoE layer over the job's first
    global batch, at `state`."""
    from tf_yarn_tpu_torch.models import moe as t_moe
    from tf_yarn_tpu_torch.models import transformer as t_tt

    model = t_tt.Transformer(pj.port_config(job), device="cpu",
                             trainable=True)
    model.load_state_dict(state)
    margins = []

    def hook(module, args, _):
        probs = torch.softmax(args[0].reshape(-1, args[0].shape[-1]).float()
                              @ module.router.float(), -1)
        top = probs.topk(2, dim=-1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))

    for module in model.modules():
        if isinstance(module, t_moe.MoEMlp):
            module.register_forward_hook(hook)
    batch = next(pj.stream(job)())
    with torch.no_grad():
        model(torch.as_tensor(batch["tokens"]).long())
    return margins


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("expert_parallel"))
    jobs, boxed = pj.prepare(tmp, {**JOBS_2, **JOBS_4})
    margins = {name: route_margins(job, torch.load(job["init"]))
               for name, job in jobs.items()}
    # ep2_resume resumes from a ckpt-2 written by ep=2 ranks: ep2's, made
    # by a first spawn of ep2 alone.
    port = pj.run_port(tmp, 2, [jobs["ep2"]])
    os.makedirs(jobs["ep2_resume"]["model_dir"])
    shutil.copytree(os.path.join(jobs["ep2"]["model_dir"], "ckpt-2"),
                    os.path.join(jobs["ep2_resume"]["model_dir"], "ckpt-2"))
    port.update(pj.run_port(tmp, 2, [jobs["dp2"], jobs["ep2_resume"]]))
    port.update(pj.run_port(tmp, 4, [jobs[n] for n in JOBS_4]))
    ref = {name: pj.jax_run(job, boxed[name]) for name, job in jobs.items()
           if name != "ep2_resume"}
    ref["ep2_resume"] = ref["ep2"]
    # ep2's ckpt-2 (the experts gathered by rank 0) resumed at one rank.
    to_one = dict(jobs["ep2"], name="to_one",
                  model_dir=os.path.join(tmp, "port-to_one"))
    os.makedirs(to_one["model_dir"])
    shutil.copytree(os.path.join(jobs["ep2"]["model_dir"], "ckpt-2"),
                    os.path.join(to_one["model_dir"], "ckpt-2"))
    _, one_state = pj.world_one(to_one)
    return {"jobs": jobs, "port": port, "ref": ref, "to_one": one_state,
            "margins": margins}


def _check_params(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key].float(), value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, msg=key)


@pytest.mark.parametrize("name", list(JOBS_2) + list(JOBS_4))
def test_moe_trains_over_ranks_as_jax(runs, name):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    assert min(runs["margins"][name]) > ROUTE_MARGIN, runs["margins"][name]
    job, ranks, ref = runs["jobs"][name], runs["port"][name], runs["ref"][name]
    steps = pj.train_params(job)["train_steps"]
    for rank, out in enumerate(ranks):
        want = {s: v for s, v in ref["losses"].items()
                if name != "ep2_resume" or s > 2}
        assert sorted(out["losses"]) == sorted(want), rank
        for step, loss in want.items():
            assert out["losses"][step] == pytest.approx(loss, rel=LOSS_RTOL), \
                (rank, step)
        assert out["mesh"] == dict({"pp": 1, "dp": 1, "fsdp": 1, "sp": 1,
                                    "tp": 1, "ep": 1}, **job["mesh"])
    saved = t_ckpt.restore_checkpoint(job["model_dir"], steps,
                                      map_location="cpu")["params"]
    _check_params(saved, ref["params"])


@pytest.mark.parametrize("name", ["ep2", "dp2_ep2"])
def test_each_ep_rank_holds_its_experts(runs, name):
    """Each rank holds E / ep experts (the checkpoint holds all E), and
    every parameter two ranks both hold whole is bitwise the same; each
    forward and backward ran the ep pair (the combine's sum and the
    dispatch input's gradient sum) once a layer."""
    job, ranks = runs["jobs"][name], runs["port"][name]
    ep = job["mesh"]["ep"]
    n_layers = pj.port_config(job).n_layers
    steps = pj.train_params(job)["train_steps"]
    for rank, out in enumerate(ranks):
        for key, value in out["state"].items():
            if key.endswith(("w_gate", "w_up", "w_down")):
                assert value.shape[0] == job["moe"] // ep, (rank, key)
        # Each step: a forward, its recompute under remat and a backward.
        assert out["spans"]["train/ep_allreduce"] == {
            "ep_combine": 2 * n_layers * steps,
            "ep_dispatch": n_layers * steps}
        assert "train/ep_allreduce_seconds" in out["histograms"]
    saved = torch.load(os.path.join(job["model_dir"], f"ckpt-{steps}",
                                    "params.pt"))
    assert saved["layers.0.moe.w_up"].shape[0] == job["moe"]
    for a in range(len(ranks)):
        for b in range(a + 1, len(ranks)):
            for key in ranks[a]["state"]:
                if not key.endswith(("w_gate", "w_up", "w_down")):
                    assert torch.equal(ranks[a]["state"][key],
                                       ranks[b]["state"][key]), (a, b, key)


def test_ep_checkpoint_resumes_at_one_rank(runs):
    """ep2's ckpt-2, the experts gathered whole by rank 0, resumed by one
    rank to step 4: JAX's straight run."""
    _check_params(runs["to_one"], runs["ref"]["ep2"]["params"])


def test_dp2_drops_across_data_ranks(runs):
    """The dp2 case's routing at its initial weights drops tokens of rank
    1 that rank 0's tokens pushed past the global capacity: a per-rank
    capacity or position would route it otherwise."""
    from tf_yarn_tpu_torch.models import moe as t_moe
    from tf_yarn_tpu_torch.models import transformer as t_tt

    job = runs["jobs"]["dp2"]
    cfg = pj.port_config(job)
    model = t_tt.Transformer(cfg, device="cpu", trainable=True)
    model.load_state_dict(torch.load(job["init"]))
    seen = []
    model.layers[0].moe.register_forward_hook(
        lambda m, args, _: seen.append(args[0].reshape(-1, cfg.d_model)))
    batch = torch.as_tensor(next(pj.stream(job)())["tokens"]).long()
    with torch.no_grad():
        model(batch)
    experts = torch.softmax(seen[0].float() @ model.layers[0].moe.router
                            .float(), -1).argmax(-1)
    cap = t_moe.capacity(cfg, experts.numel())
    half = experts.numel() // 2
    rank0 = torch.bincount(experts[:half], minlength=cfg.moe_experts)
    rank1 = torch.bincount(experts[half:], minlength=cfg.moe_experts)
    assert ((rank0 + rank1 > cap) & (rank0 < cap) & (rank1 > 0)).any(), \
        (rank0, rank1, cap)


def test_moe_refuses_beside_tp_sp_pp():
    """MoE beside tp, sp or pp raises naming item 8d (as the mesh refuses
    ep beside them), before any group is used."""
    import types

    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.parallel import expert_parallel

    model = t_tt.Transformer(pj.port_config(dict(MOE)), device="cpu")
    names = ("pp", "dp", "fsdp", "sp", "tp", "ep")
    for axis in ("tp", "sp", "pp"):
        mesh = types.SimpleNamespace(
            mesh_dim_names=names,
            shape=tuple(2 if n == axis else 1 for n in names))
        with pytest.raises(NotImplementedError, match="Queue 1 item 8d"):
            expert_parallel.parallelize(model, mesh)
