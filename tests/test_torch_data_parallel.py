"""Data-parallel `train_and_evaluate` held against the JAX package.

The port trains in processes of its own: gloo ranks on the CPU, started
with `torch.multiprocessing.spawn` (2 ranks, then 4), each calling
`training.train_and_evaluate(device="cpu")` in its process group. The
JAX package trains the same experiment in this process with the same
`MeshSpec` over its virtual CPU devices (tests/conftest.py). Both read
the same global batches from one input_fn that declares ``host_index``
and ``num_hosts``: a port rank gets its contiguous share, the one JAX
process the whole batch. Both start from the same flax variables
(`models/weights.*_from_flax` into the port).

Tolerance: per-step losses, eval metrics and final parameters within
1e-5 (relative, and 1e-6 absolute for values near zero): the ranks'
gradients are averaged in another order than JAX sums the global batch,
and Adam turns that into f32 drift of ~1e-7. BERT's key biases are left
out of the parameter check: softmax cannot see them, so their gradient
is rounding noise that Adam moves by up to the learning rate in either
package (tests/test_torch_zoo.py).

This module imports JAX only inside functions: the spawned ranks import
it by name to find their program, and they run the port alone.
"""

import json
import logging
import os
import socket

import numpy as np
import pytest
import torch

FEATURES, CLASSES, HIDDEN = 16, 4, (16,)
GLOBAL_BATCH = 8
STEPS = 4
RTOL, ATOL = 1e-5, 1e-6
BERT_SHAPE = dict(batch_size=8, seq_len=16)


# -- the inputs, the same for both packages and every world size ----------


def share(batch, host_index, num_hosts):
    """Rows [i·B/n, (i+1)·B/n) of a global batch (training.py:391-424)."""
    rows = len(next(iter(batch.values()))) // num_hosts
    return {k: v[host_index * rows:(host_index + 1) * rows]
            for k, v in batch.items()}


def mnist_input_fn(seed=0):
    from tf_yarn_tpu_torch.models import common

    def input_fn(start_step=0, host_index=0, num_hosts=1):
        stream = common.synthetic_classification_iter(
            GLOBAL_BATCH, FEATURES, CLASSES, seed=seed)
        for i, batch in enumerate(stream):
            if i >= start_step:
                yield share(batch, host_index, num_hosts)

    return input_fn


def bert_input_fn(vocab, classes, seed=0, shared=True):
    def input_fn(start_step=0, host_index=0, num_hosts=1):
        rng = np.random.RandomState(seed)
        i = 0
        while True:
            tokens = rng.randint(0, vocab, (BERT_SHAPE["batch_size"],
                                            BERT_SHAPE["seq_len"]))
            batch = {"x": tokens.astype(np.int32),
                     "y": (tokens[:, 0] % classes).astype(np.int32)}
            if i >= start_step:
                yield share(batch, host_index, num_hosts) if shared else batch
            i += 1

    if not shared:
        # Every rank reads the whole batch: the dropout check.
        return lambda start_step=0: input_fn(start_step)
    return input_fn


def train_params(module, **overrides):
    kwargs = dict(train_steps=STEPS, log_every_steps=1, eval_every_steps=2,
                  eval_steps=2, checkpoint_every_steps=2, seed=0)
    kwargs.update(overrides)
    return module.TrainParams(**kwargs)


# -- the port's side, in each rank ----------------------------------------


class _StepLog(logging.Handler):
    """(step, loss) of each "step N: loss=..." line and the eval dicts of
    each "eval @ step N" line a train loop logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses, self.evals = {}, {}

    def emit(self, record):
        if record.msg.startswith("step %d: loss=%s"):
            self.losses[int(record.args[0])] = float(record.args[1])
        elif record.msg.startswith("eval @ step %d"):
            self.evals[int(record.args[0])] = dict(record.args[1])


def capture(logger_name):
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    handler = _StepLog()
    logger.addHandler(handler)
    return logger, handler


def port_experiment(job):
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import common as t_common
    from tf_yarn_tpu_torch.models import mnist as t_mnist
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    state = torch.load(job["init"], weights_only=True)
    overrides = job.get("params", {})
    mesh = MeshSpec(**job["mesh"]) if job["mesh"] is not None else None
    if job["model"] == "mnist":
        model = t_mnist.DenseClassifier(FEATURES, HIDDEN, CLASSES,
                                        device="cpu")
        model.load_state_dict(state)
        return t_experiment.TorchExperiment(
            model=model, optimizer=t_mnist.adam(1e-2),
            loss_fn=t_common.classification_loss,
            train_input_fn=mnist_input_fn(),
            eval_input_fn=mnist_input_fn(seed=1),
            train_params=train_params(t_experiment, **overrides),
            model_dir=job["model_dir"], mesh_spec=mesh)
    cfg = t_bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True,
                                 dropout_rate=job.get("dropout", 0.0))
    model = t_bert.BertClassifier(cfg, device="cpu")
    model.load_state_dict(state)
    shared = job.get("shared", True)
    exp = t_bert.make_experiment(
        cfg, model_dir=job["model_dir"], mesh_spec=mesh,
        input_fn=bert_input_fn(cfg.vocab_size, cfg.num_classes, shared=shared),
        **BERT_SHAPE, **dict(dict(log_every_steps=1, eval_every_steps=2,
                                  eval_steps=2, checkpoint_every_steps=2,
                                  train_steps=STEPS), **overrides))
    exp.eval_input_fn = bert_input_fn(cfg.vocab_size, cfg.num_classes, seed=1)
    exp.init_fn, exp.model = None, model
    if not shared:
        # Each rank's own loss at each step, before the ranks' mean.
        loss_fn = exp.loss_fn
        local = job.setdefault("local_losses", [])

        def recording(m, batch, train=True):
            loss, aux = loss_fn(m, batch, train=train)
            if train:
                local.append(float(loss))
            return loss, aux

        exp.loss_fn = recording
    return exp


def _train_jobs(rank, world, port, jobs_path):
    import torch.distributed as dist

    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import telemetry
    from tf_yarn_tpu_torch import training as t_training

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(jobs_path) as fh:
            jobs = json.load(fh)
        logger, log = capture("tf_yarn_tpu_torch.training")
        for job in jobs:
            log.losses, log.evals = {}, {}
            telemetry.get_registry().clear()
            exp = port_experiment(job)
            final = t_training.train_and_evaluate(
                t_experiment.as_core_experiment(exp), device="cpu")
            gauges = telemetry.get_registry().snapshot()
            with open(f"{job['out']}-{rank}.json", "w") as fh:
                json.dump({"losses": log.losses, "evals": log.evals,
                           "final": final,
                           "mesh_devices": gauges.get("train/mesh_devices"),
                           "local_losses": job.get("local_losses")}, fh)
        logger.removeHandler(log)
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(program, world, *args):
    torch.multiprocessing.spawn(program, args=(world, free_port(), *args),
                                nprocs=world, join=True)


def run_port(tmp, world, jobs):
    path = os.path.join(tmp, f"jobs-{world}.json")
    with open(path, "w") as fh:
        json.dump(jobs, fh)
    spawn(_train_jobs, world, path)
    return {job["name"]: [json.load(open(f"{job['out']}-{r}.json"))
                          for r in range(world)] for job in jobs}


# -- the JAX side and the fixtures ----------------------------------------


def jax_variables(kind):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    if kind == "mnist":
        from tf_yarn_tpu.models import mnist as j_mnist

        model = j_mnist.DenseClassifier(hidden_sizes=HIDDEN,
                                        num_classes=CLASSES)
        example = jnp.zeros((GLOBAL_BATCH, FEATURES), jnp.float32)
    else:
        from tf_yarn_tpu.models import bert as j_bert

        model = j_bert.BertClassifier(j_bert.BertConfig.tiny(
            dtype=jnp.float32, fused_norms=True))
        example = jnp.zeros((BERT_SHAPE["batch_size"], BERT_SHAPE["seq_len"]),
                            jnp.int32)
    variables = nn.meta.unbox(model.init(jax.random.PRNGKey(0), example))
    return jax.tree_util.tree_map(np.asarray, variables)


def jax_run(job, variables):
    """JAX's train_and_evaluate of `job` on len(mesh) virtual CPU devices:
    logged losses and evals, final metrics, final params (by the port's
    names)."""
    import optax

    from tf_yarn_tpu import checkpoint as j_ckpt
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu import training as j_training
    from tf_yarn_tpu.models import common as j_common
    from tf_yarn_tpu.models import mnist as j_mnist
    from tf_yarn_tpu.parallel.mesh import MeshSpec, select_devices
    from tf_yarn_tpu_torch.models import weights as t_weights

    spec = MeshSpec(**job["mesh"])
    overrides = job.get("params", {})
    if job["model"] == "mnist":
        exp = j_experiment.JaxExperiment(
            model=j_mnist.DenseClassifier(hidden_sizes=HIDDEN,
                                          num_classes=CLASSES),
            optimizer=optax.adam(1e-2), loss_fn=j_common.classification_loss,
            train_input_fn=mnist_input_fn(),
            eval_input_fn=mnist_input_fn(seed=1),
            train_params=train_params(j_experiment, **overrides),
            model_dir=job["model_dir"], mesh_spec=spec)
    else:
        import jax.numpy as jnp

        from tf_yarn_tpu.models import bert as j_bert

        cfg = j_bert.BertConfig.tiny(dtype=jnp.float32, fused_norms=True)
        exp = j_bert.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=spec,
            input_fn=bert_input_fn(cfg.vocab_size, cfg.num_classes),
            **BERT_SHAPE, log_every_steps=1, eval_every_steps=2,
            eval_steps=2, checkpoint_every_steps=2, train_steps=STEPS)
        exp.eval_input_fn = bert_input_fn(cfg.vocab_size, cfg.num_classes,
                                          seed=1)
    exp.init_fn = lambda rng, batch: variables
    logger, log = capture("tf_yarn_tpu.training")
    try:
        final = j_training.train_and_evaluate(
            j_experiment.as_core_experiment(exp),
            devices=select_devices(spec.total_devices, platform="cpu"))
    finally:
        logger.removeHandler(log)
    params = j_ckpt.restore_checkpoint_host(job["model_dir"], STEPS)["params"]
    if job["model"] == "mnist":
        model = t_weights.mnist_from_flax(params, HIDDEN, CLASSES,
                                          device="cpu")
        bridged = model.state_dict()
    else:
        from tf_yarn_tpu_torch.models import bert as t_bert

        bridged = t_weights.bert_from_flax(params, t_bert.BertConfig.tiny(
            dtype=torch.float32, fused_norms=True))
    return {"losses": log.losses, "evals": log.evals, "final": final,
            "params": bridged}


def port_params(model_dir, step=STEPS):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    return t_ckpt.restore_checkpoint(model_dir, step, "cpu")["params"]


def world_one(job):
    """The port at one rank in this process."""
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training

    return t_training.train_and_evaluate(
        t_experiment.as_core_experiment(port_experiment(job)),
        device="cpu")


JOBS_2 = {
    "dp2": dict(model="mnist", mesh={"dp": 2}),
    # No mesh_spec: MeshSpec.auto(2), all on fsdp, as in JAX.
    "fsdp2": dict(model="mnist", mesh=None),
    "dp2_accum": dict(model="mnist", mesh={"dp": 2},
                      params={"grad_accum_steps": 2}),
    "bert_fsdp2": dict(model="bert", mesh={"fsdp": 2}),
    # ckpt-2 written at one rank (this process), resumed at two, under DDP
    # and under FSDP2 (the optimizer's state keyed by index, then by name).
    "from_world_1": dict(model="mnist", mesh={"dp": 2}),
    "fsdp_from_world_1": dict(model="mnist", mesh={"fsdp": 2}),
    # Two steps at two ranks, resumed at one rank after.
    "to_world_1": dict(model="mnist", mesh={"dp": 2},
                       params={"train_steps": 2}),
    # Dropout 0.1, every rank reading the whole batch: straight, and in
    # two runs of two steps (the second resumes).
    "dropout": dict(model="bert", mesh={"dp": 2}, dropout=0.1, shared=False),
    "dropout_a": dict(model="bert", mesh={"dp": 2}, dropout=0.1, shared=False,
                      params={"train_steps": 2}),
    "dropout_b": dict(model="bert", mesh={"dp": 2}, dropout=0.1, shared=False),
}
JAX_MESH = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}, "dp2_accum": {"dp": 2},
            "bert_fsdp2": {"fsdp": 2}, "dp2_fsdp2": {"dp": 2, "fsdp": 2}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data_parallel"))
    variables = {kind: jax_variables(kind) for kind in ("mnist", "bert")}
    inits = {}
    for kind in variables:
        from tf_yarn_tpu_torch.models import bert as t_bert
        from tf_yarn_tpu_torch.models import weights as t_weights

        state = (t_weights.mnist_from_flax(variables[kind], HIDDEN, CLASSES,
                                           device="cpu").state_dict()
                 if kind == "mnist" else t_weights.bert_from_flax(
                     variables[kind], t_bert.BertConfig.tiny(
                         dtype=torch.float32, fused_norms=True)))
        inits[kind] = os.path.join(tmp, f"init-{kind}.pt")
        torch.save(state, inits[kind])

    def job(name, spec, world):
        return dict(spec, name=name, init=inits[spec["model"]],
                    model_dir=os.path.join(tmp, f"port-{name}"),
                    out=os.path.join(tmp, f"out-{name}"))

    jobs2 = [job(name, spec, 2) for name, spec in JOBS_2.items()]
    by_name = {j["name"]: j for j in jobs2}
    # The world-1 half of from_world_1, the world-2 half of the dropout
    # pair (its model_dir is dropout_b's).
    for name in ("from_world_1", "fsdp_from_world_1"):
        world_one(dict(by_name[name], mesh=None, params={"train_steps": 2}))
    by_name["dropout_a"]["model_dir"] = by_name["dropout_b"]["model_dir"]
    jobs2.remove(by_name["dropout_b"])
    jobs2.append(by_name["dropout_b"])
    port = run_port(tmp, 2, jobs2)
    world_one(dict(by_name["to_world_1"], mesh=None, params={}))
    jobs4 = [job("dp2_fsdp2", dict(model="mnist", mesh={"dp": 2, "fsdp": 2}),
                 4)]
    port.update(run_port(tmp, 4, jobs4))
    ref = {}
    for name, mesh in JAX_MESH.items():
        spec = dict(JOBS_2.get(name, {"model": "mnist"}), mesh=mesh)
        ref[name] = jax_run(dict(spec, model_dir=os.path.join(tmp, f"jax-{name}")),
                            variables[spec["model"]])
    dirs = {j["name"]: j["model_dir"] for j in jobs2 + jobs4}
    return {"port": port, "jax": ref, "dirs": dirs}


def assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def assert_params_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in got:
        if name.endswith("wk.bias"):
            continue
        assert_close(got[name].numpy(), want[name].numpy(), f"{what} {name}")


@pytest.mark.parametrize("name", ["dp2", "fsdp2", "dp2_accum", "bert_fsdp2",
                                  "dp2_fsdp2"])
def test_data_parallel_run_matches_jax(runs, name):
    ranks, ref = runs["port"][name], runs["jax"][name]
    steps = [str(s) for s in range(1, STEPS + 1)]
    for rank in ranks:
        # The logged losses are the ranks' mean: the global batch's.
        assert sorted(rank["losses"]) == steps
        assert_close([rank["losses"][s] for s in steps],
                     [ref["losses"][int(s)] for s in steps], f"{name} losses")
        assert sorted(rank["evals"]) == ["2", "4"]
        for step, metrics in rank["evals"].items():
            want = ref["evals"][int(step)]
            assert sorted(metrics) == sorted(want)
            assert_close([metrics[k] for k in sorted(metrics)],
                         [float(want[k]) for k in sorted(want)],
                         f"{name} eval @ {step}")
        assert sorted(rank["final"]) == sorted(ref["final"])
        assert_close([rank["final"][k] for k in sorted(rank["final"])],
                     [float(ref["final"][k]) for k in sorted(ref["final"])],
                     f"{name} final metrics")
        assert rank["mesh_devices"] == len(ranks)
    # Every rank reports the same numbers.
    assert all(r == ranks[0] for r in ranks)
    assert_params_close(port_params(runs["dirs"][name]), ref["params"], name)


@pytest.mark.parametrize("name", ["dp2", "bert_fsdp2", "dp2_fsdp2"])
def test_checkpoints_are_written_once_in_the_one_device_format(runs, name):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    model_dir = runs["dirs"][name]
    assert sorted(os.listdir(model_dir)) == ["ckpt-2", "ckpt-4"] + (
        ["tb"] if os.path.isdir(os.path.join(model_dir, "tb")) else [])
    for step in (2, 4):
        path = t_ckpt.checkpoint_path(model_dir, step)
        assert sorted(os.listdir(path)) == ["MANIFEST.json", "optimizer.pt",
                                            "params.pt", "step.json"]
        t_ckpt.verify_checkpoint(path)
    state = t_ckpt.restore_checkpoint(model_dir, 4, "cpu")
    # Optimizer state keyed by parameter index, as one device keys it.
    assert sorted(state["optimizer"]["state"]) == list(
        range(len(state["params"])))
    assert state["step"] == 4


@pytest.mark.parametrize("name", ["from_world_1", "fsdp_from_world_1",
                                  "to_world_1"])
def test_a_checkpoint_resumes_across_world_sizes(runs, name):
    # The uninterrupted run is dp2's: the same experiment at two ranks.
    assert_params_close(port_params(runs["dirs"][name]),
                        port_params(runs["dirs"]["dp2"]), name)
    assert_params_close(port_params(runs["dirs"][name]),
                        runs["jax"]["dp2"]["params"], f"{name} against JAX")


def test_dp_dropout_differs_across_ranks_and_resumes_bitwise(runs):
    ranks = runs["port"]["dropout"]
    # Both ranks read the same whole batch: with the rank in the seed
    # their masks, and so their losses, differ at every step.
    local = [r["local_losses"] for r in ranks]
    assert len(local[0]) == len(local[1]) == STEPS
    assert all(a != b for a, b in zip(*local))
    straight = port_params(runs["dirs"]["dropout"])
    resumed = port_params(runs["dirs"]["dropout_b"])
    for name in straight:
        assert torch.equal(straight[name], resumed[name]), name
    # The resumed run's steps 3-4 drew the straight run's masks.
    assert runs["port"]["dropout_b"][0]["local_losses"] == local[0][2:]
