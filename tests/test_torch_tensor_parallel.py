"""Tensor-parallel `train_and_evaluate` held against the JAX package.

The port trains in processes of its own: gloo ranks on the CPU started
with `torch.multiprocessing.spawn` (2 ranks at ``MeshSpec(tp=2)``, then 4
at ``dp=2 x tp=2`` and ``fsdp=2 x tp=2``, one spawn each), every rank
calling `training.train_and_evaluate(device="cpu")`. The JAX package
trains the same experiment in this process at the same `MeshSpec` on its
virtual CPU devices, from the same flax variables with their partitioning
boxes (so GSPMD places them by `LOGICAL_RULES`), reading the same global
batches from input_fns that declare ``host_index`` and ``num_hosts``: a
port rank gets its data group's share, the one JAX process the whole
batch. The decoder runs flash attention in both packages (JAX's in
interpret mode partitions under these meshes).

Tolerance: per-step losses, eval metrics and final parameters within
1e-5 relative and 1e-6 absolute: the ranks sum partial products over tp
(and gradients over the data groups) in another order than XLA does. As
in tests/test_torch_data_parallel.py, BERT's and ViT's key biases are
left out of the parameter check: softmax cannot see them, so their
gradient is rounding noise that Adam moves by up to the learning rate in
either package.

What the module holds besides: the gradient rule (every LoRA factor and
column bias summed over tp, the norm scales not: a rank's replicated
parameters stay bitwise equal to its peer's and equal JAX's), dropout at
tp=2 (the tp replicas draw the same masks), checkpoints written once in
the one-device format and resumed across tp 1 <-> 2, the replicated
families (ResNet, mnist), and the train loop's counts (data groups, not
ranks).

This module imports JAX only inside functions: the spawned ranks import
it by name to find their program.
"""

import json
import logging
import os
import socket

import numpy as np
import pytest
import torch

STEPS = 4
RTOL, ATOL = 1e-5, 1e-6
SEQ, VOCAB, LORA = 16, 256, 4
DEC_BATCH, BERT_BATCH, IMG_BATCH, MNIST_BATCH = 4, 8, 4, 8
FEATURES, CLASSES, HIDDEN = 16, 4, (16,)
# Learning rates: the LoRA factors at 1e-3; mnist at 1e-2 and the rest of
# the full-weight runs at 2e-5 (BERT's recipe), as
# tests/test_torch_data_parallel.py trains them. Adam turns a gradient's
# last-bit noise on a near-zero element into a step of up to the learning
# rate: at 1e-3 the tiny decoder's full weights land up to 2.1e-5 apart
# between JAX's own tp=1 and tp=2 runs.
LRS = {"lora": 1e-3, "mnist": 1e-2, "resnet": 1e-2, "full": 2e-5}


def lr(job):
    if job["model"] == "decoder" and job.get("lora", LORA):
        return LRS["lora"]
    return LRS.get(job["model"], LRS["full"])


# -- the inputs, the same for both packages and every mesh ----------------


def share(batch, host_index, num_hosts):
    """Rows [i·B/n, (i+1)·B/n) of a global batch (training.py:391-424)."""
    rows = len(next(iter(batch.values()))) // num_hosts
    return {k: v[host_index * rows:(host_index + 1) * rows]
            for k, v in batch.items()}


def stream(kind, seed=0):
    """An input_fn of endless seeded global batches of `kind`."""

    def draw(rng):
        if kind == "decoder":
            return {"tokens": rng.randint(0, VOCAB, (DEC_BATCH, SEQ))
                    .astype(np.int32)}
        if kind == "bert":
            tokens = rng.randint(0, 128, (BERT_BATCH, SEQ))
            return {"x": tokens.astype(np.int32),
                    "y": (tokens[:, 0] % 2).astype(np.int32)}
        if kind == "mnist":
            x = rng.randn(MNIST_BATCH, FEATURES).astype(np.float32)
            return {"x": x, "y": (np.argmax(x[:, :CLASSES], -1)
                                  .astype(np.int32))}
        return {"x": rng.randn(IMG_BATCH, 32, 32, 3).astype(np.float32),
                "y": rng.randint(0, 10, IMG_BATCH).astype(np.int32)}

    def input_fn(start_step=0, host_index=0, num_hosts=1):
        rng = np.random.RandomState(seed)
        i = 0
        while True:
            batch = draw(rng)
            if i >= start_step:
                yield share(batch, host_index, num_hosts)
            i += 1

    return input_fn


def _params(**overrides):
    kwargs = dict(train_steps=STEPS, log_every_steps=1, eval_every_steps=2,
                  eval_steps=1, checkpoint_every_steps=2, seed=0)
    kwargs.update(overrides)
    return kwargs


# -- the port's side, in each rank ----------------------------------------


class _StepLog(logging.Handler):
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
    from tf_yarn_tpu_torch.models import resnet as t_resnet
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    state = torch.load(job["init"], weights_only=True)
    mesh = MeshSpec(**job["mesh"]) if job["mesh"] is not None else None
    kind = job["model"]
    params = _params(**job.get("params", {}))
    f32 = dict(dtype=torch.float32, fused_norms=True)
    if kind == "mnist":
        model = t_mnist.DenseClassifier(FEATURES, HIDDEN, CLASSES,
                                        device="cpu")
        model.load_state_dict(state)
        return t_experiment.TorchExperiment(
            model=model, optimizer=t_mnist.adam(lr(job)),
            loss_fn=t_common.classification_loss,
            train_input_fn=stream("mnist"), eval_input_fn=stream("mnist", 1),
            train_params=t_experiment.TrainParams(**params),
            model_dir=job["model_dir"], mesh_spec=mesh)
    if kind == "decoder":
        cfg = t_tt.TransformerConfig.tiny(
            attention_impl="flash", scan_layers=False, remat=True,
            max_seq_len=64, lora_rank=job["lora"], **f32)
        model = t_tt.Transformer(cfg, device="cpu", trainable=True)
        exp = t_tt.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=mesh,
            batch_size=DEC_BATCH, seq_len=SEQ, learning_rate=lr(job),
            input_fn=stream("decoder"),
            loss_chunk_size=job.get("chunk"), **params)
    elif kind == "bert":
        cfg = t_bert.BertConfig.tiny(dropout_rate=job.get("dropout", 0.0),
                                     **f32)
        model = t_bert.BertClassifier(cfg, device="cpu")
        exp = t_bert.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=mesh,
            batch_size=BERT_BATCH, seq_len=SEQ, learning_rate=lr(job),
            input_fn=stream("bert"), **params)
    elif kind == "vit":
        cfg = t_vit.ViTConfig.tiny(**f32)
        model = t_vit.ViT(cfg, device="cpu")
        exp = t_vit.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=mesh,
            batch_size=IMG_BATCH, learning_rate=lr(job), input_fn=stream("image"),
            **params)
    else:
        cfg = t_resnet.ResNetConfig.tiny(**f32)
        model = t_resnet.ResNet(cfg, device="cpu")
        exp = t_resnet.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=mesh,
            batch_size=IMG_BATCH, image_size=32, learning_rate=lr(job),
            input_fn=stream("image"), **params)
    model.load_state_dict(state)
    if kind == "bert":
        model.generator.manual_seed(0)
    exp.eval_input_fn = stream("decoder" if kind == "decoder" else
                               "bert" if kind == "bert" else "image", 1)
    exp.init_fn, exp.model = None, model
    loss_fn = exp.loss_fn
    local = job.setdefault("local_losses", [])

    def recording(m, batch, train=True):
        loss, aux = loss_fn(m, batch, train=train)
        if train:
            local.append(float(loss))
        return loss, aux

    exp.loss_fn = recording
    return exp


def _tp_ops():
    """{op: count} of the tp all-reduce spans this process recorded."""
    from tf_yarn_tpu_torch import telemetry

    ops = {}
    for span in telemetry.get_tracer().records():
        if span.name == "train/tp_allreduce":
            ops[span.args["op"]] = ops.get(span.args["op"], 0) + 1
    return ops


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
            telemetry.get_tracer().clear()
            exp = port_experiment(job)
            final = t_training.train_and_evaluate(
                t_experiment.as_core_experiment(exp), device="cpu")
            snapshot = telemetry.get_registry().snapshot()
            torch.save(exp.model.state_dict(), f"{job['out']}-{rank}.pt")
            with open(f"{job['out']}-{rank}.json", "w") as fh:
                json.dump({"losses": log.losses, "evals": log.evals,
                           "final": final,
                           "mesh_devices": snapshot.get("train/mesh_devices"),
                           "samples_total": snapshot.get(
                               "train/samples_total"),
                           "tp_ops": _tp_ops(),
                           "local_losses": job.get("local_losses")}, fh)
        logger.removeHandler(log)
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_port(tmp, world, jobs):
    path = os.path.join(tmp, f"jobs-{world}.json")
    with open(path, "w") as fh:
        json.dump(jobs, fh)
    torch.multiprocessing.spawn(_train_jobs, args=(world, free_port(), path),
                                nprocs=world, join=True)
    return {job["name"]: [dict(json.load(open(f"{job['out']}-{r}.json")),
                               state=torch.load(f"{job['out']}-{r}.pt"))
                          for r in range(world)] for job in jobs}


def world_one(job):
    """The port at one rank in this process."""
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training

    return t_training.train_and_evaluate(
        t_experiment.as_core_experiment(port_experiment(job)), device="cpu")


# -- the JAX side ---------------------------------------------------------


def _jax_model(kind, lora=LORA):
    import jax.numpy as jnp

    f32 = dict(dtype=jnp.float32, fused_norms=True)
    if kind == "decoder":
        from tf_yarn_tpu.models import transformer as j_tt

        cfg = j_tt.TransformerConfig.tiny(
            attention_impl="flash", scan_layers=False, remat=False,
            max_seq_len=64, lora_rank=lora, **f32)
        return j_tt, cfg, j_tt.Transformer(cfg), jnp.zeros((1, SEQ), jnp.int32)
    if kind == "bert":
        from tf_yarn_tpu.models import bert as j_bert

        cfg = j_bert.BertConfig.tiny(**f32)
        return (j_bert, cfg, j_bert.BertClassifier(cfg),
                jnp.zeros((2, SEQ), jnp.int32))
    if kind == "vit":
        from tf_yarn_tpu.models import vit as j_vit

        cfg = j_vit.ViTConfig.tiny(**f32)
        return j_vit, cfg, j_vit.ViT(cfg), jnp.zeros((2, 32, 32, 3))
    if kind == "resnet":
        from tf_yarn_tpu.models import resnet as j_resnet

        cfg = j_resnet.ResNetConfig.tiny(**f32)
        return (j_resnet, cfg, j_resnet.ResNet(cfg),
                jnp.zeros((2, 32, 32, 3)))
    from tf_yarn_tpu.models import mnist as j_mnist

    return (j_mnist, None, j_mnist.DenseClassifier(hidden_sizes=HIDDEN,
                                                   num_classes=CLASSES),
            jnp.zeros((2, FEATURES)))


def jax_variables(kind, lora=LORA):
    """The boxed flax variables (JAX places them by their boxes) — a
    LoRA decoder's lora_b nonzero, or every LoRA-A gradient is zero — and
    the port's one-device state dict of the same values."""
    import flax.linen as nn
    import jax

    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import resnet as t_resnet
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit
    from tf_yarn_tpu_torch.models import weights as t_weights

    _, _, model, example = _jax_model(kind, lora)
    boxed = model.init(jax.random.PRNGKey(0), example)
    rng = np.random.RandomState(11)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jax.numpy.asarray(
                rng.randn(*leaf.shape).astype(np.float32) * 0.05)
        return leaf

    boxed = jax.tree_util.tree_map_with_path(
        fill, boxed, is_leaf=lambda x: isinstance(x, nn.Partitioned))
    flat = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(boxed))
    f32 = dict(dtype=torch.float32, fused_norms=True)
    if kind == "decoder":
        state = t_weights.from_flax(flat, t_tt.TransformerConfig.tiny(
            lora_rank=lora, **f32))
    elif kind == "bert":
        state = t_weights.bert_from_flax(flat, t_bert.BertConfig.tiny(**f32))
    elif kind == "vit":
        state = t_weights.vit_from_flax(flat, t_vit.ViTConfig.tiny(**f32))
    elif kind == "resnet":
        state = t_weights.resnet_from_flax(flat, t_resnet.ResNetConfig.tiny(
            **f32))
    else:
        state = t_weights.mnist_from_flax(flat, HIDDEN, CLASSES,
                                          device="cpu").state_dict()
    return boxed, state


def jax_run(job, boxed):
    """JAX's train_and_evaluate of `job` at its mesh on virtual CPU
    devices: logged losses and evals, final metrics, final params by the
    port's names."""
    import optax

    from tf_yarn_tpu import checkpoint as j_ckpt
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu import training as j_training
    from tf_yarn_tpu.models import common as j_common
    from tf_yarn_tpu.parallel.mesh import MeshSpec, select_devices
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import resnet as t_resnet
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit
    from tf_yarn_tpu_torch.models import weights as t_weights

    spec = MeshSpec(**job["mesh"])
    kind = job["model"]
    params = _params()
    module, cfg, model, _ = _jax_model(kind, job.get("lora", LORA))
    if kind == "mnist":
        exp = j_experiment.JaxExperiment(
            model=model, optimizer=optax.adam(lr(job)),
            loss_fn=j_common.classification_loss,
            train_input_fn=stream("mnist"), eval_input_fn=stream("mnist", 1),
            train_params=j_experiment.TrainParams(**params),
            model_dir=job["model_dir"], mesh_spec=spec)
    elif kind == "decoder":
        exp = module.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=spec,
            batch_size=DEC_BATCH, seq_len=SEQ, learning_rate=lr(job),
            input_fn=stream("decoder"), loss_chunk_size=job.get("chunk"),
            **params)
    elif kind == "bert":
        exp = module.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=spec,
            batch_size=BERT_BATCH, seq_len=SEQ, learning_rate=lr(job),
            input_fn=stream("bert"), **params)
    elif kind == "vit":
        exp = module.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=spec,
            batch_size=IMG_BATCH, learning_rate=lr(job), input_fn=stream("image"),
            **params)
    else:
        exp = module.make_experiment(
            cfg, model_dir=job["model_dir"], mesh_spec=spec,
            batch_size=IMG_BATCH, image_size=32, learning_rate=lr(job),
            input_fn=stream("image"), **params)
    if kind != "mnist":
        exp.eval_input_fn = stream("decoder" if kind == "decoder" else
                                   "bert" if kind == "bert" else "image", 1)
    exp.init_fn = lambda rng, batch: boxed
    logger, log = capture("tf_yarn_tpu.training")
    try:
        final = j_training.train_and_evaluate(
            j_experiment.as_core_experiment(exp),
            devices=select_devices(spec.total_devices, platform="cpu"))
    finally:
        logger.removeHandler(log)
    flat = j_ckpt.restore_checkpoint_host(job["model_dir"], STEPS)["params"]
    f32 = dict(dtype=torch.float32, fused_norms=True)
    if kind == "decoder":
        bridged = t_weights.from_flax(flat, t_tt.TransformerConfig.tiny(
            lora_rank=job.get("lora", LORA), **f32))
    elif kind == "bert":
        bridged = t_weights.bert_from_flax(flat, t_bert.BertConfig.tiny(**f32))
    elif kind == "vit":
        bridged = t_weights.vit_from_flax(flat, t_vit.ViTConfig.tiny(**f32))
    elif kind == "resnet":
        bridged = t_weights.resnet_from_flax(
            flat, t_resnet.ResNetConfig.tiny(**f32))
    else:
        bridged = t_weights.mnist_from_flax(flat, HIDDEN, CLASSES,
                                            device="cpu").state_dict()
    return {"losses": log.losses, "evals": log.evals, "final": final,
            "params": bridged}


# -- the runs ---------------------------------------------------------------

TP2 = {"tp": 2}
JOBS_2 = {
    "dec_lora": dict(model="decoder", lora=LORA, mesh=TP2),
    "dec_full": dict(model="decoder", lora=0, mesh=TP2),
    "dec_chunked": dict(model="decoder", lora=LORA, mesh=TP2, chunk=96),
    "bert": dict(model="bert", mesh=TP2),
    "vit": dict(model="vit", mesh=TP2),
    "mnist": dict(model="mnist", mesh=TP2),
    "resnet": dict(model="resnet", mesh=TP2),
    # Two steps and a resume, both at tp=2: the uninterrupted dec_lora.
    "resume_a": dict(model="decoder", lora=LORA, mesh=TP2,
                     params={"train_steps": 2}),
    "resume_b": dict(model="decoder", lora=LORA, mesh=TP2),
    # ckpt-2 written at one rank (this process), resumed at tp=2.
    "from_tp1": dict(model="decoder", lora=LORA, mesh=TP2),
    "mnist_from_tp1": dict(model="mnist", mesh=TP2),
    # Two steps at tp=2, resumed at one rank after.
    "to_tp1": dict(model="decoder", lora=LORA, mesh=TP2,
                   params={"train_steps": 2}),
    "mnist_to_tp1": dict(model="mnist", mesh=TP2, params={"train_steps": 2}),
    "dropout": dict(model="bert", mesh=TP2, dropout=0.1),
}
JOBS_4 = {
    "dp2_dec_lora": dict(model="decoder", lora=LORA,
                         mesh={"dp": 2, "tp": 2}),
    "dp2_bert": dict(model="bert", mesh={"dp": 2, "tp": 2}),
    # The chunked loss under DDP with a trained head: the loss runs inside
    # the wrapped forward, so DDP sees the head read.
    "dp2_dec_chunked_full": dict(model="decoder", lora=0,
                                 mesh={"dp": 2, "tp": 2}, chunk=96),
    "fsdp2_dec_full": dict(model="decoder", lora=0,
                           mesh={"fsdp": 2, "tp": 2}),
    "fsdp2_mnist": dict(model="mnist", mesh={"fsdp": 2, "tp": 2}),
}
AGAINST_JAX = ["dec_lora", "dec_full", "dec_chunked", "bert", "vit", "mnist",
               "resnet", "dp2_dec_lora", "dp2_bert", "dp2_dec_chunked_full",
               "fsdp2_dec_full", "fsdp2_mnist"]


def _variant(job):
    return (job["model"], job.get("lora", LORA))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    all_jobs = {**JOBS_2, **JOBS_4}
    variants = {_variant(job) for job in all_jobs.values()}
    boxed, inits = {}, {}
    for kind, lora in sorted(variants):
        boxed[(kind, lora)], state = jax_variables(kind, lora)
        inits[(kind, lora)] = os.path.join(tmp, f"init-{kind}-{lora}.pt")
        torch.save(state, inits[(kind, lora)])

    def job(name, spec):
        return dict(spec, name=name, init=inits[_variant(spec)],
                    model_dir=os.path.join(tmp, f"port-{name}"),
                    out=os.path.join(tmp, f"out-{name}"))

    jobs2 = [job(n, s) for n, s in JOBS_2.items()]
    by_name = {j["name"]: j for j in jobs2}
    by_name["resume_a"]["model_dir"] = by_name["resume_b"]["model_dir"]
    jobs2.remove(by_name["resume_b"])
    jobs2.append(by_name["resume_b"])
    for name in ("from_tp1", "mnist_from_tp1"):
        world_one(dict(by_name[name], mesh=None, params={"train_steps": 2}))
    port = run_port(tmp, 2, jobs2)
    for name in ("to_tp1", "mnist_to_tp1"):
        world_one(dict(by_name[name], mesh=None, params={}))
    # The uninterrupted one-rank run of mnist, for the replicated family's
    # bitwise resumes.
    one = job("mnist_one", dict(model="mnist", mesh=None))
    world_one(one)
    jobs4 = [job(n, s) for n, s in JOBS_4.items()]
    port.update(run_port(tmp, 4, jobs4))
    ref = {}
    for name in AGAINST_JAX:
        spec = all_jobs[name]
        ref[name] = jax_run(dict(spec, model_dir=os.path.join(
            tmp, f"jax-{name}")), boxed[_variant(spec)])
    dirs = {j["name"]: j["model_dir"] for j in jobs2 + jobs4 + [one]}
    return {"port": port, "jax": ref, "dirs": dirs}


def assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def port_params(model_dir, step=STEPS):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    return t_ckpt.restore_checkpoint(model_dir, step, "cpu")["params"]


def assert_params_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in got:
        if name.endswith("wk.bias"):
            continue
        assert_close(got[name].numpy(), want[name].numpy(), f"{what} {name}")


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_tensor_parallel_run_matches_jax(runs, name):
    ranks, ref = runs["port"][name], runs["jax"][name]
    steps = [str(s) for s in range(1, STEPS + 1)]
    for rank in ranks:
        # The logged losses are the global batch's, on every rank.
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
        assert_close([rank["final"][k] for k in sorted(rank["final"])],
                     [float(ref["final"][k]) for k in sorted(ref["final"])],
                     f"{name} final metrics")
        assert rank["mesh_devices"] == len(ranks)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert_params_close(port_params(runs["dirs"][name]), ref["params"], name)


@pytest.mark.parametrize("name", ["dec_lora", "dec_full", "bert", "vit",
                                  "dropout"])
def test_tp_replicas_keep_replicated_parameters_bitwise_equal(runs, name):
    """The gradient rule: every parameter a rank holds whole (LoRA
    factors, biases, norm scales, kv projections, BERT's pooler, ...) is
    bitwise its peer's after training; the sharded ones are each rank's
    own slice of the checkpoint."""
    ranks = runs["port"][name]
    full = port_params(runs["dirs"][name])
    for rank_index, rank in enumerate(ranks):
        for param, value in rank["state"].items():
            if value.shape == full[param].shape:
                assert torch.equal(value, ranks[0]["state"][param]), param
                assert torch.equal(value, full[param]), param
            else:
                dim = next(d for d in range(value.dim())
                           if value.shape[d] != full[param].shape[d])
                assert torch.equal(value, full[param].chunk(2, dim)[
                    rank_index]), param


def test_lora_factors_and_column_biases_move_and_norm_scales_match_jax(runs):
    """A LoRA fine-tune trains only the factors, all replicated and all
    with tp-partial gradients: each one moved and equals JAX's. The full
    run's column biases and norm scales (BERT) equal JAX's too."""
    got = port_params(runs["dirs"]["dec_lora"])
    init = torch.load(os.path.join(os.path.dirname(runs["dirs"]["dec_lora"]),
                                   f"init-decoder-{LORA}.pt"))
    want = runs["jax"]["dec_lora"]["params"]
    lora = [n for n in got if "lora_" in n]
    assert len(lora) == 2 * 7 * 2
    for name in got:
        moved = not torch.equal(got[name], init[name])
        assert moved == (name in lora), name
    bert = port_params(runs["dirs"]["bert"])
    jax_bert = runs["jax"]["bert"]["params"]
    for name in bert:
        if name.endswith(("wq.bias", "ffn_in.bias", "wv.bias", "norm.scale",
                          "norm.bias")):
            assert_close(bert[name].numpy(), jax_bert[name].numpy(), name)


def test_dropout_at_tp2_draws_one_mask_per_data_group(runs):
    ranks = runs["port"]["dropout"]
    local = [r["local_losses"] for r in ranks]
    # The tp replicas' activations are replicated: the same masks, the
    # same loss at every step.
    assert len(local[0]) == STEPS and local[0] == local[1]
    no_dropout = runs["port"]["bert"][0]["local_losses"]
    assert local[0] != no_dropout


@pytest.mark.parametrize("name", ["dec_lora", "bert", "dp2_dec_lora",
                                  "fsdp2_dec_full"])
def test_checkpoints_are_written_once_in_the_one_device_format(runs, name):
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    model_dir = runs["dirs"][name]
    assert [d for d in sorted(os.listdir(model_dir)) if d != "tb"] == [
        "ckpt-2", "ckpt-4"]
    for step in (2, 4):
        t_ckpt.verify_checkpoint(t_ckpt.checkpoint_path(model_dir, step))
    state = t_ckpt.restore_checkpoint(model_dir, STEPS, "cpu")
    one_device = torch.load(os.path.join(
        os.path.dirname(model_dir),
        f"init-{'-'.join(map(str, _variant({**JOBS_2, **JOBS_4}[name])))}"
        ".pt"))
    assert {n: v.shape for n, v in state["params"].items()} == {
        n: v.shape for n, v in one_device.items()}
    # Adam's moments in their parameters' one-device shapes, keyed by
    # parameter index.
    moments = state["optimizer"]["state"]
    trained = [v for n, v in one_device.items() if "lora_" in n] or list(
        one_device.values())
    assert sorted(moments) == list(range(len(trained)))
    assert sorted(tuple(m["exp_avg"].shape) for m in moments.values()) == \
        sorted(tuple(v.shape) for v in trained)
    assert state["step"] == STEPS


def test_resume_at_tp2_is_bitwise_the_uninterrupted_run(runs):
    straight = port_params(runs["dirs"]["dec_lora"])
    resumed = port_params(runs["dirs"]["resume_b"])
    for name in straight:
        assert torch.equal(straight[name], resumed[name]), name
    assert runs["port"]["resume_b"][0]["local_losses"] == \
        runs["port"]["dec_lora"][0]["local_losses"][2:]


@pytest.mark.parametrize("name", ["from_tp1", "to_tp1"])
def test_decoder_resumes_across_tp(runs, name):
    """tp 1 -> 2 and 2 -> 1: the one-device checkpoint loads at either,
    and the resumed run stays within 1e-5 of the uninterrupted tp=2 run
    and of JAX's (the K split regroups f32 sums)."""
    got = port_params(runs["dirs"][name])
    assert_params_close(got, port_params(runs["dirs"]["dec_lora"]), name)
    assert_params_close(got, runs["jax"]["dec_lora"]["params"],
                        f"{name} against JAX")


@pytest.mark.parametrize("name", ["mnist_from_tp1", "mnist_to_tp1"])
def test_replicated_family_resumes_across_tp_bitwise(runs, name):
    """mnist has no tp placement: every rank trains the whole model on
    its data group's rows, so tp=2 is one device's arithmetic and a
    resume across tp 1 <-> 2 is bitwise the uninterrupted run."""
    straight = port_params(runs["dirs"]["mnist_one"])
    got = port_params(runs["dirs"][name])
    for param in straight:
        assert torch.equal(straight[param], got[param]), param
    assert port_params(runs["dirs"]["mnist"]).keys() == straight.keys()
    for param, value in port_params(runs["dirs"]["mnist"]).items():
        assert torch.equal(value, straight[param]), param


@pytest.mark.parametrize("name", ["dec_lora", "dp2_dec_lora", "fsdp2_mnist",
                                  "resnet"])
def test_counts_are_the_global_batch_once(runs, name):
    """Samples count each data group's share once (× dp·fsdp, not ×
    world); the one global batch a step."""
    batch = {"decoder": DEC_BATCH, "mnist": MNIST_BATCH,
             "resnet": IMG_BATCH}[{**JOBS_2, **JOBS_4}[name]["model"]]
    for rank in runs["port"][name]:
        assert rank["samples_total"] == STEPS * batch


@pytest.mark.parametrize("name,want", [
    ("dec_lora", {"embed", "reduce_out", "reduce_lora", "gather", "copy_in",
                  "grad_slice", "grad_lora_a"}),
    ("dec_full", {"embed", "reduce_out", "gather", "copy_in", "grad_slice"}),
    ("bert", {"embed", "reduce_out", "copy_in", "grad_slice"}),
    ("vit", {"reduce_out", "copy_in", "grad_slice"}),
    ("mnist", set()), ("resnet", set())])
def test_tp_collectives_by_family(runs, name, want):
    """Which tp all-reduces each family's step runs (spans
    `train/tp_allreduce` by op); the replicated families run none."""
    for rank in runs["port"][name]:
        assert set(rank["tp_ops"]) == want
