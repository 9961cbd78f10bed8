"""Shared harness of tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline.py: one training job, run by the port in
spawned gloo ranks and by the JAX package on its virtual CPU devices at
the same `MeshSpec`, from the same flax variables and the same seeded
global batches.

A job is a dict: ``model`` ("decoder", "bert" or "vit"), ``mesh`` (the
MeshSpec's fields, None for one rank), ``impl`` (the attention
backend), ``lora`` (the decoder's rank), and optionally ``chunk`` (the
chunked loss), ``mask`` (a decoder batch with a padding mask),
``gpipe`` (``gpipe_microbatches``), ``batch``, ``steps`` and
``checkpoint``; an MoE decoder takes ``moe`` (experts) and ``cf`` (its
capacity factor), any decoder ``optimizer`` (``"adafactor"``), ``scan``
(``scan_layers``, the layout adafactor's leaves follow) and ``wide``
(d_model 128 and d_ff 256, so adafactor factors its leaves). The JAX
side runs its norms unfused (its fused RMSNorm
has no sequence-sharded rule) and its flash kernels in interpret mode;
the port's plain versions give the same numbers either way.

This module imports JAX only inside functions: the spawned ranks import
it by name.
"""

import json
import logging
import os
import socket

import numpy as np
import torch

SEQ, VOCAB, LORA = 16, 256, 4
IMAGE = 24  # 9 patches and the CLS token: 10 positions, which sp=2 splits
CLASSES = 10
# Learning rates: the LoRA factors at 1e-3, full weights at 2e-5 (Adam
# turns a gradient's last-bit noise on a near-zero element into a step of
# up to the learning rate; tests/test_torch_tensor_parallel.py).
LR_LORA, LR_FULL = 1e-3, 2e-5
# Adafactor's step is relative to each leaf's RMS (and has no Adam-like
# sign step on a near-zero gradient): 1e-2 moves every leaf by ~1e-2 of
# its scale, well past the comparisons' tolerances.
LR_ADAFACTOR = 1e-2


def lr(job):
    if job.get("optimizer") == "adafactor":
        return LR_ADAFACTOR
    return LR_LORA if job["model"] == "decoder" and job.get("lora") else \
        LR_FULL


def batch_size(job):
    return job.get("batch", 4)


def share(batch, host_index, num_hosts):
    """Rows [i·B/n, (i+1)·B/n) of a global batch (training.py:391-424)."""
    rows = len(next(iter(batch.values()))) // num_hosts
    return {k: v[host_index * rows:(host_index + 1) * rows]
            for k, v in batch.items()}


def stream(job, seed=0):
    """An input_fn of endless seeded global batches of `job`."""
    kind, size = job["model"], batch_size(job)

    def draw(rng):
        if kind == "decoder":
            out = {"tokens": rng.randint(0, VOCAB, (size, SEQ))
                   .astype(np.int32)}
            if job.get("mask"):
                lengths = rng.randint(SEQ // 2, SEQ + 1, size)
                out["mask"] = (np.arange(SEQ)[None] < lengths[:, None]) \
                    .astype(np.int32)
            return out
        if kind == "bert":
            tokens = rng.randint(0, 128, (size, SEQ))
            return {"x": tokens.astype(np.int32),
                    "y": (tokens[:, 0] % 2).astype(np.int32)}
        return {"x": rng.randn(size, IMAGE, IMAGE, 3).astype(np.float32),
                "y": rng.randint(0, CLASSES, size).astype(np.int32)}

    def input_fn(start_step=0, host_index=0, num_hosts=1):
        rng = np.random.RandomState(seed)
        i = 0
        while True:
            batch = draw(rng)
            if i >= start_step:
                yield share(batch, host_index, num_hosts)
            i += 1

    return input_fn


def train_params(job):
    steps = job.get("steps", 3)
    return dict(train_steps=steps, log_every_steps=1,
                checkpoint_every_steps=job.get("checkpoint", steps), seed=0)


# -- the port's side ---------------------------------------------------------


class StepLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses, self.mesh = {}, None

    def emit(self, record):
        if record.msg.startswith("step %d: loss=%s"):
            self.losses[int(record.args[0])] = float(record.args[1])
        elif record.msg.startswith("mesh %s over %d ranks"):
            self.mesh = dict(record.args[0])


def capture(logger_name):
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    handler = StepLog()
    logger.addHandler(handler)
    return logger, handler


def port_config(job):
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit

    f32 = dict(dtype=torch.float32, attention_impl=job.get("impl", "xla"))
    if job["model"] == "decoder":
        return t_tt.TransformerConfig.tiny(
            remat=True, max_seq_len=64, lora_rank=job.get("lora", LORA),
            gpipe_microbatches=job.get("gpipe", 0), **decoder_knobs(job),
            **f32)
    if job["model"] == "bert":
        return t_bert.BertConfig.tiny(**f32)
    return t_vit.ViTConfig.tiny(image_size=IMAGE, **f32)


def decoder_knobs(job):
    """The decoder fields a job sets beside the tiny config, alike in
    both packages."""
    knobs = dict(scan_layers=bool(job.get("gpipe")) or job.get("scan", False),
                 moe_experts=job.get("moe", 0),
                 moe_capacity_factor=job.get("cf", 1.25))
    if job.get("wide"):
        knobs.update(d_model=128, d_ff=256)
    return knobs


def port_experiment(job):
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    cfg = port_config(job)
    mesh = MeshSpec(**job["mesh"]) if job.get("mesh") else None
    common = dict(model_dir=job["model_dir"], mesh_spec=mesh,
                  learning_rate=lr(job), input_fn=stream(job),
                  **train_params(job))
    if job["model"] == "decoder":
        model = t_tt.Transformer(cfg, device="cpu", trainable=True)
        exp = t_tt.make_experiment(cfg, batch_size=batch_size(job),
                                   seq_len=SEQ, loss_chunk_size=job.get("chunk"),
                                   optimizer=job.get("optimizer"), **common)
    elif job["model"] == "bert":
        model = t_bert.BertClassifier(cfg, device="cpu")
        exp = t_bert.make_experiment(cfg, batch_size=batch_size(job),
                                     seq_len=SEQ, **common)
    else:
        model = t_vit.ViT(cfg, device="cpu")
        exp = t_vit.make_experiment(cfg, batch_size=batch_size(job), **common)
    model.load_state_dict(torch.load(job["init"], weights_only=True))
    exp.init_fn, exp.model = None, model
    return exp


def _spans():
    """{span name: {op: count}} of the parallel spans this process
    recorded, and the histograms' names."""
    from tf_yarn_tpu_torch import telemetry

    out = {}
    for span in telemetry.get_tracer().records():
        if span.name in ("train/sp_collective", "train/pp_send",
                         "train/grad_allreduce", "train/ep_allreduce",
                         "train/adafactor_allreduce"):
            key = span.args.get("op", span.args.get("axis", ""))
            ops = out.setdefault(span.name, {})
            ops[key] = ops.get(key, 0) + 1
    return out


def _train_jobs(rank, world, port, jobs_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

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
            log.losses, log.mesh = {}, None
            telemetry.get_registry().clear()
            telemetry.get_tracer().clear()
            exp = port_experiment(job)
            t_training.train_and_evaluate(
                t_experiment.as_core_experiment(exp), device="cpu")
            snapshot = telemetry.get_registry().snapshot()
            # FSDP2's parameters: the rank's shards.
            torch.save({key: value.to_local() if isinstance(value, DTensor)
                        else value
                        for key, value in exp.model.state_dict().items()},
                       f"{job['out']}-{rank}.pt")
            with open(f"{job['out']}-{rank}.json", "w") as fh:
                json.dump({"losses": log.losses, "mesh": log.mesh,
                           "spans": _spans(),
                           "histograms": sorted(
                               k[:-len("_count")] for k in snapshot
                               if k.endswith("_seconds_count")),
                           "mesh_devices": snapshot.get("train/mesh_devices")},
                          fh)
        logger.removeHandler(log)
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_port(tmp, world, jobs, program=_train_jobs):
    """Each job trained by `world` spawned ranks, in order: {name: [each
    rank's record, with its final ``state``]}."""
    path = os.path.join(tmp, f"jobs-{world}.json")
    with open(path, "w") as fh:
        json.dump(jobs, fh)
    torch.multiprocessing.spawn(program, args=(world, free_port(), path),
                                nprocs=world, join=True)
    def record(job, r):
        with open(f"{job['out']}-{r}.json") as fh:
            out = json.load(fh)
        out["losses"] = {int(k): v for k, v in out["losses"].items()}
        return dict(out, state=torch.load(f"{job['out']}-{r}.pt"))

    return {job["name"]: [record(job, r) for r in range(world)]
            for job in jobs}


def world_one(job):
    """The port at one rank in this process: (logged losses, final
    state)."""
    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training

    logger, log = capture("tf_yarn_tpu_torch.training")
    try:
        exp = port_experiment(dict(job, mesh=None))
        t_training.train_and_evaluate(t_experiment.as_core_experiment(exp),
                                      device="cpu")
    finally:
        logger.removeHandler(log)
    return log.losses, exp.model.state_dict()


# -- the JAX side -------------------------------------------------------------


def jax_model(job):
    import jax.numpy as jnp

    unfused = dict(dtype=jnp.float32, fused_norms=False,
                   attention_impl=job.get("impl", "xla"))
    if job["model"] == "decoder":
        from tf_yarn_tpu.models import transformer as j_tt

        cfg = j_tt.TransformerConfig.tiny(
            remat=False, max_seq_len=64, lora_rank=job.get("lora", LORA),
            gpipe_microbatches=job.get("gpipe", 0), **decoder_knobs(job),
            **unfused)
        return j_tt, cfg, j_tt.Transformer(cfg), jnp.zeros((1, SEQ), jnp.int32)
    if job["model"] == "bert":
        from tf_yarn_tpu.models import bert as j_bert

        cfg = j_bert.BertConfig.tiny(**unfused)
        return (j_bert, cfg, j_bert.BertClassifier(cfg),
                jnp.zeros((2, SEQ), jnp.int32))
    from tf_yarn_tpu.models import vit as j_vit

    cfg = j_vit.ViTConfig.tiny(image_size=IMAGE, **unfused)
    return j_vit, cfg, j_vit.ViT(cfg), jnp.zeros((2, IMAGE, IMAGE, 3))


def bridge(job, flat):
    """The port's state dict of flax params `flat`."""
    from tf_yarn_tpu_torch.models import weights as t_weights

    cfg = port_config(job)
    if job["model"] == "decoder":
        return t_weights.from_flax(flat, cfg)
    if job["model"] == "bert":
        return t_weights.bert_from_flax(flat, cfg)
    return t_weights.vit_from_flax(flat, cfg)


def jax_variables(job):
    """The boxed flax variables of `job`'s model (a LoRA decoder's lora_b
    nonzero, or every LoRA-A gradient is zero) and the port's state dict
    of the same values. The init does not depend on the mesh or the
    attention backend."""
    import flax.linen as nn
    import jax

    init_job = dict(job, impl="xla", gpipe=0)
    _, _, model, example = jax_model(init_job)
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
    return boxed, bridge(job, flat)


def jax_run(job, boxed):
    """JAX's train_and_evaluate of `job` at its mesh on virtual CPU
    devices: logged losses and the final params by the port's names."""
    from tf_yarn_tpu import checkpoint as j_ckpt
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu import training as j_training
    from tf_yarn_tpu.parallel.mesh import MeshSpec, select_devices

    spec = MeshSpec(**(job.get("mesh") or {}))
    module, cfg, _, _ = jax_model(job)
    common = dict(model_dir=job["jax_dir"], mesh_spec=spec,
                  learning_rate=lr(job), input_fn=stream(job),
                  **train_params(job))
    if job["model"] == "decoder":
        exp = module.make_experiment(cfg, batch_size=batch_size(job),
                                     seq_len=SEQ,
                                     loss_chunk_size=job.get("chunk"),
                                     optimizer=job.get("optimizer"),
                                     **common)
    elif job["model"] == "bert":
        exp = module.make_experiment(cfg, batch_size=batch_size(job),
                                     seq_len=SEQ, **common)
    else:
        exp = module.make_experiment(cfg, batch_size=batch_size(job),
                                     **common)
    exp.init_fn = lambda rng, batch: boxed
    logger, log = capture("tf_yarn_tpu.training")
    try:
        j_training.train_and_evaluate(
            j_experiment.as_core_experiment(exp),
            devices=select_devices(spec.total_devices, platform="cpu"))
    finally:
        logger.removeHandler(log)
    steps = train_params(job)["train_steps"]
    flat = j_ckpt.restore_checkpoint_host(job["jax_dir"], steps)["params"]
    return {"losses": log.losses, "params": bridge(job, flat)}


def prepare(tmp, jobs):
    """Each job's init state (saved for the ranks), JAX variables and
    directories: {name: job}, and {name: boxed variables}."""
    out, boxed = {}, {}
    for name, spec in jobs.items():
        job = dict(spec, name=name,
                   init=os.path.join(tmp, f"init-{name}.pt"),
                   model_dir=os.path.join(tmp, f"port-{name}"),
                   jax_dir=os.path.join(tmp, f"jax-{name}"),
                   out=os.path.join(tmp, f"out-{name}"))
        boxed[name], state = jax_variables(job)
        torch.save(state, job["init"])
        out[name] = job
    return out, boxed
