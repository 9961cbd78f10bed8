"""Batch inference: checkpoint -> KV-cache generation -> JSONL records —
counterpart of tf_yarn_tpu/inference.py.

The runner behind `experiment.InferenceExperiment`: the train ->
checkpoint -> generate lifecycle. A three-stage pipeline keeps the
device fed: `data.prefetch.prefetch` stages input batches ahead on a
background thread, `models.generate.generate` (the model's shared
`DecodeEngine`) generates on the calling thread, and a bounded
background writer copies each batch's tokens to the host and writes
them as JSON lines.

Sharding across task instances is the input_fn's choice: declare
``(shard, num_shards)`` keywords to receive this task's slice of the
stream; instance outputs are suffixed ``-<task_id>``. `runtime` is a
launched task's (`tasks._bootstrap.TaskRuntime`: ``task_key``,
``cluster_tasks``, ``kv``, ``task``), or None for one instance. On
exit the registry is flushed (to ``{task}/metrics`` in a launched task)
and the spans exported (``TPU_YARN_TRACE``), as in the JAX package.

Where it differs: the checkpoint is the port's (the ``ckpt-<step>``
trees the port's `training.train_and_evaluate` writes; `_restore_params`
verifies one and maps its ``params`` with
`checkpoint.restore_checkpoint`), restored into the experiment's
`Transformer` on its device. The model_dir and the output path may be
any `fs` URI (a task launched by a remote backend refuses a host-local
model_dir, `fs.check_model_dir_placement`). A tensor-parallel serving
replica restores through `shard_restored_params` (JAX inference.py:107-137):
each rank fills only its shards of a model built on the ``meta``
device.
"""

from __future__ import annotations

import inspect
import io
import json
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from tf_yarn_tpu_torch import checkpoint as ckpt_lib
from tf_yarn_tpu_torch import fs as fs_lib
from tf_yarn_tpu_torch import telemetry

_logger = logging.getLogger(__name__)


def _accepts_sharding(input_fn) -> bool:
    try:
        params = inspect.signature(input_fn).parameters
    except (TypeError, ValueError):
        params = {}
    return "shard" in params and "num_shards" in params


def _check_sharding_contract(input_fn, num_shards: int,
                             allow_duplicate: bool) -> None:
    """N instances re-reading the full stream N times is an error unless
    asked for; checked before the restore, so it fails fast."""
    if _accepts_sharding(input_fn) or num_shards <= 1:
        return
    if not allow_duplicate:
        raise ValueError(
            f"{num_shards} inference instances but input_fn takes no "
            "(shard, num_shards) keywords: every instance would process "
            "the FULL stream and write duplicate records. Declare the "
            "keywords to split the stream, or set "
            "allow_duplicate_stream=True if duplication is intended."
        )
    _logger.warning("input_fn takes no (shard, num_shards): every task "
                    "instance processes the FULL stream "
                    "(allow_duplicate_stream=True).")


def _call_input_fn(input_fn, shard: int, num_shards: int):
    if _accepts_sharding(input_fn):
        return input_fn(shard=shard, num_shards=num_shards)
    return input_fn()


def verified_step(model_dir: str, step: Optional[int]) -> int:
    """The step to restore: an explicit one verified against its
    MANIFEST, or with None the newest verified one."""
    if step is None:
        step = ckpt_lib.latest_verified_step(model_dir)
        if step is None:
            raise FileNotFoundError(f"no ckpt-<step> under {model_dir}")
    else:
        ckpt_lib.verify_checkpoint(ckpt_lib.checkpoint_path(model_dir, step))
    return step


def shard_restored_params(model, state, mesh, device, rules=None):
    """The sharded restore (JAX inference.py:107-137): `model` — built on
    the ``meta`` device, or whole — cut to this rank's shards over
    `mesh`'s tp dim by its modules' logical-axis annotations under
    `rules` (`parallel.sharding.LOGICAL_RULES` by default; the ranker's
    `RANKING_RULES`) (`parallel.tensor_parallel.shard`), materialised on
    `device`, and filled with this rank's slices of the one-device
    `state` dict (`sharding.shard_like_annotated`; a memory-mapped
    checkpoint is read only where the slices lie). Returns the model. A
    state whose names are not the model's fails here, before anything
    serves."""
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
    from tf_yarn_tpu_torch.parallel import sharding
    from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib

    rules = sharding.LOGICAL_RULES if rules is None else rules
    tp = tp_lib.TensorParallel.of(mesh, mesh_lib.AXIS_TP)
    if tp is not None and model.tp is None:
        tp_lib.shard(model, tp, rules)
    if any(param.is_meta for param in model.parameters()):
        model.to_empty(device=device)
    with telemetry.span("checkpoint/load_state_dict", sharded=True):
        model.load_state_dict(sharding.shard_like_annotated(model, state,
                                                            mesh, rules))
    return model


def _restore_params(model, model_dir: str, step: Optional[int]) -> int:
    """Load the checkpoint's ``params`` into `model` (on its device);
    returns the step. An explicit step is verified against its MANIFEST
    first; None takes the newest verified one. The state dict is read
    memory-mapped on the host and copied once into the model's
    parameters, so the device holds one copy of the weights (two at
    Llama-3-8B width would be ~32 GB), and the optimizer's part is not
    read."""
    step = verified_step(model_dir, step)
    state = ckpt_lib.restore_checkpoint(model_dir, step, map_location="cpu",
                                        parts=("params",), mmap=True)
    with telemetry.span("checkpoint/load_state_dict", step=step):
        model.load_state_dict(state["params"])
    del state
    return step


class _JsonlWriter:
    """Bounded background JSONL writer (stage 3 of the pipeline).

    The main thread enqueues (tokens, sequences, extras) with `sequences`
    still on the device; the copy to the host happens here. A dead writer
    never deadlocks the producer (it drains without processing and the
    error re-raises on the next `put`/`close`).

    Also the token accountant: `real_tokens` counts each row's generated
    tokens up to and including its first eos — the repeated-eos tail is
    padding — while `padded_tokens` keeps the full-width figure."""

    def __init__(self, out, eos_token: Optional[int], depth: int):
        self._out = out
        self._eos = eos_token
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        self.records = 0
        self.real_tokens = 0
        self.padded_tokens = 0
        self.write_seconds = 0.0
        self.max_queue_depth = 0
        self._thread = threading.Thread(target=self._run,
                                        name="inference-writer", daemon=True)
        self._thread.start()

    def _write_batch(self, tokens, sequences, extras) -> None:
        if isinstance(sequences, torch.Tensor):
            sequences = sequences.cpu().numpy()
        sequences = np.asarray(sequences)
        tokens = np.asarray(tokens)
        generated = sequences[:, tokens.shape[1]:]
        for row in range(sequences.shape[0]):
            record = {"prompt": tokens[row].tolist(),
                      "tokens": generated[row].tolist()}
            for key, value in extras.items():
                record[key] = np.asarray(value[row]).tolist()
            self._out.write(json.dumps(record) + "\n")
            self.records += 1
        self.padded_tokens += int(generated.size)
        if self._eos is None:
            self.real_tokens += int(generated.size)
        else:
            hit = generated == self._eos
            first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                             generated.shape[1])
            self.real_tokens += int(first.sum())

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # drain so the producer never blocks
            try:
                with telemetry.span("inference/write_batch") as sp:
                    self._write_batch(*item)
                self.write_seconds += sp.duration
                telemetry.get_registry().histogram(
                    "inference/stage_seconds", stage="write").observe(
                        sp.duration)
            except BaseException as exc:  # noqa: BLE001 - re-raised in put/close
                self._exc = exc

    def put(self, tokens, sequences, extras) -> None:
        if self._exc is not None:
            raise self._exc
        self._q.put((tokens, sequences, extras))
        depth = self._q.qsize()
        self.max_queue_depth = max(self.max_queue_depth, depth)
        telemetry.get_registry().gauge("inference/writer_queue_depth").set(
            depth)

    def close(self) -> None:
        """Flush the queue, stop the thread, re-raise any writer error."""
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


def _depth(experiment, name: str, default: int) -> int:
    value = int(getattr(experiment, name, default))
    if value < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")
    return value


def run_inference(experiment, runtime=None) -> dict:
    """Generate for every batch of the (sharded) input stream; returns
    summary stats ({"records", "batches", "ckpt_step", "tokens_per_sec",
    "padded_tokens_per_sec", "stage_seconds", "writer_queue_depth_max",
    "decode_engine"})."""
    from tf_yarn_tpu_torch.data.prefetch import prefetch
    from tf_yarn_tpu_torch.models.decode_engine import get_engine
    from tf_yarn_tpu_torch.models.generate import generate

    shard, num_shards = 0, 1
    telemetry_task = "inference"
    if runtime is not None:
        shard = runtime.task_key.id
        num_shards = sum(1 for ti in runtime.cluster_tasks
                         if ti.key.type == runtime.task_key.type)
        telemetry_task = getattr(runtime, "task",
                                 f"{runtime.task_key.type}:{shard}")
    telemetry.enable_env_jsonl(telemetry_task)
    _check_sharding_contract(experiment.input_fn, num_shards,
                             getattr(experiment, "allow_duplicate_stream",
                                     False))
    fs_lib.check_model_dir_placement(experiment.model_dir)
    model = experiment.model
    with telemetry.span("inference/restore_params"):
        step = _restore_params(model, experiment.model_dir, experiment.step)
    _logger.info("inference from ckpt-%d, shard %d/%d -> %s", step, shard,
                 num_shards, experiment.output_path)
    out_path = experiment.output_path
    if num_shards > 1:
        out_path = f"{out_path}-{shard}"

    registry = telemetry.get_registry()
    stage_seconds = {"input_wait": 0.0, "decode": 0.0, "writer_put": 0.0}
    batches = 0
    t0 = time.perf_counter()
    end = object()
    # output_path may be any fs URI: results land where the fleet can
    # read them, like every other model_dir artifact.
    with io.TextIOWrapper(fs_lib.open_output(out_path),
                          encoding="utf-8") as out:
        writer = _JsonlWriter(out, experiment.eos_token,
                              depth=_depth(experiment, "writer_depth", 8))
        try:
            stream = prefetch(
                _call_input_fn(experiment.input_fn, shard, num_shards),
                depth=_depth(experiment, "prefetch_depth", 2),
                name="inference")
            while True:
                with telemetry.span("inference/input_wait") as sp_in:
                    batch = next(stream, end)
                if batch is end:
                    break
                stage_seconds["input_wait"] += sp_in.duration
                registry.histogram("inference/stage_seconds",
                                   stage="input_wait").observe(sp_in.duration)
                tokens = np.asarray(batch["tokens"], np.int32)
                with telemetry.span("inference/decode",
                                    batch_index=batches) as sp_dec:
                    sequences = generate(
                        model, tokens, max_new_tokens=experiment.max_new_tokens,
                        temperature=experiment.temperature,
                        top_k=experiment.top_k,
                        top_p=getattr(experiment, "top_p", None),
                        eos_token=experiment.eos_token)
                stage_seconds["decode"] += sp_dec.duration
                registry.histogram("inference/stage_seconds",
                                   stage="decode").observe(sp_dec.duration)
                extras = {key: np.asarray(value)
                          for key, value in batch.items() if key != "tokens"}
                with telemetry.span("inference/writer_put") as sp_put:
                    writer.put(tokens, sequences, extras)
                stage_seconds["writer_put"] += sp_put.duration
                registry.histogram("inference/stage_seconds",
                                   stage="writer_put").observe(sp_put.duration)
                batches += 1
        except BaseException:
            # The pipeline's error wins over a writer error; flush what
            # already decoded.
            try:
                writer.close()
            except BaseException:  # noqa: BLE001 - original error wins
                pass
            telemetry.export_trace(telemetry_task)
            raise
        writer.close()
    elapsed = max(time.perf_counter() - t0, 1e-9)
    stage_seconds["write"] = writer.write_seconds
    stats = {
        "records": writer.records,
        "batches": batches,
        "ckpt_step": step,
        # Per-row tokens up to the first eos; the repeated-eos fill is
        # reported separately.
        "tokens_per_sec": round(writer.real_tokens / elapsed, 2),
        "padded_tokens_per_sec": round(writer.padded_tokens / elapsed, 2),
        "stage_seconds": {k: round(v, 4) for k, v in stage_seconds.items()},
        "writer_queue_depth_max": writer.max_queue_depth,
        "decode_engine": dict(get_engine(model).stats),
    }
    _logger.info("inference done: %s", stats)
    # The registry to the log, MLflow and, in a launched task, the run's
    # KV store ({task}/metrics); the spans to TPU_YARN_TRACE.
    telemetry.flush_metrics(
        registry, kv=getattr(runtime, "kv", None),
        task=telemetry_task if runtime is not None else None)
    telemetry.export_trace(telemetry_task)
    return stats
