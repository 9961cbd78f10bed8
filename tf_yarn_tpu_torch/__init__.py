"""PyTorch/CUDA port of tf_yarn_tpu, for the NVIDIA H100.

The JAX package (`tf_yarn_tpu`) is the reference and stays as it is;
this package mirrors its module names so each counterpart is easy to
find. It imports torch and numpy only — never jax, flax or anything
under `tf_yarn_tpu`.

Ported so far:

* serving of the llama-style decoder — `models.transformer.Transformer`
  (fused RMSNorm, KV cache in the compute dtype or int8),
  `models.decode_engine.DecodeEngine`, `serving.scheduler.SlotScheduler`
  (the dense slot grid, or the paged pool read in the gather mode or by
  the fused paged kernel; n-gram speculative drafts) and
  `serving.server.ServingServer`;
* generation and batch inference — `models.generate.generate` and
  `inference.run_inference` (`experiment.InferenceExperiment`,
  `data.prefetch`);
* LoRA (or full) fine-tuning of the same decoder on one device —
  `models.transformer.make_experiment` fed to
  `training.train_and_evaluate` (`experiment`, `checkpoint`,
  `models.common`, `utils.flops`);
* training of the model zoo the same way — `models.bert` (BERT),
  `models.vit` (ViT) and `models.resnet` (ResNet with GroupNorm), each
  with its `make_experiment`;
* the DLRM ranker behind `/v1/rank` — `models.dlrm`,
  `models.rank_engine`, `ranking` — on one device or with its table's
  rows cut over a tp replica's ranks (`serving.tp_replica`);
* training over the ranks of a process group —
  `training.train_and_evaluate` over a `parallel.mesh.MeshSpec` of ``dp``,
  ``fsdp`` and ``tp`` (DDP, FSDP2 or both: `parallel.data_parallel`; the
  model cut over ``tp`` by the placements of `parallel.sharding` and
  computed on its shards by `parallel.tensor_parallel`), with
  `parallel.collectives` over a mesh dimension;
* the PyTorch experiment — `pytorch.PytorchExperiment` launched by
  `pytorch.run_on_gpu` on the `tasks.pytorch_worker` task program (DDP
  workers and the user's ``main_fn``), with `utils.model_ckpt`;
* launching — `client.run_on_gpu` over the JAX package's KV and event
  protocol (`coordination`, `event`, `backends.LocalBackend`,
  `resilience`), with the `tasks.worker` and `tasks.distributed` task
  programs, and the serving, prefill and rank replicas
  (`tasks.serving`, `tasks.prefill`, `tasks.rank`:
  `experiment.ServingExperiment` and `RankingExperiment` through
  `serving.server.run_serving`, the disaggregated prefill tier of
  `serving.prefill` and `ranking.server.run_ranking`);
* remote hosts and remote storage — `backends.SshBackend` over the
  hosts `discovery.discover_gpu_hosts` finds, the code and its wheels
  shipped to bare workers by `packaging`, and every model_dir-like path
  resolved by `fs` (a path, ``file://``, ``gs://``, ``hdfs://`` or a
  registered scheme; checkpoints staged for a remote one).

Twelve hand-written Hopper kernels under `ops/csrc/` carry them (RMSNorm,
LayerNorm and GroupNorm, each with its dx; int8 quantize, per row or per
group of rows; paged int8 decode attention over per-row or per-block
scales, and dense; flash attention forward, dq and
dk/dv). ROADMAP.md lists what is still to port.

Entry points run on CUDA unless the caller passes ``device="cpu"``.

Public surface, as the JAX package's::

    from tf_yarn_tpu_torch.client import run_on_gpu
    from tf_yarn_tpu_torch.topologies import TaskSpec, allreduce_topology
    from tf_yarn_tpu_torch.parallel import MeshSpec
    from tf_yarn_tpu_torch.pytorch import PytorchExperiment
"""

from tf_yarn_tpu_torch._device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
