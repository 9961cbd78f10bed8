"""PyTorch/CUDA port of tf_yarn_tpu, for the NVIDIA H100.

The JAX package (`tf_yarn_tpu`) is the reference and stays as it is;
this package mirrors its module names so each counterpart is easy to
find. It imports torch and numpy only — never jax, flax or anything
under `tf_yarn_tpu`.

Ported so far:

* paged-int8 serving of the llama-style decoder —
  `models.transformer.Transformer` (fused RMSNorm, int8 KV, fused paged
  decode), `models.decode_engine.DecodeEngine`,
  `serving.scheduler.SlotScheduler` and `serving.server.ServingServer`;
* LoRA (or full) fine-tuning of the same decoder on one device —
  `models.transformer.make_experiment` fed to
  `training.train_and_evaluate` (`experiment`, `checkpoint`,
  `models.common`, `utils.flops`).

Seven hand-written Hopper kernels under `ops/csrc/` carry them (RMSNorm
and its dx, per-row int8 quantize, paged int8 window attention, flash
attention forward, dq and dk/dv). ROADMAP.md lists what is still to
port.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from tf_yarn_tpu_torch._device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
