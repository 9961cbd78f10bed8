"""Online serving for the port: continuous batching over the decode
engine.

* :mod:`~tf_yarn_tpu_torch.serving.request` — Request/Response
  lifecycle and the bounded admission queue (a copy of the JAX
  package's module).
* :mod:`~tf_yarn_tpu_torch.serving.paging` — block-pool free list,
  refcounts and the prefix cache (a copy).
* :mod:`~tf_yarn_tpu_torch.serving.scheduler` — `SlotScheduler`: the
  dense slot grid, or the paged pool in the gather or fused mode.
* :mod:`~tf_yarn_tpu_torch.serving.server` — `ServingServer`:
  ``/v1/generate``, ``/healthz``, ``/stats``, ``/metrics``.
"""

from tf_yarn_tpu_torch.serving.paging import BlockPool, PrefixCache  # noqa: F401
from tf_yarn_tpu_torch.serving.request import (  # noqa: F401
    QueueFull,
    Request,
    Response,
    SamplingParams,
)
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler  # noqa: F401
from tf_yarn_tpu_torch.serving.server import ServingServer  # noqa: F401
