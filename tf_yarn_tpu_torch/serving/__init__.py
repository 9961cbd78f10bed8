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
  ``/v1/generate``, ``/healthz``, ``/stats``, ``/metrics``,
  ``/v1/blocks``; `run_serving`, the ``serving`` task's body.
* :mod:`~tf_yarn_tpu_torch.serving.prefill` — the disaggregated prefill
  tier: `PrefillWorker`, `PrefillServer` (``/v1/prefill``),
  `PrefillClient` and `run_prefill`, the ``prefill`` task's body.
"""

from tf_yarn_tpu_torch.serving.paging import BlockPool, PrefixCache  # noqa: F401
from tf_yarn_tpu_torch.serving.prefill import (  # noqa: F401
    PrefillClient,
    PrefillServer,
    PrefillTierConfig,
    PrefillWorker,
    kv_prefill_resolver,
    parse_prefill_tier,
    run_prefill,
)
from tf_yarn_tpu_torch.serving.request import (  # noqa: F401
    QueueFull,
    Request,
    Response,
    SamplingParams,
)
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler  # noqa: F401
from tf_yarn_tpu_torch.serving.server import (  # noqa: F401
    ServingServer,
    advertised_endpoint,
    run_serving,
)
