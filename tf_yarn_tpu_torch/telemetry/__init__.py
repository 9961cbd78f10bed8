"""Runtime telemetry for the PyTorch port: spans and metrics.

Copies of the JAX package's jax-free telemetry modules, so the port
reports into the same metric names and serves the same `/stats` and
`/metrics` wire formats:

* :mod:`~tf_yarn_tpu_torch.telemetry.spans` — nested, thread-aware span
  tracing with a ring buffer and a Chrome trace exporter.
* :mod:`~tf_yarn_tpu_torch.telemetry.registry` — process-global
  counters, gauges and mergeable quantile histograms with labels.
* :mod:`~tf_yarn_tpu_torch.telemetry.exposition` — Prometheus text for
  `/metrics` and the versioned `signals` block `/stats` embeds.
* :mod:`~tf_yarn_tpu_torch.telemetry.slo` — declared latency objectives
  evaluated over histogram windows.

The heartbeat module and the metrics flush to MLflow and the
coordination KV store belong to the launcher and are not part of the
port yet (ROADMAP.md, Queue 1).
"""

from tf_yarn_tpu_torch.telemetry.exposition import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE,
    SIGNALS_VERSION,
    STATS_SCHEMA_VERSION,
    render_prometheus,
    signals_block,
)
from tf_yarn_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    HIST_ALPHA,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from tf_yarn_tpu_torch.telemetry.slo import (  # noqa: F401
    SloEvaluator,
    SloObjective,
    parse_slo,
)
from tf_yarn_tpu_torch.telemetry.spans import (  # noqa: F401
    Span,
    Tracer,
    get_tracer,
    span,
)
