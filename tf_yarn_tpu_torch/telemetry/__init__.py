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
  evaluated over histogram windows;
* :mod:`~tf_yarn_tpu_torch.telemetry.heartbeat` — task heartbeats over
  the run's KV store;
* `flush_metrics` (the registry to the log, MLflow and ``{task}/metrics``)
  and the environment-driven trace files (`export_trace`,
  `enable_env_jsonl`).
"""

from tf_yarn_tpu_torch.telemetry import heartbeat  # noqa: F401
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
    flush_metrics,
    get_registry,
)
from tf_yarn_tpu_torch.telemetry.heartbeat import Heartbeat  # noqa: F401
from tf_yarn_tpu_torch.telemetry.slo import (  # noqa: F401
    SloEvaluator,
    SloObjective,
    parse_slo,
)
from tf_yarn_tpu_torch.telemetry.spans import (  # noqa: F401
    Span,
    Tracer,
    close_jsonl_sinks,
    enable_env_jsonl,
    export_trace,
    get_tracer,
    span,
    trace_dir,
)
