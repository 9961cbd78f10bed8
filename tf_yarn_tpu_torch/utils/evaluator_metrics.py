"""Driver-side poller of the side-car evaluator's health metrics — a
copy of tf_yarn_tpu/utils/evaluator_metrics.py.

The evaluator broadcasts its stats into the KV store
(`evaluation.continuous_eval`); the driver polls them during the run
and logs each changed value that passes the optional thresholds
(``run_on_gpu(eval_monitor_log_thresholds={metric: (low, high)})``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from tf_yarn_tpu_torch.coordination.kv import KVStore
from tf_yarn_tpu_torch.topologies import TaskKey
from tf_yarn_tpu_torch.utils import mlflow

_logger = logging.getLogger(__name__)

# Metric name -> the log's label.
MONITORED_METRICS = {
    "awake_time_ratio": "Awake/idle ratio",
    "eval_step_mean_duration": "Eval step mean duration (secs)",
    "last_training_step": "Training set of last checkpoint",
    "nb_eval_steps": "Number of evaluation steps done",
}


class EvaluatorMetricsLogger:
    """Log evaluator KV metrics, once per changed value, threshold-filtered."""

    def __init__(
        self,
        evaluator_list: List[TaskKey],
        kv: KVStore,
        n_try: int = 0,
        log_thresholds: Optional[Dict[str, Tuple[float, float]]] = None,
    ) -> None:
        self.evaluator_list = evaluator_list
        self.kv = kv
        self.n_try = n_try
        self.log_thresholds = log_thresholds or {}
        self.last_metrics: Dict[str, Dict[str, str]] = {
            e.to_kv_str(): {} for e in evaluator_list
        }

    def log(self) -> None:
        for evaluator in self.evaluator_list:
            task = evaluator.to_kv_str()
            for metric, label in MONITORED_METRICS.items():
                value = self.kv.get_str(f"{task}/{metric}")
                if value is None or self.last_metrics[task].get(metric) == value:
                    continue
                self.last_metrics[task][metric] = value
                lo, hi = self.log_thresholds.get(metric, (None, None))
                try:
                    numeric = float(value)
                except ValueError:
                    continue
                if (lo is None or numeric >= lo) and (hi is None or numeric <= hi):
                    _logger.info("%s [%s]: %s", label, task, value)
                mlflow.log_metric(f"{task}_{metric}_{self.n_try}", numeric)
