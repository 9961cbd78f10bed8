"""Serving fleet: the router, the replica registry, the fleet monitor and
the autoscaler — counterpart of tf_yarn_tpu/fleet/, with the same names,
metric names and HTTP bodies.

The replicas stay as `serving.server`, `serving.prefill` and
`ranking.server` run them; this package puts one endpoint in front:

* :mod:`~tf_yarn_tpu_torch.fleet.registry` — the live replica set from
  the KV ``{task}/{serving,rank,prefill}_endpoint`` advertisements and
  ``{task}/heartbeat`` beats, with ``/healthz`` ejection (held until
  healthy, draining-aware, re-admitted on recovery);
* :mod:`~tf_yarn_tpu_torch.fleet.policy` — round-robin and least-loaded;
* :mod:`~tf_yarn_tpu_torch.fleet.monitor` — merges the replicas'
  ``signals`` sketches into pooled fleet quantiles and evaluates the SLO
  at ``scope=fleet``;
* :mod:`~tf_yarn_tpu_torch.fleet.autoscaler` — per-kind scale decisions
  over the monitor and the registry, and the peer warm start over
  ``/v1/blocks``;
* :mod:`~tf_yarn_tpu_torch.fleet.router` — the router's HTTP frontend,
  path-aware dispatch with failover, and `run_router`, the ``router``
  task's body (tasks/router.py, `topologies.fleet_topology`).

Nothing here touches a device: the router task's model is on the meta
device (`_device.task_device`).
"""

from tf_yarn_tpu_torch.fleet.autoscaler import (  # noqa: F401
    AutoscalePolicy,
    FleetAutoscaler,
    ScaleEvent,
    parse_autoscale,
)
from tf_yarn_tpu_torch.fleet.monitor import (  # noqa: F401
    FleetMonitor,
    http_scrape,
)
from tf_yarn_tpu_torch.fleet.policy import (  # noqa: F401
    POLICIES,
    LeastLoadedPolicy,
    RoundRobinPolicy,
    make_policy,
)
from tf_yarn_tpu_torch.fleet.registry import (  # noqa: F401
    EJECTED,
    HEALTHY,
    PENDING,
    STOPPED,
    Replica,
    ReplicaRegistry,
    http_probe,
)
from tf_yarn_tpu_torch.fleet.router import RouterServer, run_router  # noqa: F401

__all__ = [
    "AutoscalePolicy",
    "EJECTED",
    "FleetAutoscaler",
    "FleetMonitor",
    "HEALTHY",
    "LeastLoadedPolicy",
    "PENDING",
    "POLICIES",
    "Replica",
    "ReplicaRegistry",
    "RoundRobinPolicy",
    "RouterServer",
    "STOPPED",
    "ScaleEvent",
    "http_probe",
    "http_scrape",
    "make_policy",
    "parse_autoscale",
    "run_router",
]
