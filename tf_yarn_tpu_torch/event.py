"""Lifecycle-event protocol over the coordination KV store — a copy of
tf_yarn_tpu/event.py. Its keys are the protocol: ``"{task}/{stage}"``
with ``task`` the ``"type:id"`` string of a
:class:`~tf_yarn_tpu_torch.topologies.TaskKey`.

Stages ``init``, ``start``, ``stop`` (traceback payload with a
failure-kind marker, or ""), ``logs``, ``url``; the timer keys folded into
the run's `Metrics` by `utils.metrics.handle_events`; the telemetry keys
(``heartbeat``, ``heartbeat.stopped``, ``metrics``); and the discovery
keys of the serving, router, rank and prefill tasks, kept so the two
packages read each other's KV.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Optional

from tf_yarn_tpu_torch.coordination.kv import KVStore

_logger = logging.getLogger(__name__)

# Lifecycle stages (reference: event.py:33-47).
INIT = "init"
START = "start"
STOP = "stop"
LOGS = "logs"
URL = "url"

# Timer stages (reference: event.py:50-67).
CONTAINER_START_TIME = "container_start_time"
CONTAINER_STOP_TIME = "container_stop_time"
TRAIN_EVAL_START_TIME = "train_eval_start_time"
TRAIN_EVAL_STOP_TIME = "train_eval_stop_time"

# Telemetry stages (no reference analog — the unified telemetry layer,
# telemetry package, publishes per-task liveness + metric snapshots
# through the same KV protocol the lifecycle events use).
HEARTBEAT = "heartbeat"
# Tombstone published on clean Heartbeat.stop(): lets the watchdog (and
# utils.metrics) distinguish "finished" from "died" — both used to look
# like a growing heartbeat age.
HEARTBEAT_STOPPED = "heartbeat.stopped"
METRICS = "metrics"
# Online-serving discovery (the serving task): each serving task
# advertises its HTTP endpoint so clients and the driver find it
# through the KV store instead of guessing ports.
SERVING_ENDPOINT = "serving_endpoint"
# Fleet-router discovery (tf_yarn_tpu/fleet/): the router task advertises
# ITS endpoint the same way — the one address clients actually dial in a
# fleet topology (the serving endpoints behind it stay advertised too,
# for direct access and for the router's own registry).
ROUTER_ENDPOINT = "router_endpoint"
# Ranking discovery (the rank task): a DIFFERENT key suffix than
# serving's, deliberately — the suffix is the endpoint's capability
# declaration. The fleet registry derives each replica's kind from
# which key it advertised, so the router's path-aware dispatch never
# sends a /v1/rank request to a token-decode replica.
RANK_ENDPOINT = "rank_endpoint"
# Disaggregated-prefill discovery (tf_yarn_tpu/serving/prefill.py): a
# prefill-tier replica advertises under its OWN suffix — again the
# capability declaration. Decode replicas resolve the tier from this
# key (two-stage dispatch pulls, so /v1/generate routing is untouched)
# and the fleet registry tags the replica kind "prefill" from it.
PREFILL_ENDPOINT = "prefill_endpoint"
# Autoscaler desired-capacity advertisement (tf_yarn_tpu/fleet
# .autoscaler): the router-side decision plane publishes the per-kind
# replica count it wants; the driver's elastic relaunch path (and any
# operator) reads it. Kind rides in the key so the generate and rank
# advertisements never clobber each other.
FLEET_DESIRED = "fleet_desired"


def wait(kv: KVStore, key: str, timeout: Optional[float] = None) -> str:
    """Block until `key` exists; returns its UTF-8 value (reference: event.py:13-30)."""
    _logger.info("waiting for %s", key)
    value = kv.wait_str(key, timeout=timeout)
    _logger.info("received %s", key)
    return value


def broadcast(kv: KVStore, key: str, value: str = "") -> None:
    """Publish `key` (reference: event.py:70-79)."""
    _logger.info("broadcasting %s = %r", key, value[:120])
    kv.put_str(key, value)


def init_event(kv: KVStore, task: str, sock_addr: str) -> None:
    broadcast(kv, f"{task}/{INIT}", sock_addr)


def start_event(kv: KVStore, task: str) -> None:
    broadcast(kv, f"{task}/{START}")


def stop_event(
    kv: KVStore, task: str, exception: Optional[BaseException] = None
) -> None:
    """Publish the task's terminal state. A failure payload leads with a
    failure-kind marker line (resilience.taxonomy.encode_failure) so the
    driver's retry policy knows *why* the attempt died without parsing
    tracebacks; success stays the reference's empty string."""
    if exception is None:
        broadcast(kv, f"{task}/{STOP}", "")
        return
    from tf_yarn_tpu_torch.resilience import taxonomy

    broadcast(kv, f"{task}/{STOP}", taxonomy.encode_failure(exception))


def logs_event(kv: KVStore, task: str, logs_location: str) -> None:
    broadcast(kv, f"{task}/{LOGS}", logs_location)


def url_event(kv: KVStore, task: str, url: str) -> None:
    broadcast(kv, f"{task}/{URL}", url)


def start_time_event(kv: KVStore, task: str) -> None:
    broadcast(kv, f"{task}/{CONTAINER_START_TIME}", str(time.time()))


def stop_time_event(kv: KVStore, task: str) -> None:
    broadcast(kv, f"{task}/{CONTAINER_STOP_TIME}", str(time.time()))


def train_eval_start_event(kv: KVStore, task: str) -> None:
    broadcast(kv, f"{task}/{TRAIN_EVAL_START_TIME}", str(time.time()))


def train_eval_stop_event(kv: KVStore, task: str) -> None:
    broadcast(kv, f"{task}/{TRAIN_EVAL_STOP_TIME}", str(time.time()))


def heartbeat_event(
    kv: KVStore, task: str, timestamp: Optional[float] = None
) -> None:
    """Per-task liveness beacon: wall-clock seconds, compared across
    hosts by utils.metrics.task_heartbeats (the one timer that SHOULD be
    wall clock — ages are computed against the observer's clock)."""
    ts = time.time() if timestamp is None else timestamp
    broadcast(kv, f"{task}/{HEARTBEAT}", f"{ts:.3f}")


def heartbeat_stopped_event(
    kv: KVStore, task: str, timestamp: Optional[float] = None
) -> None:
    """Final liveness tombstone on clean heartbeat shutdown: the task is
    done beating on purpose. Consumers (resilience.HeartbeatWatchdog,
    utils.metrics.task_heartbeats) treat tombstoned tasks as finished,
    never as dead."""
    ts = time.time() if timestamp is None else timestamp
    broadcast(kv, f"{task}/{HEARTBEAT_STOPPED}", f"{ts:.3f}")


def serving_endpoint_event(kv: KVStore, task: str, endpoint: str) -> None:
    """Advertise a serving task's HTTP endpoint (``host:port``) for
    discovery: clients read ``{task}/serving_endpoint`` instead of
    guessing ports, and the driver logs it once at launch."""
    broadcast(kv, f"{task}/{SERVING_ENDPOINT}", endpoint)


def serving_endpoint_event_name(task: str) -> str:
    return f"{task}/{SERVING_ENDPOINT}"


def router_endpoint_event(kv: KVStore, task: str, endpoint: str) -> None:
    """Advertise the fleet router's HTTP endpoint (``host:port``): the
    single address clients dial in a fleet topology (docs/Fleet.md);
    the driver logs it once at launch."""
    broadcast(kv, f"{task}/{ROUTER_ENDPOINT}", endpoint)


def router_endpoint_event_name(task: str) -> str:
    return f"{task}/{ROUTER_ENDPOINT}"


def rank_endpoint_event(kv: KVStore, task: str, endpoint: str) -> None:
    """Advertise a ranking task's HTTP endpoint (``host:port``). The
    distinct suffix doubles as the replica's capability declaration —
    see RANK_ENDPOINT."""
    broadcast(kv, f"{task}/{RANK_ENDPOINT}", endpoint)


def rank_endpoint_event_name(task: str) -> str:
    return f"{task}/{RANK_ENDPOINT}"


def prefill_endpoint_event(kv: KVStore, task: str, endpoint: str) -> None:
    """Advertise a prefill-tier task's HTTP endpoint (``host:port``).
    The distinct suffix doubles as the replica's capability declaration
    — see PREFILL_ENDPOINT."""
    broadcast(kv, f"{task}/{PREFILL_ENDPOINT}", endpoint)


def prefill_endpoint_event_name(task: str) -> str:
    return f"{task}/{PREFILL_ENDPOINT}"


def fleet_desired_event(kv: KVStore, task: str, kind: str,
                        replicas: int, reason: str = "") -> None:
    """Advertise the autoscaler's desired replica count for one kind
    (JSON payload: replicas + reason). Last write wins — the value is a
    desired STATE, not an event log."""
    import json

    broadcast(kv, fleet_desired_event_name(task, kind), json.dumps({
        "kind": kind, "replicas": int(replicas), "reason": reason,
    }))


def fleet_desired_event_name(task: str, kind: str) -> str:
    return f"{task}/{FLEET_DESIRED}_{kind}"


def metrics_event(kv: KVStore, task: str, payload: str) -> None:
    """Publish a task's telemetry-registry snapshot (a JSON object) as a
    single key, aggregated chief-side exactly like last_training_step."""
    broadcast(kv, f"{task}/{METRICS}", payload)


def maybe_format_exception(exception: Optional[BaseException]) -> str:
    """"" for success, full traceback text otherwise (reference: event.py:82-85)."""
    if exception is None:
        return ""
    return "".join(
        traceback.format_exception(type(exception), exception, exception.__traceback__)
    )
