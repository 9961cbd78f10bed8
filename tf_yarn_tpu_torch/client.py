"""Driver: `run_on_gpu` — launch an experiment's task programs and await
them; counterpart of `run_on_tpu` (tf_yarn_tpu/client.py:522-772).

One attempt starts the coordination service (the Python KV server),
posts the cluster layout, launches one task program a task through a
:class:`~tf_yarn_tpu_torch.backends.SliceBackend` (`LocalBackend`:
subprocesses on this host; `SshBackend`: one a host over ssh), posts the
pickled experiment and polls the
tasks to the end, with the heartbeat watchdog and one global deadline.
A failed attempt is classified from the tasks' stop events (TRANSIENT,
PREEMPTED, LOST_TASK, FATAL_USER) and retried within that kind's
budget. With an `elastic_policy` a retry resizes instead of waiting for
the same capacity (JAX client.py:722-763): a capacity failure (LOST_TASK,
PREEMPTED) relaunches each elastic task type on its surviving tasks,
another retryable failure grows it back, and the tasks learn the
attempt's count and the full one from ``TPU_YARN_ELASTIC_WORKERS`` and
``TPU_YARN_ELASTIC_MAX_WORKERS`` (other types: `constants.
elastic_env_vars`), from which the train loop refits its mesh. The
run's `Metrics` come back to the caller.

The experiment crosses to the tasks pickled: by value with cloudpickle
where the driver has it, else by reference with the stdlib pickle, so
the experiment fn must then be importable in the task —
:func:`get_safe_experiment_fn` ("package.module.fn") always is. An fn
that cannot be pickled raises here, before anything is launched.

A remote backend (`SliceBackend.is_remote`) gets the coordinator bound
on every interface and advertised at a routable address
(`coordinator_advertise` names it), the project code shipped by default
(`packaging.ship_files` over the backend's file channel, or
`packaging.ship_env` staged on `env_staging_dir`; `requirements` and
`wheels_dir` add a wheelhouse), and ``TPU_YARN_REMOTE_BACKEND=1`` in its
tasks' environment, so a task refuses a host-local model_dir
(`fs.check_model_dir_placement`). A failed attempt's lost tasks go back
to the backend (`note_lost_tasks`), so `SshBackend` keeps their hosts
out of the relaunch.

The side-cars: an ``evaluator`` task places itself as every task does,
on the card unless the caller's env sets ``TPU_YARN_PLATFORM=cpu`` (the
JAX driver defaults its evaluator to the CPU; the port does not); the
driver polls its health metrics
(`utils.evaluator_metrics.EvaluatorMetricsLogger`, filtered by
`eval_monitor_log_thresholds`). A ``tensorboard`` task gets
``TB_MODEL_DIR``, ``TB_EXTRA_ARGS`` and
``TB_TERMINATION_TIMEOUT_SECONDS`` from its `TaskSpec`, and the driver
logs its URL once ("tensorboard URL http://..."). The side-cars do not
gate the attempt's outcome; after a successful one the driver keeps the
coordination service up until they end on their own (the evaluator
after the final checkpoint, tensorboard after its linger), within the
run's budget, and terminates any still running before it returns.

The serving, prefill and rank replicas and the fleet's router advertise
their HTTP endpoints in the KV store (``{task}/serving_endpoint``,
``{task}/prefill_endpoint``, ``{task}/rank_endpoint``,
``{task}/router_endpoint``); the driver logs each once, as soon as it
appears ("serving endpoint 127.0.0.1:41231", "router endpoint ...").
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import pickle
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Callable, Dict, List, Optional

from tf_yarn_tpu_torch import _env, constants, event, resilience, telemetry
from tf_yarn_tpu_torch._internal import MonitoredThread, dumps_fn
from tf_yarn_tpu_torch.backends import (
    FAILED,
    KILLED,
    PRIMARY_TASK_TYPES,
    RUNNING,
    SUCCEEDED,
    ClusterHandle,
    LocalBackend,
    ServiceSpec,
    SliceBackend,
)
from tf_yarn_tpu_torch.coordination import KVClient, KVStore
from tf_yarn_tpu_torch.coordination.server_factory import start_best_server
from tf_yarn_tpu_torch.resilience import (
    Deadline,
    ElasticPolicy,
    FailureKind,
    HeartbeatWatchdog,
    RetryPolicy,
)
from tf_yarn_tpu_torch.topologies import (
    TaskSpecs,
    check_topology,
    single_server_topology,
)
from tf_yarn_tpu_torch.utils import mlflow
from tf_yarn_tpu_torch.utils.evaluator_metrics import EvaluatorMetricsLogger
from tf_yarn_tpu_torch.utils.metrics import (
    Metrics,
    OneShotMetricsLogger,
    TaskOutcome,
    handle_events,
)
from tf_yarn_tpu_torch.utils.tensorboard_utils import url_event_name

_logger = logging.getLogger(__name__)

ExperimentFn = Callable[[], object]

# The endpoint each replica type advertises, and the driver log's label
# for it.
ENDPOINT_EVENTS = {
    "serving": (event.serving_endpoint_event_name, "serving endpoint"),
    "prefill": (event.prefill_endpoint_event_name, "prefill endpoint"),
    "rank": (event.rank_endpoint_event_name, "rank endpoint"),
    "router": (event.router_endpoint_event_name, "router endpoint"),
}


class RunFailed(Exception):
    """Raised when the experiment fails. Carries the attempt's
    :class:`~tf_yarn_tpu_torch.resilience.FailureKind` and the tasks that
    died without a lifecycle close (`lost_tasks`)."""

    def __init__(
        self,
        message: str,
        kind: Optional[FailureKind] = None,
        lost_tasks: Optional[List[str]] = None,
    ):
        super().__init__(message)
        self.kind = kind
        self.lost_tasks = list(lost_tasks or [])


@dataclass
class SliceCluster:
    """A running cluster: coordination service + launched tasks."""

    server: object
    kv: KVStore
    handle: ClusterHandle
    cluster_tasks: List[str]
    log_dir: str
    event_listener: Optional[MonitoredThread] = None
    events: Dict[str, Dict[str, str]] = field(default_factory=dict)


def _setup_cluster_spec(task_specs: TaskSpecs, kv: KVStore) -> List[str]:
    """Post the cluster layout; evaluator/tensorboard are side-cars and not
    part of the training cluster."""
    instances = [
        (f"{task_type}:{task_id}", spec.nb_proc_per_worker)
        for task_type, spec in task_specs.items()
        if task_type not in ("evaluator", "tensorboard")
        for task_id in range(spec.instances)
    ]
    kv.put_str(constants.KV_CLUSTER_INSTANCES, json.dumps(instances))
    return [task for task, _ in instances]


def _setup_task_env(
    task_specs: TaskSpecs,
    endpoint: str,
    log_dir: str,
    n_try: int,
    env: Dict[str, str],
    custom_task_module: Optional[str],
    pre_script_hook: str,
    files: Optional[Dict[str, str]] = None,
) -> Dict[str, ServiceSpec]:
    """One ServiceSpec per task type with instances: the caller's env plus
    the coordinator, the attempt, the log dir and the process count."""
    services: Dict[str, ServiceSpec] = {}
    for task_type, spec in task_specs.items():
        if spec.instances == 0:
            continue
        task_env = dict(env)
        task_env[constants.ENV_COORDINATOR] = endpoint
        task_env[constants.ENV_N_TRY] = str(n_try)
        task_env[constants.ENV_LOG_DIR] = log_dir
        task_env[constants.ENV_NB_PROC] = str(spec.nb_proc_per_worker)
        # MLflow context crosses to tasks via env, only when mlflow is
        # really active.
        if mlflow.use_mlflow():
            task_env.setdefault("MLFLOW_RUN_ID", mlflow.active_run_id())
            tracking_uri = mlflow.get_tracking_uri()
            if tracking_uri:
                task_env.setdefault("MLFLOW_TRACKING_URI", tracking_uri)
        if task_type == "tensorboard":
            if spec.tb_model_dir:
                task_env.setdefault("TB_MODEL_DIR", spec.tb_model_dir)
            if spec.tb_extra_args:
                task_env.setdefault("TB_EXTRA_ARGS", spec.tb_extra_args)
            task_env.setdefault(
                "TB_TERMINATION_TIMEOUT_SECONDS",
                str(spec.tb_termination_timeout_seconds),
            )
        services[task_type] = ServiceSpec(
            module=_env.gen_task_module(task_type, custom_task_module),
            instances=spec.instances,
            env=task_env,
            nb_proc=spec.nb_proc_per_worker,
            pre_script_hook=pre_script_hook,
            files=dict(files or {}),
        )
    return services


def _start_event_listener(cluster: SliceCluster) -> MonitoredThread:
    """Tail the KV event log and record the last-seen stage per task."""

    def listen() -> None:
        cursor = 0
        while cluster.handle.status() == RUNNING:
            tail, cursor = cluster.kv.events(cursor)
            for _, key in tail:
                task, _, stage = key.rpartition("/")
                if task:
                    value = cluster.kv.get_str(key) or ""
                    cluster.events.setdefault(task, {})[stage] = value
                    _logger.info("event %s = %.80s", key, value)
            time.sleep(0.5)

    thread = MonitoredThread(target=listen, name="event-listener", daemon=True)
    thread.start()
    return thread


def _routable_host() -> str:
    """This machine's address as other hosts see it. The UDP connect trick
    picks the interface with a default route (no packet is sent)."""
    import socket

    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.connect(("8.8.8.8", 80))
            return sock.getsockname()[0]
    except OSError:
        return socket.getfqdn()


def _advertised_endpoint(
    server_endpoint: str, backend: SliceBackend,
    coordinator_advertise: Optional[str]
) -> str:
    """The coordinator address tasks dial (JAX client.py:206-225). Remote
    backends must not be handed a loopback or wildcard bind host: they
    would dial their own localhost and hang."""
    host, _, port = server_endpoint.rpartition(":")
    if coordinator_advertise:
        if ":" in coordinator_advertise:
            return coordinator_advertise
        return f"{coordinator_advertise}:{port}"
    if getattr(backend, "is_remote", True) and host in (
        "127.0.0.1", "localhost", "0.0.0.0", "",
    ):
        routable = _routable_host()
        _logger.info(
            "advertising coordinator as %s:%s to remote tasks "
            "(bind address %s is not routable)", routable, port, host,
        )
        return f"{routable}:{port}"
    return server_endpoint


def _setup_cluster(
    task_specs: TaskSpecs,
    backend: SliceBackend,
    n_try: int,
    env: Dict[str, str],
    custom_task_module: Optional[str],
    pre_script_hook: str,
    name: str,
    coordinator_bind: str = "127.0.0.1",
    files: Optional[Dict[str, str]] = None,
    coordinator_advertise: Optional[str] = None,
) -> SliceCluster:
    log_dir = tempfile.mkdtemp(prefix=f"{name}-logs-")
    server = start_best_server(host=coordinator_bind)
    if getattr(backend, "is_remote", True):
        # Tasks land on other machines: fs.check_model_dir_placement fails
        # fast on a host-local model_dir (a shared mount opts out with
        # TPU_YARN_ALLOW_LOCAL_MODEL_DIR=1).
        env = dict(env)
        env.setdefault("TPU_YARN_REMOTE_BACKEND", "1")
    try:
        kv = KVClient(server.endpoint)
        services = _setup_task_env(
            task_specs,
            _advertised_endpoint(server.endpoint, backend,
                                 coordinator_advertise),
            log_dir,
            n_try,
            env,
            custom_task_module,
            pre_script_hook,
            files,
        )
        cluster_tasks = _setup_cluster_spec(task_specs, kv)
        handle = backend.launch(services, log_dir)
    except Exception:
        server.stop()
        raise
    cluster = SliceCluster(
        server=server,
        kv=kv,
        handle=handle,
        cluster_tasks=cluster_tasks,
        log_dir=log_dir,
    )
    cluster.event_listener = _start_event_listener(cluster)
    return cluster


def _execute_and_await_termination(
    cluster: SliceCluster,
    serialized_fn: bytes,
    n_try: int,
    poll_every_secs: float,
    eval_monitor_log_thresholds: Optional[Dict[str, tuple]] = None,
    deadline: Optional[Deadline] = None,
    dead_task_secs: Optional[float] = None,
) -> Metrics:
    """Post the experiment, poll to completion, fold the events into
    Metrics.

    `deadline` is the run's ONE monotonic budget, shared across retries.
    `dead_task_secs` arms the heartbeat watchdog: a task that beat once
    and then went silent that long fails the attempt as LOST_TASK within
    a poll interval, instead of hanging until the deadline."""
    cluster.kv.put(constants.KV_EXPERIMENT_FN, serialized_fn)

    evaluator_logger = EvaluatorMetricsLogger(
        [t for t in cluster.handle.tasks() if t.type == "evaluator"],
        cluster.kv,
        n_try=n_try,
        log_thresholds=eval_monitor_log_thresholds,
    )
    # The tensorboard URL and each replica's advertised endpoint, logged
    # once when it appears (the JAX driver logs the serving and rank
    # ones; the prefill tier's too here, so a disaggregated run shows
    # both of its tiers).
    endpoint_logger = OneShotMetricsLogger(
        cluster.kv,
        [(url_event_name(key.to_kv_str()), "tensorboard URL")
         for key in cluster.handle.tasks() if key.type == "tensorboard"]
        + [(ENDPOINT_EVENTS[key.type][0](key.to_kv_str()),
            ENDPOINT_EVENTS[key.type][1])
           for key in cluster.handle.tasks() if key.type in ENDPOINT_EVENTS],
        n_try,
    )
    watchdog = None
    if dead_task_secs:
        watchdog = HeartbeatWatchdog(
            cluster.kv, cluster.cluster_tasks, dead_task_secs
        )
    status = RUNNING
    lost_tasks: List[str] = []
    while status == RUNNING:
        time.sleep(poll_every_secs)
        status = cluster.handle.status()
        evaluator_logger.log()
        endpoint_logger.log()
        if status != RUNNING:
            break
        if watchdog is not None:
            lost_tasks = watchdog.poll()
            if lost_tasks:
                # Wedged-but-alive task (host gone, partition, livelock):
                # fail the attempt in seconds as LOST_TASK.
                _logger.error(
                    "heartbeat watchdog: %s silent > %.0fs; killing attempt",
                    lost_tasks, dead_task_secs,
                )
                telemetry.get_registry().counter(
                    "driver/lost_tasks_total"
                ).inc(len(lost_tasks))
                cluster.handle.kill()
                status = KILLED
                break
        if deadline is not None and deadline.expired():
            # Hung cluster (deadlocked collective, stuck host): kill it so
            # the retry loop / caller gets control back.
            _logger.error(
                "run exceeded its %.0fs global budget; killing",
                deadline.seconds,
            )
            cluster.handle.kill()
            status = KILLED
            break

    if status == SUCCEEDED:
        # The side-cars end on their own once training has stopped (the
        # evaluator after the final checkpoint, or with none pending;
        # tensorboard after its linger): the coordination service stays
        # up for them, within the run's budget.
        while cluster.handle.side_cars() and not (
                deadline is not None and deadline.expired()):
            time.sleep(poll_every_secs)
            evaluator_logger.log()
            endpoint_logger.log()
    cluster.handle.stop_side_cars()

    if cluster.event_listener is not None:
        cluster.event_listener.join(timeout=5.0)

    all_tasks = [key.to_kv_str() for key in cluster.handle.tasks()]
    metrics, outcomes = handle_events(cluster.kv, all_tasks)
    _log_run_outcome(cluster, status, outcomes)
    metrics.log_mlflow(n_try)

    failures = {
        t: o
        for t, o in outcomes.items()
        if o.status == "FAILED" and t.split(":", 1)[0] in PRIMARY_TASK_TYPES
    }
    if failures:
        _print_failed_task_logs(cluster, failures)
    if status != "SUCCEEDED" or failures:
        kind = _attempt_kind(outcomes, failures, lost_tasks)
        details = "\n".join(
            f"{task}: {outcome.exception}" for task, outcome in failures.items()
        )
        if lost_tasks:
            details = (
                f"heartbeat-silent tasks declared lost: {lost_tasks}\n"
                + details
            )
        raise RunFailed(
            f"run final status {status} (classified {kind.value}); "
            f"failed tasks: {sorted(failures) or 'none reported'}\n{details}",
            kind=kind,
            lost_tasks=_lost_primaries(outcomes, lost_tasks),
        )
    return metrics


def _lost_primaries(
    outcomes: Dict[str, TaskOutcome], lost_tasks: List[str]
) -> List[str]:
    """Primary tasks that died without a lifecycle close: the watchdog's
    heartbeat-silent set when it fired (the kill that follows leaves every
    wedged survivor equally stop-event-less), else the
    started-but-never-stopped primaries (SIGKILL, host gone)."""
    if lost_tasks:
        return sorted(set(lost_tasks))
    return sorted(
        task
        for task, outcome in outcomes.items()
        if outcome.status == "KILLED"
        and task.split(":", 1)[0] in PRIMARY_TASK_TYPES
    )


def _attempt_kind(
    outcomes: Dict[str, TaskOutcome],
    failures: Dict[str, TaskOutcome],
    lost_tasks: List[str],
) -> FailureKind:
    """Fold per-task failure kinds into the attempt's dominant kind (the
    retry policy's input): FATAL_USER anywhere beats everything, a
    preemption explains collateral losses, and primaries killed without a
    stop event are lost tasks — counted even when other tasks reported
    failures, because a survivor's collateral crash (its collective peer
    vanished, a TRANSIENT ConnectionError) must not mask the lost host
    that caused it."""
    kinds = [FailureKind.LOST_TASK] * bool(lost_tasks)
    kinds.extend(
        outcome.kind or FailureKind.TRANSIENT for outcome in failures.values()
    )
    kinds.extend(
        FailureKind.LOST_TASK
        for task, outcome in outcomes.items()
        if outcome.status == "KILLED"
        and task.split(":", 1)[0] in PRIMARY_TASK_TYPES
    )
    return resilience.worst(kinds) or FailureKind.TRANSIENT


def _print_failed_task_logs(
    cluster: SliceCluster, failures: Dict[str, TaskOutcome], tail_lines: int = 25
) -> None:
    """Surface the tail of each failed task's log in the driver output."""
    logs = cluster.handle.logs()
    for task in sorted(failures):
        path = logs.get(task)
        if not path or not os.path.exists(path):
            continue
        try:
            with open(path, "r", errors="replace") as fh:
                tail = list(deque(fh, maxlen=tail_lines))
        except OSError:
            continue
        _logger.error(
            "---- last %d log lines of failed %s (%s) ----\n%s",
            len(tail), task, path, "".join(tail).rstrip(),
        )


def _log_run_outcome(
    cluster: SliceCluster, status: str, outcomes: Dict[str, TaskOutcome]
) -> None:
    """Log each task's outcome and log location; archive to MLflow."""
    logs = cluster.handle.logs()
    lines = [f"final status: {status}"]
    for task in sorted(outcomes):
        outcome = outcomes[task]
        lines.append(f"  {task}: {outcome.status}  logs: {logs.get(task, '?')}")
        if outcome.exception:
            lines.append(f"    {outcome.exception.strip().splitlines()[-1]}")
    summary = "\n".join(lines)
    _logger.info("%s", summary)
    mlflow.save_text_to_mlflow(summary, "tpu_yarn_run_outcome")


def run_on_gpu(
    experiment_fn: ExperimentFn,
    task_specs: Optional[TaskSpecs] = None,
    *,
    name: str = "gpu_yarn",
    backend: Optional[SliceBackend] = None,
    custom_task_module: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    files: Optional[Dict[str, str]] = None,
    pre_script_hook: str = "",
    env_staging_dir: Optional[str] = None,
    ship_code: Optional[bool] = None,
    requirements=None,
    wheels_dir: Optional[str] = None,
    nb_retries: int = 0,
    retry_policy: Optional[RetryPolicy] = None,
    elastic_policy=None,
    poll_every_secs: float = 0.5,
    timeout_secs: Optional[float] = None,
    dead_task_secs: Optional[float] = None,
    coordinator_bind: str = "127.0.0.1",
    coordinator_advertise: Optional[str] = None,
    eval_monitor_log_thresholds: Optional[Dict[str, tuple]] = None,
) -> Optional[Metrics]:
    """Run `experiment_fn` on GPU hosts — `run_on_tpu`'s surface and
    semantics.

    `experiment_fn` is a zero-arg callable returning one of
    `experiment.EXPERIMENT_TYPES` (the worker task program trains it on
    the task's device: the card, unless ``env`` sets
    ``TPU_YARN_PLATFORM=cpu``), or, with
    ``custom_task_module="tf_yarn_tpu_torch.tasks.distributed"``, a
    function of `TaskParameters` run per local process.

    Failure handling: each failed attempt is classified (TRANSIENT /
    PREEMPTED / LOST_TASK / FATAL_USER) from the tasks' stop events.
    `nb_retries=N` grants N retries *per retryable kind* with
    decorrelated-jitter backoff (preemptions relaunch immediately;
    deterministic user errors raise at once). Pass `retry_policy` for
    explicit budgets. `timeout_secs` is ONE monotonic budget over the
    whole run, retries included. `dead_task_secs` (default: the
    ``TPU_YARN_DEAD_TASK_SECS`` env) arms the heartbeat watchdog. Task
    logs land in ``<tmp>/<name>-logs-*/<type>-<id>.log``, listed in the
    run-outcome summary.

    `elastic_policy` (an `ElasticPolicy` for the ``worker`` type, or
    ``{task_type: ElasticPolicy}``) makes a retry resize instead: a
    LOST_TASK or PREEMPTED attempt relaunches the type on its surviving
    tasks (never below ``min_workers``), another retryable failure grows
    it back to ``max_workers``; `ElasticPolicy.history` records each
    resize and ``driver/elastic_resizes_total{direction}`` counts them.

    Remote hosts (JAX client.py:532-677): with a backend whose
    ``is_remote`` is true (`SshBackend`) the coordinator binds
    ``0.0.0.0`` (unless `coordinator_bind` says otherwise) and is
    advertised at `coordinator_advertise` (``host`` or ``host:port``),
    else at this machine's routable address. The project code travels to
    every worker (`ship_code` defaults to the backend's ``is_remote``):
    staged on `env_staging_dir` (a URI every worker can read: an NFS
    path, ``gs://``, ``hdfs://``) with the unpack hook prepended to
    `pre_script_hook`, else streamed over the backend's file channel.
    `requirements` (pip specs or a requirements.txt path) and
    `wheels_dir` (pre-downloaded wheels) travel with it as a wheelhouse
    that the worker installs with ``pip install --no-index`` before it
    unpickles the experiment; they need `ship_code`. Without them a
    missing import fails on the worker naming the module. A shipped
    worker builds the kernel library from the shipped sources at its
    first kernel launch.
    """
    task_specs = dict(task_specs) if task_specs else single_server_topology()
    check_topology(task_specs)
    backend = backend or LocalBackend()
    if getattr(backend, "is_remote", True) and coordinator_bind == "127.0.0.1":
        # Remote tasks must be able to dial in: listen on every interface
        # and advertise a routable address.
        coordinator_bind = "0.0.0.0"
    env = dict(env or {})
    files = dict(files or {})
    if ship_code is None:
        ship_code = getattr(backend, "is_remote", True)
    if (requirements is not None or wheels_dir is not None) and not ship_code:
        raise ValueError(
            "requirements=/wheels_dir= travel with the shipped env; "
            "they have no effect with ship_code=False"
        )
    if ship_code:
        from tf_yarn_tpu_torch import packaging

        if env_staging_dir is not None:
            ship_hook = packaging.ship_env(
                env_staging_dir, requirements=requirements,
                wheels_dir=wheels_dir,
                # Install wheels under the interpreter that runs the task,
                # so pip's compatibility tags match it.
                python=getattr(backend, "python", None) or "python3",
            )
            pre_script_hook = (
                f"{ship_hook} && {pre_script_hook}" if pre_script_hook
                else ship_hook
            )
        else:
            ship_entries = packaging.ship_files(
                requirements=requirements, wheels_dir=wheels_dir)
            for ship_name, ship_src in ship_entries.items():
                files.setdefault(ship_name, ship_src)
    try:
        serialized_fn = dumps_fn(experiment_fn)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise TypeError(
            f"experiment_fn {experiment_fn!r} cannot be sent to the tasks "
            f"({exc}); without cloudpickle the tasks import it by name: "
            "define it at module level and pass "
            "get_safe_experiment_fn('package.module.fn')"
        ) from exc

    policy = retry_policy or RetryPolicy.from_nb_retries(nb_retries)
    elastic_policies = _normalize_elastic(elastic_policy, task_specs)
    current_counts = {
        task_type: task_specs[task_type].instances
        for task_type in elastic_policies
    }
    # ONE monotonic budget for the whole run: created before the first
    # attempt, never recomputed.
    deadline = Deadline.after(timeout_secs)
    if dead_task_secs is None:
        dead_task_secs = resilience.dead_task_secs_from_env()

    n_try = 0
    while True:
        cluster: Optional[SliceCluster] = None
        try:
            cluster = _setup_cluster(
                task_specs,
                backend,
                n_try,
                env,
                custom_task_module,
                pre_script_hook,
                name,
                coordinator_bind,
                files,
                coordinator_advertise,
            )
            return _execute_and_await_termination(
                cluster,
                serialized_fn,
                n_try,
                poll_every_secs,
                eval_monitor_log_thresholds,
                deadline,
                dead_task_secs,
            )
        except KeyboardInterrupt:
            _shutdown_on_exception(cluster, KILLED)
            raise
        except Exception as exc:
            _shutdown_on_exception(cluster, FAILED)
            kind = (
                exc.kind
                if isinstance(exc, RunFailed) and exc.kind is not None
                # Driver-side failures (cluster setup, coordination):
                # classified from the exception itself.
                else resilience.classify_exception(exc)
            )
            delay = policy.next_delay(kind)
            if delay is None:
                _logger.error(
                    "attempt %d failed (%s); not retrying (budget for "
                    "%s: %d, spent: %d)", n_try, kind.value, kind.value,
                    policy.budgets.get(kind, 0), policy.spent(kind),
                )
                raise
            if deadline is not None and deadline.remaining() <= delay:
                _logger.error(
                    "attempt %d failed (%s) but the global %.0fs budget "
                    "is exhausted; not retrying", n_try, kind.value,
                    deadline.seconds,
                )
                raise
            _logger.exception(
                "run attempt %d failed (%s); retrying in %.1fs",
                n_try, kind.value, delay,
            )
            telemetry.get_registry().counter(
                "driver/retries_total", kind=kind.value
            ).inc()
            _note_lost_to_backend(backend, exc)
            for task_type, type_policy in elastic_policies.items():
                # Resize-not-retry: a capacity failure relaunches the
                # elastic task types on the surviving hosts instead of
                # blocking on full capacity; any other retryable failure
                # is the moment to grow back. Each elastic type resizes
                # independently — a lost serving replica must not shrink
                # the worker pool.
                lost_count = sum(
                    1
                    for task in getattr(exc, "lost_tasks", None) or []
                    if task.split(":", 1)[0] == task_type
                )
                new_count = type_policy.plan_resize(
                    kind, current_counts[task_type], lost_tasks=lost_count
                )
                if new_count is None:
                    continue
                direction = (
                    "shrink" if new_count < current_counts[task_type]
                    else "grow"
                )
                _logger.warning(
                    "elastic resize (%s): relaunching with %d %s tasks "
                    "(was %d) after %s",
                    direction, new_count, task_type,
                    current_counts[task_type], kind.value,
                )
                telemetry.get_registry().counter(
                    "driver/elastic_resizes_total", direction=direction
                ).inc()
                current_counts[task_type] = new_count
                task_specs = dict(task_specs)
                task_specs[task_type] = replace(
                    task_specs[task_type], instances=new_count
                )
                env = dict(env)
                count_var, max_var = constants.elastic_env_vars(task_type)
                env[count_var] = str(new_count)
                env[max_var] = str(type_policy.max_workers)
            if delay:
                time.sleep(delay)
            n_try += 1
            continue
        finally:
            if cluster is not None:
                try:
                    cluster.server.stop()
                except Exception:  # best-effort teardown
                    _logger.debug("coordination server stop failed",
                                  exc_info=True)


def _normalize_elastic(
    elastic_policy, task_specs
) -> Dict[str, ElasticPolicy]:
    """The elastic band(s) as ``{task_type: ElasticPolicy}``, validated
    against the topology (JAX client.py:775-817). A bare policy resizes
    the ``worker`` type; a dict makes any task type elastic (``serving``
    or ``rank`` replica pools). Raises ValueError on a type missing
    from the topology or an initial count outside its band."""
    if elastic_policy is None:
        return {}
    if isinstance(elastic_policy, ElasticPolicy):
        policies = {"worker": elastic_policy}
    elif isinstance(elastic_policy, dict):
        policies = dict(elastic_policy)
    else:
        raise ValueError(
            "elastic_policy must be an ElasticPolicy or a "
            f"{{task_type: ElasticPolicy}} dict, got {elastic_policy!r}"
        )
    for task_type, type_policy in policies.items():
        if not isinstance(type_policy, ElasticPolicy):
            raise ValueError(
                f"elastic_policy[{task_type!r}] must be an ElasticPolicy, "
                f"got {type_policy!r}"
            )
        if task_type not in task_specs \
                or task_specs[task_type].instances < 1:
            raise ValueError(
                f"elastic_policy resizes the {task_type!r} task type; "
                f"the topology needs a {task_type!r} spec with instances "
                ">= 1 (chief and side-cars are never resized)"
            )
        count = task_specs[task_type].instances
        if not (
            type_policy.min_workers <= count <= type_policy.max_workers
        ):
            raise ValueError(
                f"initial {task_type} count {count} outside the "
                f"elastic band [{type_policy.min_workers}, "
                f"{type_policy.max_workers}]"
            )
    return policies


def _note_lost_to_backend(backend, exc: Exception) -> None:
    """Feed the failed attempt's lost tasks (SIGKILLed or heartbeat-
    silent, carried on RunFailed.lost_tasks) back to the backend before
    the relaunch, so `SshBackend` keeps the dead machines out of the next
    attempt (JAX client.py:820-833). Best-effort: placement hygiene must
    never turn a retryable failure fatal."""
    lost = getattr(exc, "lost_tasks", None) or []
    if not lost:
        return
    try:
        backend.note_lost_tasks(list(lost))
    except Exception:  # diagnostics only
        _logger.exception("backend.note_lost_tasks failed; continuing")


def _shutdown_on_exception(cluster: Optional[SliceCluster], status: str) -> None:
    """Kill outstanding tasks on driver exception / Ctrl-C."""
    if cluster is None:
        return
    try:
        if cluster.handle.status() == RUNNING:
            _logger.warning("shutting down run as %s", status)
            cluster.handle.kill()
    except Exception:  # best-effort teardown
        _logger.exception("error during shutdown")


def _load_and_call(module_name: str, fn_name: str, *args):
    module = importlib.import_module(module_name)
    return getattr(module, fn_name)(*args)


def get_safe_experiment_fn(full_fn_name: str, *args) -> ExperimentFn:
    """Reference the experiment function by module path, so the pickle
    holds no driver-side objects and the stdlib pickle can send it: a
    `functools.partial` of a module-level loader. ``args`` are passed to
    the function and must pickle too."""
    module_name, _, fn_name = full_fn_name.rpartition(".")
    if not module_name:
        raise ValueError(
            f"expected 'package.module.function', got {full_fn_name!r}"
        )
    return partial(_load_and_call, module_name, fn_name, *args)
