"""Task-side bootstrap commons — counterpart of
tf_yarn_tpu/_task_commons.py: logging setup, the cluster layout and the
experiment from the KV store, task identity, ranks and world size, and
the election of a master address.

The experiment arrives pickled (`_internal.dumps_fn`: cloudpickle where
the driver has it, else the stdlib pickle by reference); `pickle.loads`
reads both, importing cloudpickle only for a payload that needs it.
Before it unpickles, a task that finds a shipped wheelhouse
(``_shipped_wheels/`` in its working directory, `packaging.ship_files`
with `requirements`) installs it with ``pip install --no-index`` into
``_pydeps/<digest>`` and puts that on its path.
"""

from __future__ import annotations

import json
import logging
import logging.config
import os
import pickle
import sys
import time
from typing import List

from tf_yarn_tpu_torch import constants, event
from tf_yarn_tpu_torch._internal import reserve_sock_addr
from tf_yarn_tpu_torch.coordination.kv import KVClient, KVStore
from tf_yarn_tpu_torch.topologies import TaskInstance, TaskKey

_logger = logging.getLogger(__name__)

MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"


def setup_logging() -> None:
    """Load the packaged log config (reference: _task_commons.py:19-23)."""
    conf = os.path.join(os.path.dirname(__file__), "default.log.conf")
    if os.path.exists(conf):
        logging.config.fileConfig(conf, disable_existing_loggers=False)
    else:  # pragma: no cover - packaged file always present
        logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _logger.info("using log conf %s", conf)


def get_task_key() -> TaskKey:
    """Identity from the env set by the backend (reference derives it from
    SKEIN_CONTAINER_ID, _task_commons.py:70-72)."""
    raw = os.environ[constants.ENV_TASK_KEY]
    return TaskKey.from_kv_str(raw)


def get_task() -> str:
    return get_task_key().to_kv_str()


def n_try() -> int:
    return int(os.environ.get(constants.ENV_N_TRY, "0"))


def get_nb_proc() -> int:
    return int(os.environ.get(constants.ENV_NB_PROC, "1"))


def connect_kv() -> KVClient:
    """Client for the run's coordination service (the analog of
    `skein.ApplicationClient.from_current()`, tf_task_common.py:24)."""
    return KVClient(os.environ[constants.ENV_COORDINATOR])


def setup_task_logs(kv: KVStore, task: str) -> None:
    """Publish start-time + log-location events (reference: _task_commons.py:26-34)."""
    event.start_time_event(kv, task)
    log_dir = os.environ.get(constants.ENV_LOG_DIR)
    if log_dir:
        event.logs_event(kv, task, os.path.join(log_dir, f"{task.replace(':', '-')}.log"))


def get_cluster_tasks(kv: KVStore, timeout: float = 300.0) -> List[TaskInstance]:
    """Cluster layout posted by the driver (reference: _task_commons.py:37-40)."""
    raw = kv.wait_str(constants.KV_CLUSTER_INSTANCES, timeout=timeout)
    return [
        TaskInstance(TaskKey.from_kv_str(t), int(nb_proc))
        for t, nb_proc in json.loads(raw)
    ]


def compute_world_size(cluster_tasks: List[TaskInstance]) -> int:
    """Total process count (reference: _task_commons.py:43-52)."""
    return sum(instance.nb_proc for instance in cluster_tasks)


def _sorted_tasks(cluster_tasks: List[TaskInstance]) -> List[TaskInstance]:
    # Chief first, then workers, each ordered by id — a deterministic global
    # order every process can compute locally (reference: _task_commons.py:111-114).
    order = {"chief": 0, "worker": 1}
    return sorted(
        cluster_tasks, key=lambda ti: (order.get(ti.key.type, 2), ti.key.id)
    )


def compute_rank(
    task_key: TaskKey, cluster_tasks: List[TaskInstance], local_rank: int = 0
) -> int:
    """Global rank of `local_rank` on this task (reference: _task_commons.py:111-114)."""
    rank = 0
    for instance in _sorted_tasks(cluster_tasks):
        if instance.key == task_key:
            return rank + local_rank
        rank += instance.nb_proc
    raise ValueError(f"{task_key} not in cluster {cluster_tasks}")


def is_chief(task_key: TaskKey, cluster_tasks: List[TaskInstance]) -> bool:
    """True for the rank-0 process owner. Worker-only topologies elect
    worker:0 (the reference KeyErrors there — SURVEY §2.6)."""
    ordered = _sorted_tasks(cluster_tasks)
    return bool(ordered) and ordered[0].key == task_key


def choose_master(
    kv: KVStore,
    task_key: TaskKey,
    cluster_tasks: List[TaskInstance],
    timeout: float = 300.0,
) -> str:
    """Elect the coordination master: the rank-0 process reserves a port and
    broadcasts ``host:port``; everyone else waits (reference:
    _task_commons.py:95-108); the address of the torch process group's
    TCPStore.

    The reservation socket closes on return, leaving a window before the
    TCPStore binds in which another process could take the port — the
    compromise the reference makes. The JAX package can hold the
    reservation across its coordinator's bind (``hold=True``) because
    that server binds with SO_REUSEPORT; torch's TCPStore does not, so
    the port has no such option.
    """
    if is_chief(task_key, cluster_tasks):
        with reserve_sock_addr() as (host, port):
            addr = f"{host}:{port}"
            event.broadcast(kv, MASTER_ADDR, addr)
    else:
        addr = event.wait(kv, MASTER_ADDR, timeout=timeout)
    host, _, port = addr.rpartition(":")
    os.environ.setdefault(MASTER_ADDR, host)
    os.environ.setdefault(MASTER_PORT, port)
    return addr


def _wheelhouse_digest(house: str) -> str:
    """Content digest of a shipped wheelhouse (sorted names + bytes),
    keying the `_pydeps/<digest>` install target below."""
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(os.listdir(house)):
        path = os.path.join(house, name)
        if not os.path.isfile(path):
            continue
        digest.update(name.encode())
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                digest.update(chunk)
    return digest.hexdigest()[:12]


def _install_shipped_wheels() -> None:
    """File-channel third-party deps (JAX _task_commons.py:181-240): a
    `_shipped_wheels/` dir in the task workdir is pip-installed
    --no-index into `_pydeps/<digest>/` and prepended to sys.path (and
    PYTHONPATH, for nb_proc_per_worker children) before the experiment
    unpickles. The target is content-addressed and a marker file vouches
    for a finished install, so a reused workdir whose wheels changed
    installs afresh and never imports stale deps."""
    import subprocess

    from tf_yarn_tpu_torch.packaging import WHEELHOUSE_MANIFEST

    house = os.path.abspath("_shipped_wheels")
    if not os.path.isdir(house):
        return
    target = os.path.abspath(
        os.path.join("_pydeps", _wheelhouse_digest(house)))
    marker = os.path.join(target, ".tpu_yarn_done")
    if not os.path.exists(marker):
        subprocess.run(
            [sys.executable, "-m", "pip", "install", "-q", "--no-index",
             "--find-links", house, "--target", target,
             "-r", os.path.join(house, WHEELHOUSE_MANIFEST)],
            check=True,
        )
        # pip does not create --target for an empty manifest.
        os.makedirs(target, exist_ok=True)
        with open(marker, "w"):
            pass
        _logger.info("installed shipped wheelhouse %s -> %s", house, target)
    if target not in sys.path:
        sys.path.insert(0, target)
    os.environ["PYTHONPATH"] = (
        target + os.pathsep + os.environ.get("PYTHONPATH", ""))


def get_experiment(kv: KVStore, timeout: float = 300.0):
    """Unpickle and call the experiment closure; failures broadcast both
    `start` and `stop` so the driver can attribute them (reference:
    _task_commons.py:55-63)."""
    task = get_task()
    try:
        _install_shipped_wheels()
        fn_bytes = kv.wait(constants.KV_EXPERIMENT_FN, timeout=timeout)
        try:
            experiment = pickle.loads(fn_bytes)()
        except ModuleNotFoundError as missing:
            # Fail fast with the dep's NAME and the remediation, not a
            # bare unpickle traceback.
            raise ModuleNotFoundError(
                f"experiment requires module {missing.name!r}, which is "
                "not installed on this worker. Ship it with "
                "run_on_gpu(requirements=[...]) (wheel channel), stage "
                "pre-downloaded wheels via wheels_dir=, or bake it into "
                "the host's image.",
                name=missing.name,
            ) from missing
    except Exception as exc:
        event.start_event(kv, task)
        event.stop_event(kv, task, exc)
        raise
    return experiment


class catchtime:
    """Timing context manager (reference: _task_commons.py:117-125)."""

    def __init__(self, message: str) -> None:
        self.message = message

    def __enter__(self) -> "catchtime":
        _logger.info("start %s", self.message)
        self.start = time.time()
        return self

    def __exit__(self, *exc_info) -> None:
        _logger.info("done %s (%.3f s)", self.message, time.time() - self.start)
