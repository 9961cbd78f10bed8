"""Backends: how task programs get placed onto machines — counterpart of
tf_yarn_tpu/backends.py.

A backend receives fully-resolved :class:`ServiceSpec`s (module to run,
instance count, env, files) and returns a :class:`ClusterHandle` the
driver polls.

* :class:`LocalBackend` — every task instance is a subprocess on this
  host (``python -m <module>``, the driver's environment plus the
  spec's, the spec's `files` copied into the task's working directory).
  It serves single-host GPU runs and the real-process test harness: no
  mocks, actual processes coordinating through the actual KV service.

The JAX package's `SshBackend` (backends.py:260), one task runner a
machine over ssh that blacklists the hosts `note_lost_tasks` names, is
not ported yet (ROADMAP.md Queue 1 item 5.4).
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import sys
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tf_yarn_tpu_torch import constants
from tf_yarn_tpu_torch.topologies import TaskKey

_logger = logging.getLogger(__name__)

# Final statuses, mirroring YARN's (reference: client.py:557-599 polls
# `application_report.final_status` in {"succeeded","failed","killed"}).
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
KILLED = "KILLED"

# Side-cars don't gate run completion: the reference's evaluator and
# tensorboard self-terminate after the training tasks stop
# (evaluator_task.py:21-35, _tensorboard_task.py:54-58). Serving tasks
# ARE primary: a crashed server fails (and relaunches) the run — and so
# are ranking replicas and the fleet router, the one endpoint every
# client dials.
PRIMARY_TASK_TYPES = (
    "chief", "worker", "serving", "rank", "router", "prefill",
)


@dataclass
class ServiceSpec:
    """One task type's launch recipe (the skein.Service analog)."""

    module: str
    instances: int
    env: Dict[str, str] = field(default_factory=dict)
    nb_proc: int = 1
    pre_script_hook: str = ""
    # Extra files shipped into each task's working directory, name -> local
    # path (the reference's `files` upload, client.py:337-344).
    files: Dict[str, str] = field(default_factory=dict)


class ClusterHandle(ABC):
    """A launched set of task programs the driver can poll / kill."""

    @abstractmethod
    def status(self) -> str:
        """RUNNING until all primary tasks exit, then SUCCEEDED/FAILED."""

    @abstractmethod
    def tasks(self) -> List[TaskKey]:
        ...

    @abstractmethod
    def kill(self) -> None:
        ...

    @abstractmethod
    def logs(self) -> Dict[str, str]:
        """task "type:id" -> log location (file path or URL)."""

    def side_cars(self) -> List[TaskKey]:
        """Side-car tasks (evaluator, tensorboard) still running."""
        return []

    def stop_side_cars(self) -> None:
        """Terminate the side-cars still running."""


class SliceBackend(ABC):
    @abstractmethod
    def launch(
        self, services: Dict[str, ServiceSpec], log_dir: str
    ) -> ClusterHandle:
        ...

    def note_lost_tasks(self, tasks: List[str]) -> None:
        """Driver feedback after a failed attempt: these "type:id" tasks
        died without a lifecycle close (SIGKILLed host, heartbeat-silent
        past the watchdog). A backend that maps tasks onto real machines
        uses it to keep the dead machine out of the NEXT launch — an
        elastic shrink that re-places a task on the host that just
        vanished would lose it again at once. Default: no-op
        (LocalBackend's subprocesses share one host)."""


def _terminate(procs) -> None:
    """SIGTERM each running process, then SIGKILL what outlives 10 s."""
    procs = list(procs)
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


class _LocalHandle(ClusterHandle):
    def __init__(
        self,
        procs: Dict[TaskKey, subprocess.Popen],
        log_files: Dict[TaskKey, str],
    ) -> None:
        self._procs = procs
        self._log_files = log_files
        self._killed = False

    def status(self) -> str:
        primary = [
            (key, proc)
            for key, proc in self._procs.items()
            if key.type in PRIMARY_TASK_TYPES
        ]
        if not primary:  # side-car-only app: gate on everything
            primary = list(self._procs.items())
        if any(proc.poll() is None for _, proc in primary):
            return RUNNING
        if self._killed:
            return KILLED
        if all(proc.returncode == 0 for _, proc in primary):
            return SUCCEEDED
        return FAILED

    def tasks(self) -> List[TaskKey]:
        return list(self._procs)

    def kill(self) -> None:
        self._killed = True
        _terminate(self._procs.values())

    def side_cars(self) -> List[TaskKey]:
        return [key for key, proc in self._procs.items()
                if key.type not in PRIMARY_TASK_TYPES and proc.poll() is None]

    def stop_side_cars(self) -> None:
        _terminate(proc for key, proc in self._procs.items()
                   if key.type not in PRIMARY_TASK_TYPES)

    def logs(self) -> Dict[str, str]:
        return {key.to_kv_str(): path for key, path in self._log_files.items()}


class LocalBackend(SliceBackend):
    """Run every task instance as a local subprocess.

    The per-task command is ``python -m <module>`` with identity/coordinator
    env vars — the same contract `_env.gen_task_module` defines for every
    backend (reference container command: _env.py:10-24).
    """

    def __init__(self, python: Optional[str] = None) -> None:
        self._python = python or sys.executable

    def launch(
        self, services: Dict[str, ServiceSpec], log_dir: str
    ) -> _LocalHandle:
        os.makedirs(log_dir, exist_ok=True)
        procs: Dict[TaskKey, subprocess.Popen] = {}
        log_files: Dict[TaskKey, str] = {}
        for task_type, spec in services.items():
            for task_id in range(spec.instances):
                key = TaskKey(task_type, task_id)
                env = dict(os.environ)
                env.update(spec.env)
                env[constants.ENV_TASK_KEY] = key.to_kv_str()
                workdir = None
                if spec.files:
                    # Each task gets a working dir with the shipped files
                    # (container-cwd semantics of the reference's uploads).
                    import shutil

                    workdir = os.path.join(
                        log_dir, f"{task_type}-{task_id}-files"
                    )
                    os.makedirs(workdir, exist_ok=True)
                    ignore = shutil.ignore_patterns(
                        "__pycache__", "*.pyc", ".git", ".pytest_cache",
                        "node_modules",
                    )
                    for name, src in spec.files.items():
                        dst = os.path.join(workdir, name)
                        os.makedirs(os.path.dirname(dst), exist_ok=True)
                        if os.path.isdir(src):
                            shutil.copytree(
                                src, dst, dirs_exist_ok=True, ignore=ignore
                            )
                        else:
                            shutil.copy(src, dst)
                    # cwd moves to the workdir; keep the driver's cwd
                    # importable (python -m relied on it for source
                    # checkouts where the package isn't installed).
                    env["PYTHONPATH"] = (
                        os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
                    )
                log_path = os.path.join(log_dir, f"{task_type}-{task_id}.log")
                log_files[key] = log_path
                log_file = open(log_path, "wb")
                cmd = [self._python, "-m", spec.module]
                if spec.pre_script_hook:
                    shell = f"{spec.pre_script_hook}; exec {shlex.join(cmd)}"
                    procs[key] = subprocess.Popen(
                        ["/bin/sh", "-c", shell],
                        env=env,
                        cwd=workdir,
                        stdout=log_file,
                        stderr=subprocess.STDOUT,
                    )
                else:
                    procs[key] = subprocess.Popen(
                        cmd,
                        env=env,
                        cwd=workdir,
                        stdout=log_file,
                        stderr=subprocess.STDOUT,
                    )
                log_file.close()
                _logger.info("launched %s as pid %d", key, procs[key].pid)
        return _LocalHandle(procs, log_files)
