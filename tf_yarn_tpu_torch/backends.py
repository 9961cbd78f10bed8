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
* :class:`SshBackend` — one task runner a :class:`GpuHost` over ssh, the
  multi-host path (JAX backends.py:253-498): `files` tarred and streamed
  over the ssh channel into a per-run remote workdir, a dead-host
  blacklist fed by `note_lost_tasks`, and `ssh_cmd` to swap the
  transport (the tests drive it through a local shell shim).
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import sys
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
    # Whether tasks run on other machines: a remote backend's driver binds
    # the coordinator on every interface and advertises a routable
    # address, ships the code by default, and its tasks refuse a
    # host-local model_dir (client.run_on_gpu). Custom backends that
    # launch locally override it.
    is_remote = True

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

    is_remote = False

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


@dataclass
class GpuHost:
    """One worker machine reachable over ssh (`TpuVmHost` of the JAX
    package, the same fields)."""

    hostname: str
    worker_index: int


class SshBackend(SliceBackend):
    """Place one task runner a GPU host over ssh (JAX backends.py:260).

    Host *i* runs the *i*-th task instance, in the order chief, worker,
    evaluator, tensorboard (chief = host 0).

    * ``hosts=None`` discovers the hosts (`discovery.discover_gpu_hosts`:
      env override, GCE metadata, ambient env, gcloud).
    * ``files=`` on a ServiceSpec are shipped per task: tarred locally,
      streamed over the ssh channel into a per-run remote workdir
      (``$HOME/.tpu_yarn_runs/<run>/<type>-<id>``), and the task starts
      with its cwd there and the workdir on PYTHONPATH — container upload
      semantics without a shared filesystem. `remote_prefix` (a
      pre-provisioned code root) lands on PYTHONPATH too.
    * ``ssh_cmd`` swaps the transport binary — the tests drive the full
      path through a local shell shim, no sshd required.
    * A host that ran a task the driver reports lost (`note_lost_tasks`)
      is blacklisted: later launches, an elastic shrink's relaunch among
      them, place tasks on the survivors only.
    """

    is_remote = True

    def __init__(
        self,
        hosts: Optional[List[GpuHost]] = None,
        python: str = "python3",
        remote_prefix: str = "",
        ssh_options: Optional[List[str]] = None,
        ssh_cmd: Optional[List[str]] = None,
        tpu_name: Optional[str] = None,
        zone: Optional[str] = None,
    ) -> None:
        self._hosts = hosts
        self.python = python
        self._remote_prefix = remote_prefix
        self._ssh_cmd = list(ssh_cmd) if ssh_cmd else [
            "ssh", *(ssh_options or ["-o", "StrictHostKeyChecking=no"])
        ]
        self._tpu_name = tpu_name
        self._zone = zone
        # task "type:id" -> hostname of the LAST launch, and the hostnames
        # the driver reported lost.
        self._last_assignment: Dict[str, str] = {}
        self._dead_hosts: set = set()

    def note_lost_tasks(self, tasks: List[str]) -> None:
        for task in tasks:
            hostname = self._last_assignment.get(task)
            if hostname is None:
                continue
            if hostname not in self._dead_hosts:
                _logger.warning(
                    "blacklisting host %s (ran %s, reported lost); it is "
                    "excluded from later launches", hostname, task,
                )
            self._dead_hosts.add(hostname)

    @property
    def dead_hosts(self) -> List[str]:
        """The blacklisted hostnames."""
        return sorted(self._dead_hosts)

    def _resolve_hosts(self) -> List[GpuHost]:
        if self._hosts is None:
            from tf_yarn_tpu_torch.discovery import discover_gpu_hosts

            self._hosts = discover_gpu_hosts(self._tpu_name, self._zone)
        live = [host for host in self._hosts
                if host.hostname not in self._dead_hosts]
        if self._dead_hosts and not live:
            raise RuntimeError(
                f"every known host is blacklisted as dead "
                f"({sorted(self._dead_hosts)}); refusing to launch"
            )
        return live

    @staticmethod
    def _pack_files(files: Dict[str, str]) -> str:
        """Tar `name -> local path` entries into a temp archive, without
        what `packaging.zip_path` leaves out: caches, VCS trees and build
        products (a shipped worker builds its own kernel library)."""
        import tarfile
        import tempfile

        from tf_yarn_tpu_torch.packaging import _EXCLUDE_DIRS

        def _filter(info):
            parts = info.name.split("/")
            if any(p in _EXCLUDE_DIRS for p in parts) \
                    or info.name.endswith((".pyc", ".so")):
                return None
            return info

        fd, tar_path = tempfile.mkstemp(suffix=".tar.gz",
                                        prefix="tpu_yarn_files-")
        os.close(fd)
        with tarfile.open(tar_path, "w:gz") as tar:
            for name, src in files.items():
                tar.add(src, arcname=name, filter=_filter)
        return tar_path

    def _ship_files(self, hostname: str, tar_path: str, remote_dir: str) -> None:
        """Stream the tar through the ssh channel into remote_dir."""
        unpack = f"mkdir -p {remote_dir} && tar xzf - -C {remote_dir}"
        with open(tar_path, "rb") as tar_file:
            result = subprocess.run(
                [*self._ssh_cmd, hostname, unpack],
                stdin=tar_file,
                capture_output=True,
            )
        if result.returncode != 0:
            raise RuntimeError(
                f"shipping files to {hostname} failed: "
                f"{result.stderr.decode(errors='replace').strip()}"
            )

    @staticmethod
    def _dq_escape(value: str) -> str:
        """Escape for interpolation inside a double-quoted shell string
        (so `$PWD`-style parts added on purpose still expand)."""
        for ch in ("\\", '"', "$", "`"):
            value = value.replace(ch, "\\" + ch)
        return value

    def launch(
        self, services: Dict[str, ServiceSpec], log_dir: str
    ) -> _LocalHandle:
        import re
        from concurrent.futures import ThreadPoolExecutor

        os.makedirs(log_dir, exist_ok=True)
        hosts = self._resolve_hosts()
        # The run id lands in remote shell commands: keep it shell-inert.
        run_id = re.sub(r"[^A-Za-z0-9._-]", "_",
                        os.path.basename(os.path.normpath(log_dir)))
        assignments: List[Tuple[TaskKey, ServiceSpec]] = []
        for task_type in ("chief", "worker", "evaluator", "tensorboard"):
            spec = services.get(task_type)
            if spec is None:
                continue
            for task_id in range(spec.instances):
                assignments.append((TaskKey(task_type, task_id), spec))
        if len(assignments) > len(hosts):
            raise ValueError(
                f"{len(assignments)} task instances > {len(hosts)} hosts")
        tar_cache: Dict[int, str] = {}
        procs: Dict[TaskKey, subprocess.Popen] = {}
        log_files: Dict[TaskKey, str] = {}
        # A fresh task -> host map each launch: note_lost_tasks consults
        # the LAST placement.
        self._last_assignment = {
            key.to_kv_str(): host.hostname
            for host, (key, _spec) in zip(hosts, assignments)
        }
        try:
            # Ship files to every host first, concurrently.
            remote_dirs: Dict[TaskKey, str] = {}
            ship_jobs = []
            for host, (key, spec) in zip(hosts, assignments):
                if not spec.files:
                    continue
                if id(spec) not in tar_cache:
                    tar_cache[id(spec)] = self._pack_files(spec.files)
                remote_dirs[key] = (
                    f"$HOME/.tpu_yarn_runs/{run_id}/{key.type}-{key.id}")
                ship_jobs.append(
                    (host.hostname, tar_cache[id(spec)], remote_dirs[key]))
            if ship_jobs:
                with ThreadPoolExecutor(
                        max_workers=min(16, len(ship_jobs))) as pool:
                    for future in [pool.submit(self._ship_files, *job)
                                   for job in ship_jobs]:
                        future.result()

            for host, (key, spec) in zip(hosts, assignments):
                workdir_prefix = ""
                pythonpath_parts = []
                if self._remote_prefix:
                    pythonpath_parts.append(self._dq_escape(self._remote_prefix))
                if spec.files:
                    workdir_prefix = f"cd {remote_dirs[key]} && "
                    pythonpath_parts.append("$PWD")
                elif self._remote_prefix:
                    workdir_prefix = f"cd {shlex.quote(self._remote_prefix)} && "
                task_env = {**spec.env, constants.ENV_TASK_KEY: key.to_kv_str()}
                # PYTHONPATH merges (as LocalBackend's does) instead of the
                # last `env` assignment winning.
                caller_pythonpath = task_env.pop("PYTHONPATH", "")
                if caller_pythonpath:
                    pythonpath_parts.append(self._dq_escape(caller_pythonpath))
                env_exports = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in task_env.items())
                if pythonpath_parts:
                    # Double-quoted on purpose: $PWD/$PYTHONPATH expand in
                    # the remote shell; literal parts are escaped above.
                    env_exports += (
                        f' PYTHONPATH="{":".join(pythonpath_parts)}:$PYTHONPATH"')
                hook = f"{spec.pre_script_hook}; " if spec.pre_script_hook else ""
                remote_cmd = (f"{workdir_prefix}{hook}env {env_exports} "
                              f"{self.python} -m {spec.module}")
                log_path = os.path.join(log_dir, f"{key.type}-{key.id}.log")
                log_files[key] = log_path
                with open(log_path, "wb") as log_file:
                    procs[key] = subprocess.Popen(
                        [*self._ssh_cmd, host.hostname, remote_cmd],
                        stdout=log_file, stderr=subprocess.STDOUT)
                _logger.info("launched %s on %s", key, host.hostname)
        except Exception:
            # Don't leak half a cluster: reap anything already started.
            for key, proc in procs.items():
                if proc.poll() is None:
                    _logger.warning("killing partially-launched %s", key)
            _terminate(procs.values())
            raise
        finally:
            for tar_path in tar_cache.values():
                try:
                    os.unlink(tar_path)
                except OSError:
                    pass
        return _LocalHandle(procs, log_files)
