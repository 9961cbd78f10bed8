"""`run_on_gpu` over `SshBackend`, the JAX package's
tests/test_ssh_integration.py on the port: ssh is a local shim (no sshd)
that gives each host a HOME of its own, starts the remote shell there and
drops the caller's PYTHONPATH, so a worker is a bare interpreter — torch
in site-packages, no tf_yarn_tpu_torch until shipping lands it. Files
shipped per task, code shipped over the channel and through a staging
dir, requirements over both, a missing dependency failing fast, a failure
propagating as RunFailed, and the dead-host blacklist placing an elastic
relaunch on the survivors."""

import os
import signal
import sys
from pathlib import Path

import pytest

from tests._wheels import make_wheel
from tf_yarn_tpu_torch import resilience
from tf_yarn_tpu_torch.backends import GpuHost, SshBackend
from tf_yarn_tpu_torch.client import RunFailed, run_on_gpu
from tf_yarn_tpu_torch.topologies import TaskSpec

REPO = Path(__file__).resolve().parents[1]
DISTRIBUTED = "tf_yarn_tpu_torch.tasks.distributed"

_SHIM = '''#!{python} -S
"""ssh stand-in: `shim <host> <command>` runs the command in /bin/sh with
HOME={base}/<host>, from there, without the caller's PYTHONPATH; SIGTERM
reaches the command's whole process group."""
import os, signal, subprocess, sys

host, command = sys.argv[1], sys.argv[2]
home = os.path.join({base!r}, host)
os.makedirs(home, exist_ok=True)
env = {{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}}
env["HOME"] = home
proc = subprocess.Popen(["/bin/sh", "-c", command], cwd=home, env=env,
                        start_new_session=True)
for sig in (signal.SIGTERM, signal.SIGINT):
    signal.signal(sig, lambda s, f: os.killpg(proc.pid, s))
code = proc.wait()
sys.exit(128 - code if code < 0 else code)
'''


def _shim(tmp_path):
    """The shim's path and the directory holding each host's HOME."""
    base = tmp_path / "hosts"
    base.mkdir()
    shim = tmp_path / "fake_ssh"
    shim.write_text(_SHIM.format(python=sys.executable, base=str(base)))
    shim.chmod(0o755)
    return str(shim), base


def _backend(shim, n_hosts, **kwargs):
    return SshBackend(hosts=[GpuHost(f"vm-{i}", i) for i in range(n_hosts)],
                      python=sys.executable, ssh_cmd=[shim], **kwargs)


def _run(fn, backend, instances=1, **kwargs):
    return run_on_gpu(fn, {"worker": TaskSpec(instances=instances)},
                      backend=backend, custom_task_module=DISTRIBUTED,
                      coordinator_advertise="127.0.0.1", poll_every_secs=0.2,
                      timeout_secs=180, **kwargs)


def _check_payload_experiment():
    def run(params):
        with open("payload/data.txt") as fh:
            content = fh.read()
        assert content == "shipped", content
    return run


def test_run_on_gpu_over_ssh_with_files(tmp_path):
    """files= ride the ssh channel into each task's own workdir, which is
    the task's cwd and on its PYTHONPATH (with the pre-provisioned
    `remote_prefix`)."""
    shim, base = _shim(tmp_path)
    payload = tmp_path / "data.txt"
    payload.write_text("shipped")
    metrics = _run(
        _check_payload_experiment, _backend(shim, 2, remote_prefix=str(REPO)),
        instances=2, ship_code=False,
        files={"payload/data.txt": str(payload),
               "test_torch_ssh.py": __file__})
    assert set(metrics.container_duration) == {"worker:0", "worker:1"}
    shipped = sorted((p.parents[4].name, p.parent.parent.name)
                     for p in base.rglob("payload/data.txt"))
    assert shipped == [("vm-0", "worker-0"), ("vm-1", "worker-1")]


def _shipped_code_experiment_fn(out: str):
    """An experiment closure made inside a call, so cloudpickle sends it by
    value (this test module is not importable on the bare worker). Its fn
    writes where the worker imported the port from, and the worker's
    HOME."""

    def experiment_fn():
        def run(params):
            import json
            import os as _os

            import tf_yarn_tpu_torch as pkg

            with open(_os.path.join(out, f"rank-{params.rank}.json"),
                      "w") as fh:
                json.dump({"package": _os.path.abspath(pkg.__file__),
                           "home": _os.environ["HOME"],
                           "deppkg": _deppkg()}, fh)
        return run

    def _deppkg():
        try:
            import deppkg
        except ImportError:
            return None
        return [deppkg.VALUE, deppkg.__file__]

    return experiment_fn


def _records(out, n):
    import json

    return [json.loads((out / f"rank-{rank}.json").read_text())
            for rank in range(n)]


@pytest.mark.parametrize("channel", ["files", "staging"])
def test_code_and_requirements_ship_to_bare_workers(channel, tmp_path):
    """No remote_prefix and nothing pre-provisioned: the port travels over
    the ssh channel (`packaging.ship_files`) or through a staging dir
    (`packaging.ship_env`), with a wheelhouse of `deppkg` that each worker
    installs with pip --no-index under a content-addressed `_pydeps`; the
    workers import both from the shipped copies under their own HOME."""
    shim, base = _shim(tmp_path)
    make_wheel(str(tmp_path / "dl"))
    out = tmp_path / "out"
    out.mkdir()
    staging = tmp_path / "staging"
    extra = {"env_staging_dir": str(staging)} if channel == "staging" else {}
    metrics = _run(_shipped_code_experiment_fn(str(out)), _backend(shim, 2),
                   instances=2, requirements=["deppkg"],
                   wheels_dir=str(tmp_path / "dl"), **extra)
    assert set(metrics.container_duration) == {"worker:0", "worker:1"}
    for rank, record in enumerate(_records(out, 2)):
        home = str(base / f"vm-{rank}")
        assert record["home"] == home
        assert record["package"].startswith(home + os.sep)
        value, dep_file = record["deppkg"]
        assert value == 42 and dep_file.startswith(home + os.sep)
        assert "_pydeps" in Path(dep_file).parts
    if channel == "staging":
        assert sorted(p.suffix for p in staging.iterdir()) == [".zip", ".zip"]
        assert len(list(base.rglob(".tpu_yarn_code/*/tf_yarn_tpu_torch/"
                                   "client.py"))) == 2
    else:
        assert len(list(base.rglob(".tpu_yarn_runs/*/worker-*/"
                                   "tf_yarn_tpu_torch/client.py"))) == 2


def test_missing_dep_fails_fast_naming_module(tmp_path):
    """Without a wheelhouse the worker fails at unpickle time with the
    missing module's name and the remediation."""

    def missing_dep_experiment_fn():
        import definitely_not_installed_pkg  # noqa: F401
        return None

    shim, _ = _shim(tmp_path)
    with pytest.raises(RunFailed) as excinfo:
        _run(missing_dep_experiment_fn, _backend(shim, 1))
    message = str(excinfo.value)
    assert "definitely_not_installed_pkg" in message
    assert "requirements" in message


def test_run_on_gpu_over_ssh_failure_propagates(tmp_path):
    def failing_experiment():
        def run(params):
            raise RuntimeError("boom on the far side")
        return run

    shim, _ = _shim(tmp_path)
    with pytest.raises(RunFailed, match="worker:0") as excinfo:
        _run(failing_experiment, _backend(shim, 1))
    assert "boom on the far side" in str(excinfo.value)


def _lose_worker_0_experiment_fn(out: str):
    def experiment_fn():
        def run(params):
            import os as _os

            attempt = _os.environ["TPU_YARN_N_TRY"]
            task = _os.environ["TPU_YARN_TASK"].replace(":", "-")
            with open(_os.path.join(out, f"{attempt}-{task}"), "w") as fh:
                fh.write(_os.environ["HOME"])
            if attempt == "0" and task == "worker-0":
                _os.kill(_os.getpid(), signal.SIGKILL)
        return run

    return experiment_fn


def test_blacklisted_host_is_left_out_of_the_elastic_relaunch(tmp_path):
    """Two workers on three hosts; worker:0 (on vm-0) dies in attempt 0.
    The driver classifies LOST_TASK, tells the backend, which blacklists
    vm-0, and the elastic shrink relaunches one worker on vm-1, the first
    survivor (without the blacklist it would land on vm-0 again)."""
    shim, base = _shim(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    backend = _backend(shim, 3)
    elastic = resilience.ElasticPolicy(min_workers=1, max_workers=2)
    retry = resilience.RetryPolicy.from_nb_retries(
        1, seed=0, base_backoff_secs=0.1, max_backoff_secs=0.2)
    _run(_lose_worker_0_experiment_fn(str(out)), backend, instances=2,
         ship_code=False, elastic_policy=elastic, retry_policy=retry,
         env={"PYTHONPATH": str(REPO)})
    assert backend.dead_hosts == ["vm-0"]
    assert [d.kind.value for d in retry.history] == ["LOST_TASK"]
    assert [(r.from_workers, r.to_workers) for r in elastic.history] == \
        [(2, 1)]
    ran = {p.name: p.read_text() for p in out.iterdir()}
    assert ran == {"0-worker-0": str(base / "vm-0"),
                   "0-worker-1": str(base / "vm-1"),
                   "1-worker-0": str(base / "vm-1")}
