"""`run_on_gpu` against `run_on_tpu` on real task processes: the same
function of rank through each package's `tasks.distributed` program,
LocalBackend and KV server. The functions are closures, so cloudpickle
sends them by value and the task needs no test module."""

import json
import os

import pytest

from tf_yarn_tpu.client import RunFailed as JRunFailed
from tf_yarn_tpu.client import run_on_tpu
from tf_yarn_tpu.topologies import TaskSpec as JTaskSpec
from tf_yarn_tpu_torch.client import RunFailed as TRunFailed
from tf_yarn_tpu_torch.client import run_on_gpu
from tf_yarn_tpu_torch.resilience import FailureKind
from tf_yarn_tpu_torch.topologies import TaskSpec as TTaskSpec

SIDES = {
    "jax": (run_on_tpu, JTaskSpec, JRunFailed, "tf_yarn_tpu.tasks.distributed"),
    "port": (run_on_gpu, TTaskSpec, TRunFailed,
             "tf_yarn_tpu_torch.tasks.distributed"),
}


def _run(side, experiment_fn, instances=1, nb_proc=1, **kwargs):
    run, spec, _, module = SIDES[side]
    return run(experiment_fn,
               {"worker": spec(instances=instances, nb_proc_per_worker=nb_proc)},
               custom_task_module=module, poll_every_secs=0.2, **kwargs)


def _params_writer(out_dir):
    def experiment_fn():
        def run(params):
            import json
            import os
            import sys

            record = dict(params._asdict())
            record["foreign_modules"] = sorted(
                name for name in ("jax", "flax", "tf_yarn_tpu")
                if name in sys.modules)
            record["n_try"] = os.environ["TPU_YARN_N_TRY"]
            with open(os.path.join(out_dir, f"rank-{params.rank}"), "w") as fh:
                json.dump(record, fh)

        return run

    return experiment_fn


def _records(out_dir):
    return [json.load(open(os.path.join(out_dir, name)))
            for name in sorted(os.listdir(out_dir))]


def test_two_hosts_two_processes_give_the_task_parameters_of_jax(tmp_path):
    """2 hosts x 2 processes: the same TaskParameters (ports aside) and
    Metrics of the same shape; the port's task processes hold no JAX."""
    got = {}
    for side in SIDES:
        out = tmp_path / side
        out.mkdir()
        metrics = _run(side, _params_writer(str(out)), instances=2, nb_proc=2)
        records = _records(str(out))
        got[side] = (
            [{k: v for k, v in r.items()
              if k not in ("master_port", "foreign_modules")} for r in records],
            sorted(metrics.container_duration),
            metrics.total_training_duration is not None,
        )
        if side == "port":
            assert all(r["foreign_modules"] == [] for r in records)
            assert len({r["master_port"] for r in records}) == 1
    assert got["port"] == got["jax"]
    assert [r["rank"] for r in got["port"][0]] == [0, 1, 2, 3]
    assert got["port"][1] == ["worker:0", "worker:1"]


def _gloo_all_reduce(out_dir):
    def experiment_fn():
        def run(params):
            import json
            import os

            import torch
            import torch.distributed as dist

            dist.init_process_group(
                "gloo", rank=params.rank, world_size=params.world_size,
                init_method=f"tcp://{params.master_addr}:{params.master_port}")
            try:
                x = torch.full((4,), float(params.rank + 1))
                dist.all_reduce(x)
            finally:
                dist.destroy_process_group()
            with open(os.path.join(out_dir, f"rank-{params.rank}"), "w") as fh:
                json.dump({"rank": params.rank, "result": x.tolist()}, fh)

        return run

    return experiment_fn


def test_fn_of_rank_all_reduces_over_gloo_from_its_task_parameters(tmp_path):
    """2 hosts x 1 process join one gloo group from their TaskParameters
    and reduce: each rank holds 1 + 2 (the card's smoke can run only one
    NCCL rank)."""
    _run("port", _gloo_all_reduce(str(tmp_path)), instances=2)
    assert _records(str(tmp_path)) == [
        {"rank": 0, "result": [3.0] * 4}, {"rank": 1, "result": [3.0] * 4}]


def _raising():
    def experiment_fn():
        def run(params):
            if params.rank == 0:
                raise ValueError("injected failure on rank 0")

        return run

    return experiment_fn


def test_a_raising_fn_fails_fatal_user_as_in_jax():
    kinds = {}
    for side, (_, _, run_failed, _) in SIDES.items():
        with pytest.raises(run_failed) as err:
            _run(side, _raising(), instances=2)
        assert "worker:0" in str(err.value)
        assert "injected failure on rank 0" in str(err.value)
        kinds[side] = err.value.kind.value
    assert kinds["port"] == kinds["jax"] == FailureKind.FATAL_USER.value


def _flaky(out_dir):
    def experiment_fn():
        def run(params):
            import os

            n_try = os.environ["TPU_YARN_N_TRY"]
            if n_try == "0":
                raise RuntimeError("flaky first attempt")
            with open(os.path.join(out_dir, f"done-{n_try}"), "w"):
                pass

        return run

    return experiment_fn


def test_a_fn_failing_on_try_0_succeeds_on_try_1_as_in_jax(tmp_path):
    done = {}
    for side in SIDES:
        out = tmp_path / side
        out.mkdir()
        metrics = _run(side, _flaky(str(out)), nb_retries=1)
        assert metrics is not None
        done[side] = sorted(os.listdir(out))
    assert done["port"] == done["jax"] == ["done-1"]
    # Without a retry the first attempt's TRANSIENT failure is final.
    with pytest.raises(TRunFailed) as err:
        _run("port", _flaky(str(tmp_path)))
    assert err.value.kind is FailureKind.TRANSIENT


def _shipped_reader(out_dir):
    def experiment_fn():
        def run(params):
            import json
            import os

            with open(os.path.join("data", "shipped.txt")) as fh:
                shipped = fh.read()
            with open(os.path.join(out_dir, f"rank-{params.rank}"), "w") as fh:
                json.dump({"shipped": shipped,
                           "hook": os.environ.get("HOOK_SEEN")}, fh)

        return run

    return experiment_fn


def test_files_and_the_pre_script_hook_reach_the_task_as_in_jax(tmp_path):
    """`files` lands in the task's working directory under its name, and
    `pre_script_hook` runs in the task's shell before the program."""
    src = tmp_path / "src.txt"
    src.write_text("shipped by the driver")
    got = {}
    for side in SIDES:
        out = tmp_path / side
        out.mkdir()
        _run(side, _shipped_reader(str(out)),
             files={"data/shipped.txt": str(src)},
             pre_script_hook="export HOOK_SEEN=yes")
        got[side] = _records(str(out))
    assert got["port"] == got["jax"] == [
        {"shipped": "shipped by the driver", "hook": "yes"}]


def _wedged(started_dir):
    """A fn that parks until SIGTERM (the preemption flag) or 60 s."""

    def experiment_fn():
        def run(params):
            import os
            import time

            from tf_yarn_tpu_torch import preemption

            open(os.path.join(started_dir, "started"), "w").close()
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60 and not preemption.requested():
                time.sleep(0.1)

        return run

    return experiment_fn


def test_the_watchdog_declares_a_wedged_task_lost(tmp_path):
    """One beat at start-up, then silence: the heartbeat watchdog fails
    the attempt as LOST_TASK within seconds, not at the deadline."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TRunFailed) as err:
        _run("port", _wedged(str(tmp_path)),
             env={"TPU_YARN_HEARTBEAT_SECS": "3600"}, dead_task_secs=2.0,
             timeout_secs=45)
    assert err.value.kind is FailureKind.LOST_TASK
    assert "heartbeat-silent" in str(err.value)
    assert err.value.lost_tasks == ["worker:0"]
    assert os.listdir(tmp_path) == ["started"]
    assert time.monotonic() - t0 < 30
