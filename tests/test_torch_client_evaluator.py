"""The side-car task programs launched by `run_on_gpu` on the CPU: a
worker beside an evaluator and a tensorboard task, two data-parallel
ranks, the same two ranks drained by one rank's preemption flag,
relaunched and resumed, and two pytorch workers — `chip_smoke.py` phase
9 rehearsed at the tiny f32 BERT (``TPU_YARN_PLATFORM=cpu``) — and
the driver's side of the side-cars held against the JAX package: their
environment, the evaluator's health log, the tensorboard task's linger
and URL, and the barrier on training's end.
"""

import json
import logging
import os
import re
import threading

import pytest
import torch

from tf_yarn_tpu import client as j_client
from tf_yarn_tpu import topologies as j_topo
from tf_yarn_tpu.coordination import kv as j_kv
from tf_yarn_tpu.utils import evaluator_metrics as j_evaluator_metrics
from tf_yarn_tpu.utils import tensorboard_utils as j_tb
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import event as t_event
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import topologies as t_topo
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.coordination import kv as t_kv
from tf_yarn_tpu_torch.tasks import _bootstrap as t_bootstrap
from tf_yarn_tpu_torch.utils import evaluator_metrics as t_evaluator_metrics
from tf_yarn_tpu_torch.utils import tensorboard_utils as t_tb

CPU = {"TPU_YARN_PLATFORM": "cpu"}


@pytest.fixture(scope="module")
def phase9():
    """chip_smoke.launcher_slice at the tiny f32 BERT on the CPU, its
    losses and launches held to the same experiment trained in process.
    The conftest's TPU_YARN_PLATFORM=cpu is taken out for the launches:
    part (b) needs a task that sees no card and no CPU setting."""
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        t_training.train_and_evaluate(t_experiment.as_core_experiment(
            chip_smoke.launcher_bert_experiment(tmp, tiny=True)),
            device="cpu")
        with open(os.path.join(tmp, chip_smoke.LAUNCHER_COUNTS)) as fh:
            reference = json.load(fh)
    platform = os.environ.pop("TPU_YARN_PLATFORM", None)
    try:
        result = chip_smoke.launcher_slice(
            torch, t_client, t_topo, reference["losses"],
            reference["launches"], tiny=True, env=CPU)
    finally:
        if platform is not None:
            os.environ["TPU_YARN_PLATFORM"] = platform
    return reference, result


def test_worker_trains_beside_the_evaluator_and_tensorboard(phase9):
    """Part (a): the worker's losses are the in-process run's, in chunks
    of 2 steps; the evaluator evaluated ckpt-2 and ckpt-4, the last
    equal to the worker's final eval, and published its health keys;
    the tensorboard task ran to its end (this image's tensorboard cannot
    serve: no URL) and the worker wrote its ``tb/`` events."""
    reference, result = phase9
    trained = result["a_train"]
    assert trained["losses"] == reference["losses"]
    assert trained["losses_bitwise_equal"]
    assert trained["steps_per_chunk"] == 2 and len(trained["chunk_s"]) == 2
    evaluator = trained["evaluator"]
    assert evaluator["markers"] == ["eval-done-2.json", "eval-done-4.json"]
    assert evaluator["max_abs_err"] == 0.0
    assert evaluator["device"] == "cpu"
    assert evaluator["health"]["last_training_step"] == "4"
    assert evaluator["health"]["nb_eval_steps"] == "4"
    assert trained["tensorboard"]["events"]
    # The worker's checkpoints went through the async writer: the
    # registry it flushed at its last log step holds ckpt-2's submit.
    ops = {re.search(r"\{op=(\w+)\}", key).group(1)
           for key in trained["checkpoint_seconds"]}
    assert ops == {"save_submit"}
    assert set(result["seconds"]) == {"a_train", "b_no_card", "c_all_reduce",
                                      "e_ranks", "d_drain", "f_pytorch",
                                      "bcf_together"}


def test_two_ranks_train_data_parallel(phase9):
    """Part (e): a chief and a worker of allreduce_topology at
    MeshSpec(dp=2), each on half of the batch: gloo on the CPU, equal
    parameters (checked in the phase), rank 0 alone checkpointing, one
    gradient all-reduce timed at each step; with dropout the ranks draw
    their own masks, so the mean loss is near the one-device run's only."""
    reference, result = phase9
    ranks = result["e_ranks"]
    assert [(r["rank"], r["world"], r["backend"], r["device"])
            for r in ranks["ranks"]] == [(0, 2, "gloo", "cpu"),
                                         (1, 2, "gloo", "cpu")]
    assert ranks["checkpoint_save_submits"] == {"chief:0": 2, "worker:0": 0}
    assert ranks["params_bitwise_equal_across_ranks"]
    assert ranks["ckpt_restored_equal_rank0"]
    assert sorted(ranks["grad_allreduce_by_step"]) == [0, 1, 2, 3]
    assert all(step["buckets"] >= 1 and step["sum_s"] > 0
               for step in ranks["grad_allreduce_by_step"].values())
    assert ranks["reference_losses"] == reference["losses"]


def test_a_drained_attempt_relaunches_and_resumes(phase9):
    """Part (d), at two ranks: rank 1 alone requests the drain, both ranks
    drain at ckpt-2 and the attempt is retried as PREEMPTED; attempt 1
    resumes at step 2 and each rank's steps 3-4 give part (e)'s losses,
    bitwise."""
    _, result = phase9
    drained = result["d_drain"]
    assert drained["attempts"] == 2 and drained["preempted_retries"] == 1
    for stop in drained["attempt_0_stops"].values():
        assert "Preempted: preempted at step 2; checkpoint saved to " in stop
    assert drained["resumed_at"] == [2, 2]
    assert drained["losses"] == drained["reference_losses"]
    assert drained["losses_bitwise_equal"]


def test_two_pytorch_workers_train_bert(phase9):
    """Part (f): two pytorch workers over gloo, DDP-wrapped, each a pass
    over its DistributedSampler share; equal parameters and rank 0's
    model_ckpt save equal to them (checked in the phase)."""
    _, result = phase9
    part = result["f_pytorch"]
    assert [(w["rank"], w["backend"], w["device"]) for w in part["workers"]] \
        == [(0, "gloo", "cpu"), (1, "gloo", "cpu")]
    assert all(len(w["losses"]) == 4 for w in part["workers"])
    assert part["params_bitwise_equal_across_ranks"]
    assert part["model_ckpt_restored_equal"]


def test_no_card_and_fn_of_rank_still_hold(phase9):
    _, result = phase9
    assert result["b_no_card"]["raised"] == "RunFailed"
    assert result["c_all_reduce"]["result"] == [1.0] * 4


# -- the driver's side, held against the JAX package ---------------------------

def _envs(module, topo, specs, env):
    services = module._setup_task_env(specs, "127.0.0.1:1", "/logs", 0, env,
                                      None, "")
    return {task: dict(service.env) for task, service in services.items()}


@pytest.mark.parametrize("env", [{}, {"TPU_YARN_PLATFORM": "cuda"}])
def test_side_car_environments_match_jax(env):
    """The evaluator is placed as every port task is: on the card unless
    the caller's env says ``cpu`` (the JAX driver defaults it to the
    CPU; that is the one difference); the tensorboard task gets its
    TaskSpec's knobs."""
    def specs(topo):
        return {"worker": topo.TaskSpec(instances=1),
                "evaluator": topo.TaskSpec(instances=1),
                "tensorboard": topo.TaskSpec(
                    instances=1, tb_model_dir="/runs/x",
                    tb_extra_args="--reload_interval 1",
                    tb_termination_timeout_seconds=5)}

    got = _envs(t_client, t_topo, specs(t_topo), env)
    want = _envs(j_client, j_topo, specs(j_topo), env)
    assert want["evaluator"].get("TPU_YARN_PLATFORM") == env.get(
        "TPU_YARN_PLATFORM", "cpu")
    assert got["evaluator"].get("TPU_YARN_PLATFORM") == env.get(
        "TPU_YARN_PLATFORM")
    if not env:
        del want["evaluator"]["TPU_YARN_PLATFORM"]
    assert got == want
    assert "TPU_YARN_PLATFORM" not in got["worker"] or env
    assert got["tensorboard"]["TB_MODEL_DIR"] == "/runs/x"
    assert got["tensorboard"]["TB_TERMINATION_TIMEOUT_SECONDS"] == "5"
    default = _envs(t_client, t_topo, {"worker": t_topo.TaskSpec(),
                                       "tensorboard": t_topo.TaskSpec()}, {})
    assert default == _envs(j_client, j_topo, {
        "worker": j_topo.TaskSpec(), "tensorboard": j_topo.TaskSpec()}, {})


def test_taskspec_tensorboard_fields_match_jax():
    for name in ("tb_termination_timeout_seconds", "tb_model_dir",
                 "tb_extra_args"):
        assert getattr(t_topo.TaskSpec(), name) == getattr(
            j_topo.TaskSpec(), name)


@pytest.mark.parametrize("raw", [None, "0", "12", "-3", "soon"])
def test_tensorboard_linger_matches_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("TB_TERMINATION_TIMEOUT_SECONDS", raising=False)
    else:
        monkeypatch.setenv("TB_TERMINATION_TIMEOUT_SECONDS", raw)
    assert t_tb.get_termination_timeout() == j_tb.get_termination_timeout()
    assert t_tb.url_event_name("tensorboard:0") == j_tb.url_event_name(
        "tensorboard:0")


def test_evaluator_health_log_matches_jax(caplog):
    """Each changed value logged once, filtered by the thresholds."""
    def logged(kv_mod, topo, metrics_mod):
        kv = kv_mod.InProcessKV()
        logger = metrics_mod.EvaluatorMetricsLogger(
            [topo.TaskKey("evaluator", 0)], kv,
            log_thresholds={"awake_time_ratio": (0.5, 1.0)})
        lines = []
        for values in ({"awake_time_ratio": "0.2", "nb_eval_steps": "2"},
                       {"awake_time_ratio": "0.7", "nb_eval_steps": "2"},
                       {"last_training_step": "4", "nb_eval_steps": "x"}):
            for key, value in values.items():
                kv.put_str(f"evaluator:0/{key}", value)
            caplog.clear()
            with caplog.at_level(logging.INFO):
                logger.log()
            lines.append([r.getMessage() for r in caplog.records])
        return lines

    assert logged(t_kv, t_topo, t_evaluator_metrics) == logged(
        j_kv, j_topo, j_evaluator_metrics)
    assert t_evaluator_metrics.MONITORED_METRICS == \
        j_evaluator_metrics.MONITORED_METRICS


def test_tensorboard_task_waits_for_training_to_stop():
    """`wait_for_all_stops` returns once every other cluster task has
    published its stop event."""
    kv = t_kv.InProcessKV()
    runtime = t_bootstrap.TaskRuntime(
        kv, t_topo.TaskKey("tensorboard", 0), "tensorboard:0",
        [t_topo.TaskInstance(t_topo.TaskKey("worker", i), 1)
         for i in range(2)], 0)
    waiter = threading.Thread(target=t_bootstrap.wait_for_all_stops,
                              args=(runtime, 30.0))
    waiter.start()
    t_event.stop_event(kv, "worker:0")
    waiter.join(0.3)
    assert waiter.is_alive()
    t_event.stop_event(kv, "worker:1", RuntimeError("boom"))
    waiter.join(30)
    assert not waiter.is_alive()


def test_driver_logs_the_tensorboard_url_once(caplog, monkeypatch):
    """The driver's one-shot log of ``tensorboard:0/url`` while it polls,
    under the JAX driver's label."""
    kv = t_kv.InProcessKV()

    class Handle:
        polls = 0

        def tasks(self):
            return [t_topo.TaskKey("worker", 0),
                    t_topo.TaskKey("tensorboard", 0)]

        def status(self):
            Handle.polls += 1
            if Handle.polls == 2:
                t_event.url_event(kv, "tensorboard:0", "http://host:6006/")
            return "RUNNING" if Handle.polls < 5 else "SUCCEEDED"

        def side_cars(self):
            return []

        def stop_side_cars(self):
            pass

        def logs(self):
            return {}

    cluster = t_client.SliceCluster(server=None, kv=kv, handle=Handle(),
                                    cluster_tasks=["worker:0"], log_dir="/x")
    t_event.stop_event(kv, "worker:0")
    with caplog.at_level(logging.INFO, logger="tf_yarn_tpu_torch.utils.metrics"):
        t_client._execute_and_await_termination(cluster, b"fn", 0, 0.01)
    urls = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("tensorboard URL")]
    assert urls == ["tensorboard URL http://host:6006/"]


def test_driver_waits_for_the_side_cars_then_stops_them():
    """After the primaries succeed the coordination service stays up
    while a side-car runs (within the budget); whatever still runs is
    stopped before the driver returns."""
    kv = t_kv.InProcessKV()
    stops = []

    class Handle:
        running = 3

        def tasks(self):
            return [t_topo.TaskKey("worker", 0),
                    t_topo.TaskKey("evaluator", 0)]

        def status(self):
            return "SUCCEEDED"

        def side_cars(self):
            Handle.running -= 1
            return [t_topo.TaskKey("evaluator", 0)] if Handle.running > 0 \
                else []

        def stop_side_cars(self):
            stops.append(Handle.running)

        def logs(self):
            return {}

    cluster = t_client.SliceCluster(server=None, kv=kv, handle=Handle(),
                                    cluster_tasks=["worker:0"], log_dir="/x")
    t_event.stop_event(kv, "worker:0")
    t_client._execute_and_await_termination(cluster, b"fn", 0, 0.01)
    assert Handle.running == 0 and stops == [0]
