"""Elastic resize in the port (`resilience.elastic`, `client.run_on_gpu`'s
resize-not-retry) held against the JAX package's.

`ElasticPolicy` decisions and history over seeded sequences of failures,
the bands' validation, `_normalize_elastic`'s bands and messages, and
the driver's retry loop — each attempt's task counts and elastic
environment — are compared with the JAX package's on the same inputs.
The acceptance case (the port's version of tests/test_elastic.py:350)
really kills a host: ``lose_host_at_step=5@worker:1`` SIGKILLs worker:1
of two launched CPU workers training at ``MeshSpec(dp=2)``; the driver
classifies LOST_TASK, shrinks to one worker, which refits the mesh,
restores a pre-crash checkpoint (bitwise the uninterrupted run's) and
finishes within 1e-5 of it. The test task `tasks._spin` drives
`LocalBackend`'s KILLED path."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from tf_yarn_tpu import backends as j_backends
from tf_yarn_tpu import client as j_client
from tf_yarn_tpu import resilience as j_resilience
from tf_yarn_tpu import telemetry as j_telemetry
from tf_yarn_tpu import topologies as j_topologies
from tf_yarn_tpu.parallel import mesh as j_mesh
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import resilience as t_resilience
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import topologies as t_topologies
from tf_yarn_tpu_torch.backends import (
    KILLED,
    RUNNING,
    SUCCEEDED,
    LocalBackend,
    ServiceSpec,
)
from tf_yarn_tpu_torch.parallel import mesh as t_mesh

PACKAGES = {"jax": (j_resilience, j_client, j_topologies),
            "port": (t_resilience, t_client, t_topologies)}
KINDS = ("TRANSIENT", "PREEMPTED", "LOST_TASK", "FATAL_USER")


@pytest.fixture(autouse=True)
def _chaos_reset():
    for resilience, _, _ in PACKAGES.values():
        resilience.chaos.reset()
    yield
    for resilience, _, _ in PACKAGES.values():
        resilience.chaos.reset()


def _history(policy):
    return [(r.direction, r.from_workers, r.to_workers,
             r.kind.value if r.kind is not None else None)
            for r in policy.history]


# -- ElasticPolicy -------------------------------------------------------------

POLICIES = {
    "band_1_4": dict(min_workers=1, max_workers=4),
    "shrink_step_2": dict(min_workers=1, max_workers=8, shrink_step=2),
    "no_regrow": dict(min_workers=2, max_workers=6, regrow=False),
    "fixed": dict(min_workers=3, max_workers=3),
}


def _decisions(resilience, fields, failures):
    policy = resilience.ElasticPolicy(**fields)
    current = fields["max_workers"]
    out = []
    for kind, lost in failures:
        planned = policy.plan_resize(resilience.FailureKind(kind), current,
                                     lost_tasks=lost)
        out.append((planned, policy.degraded(current)))
        if planned is not None:
            current = planned
    return out, _history(policy)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_plan_resize_sequences_equal_jax(name, seed):
    """40 seeded (kind, lost tasks) failures: every decision, the
    degraded flag and the history equal the JAX policy's."""
    rng = np.random.RandomState(seed)
    failures = [(KINDS[rng.randint(len(KINDS))], int(rng.randint(0, 4)))
                for _ in range(40)]
    got = _decisions(t_resilience, POLICIES[name], failures)
    assert got == _decisions(j_resilience, POLICIES[name], failures)
    assert got[1] or name == "fixed"


def _band_error(resilience, fields):
    try:
        resilience.ElasticPolicy(**fields)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("fields", [
    dict(min_workers=0, max_workers=2), dict(min_workers=3, max_workers=2),
    dict(min_workers=1, max_workers=2, shrink_step=0),
    dict(min_workers=1, max_workers=1)], ids=str)
def test_policy_validates_its_band_as_jax(fields):
    got = _band_error(t_resilience, fields)
    assert got == _band_error(j_resilience, fields)
    assert (got is None) == (fields == dict(min_workers=1, max_workers=1))


def test_policy_decisions_of_the_jax_tests():
    """tests/test_elastic.py:42-83 on the port."""
    FailureKind, ElasticResize = (t_resilience.FailureKind,
                                  t_resilience.ElasticResize)
    policy = t_resilience.ElasticPolicy(min_workers=1, max_workers=4)
    assert policy.plan_resize(FailureKind.LOST_TASK, 4) == 3
    assert policy.plan_resize(FailureKind.PREEMPTED, 3, lost_tasks=2) == 1
    assert policy.plan_resize(FailureKind.LOST_TASK, 1) is None
    assert policy.history == [
        ElasticResize("shrink", 4, 3, FailureKind.LOST_TASK),
        ElasticResize("shrink", 3, 1, FailureKind.PREEMPTED)]
    policy = t_resilience.ElasticPolicy(min_workers=1, max_workers=8,
                                        shrink_step=2)
    assert policy.plan_resize(FailureKind.LOST_TASK, 8, lost_tasks=1) == 6
    assert policy.plan_resize(FailureKind.LOST_TASK, 6, lost_tasks=5) == 1
    policy = t_resilience.ElasticPolicy(min_workers=1, max_workers=4)
    assert policy.plan_resize(FailureKind.LOST_TASK, 4) == 3
    assert policy.plan_resize(FailureKind.TRANSIENT, 3) == 4
    assert policy.plan_resize(FailureKind.TRANSIENT, 4) is None
    assert [r.direction for r in policy.history] == ["shrink", "grow"]
    assert policy.degraded(3) and not policy.degraded(4)
    policy = t_resilience.ElasticPolicy(min_workers=1, max_workers=4,
                                        regrow=False)
    assert policy.plan_resize(FailureKind.PREEMPTED, 4) == 3
    assert policy.plan_resize(FailureKind.TRANSIENT, 3) is None
    assert [k.value for k in t_resilience.CAPACITY_KINDS] == [
        k.value for k in j_resilience.CAPACITY_KINDS]


# -- the driver's bands ----------------------------------------------------------

def _band(resilience, low, high):
    return resilience.ElasticPolicy(min_workers=low, max_workers=high)


NORMALIZE = {
    "none": lambda r: None,
    "bare": lambda r: _band(r, 1, 4),
    "dict_two_types": lambda r: {"worker": _band(r, 1, 4),
                                 "serving": _band(r, 1, 3)},
    "not_a_policy": lambda r: "grow please",
    "dict_value_not_a_policy": lambda r: {"worker": "x"},
    "chief": lambda r: {"chief": _band(r, 1, 4)},
    "absent_type": lambda r: {"rank": _band(r, 1, 4)},
    "outside_band": lambda r: {"serving": _band(r, 3, 5)},
    "bare_outside_band": lambda r: _band(r, 1, 2),
}


def _normalized(package, case, specs):
    resilience, client, topologies = PACKAGES[package]
    task_specs = {t: topologies.TaskSpec(instances=n) for t, n in specs.items()}
    try:
        bands = client._normalize_elastic(NORMALIZE[case](resilience),
                                          task_specs)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return {t: (p.min_workers, p.max_workers) for t, p in bands.items()}


@pytest.mark.parametrize("case", sorted(NORMALIZE))
def test_normalize_elastic_equals_jax(case):
    """tests/test_elastic.py:89: the same bands, and the same messages
    ("elastic band", "resizes the ... task type", "never resized")."""
    specs = {"worker": 4, "serving": 2, "chief": 0}
    got = _normalized("port", case, specs)
    assert got == _normalized("jax", case, specs)
    if case in ("chief", "absent_type"):
        assert "never resized" in got[1]
    if case.endswith("outside_band"):
        assert "elastic band" in got[1]


def _no_launch(*args, **kwargs):
    raise AssertionError("run_on_gpu launched a refused run")


def test_run_on_gpu_validates_the_elastic_topology(monkeypatch):
    """tests/test_elastic.py:267 on the port: no worker type, or a
    worker count outside the band, raises before anything launches."""
    monkeypatch.setattr(t_client, "_setup_cluster", _no_launch)
    band = t_resilience.ElasticPolicy(min_workers=1, max_workers=2)
    fn = t_client.get_safe_experiment_fn("os.getcwd")
    with pytest.raises(ValueError, match="worker"):
        t_client.run_on_gpu(fn, {"chief": t_topologies.TaskSpec(instances=1)},
                            elastic_policy=band)
    with pytest.raises(ValueError, match="elastic band"):
        t_client.run_on_gpu(fn, {"worker": t_topologies.TaskSpec(instances=4)},
                            elastic_policy=band)


# -- the driver's retry loop -----------------------------------------------------

class _Stub:
    """What the retry loop touches of a cluster."""

    class server:
        @staticmethod
        def stop():
            pass

    class handle:
        @staticmethod
        def status():
            return "FAILED"


def _recorder(backend_cls):
    """A backend of `backend_cls` that records what the driver notes."""

    class Recorder(backend_cls):
        def __init__(self):
            super().__init__()
            self.noted = []

        def note_lost_tasks(self, tasks):
            self.noted.append(tasks)

    return Recorder()


def _retry_loop(package, monkeypatch):
    """Three scripted attempts through the real retry loop: LOST_TASK
    (worker:1 lost), TRANSIENT, success. Returns each attempt's worker
    count and elastic environment, the policy's history and the counts
    of the resize counter, and what the backend was told."""
    resilience, client, topologies = PACKAGES[package]
    attempts = []
    script = [
        client.RunFailed("lost", kind=resilience.FailureKind.LOST_TASK,
                         lost_tasks=["worker:1"]),
        client.RunFailed("flaky", kind=resilience.FailureKind.TRANSIENT),
        None]

    def setup(task_specs, backend, n_try, env, *rest):
        attempts.append((n_try, task_specs["worker"].instances,
                         task_specs["chief"].instances,
                         {k: v for k, v in env.items()
                          if k.startswith("TPU_YARN_ELASTIC")}))
        return _Stub()

    def execute(cluster, *args):
        outcome = script[len(attempts) - 1]
        if outcome is not None:
            raise outcome
        return "metrics"

    monkeypatch.setattr(client, "_setup_cluster", setup)
    monkeypatch.setattr(client, "_execute_and_await_termination", execute)
    backend = _recorder(LocalBackend if package == "port"
                        else j_backends.LocalBackend)
    policy = resilience.ElasticPolicy(min_workers=1, max_workers=2)
    retry = resilience.RetryPolicy.from_nb_retries(
        2, seed=0, base_backoff_secs=0.01, max_backoff_secs=0.02)
    registry = (telemetry if package == "port"
                else j_telemetry).get_registry()
    counters = {d: registry.counter("driver/elastic_resizes_total",
                                    direction=d) for d in ("shrink", "grow")}
    before = {d: c.value for d, c in counters.items()}
    run = client.run_on_gpu if package == "port" else client.run_on_tpu
    result = run(lambda: None, {"chief": topologies.TaskSpec(instances=1),
                                "worker": topologies.TaskSpec(instances=2)},
                 backend=backend, retry_policy=retry, elastic_policy=policy,
                 env={"KEEP": "1"})
    return (result, attempts, _history(policy),
            {d: c.value - before[d] for d, c in counters.items()},
            backend.noted, [d.kind.value for d in retry.history])


def test_retry_loop_resizes_as_jax(monkeypatch):
    got = _retry_loop("port", monkeypatch)
    assert got == _retry_loop("jax", monkeypatch)
    result, attempts, history, resizes, noted, kinds = got
    assert result == "metrics"
    assert attempts == [
        (0, 2, 1, {}),
        (1, 1, 1, {"TPU_YARN_ELASTIC_WORKERS": "1",
                   "TPU_YARN_ELASTIC_MAX_WORKERS": "2"}),
        (2, 2, 1, {"TPU_YARN_ELASTIC_WORKERS": "2",
                   "TPU_YARN_ELASTIC_MAX_WORKERS": "2"})]
    assert history == [("shrink", 2, 1, "LOST_TASK"),
                       ("grow", 1, 2, "TRANSIENT")]
    assert resizes == {"shrink": 1, "grow": 1}
    assert noted == [["worker:1"]]
    assert kinds == ["LOST_TASK", "TRANSIENT"]


def test_note_lost_tasks_reaches_the_backend():
    """The base's (so LocalBackend's) note is a no-op; the driver hands a
    backend the lost tasks of a failure that has some, and nothing
    otherwise."""
    assert LocalBackend().note_lost_tasks(["worker:1"]) is None
    backend = _recorder(LocalBackend)
    t_client._note_lost_to_backend(backend, t_client.RunFailed(
        "x", lost_tasks=["worker:0"]))
    t_client._note_lost_to_backend(backend, RuntimeError("no lost tasks"))
    assert backend.noted == [["worker:0"]]


# -- the mesh refit's rule -------------------------------------------------------

RESIZES = {
    "dp8_to_4": (dict(dp=8), 4),
    "fsdp8_to_4": (dict(fsdp=8), 4),
    "dp2_fsdp4_to_4": (dict(dp=2, fsdp=4), 4),
    "dp2_fsdp4_to_2": (dict(dp=2, fsdp=4), 2),
    "grow_back": (dict(dp=1, fsdp=2), 8),
    "dp4_tp2_to_4": (dict(dp=4, tp=2), 4),
    "tp2_to_3": (dict(dp=4, tp=2), 3),
    "to_0": (dict(dp=4, tp=2), 0),
    "dp2_to_1": (dict(dp=2), 1),
    "dp2_fsdp2_to_2": (dict(dp=2, fsdp=2), 2),
    "dp2_tp2_to_2": (dict(dp=2, tp=2), 2),
    "sp2_pp2_to_8": (dict(sp=2, pp=2), 8),
}


def _resized(mesh_module, fields, n):
    try:
        return dataclasses.asdict(mesh_module.resize_mesh_spec(
            mesh_module.MeshSpec(**fields), n))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_mesh_spec_equals_jax(case):
    """tests/test_elastic.py:143-160: the model axes stay, the data axes
    refit; a count that cannot hold tp raises."""
    fields, n = RESIZES[case]
    got = _resized(t_mesh, fields, n)
    assert got == _resized(j_mesh, fields, n)
    if case == "tp2_to_3":
        assert "model axes" in got[1]


# -- tasks._spin: LocalBackend's KILLED path --------------------------------------

def _wait(handle, seconds):
    deadline = time.time() + seconds
    while handle.status() == RUNNING and time.time() < deadline:
        time.sleep(0.2)
    return handle.status()


def test_local_backend_killed_status(tmp_path):
    """tests/test_backends.py:21 on the port's backend and spin task."""
    handle = LocalBackend().launch(
        {"worker": ServiceSpec(module="tf_yarn_tpu_torch.tasks._spin",
                               instances=1)}, str(tmp_path))
    assert handle.status() == RUNNING
    handle.kill()
    assert _wait(handle, 15) == KILLED


def test_spin_task_exits_at_its_seconds(tmp_path):
    """tests/test_backends.py:133's spin: TPU_YARN_SPIN_SECS=0 exits at
    once, shipped files in the task's working directory."""
    payload = tmp_path / "data.txt"
    payload.write_text("hello")
    handle = LocalBackend().launch(
        {"worker": ServiceSpec(module="tf_yarn_tpu_torch.tasks._spin",
                               instances=2, env={"TPU_YARN_SPIN_SECS": "0"},
                               files={"payload/data.txt": str(payload)})},
        str(tmp_path / "logs"))
    assert _wait(handle, 30) == SUCCEEDED, open(
        handle.logs()["worker:0"]).read()
    assert set(handle.logs()) == {"worker:0", "worker:1"}
    assert (tmp_path / "logs" / "worker-1-files" / "payload"
            / "data.txt").read_text() == "hello"


# -- end to end: lose a host, shrink, resume, finish ------------------------------

def _elastic_experiment_fn(model_dir, marker_path, train_steps=10):
    """tests/test_elastic.py:305's experiment on the port: mnist over a
    dp=2 mesh whose input_fn yields its data group's contiguous share of
    a fixed 16-row global batch (a pure function of the step), so any
    number of ranks replays the same global stream. Each attempt's rank
    0 appends "n_try:num_hosts:start_step" to `marker_path`."""

    def experiment_fn():
        import numpy as np

        from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
        from tf_yarn_tpu_torch.models import common, mnist
        from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

        def input_fn(start_step=0, host_index=0, num_hosts=1):
            import os

            if host_index == 0:
                with open(marker_path, "a") as fh:
                    fh.write(f"{os.environ.get('TPU_YARN_N_TRY')}:"
                             f"{num_hosts}:{start_step}\n")

            def gen():
                step = start_step
                per = 16 // num_hosts
                lo = host_index * per
                while True:
                    step += 1
                    rng = np.random.RandomState(10_000 + step)
                    x = rng.normal(size=(16, 8)).astype(np.float32)
                    y = rng.randint(0, 4, size=(16,)).astype(np.int32)
                    yield {"x": x[lo:lo + per], "y": y[lo:lo + per]}

            return gen()

        return TorchExperiment(
            model=None,
            init_fn=lambda device, seed: mnist.make_model(8, (16,), 4, seed,
                                                          device),
            optimizer=mnist.adam(1e-2),
            loss_fn=common.classification_loss,
            train_input_fn=input_fn,
            train_params=TrainParams(
                train_steps=train_steps, log_every_steps=2,
                checkpoint_every_steps=2, keep_last_n=None, seed=0),
            mesh_spec=MeshSpec(dp=2),
            model_dir=model_dir,
        )

    return experiment_fn


BASE_ENV = {"TPU_YARN_PLATFORM": "cpu", "TPU_YARN_HEARTBEAT_SECS": "0.5"}


def _state_bytes(model_dir, step):
    state = t_ckpt.restore_checkpoint(model_dir, step, map_location="cpu")
    return {part: {str(k): v for k, v in _flat(state[part])}
            for part in ("params", "optimizer")}


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree.detach().cpu()
    elif isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _flat(tree[key], f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flat(item, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _clean_run(tmp_path, steps):
    clean_dir = str(tmp_path / "clean")
    t_client.run_on_gpu(
        _elastic_experiment_fn(clean_dir, str(tmp_path / "clean-marker"),
                               steps),
        {"worker": t_topologies.TaskSpec(instances=2)}, env=dict(BASE_ENV),
        poll_every_secs=0.2)
    return clean_dir


def _attempts(marker):
    return [line.split(":") for line in
            open(marker).read().strip().splitlines()]


def test_lose_host_elastic_shrink_resumes_and_matches(tmp_path):
    """tests/test_elastic.py:350 on the port: worker:1 of two launched
    workers is SIGKILLed at step 5; the driver classifies LOST_TASK and
    shrinks to the survivor, whose one rank refits the dp=2 mesh and
    finishes all 10 steps on the same global batches. The checkpoint it
    resumed from is bitwise the uninterrupted run's; the final state is
    within 1e-5 of it."""
    steps = 10
    clean_dir = _clean_run(tmp_path, steps)
    chaos_dir = str(tmp_path / "chaos")
    marker = str(tmp_path / "chaos-marker")
    retry = t_resilience.RetryPolicy.from_nb_retries(
        2, seed=7, base_backoff_secs=0.2, max_backoff_secs=1.0)
    elastic = t_resilience.ElasticPolicy(min_workers=1, max_workers=2)
    shrinks = telemetry.get_registry().counter(
        "driver/elastic_resizes_total", direction="shrink")
    before = shrinks.value
    metrics = t_client.run_on_gpu(
        _elastic_experiment_fn(chaos_dir, marker, steps),
        {"worker": t_topologies.TaskSpec(instances=2)},
        env=dict(BASE_ENV, TPU_YARN_FAULT="lose_host_at_step=5@worker:1"),
        retry_policy=retry, elastic_policy=elastic, dead_task_secs=3.0,
        poll_every_secs=0.2)
    assert metrics is not None

    # The JAX test's histories.
    j_kind = j_resilience.FailureKind.LOST_TASK
    assert [d.kind.value for d in retry.history] == [j_kind.value]
    assert _history(elastic) == [
        (r.direction, r.from_workers, r.to_workers, r.kind.value)
        for r in [j_resilience.ElasticResize("shrink", 2, 1, j_kind)]]
    assert shrinks.value - before == 1

    attempts = _attempts(marker)
    assert [a[0] for a in attempts] == ["0", "1"]
    assert attempts[0][1] == "2" and attempts[1][1] == "1"
    resume_step = int(attempts[1][2])
    assert resume_step in (2, 4)

    clean, chaos = (_state_bytes(d, resume_step)
                    for d in (clean_dir, chaos_dir))
    for part in ("params", "optimizer"):
        assert sorted(clean[part]) == sorted(chaos[part])
        for key, value in clean[part].items():
            other = chaos[part][key]
            if isinstance(value, torch.Tensor):
                assert torch.equal(value, other), (part, key)
            else:
                assert value == other, (part, key)

    assert t_ckpt.latest_verified_step(chaos_dir) == steps
    clean, chaos = (_state_bytes(d, steps) for d in (clean_dir, chaos_dir))
    for part in ("params", "optimizer"):
        for key, value in clean[part].items():
            if isinstance(value, torch.Tensor):
                np.testing.assert_allclose(
                    chaos[part][key].double().numpy(),
                    value.double().numpy(), rtol=0, atol=1e-5,
                    err_msg=f"{part} {key}")


@pytest.mark.slow  # a third launch cycle, as the JAX test marks it
def test_lose_host_without_elastic_policy_relaunches_full(tmp_path):
    """tests/test_elastic.py:430 on the port: without an ElasticPolicy the
    relaunch asks for the same two workers and ends bit for bit equal to
    the uninterrupted run."""
    steps = 8
    clean_dir = _clean_run(tmp_path, steps)
    chaos_dir = str(tmp_path / "chaos")
    marker = str(tmp_path / "m1")
    retry = t_resilience.RetryPolicy.from_nb_retries(
        2, seed=3, base_backoff_secs=0.2, max_backoff_secs=1.0)
    t_client.run_on_gpu(
        _elastic_experiment_fn(chaos_dir, marker, steps),
        {"worker": t_topologies.TaskSpec(instances=2)},
        env=dict(BASE_ENV, TPU_YARN_FAULT="lose_host_at_step=3@worker:1"),
        retry_policy=retry, dead_task_secs=3.0, poll_every_secs=0.2)
    assert [d.kind.value for d in retry.history] == ["LOST_TASK"]
    assert [a[1] for a in _attempts(marker)] == ["2", "2"]
    clean, chaos = (_state_bytes(d, steps) for d in (clean_dir, chaos_dir))
    for part in ("params", "optimizer"):
        for key, value in clean[part].items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(value, chaos[part][key]), (part, key)
    assert os.path.isdir(chaos_dir)
