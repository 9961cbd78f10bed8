"""Fault injection in the port (`resilience.chaos`) held against the JAX
package's: the ``TPU_YARN_FAULT`` grammar, the seeded ``kv_delay``
draws, the arming on attempt 0 only and the lazy read of the
environment, the one-shot clauses, and each hook at its call site — the
train loop's step boundary (an injected crash under a launched driver
recovers bit for bit, an injected SIGTERM drains and classifies
PREEMPTED), the KV client, the checkpoint commit (both save paths) and
the serving replica's poll loop — and the classification of a primary
killed without a stop event (LOST_TASK)."""

import dataclasses
import os
import signal
import time
import types

import numpy as np
import pytest
import torch

from tests.test_torch_serving_task import (  # noqa: F401  (a fixture)
    Package,
    _finished,
    decoder_dir,
    get,
)
from tf_yarn_tpu import resilience as j_resilience
from tf_yarn_tpu.resilience import chaos as j_chaos
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import resilience as t_resilience
from tf_yarn_tpu_torch.resilience import chaos as t_chaos

PACKAGES = {"jax": j_chaos, "port": t_chaos}


@pytest.fixture(autouse=True)
def _chaos_reset():
    for module in PACKAGES.values():
        module.reset()
    yield
    for module in PACKAGES.values():
        module.reset()


# -- the grammar -------------------------------------------------------------

# test_resilience.py:211's and :227's specs, the lost-host clause, and the
# edges of the parser: empty clauses, spaces, a missing value or key.
SPECS = {
    "all_train_clauses": ("crash_at_step=7; sigterm_at_step=3;"
                          "kv_delay=0.25,1.5;truncate_ckpt=latest", 9),
    "fleet_clauses": ("preempt_replica_at=0.5@serving:1; rate_step=0.75,3.0",
                      0),
    "replica_untargeted": ("preempt_replica_at=2", 0),
    "lose_host": ("lose_host_at_step=5", 0),
    "lose_host_task": ("lose_host_at_step=7@worker:1", 0),
    "empty": ("", 0),
    "empty_clauses": (" ; ;crash_at_step=2;; ", 4),
    "spaces": ("  kv_delay = 1.0 , 0.05 ", 3),
    "later_wins": ("crash_at_step=2;crash_at_step=5", 0),
    "bad_no_value": ("crash_at_step", 0),
    "bad_int": ("crash_at_step=x", 0),
    "bad_key": ("what=1", 0),
    "bad_truncate": ("truncate_ckpt=newest", 0),
    "bad_kv_delay": ("kv_delay=0.5", 0),
    "bad_kv_prob": ("kv_delay=x,1", 0),
    "bad_lose_host": ("lose_host_at_step=x@worker:1", 0),
    "bad_replica_negative": ("preempt_replica_at=-1", 0),
    "bad_replica": ("preempt_replica_at=x", 0),
    "bad_rate_one": ("rate_step=0.5", 0),
    "bad_rate_zero": ("rate_step=0.5,0", 0),
    "bad_rate_negative": ("rate_step=-1,2", 0),
    "bad_empty_value": ("sigterm_at_step=", 0),
    "bad_no_key": ("=3", 0),
}


def _parsed(module, spec, seed):
    try:
        plan = module.parse_fault_spec(spec, seed=seed)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return ("plan", dataclasses.asdict(plan), plan.any())


@pytest.mark.parametrize("case", sorted(SPECS))
def test_parse_fault_spec_equals_jax(case):
    spec, seed = SPECS[case]
    got = _parsed(t_chaos, spec, seed)
    assert got == _parsed(j_chaos, spec, seed)
    assert (got[0] == "ValueError") == case.startswith("bad_")


def test_fault_plan_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(t_chaos.FaultPlan)] == [
        f.name for f in dataclasses.fields(j_chaos.FaultPlan)]
    assert (t_chaos.ENV_FAULT, t_chaos.ENV_FAULT_SEED) == (
        j_chaos.ENV_FAULT, j_chaos.ENV_FAULT_SEED)


def test_injected_fault_classifies_transient_in_both_packages():
    for resilience, chaos in ((t_resilience, t_chaos),
                              (j_resilience, j_chaos)):
        kind = resilience.classify_exception(chaos.InjectedFault("boom"))
        assert kind.value == "TRANSIENT"


# -- the kv_delay draws ------------------------------------------------------

@pytest.mark.parametrize("seed, probability", [(0, 0.1), (3, 0.5), (7, 0.9),
                                               (11, 0.25)])
def test_kv_delay_draws_equal_jax(seed, probability, monkeypatch):
    """The same seed and probability delay the same ops, over 200
    draws (the sleep is recorded, not slept)."""
    decisions = {}
    for name, module in PACKAGES.items():
        slept = []
        monkeypatch.setattr(module, "time",
                            types.SimpleNamespace(sleep=slept.append))
        module.configure(f"kv_delay={probability},0.125", seed=seed)
        for i in range(200):
            slept.append(None)
            module.on_kv_op("get" if i % 2 else "put")
        decisions[name] = [value for value in slept]
    assert decisions["port"] == decisions["jax"]
    delayed = decisions["port"].count(0.125)
    assert 0 < delayed < 200


def test_kv_delay_is_seeded_and_probabilistic():
    """test_resilience.py:345 on the port."""
    t_chaos.configure("kv_delay=1.0,0.05", seed=3)
    t0 = time.perf_counter()
    t_chaos.on_kv_op("get")
    t_chaos.on_kv_op("put")
    assert time.perf_counter() - t0 >= 0.1
    t_chaos.configure("kv_delay=0.0,5.0", seed=3)
    t0 = time.perf_counter()
    t_chaos.on_kv_op("get")
    assert time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("package", ["jax", "port"])
def test_kv_delay_slows_the_kv_client(package):
    """test_kv.py:205: at p=1.0 every request of the client pays the
    injected latency."""
    if package == "port":
        from tf_yarn_tpu_torch.coordination.kv import KVClient
        from tf_yarn_tpu_torch.coordination.server_factory import (
            start_best_server as start_server)
    else:
        from tf_yarn_tpu.coordination.kv import KVClient, start_server
    server = start_server()
    try:
        client = KVClient(server.endpoint)
        client.put("warm", b"1")
        PACKAGES[package].configure("kv_delay=1.0,0.08", seed=0)
        t0 = time.monotonic()
        client.put("k", b"v")
        assert client.get("k") == b"v"
        assert time.monotonic() - t0 >= 0.16
    finally:
        server.stop()


# -- arming ------------------------------------------------------------------

def _arming(module):
    """test_resilience.py:272: what each call of the attempt-0 and
    retried plans does."""
    out = []
    module.configure("crash_at_step=2", n_try=1)
    out.append(module.active())
    module.on_train_step(2)
    module.configure("crash_at_step=2", n_try=0)
    out.append(module.active())
    module.on_train_step(1)
    try:
        module.on_train_step(2)
    except module.InjectedFault as exc:
        out.append(str(exc))
    module.on_train_step(2)
    return out


def test_armed_only_on_attempt_zero_as_jax():
    got = _arming(t_chaos)
    assert got == _arming(j_chaos)
    assert got == [False, True, "chaos: injected crash at step 2"]


def _lazy_env(module, monkeypatch):
    """test_resilience.py:284: the spec is read from the environment at
    the first hook call, and a retried attempt ignores it."""
    out = []
    monkeypatch.setenv(module.ENV_FAULT, "crash_at_step=4")
    monkeypatch.setenv("TPU_YARN_N_TRY", "0")
    module.reset()
    try:
        module.on_train_step(4)
    except module.InjectedFault:
        out.append("raised")
    monkeypatch.setenv("TPU_YARN_N_TRY", "1")
    module.reset()
    module.on_train_step(4)
    out.append(module.active())
    monkeypatch.setenv("TPU_YARN_N_TRY", "0")
    monkeypatch.setenv(module.ENV_FAULT_SEED, "5")
    module.reset()
    out.append(module._active().plan.seed)
    monkeypatch.delenv(module.ENV_FAULT)
    module.reset()
    out.append(module.active())
    return out


def test_reads_the_environment_lazily_as_jax(monkeypatch):
    got = _lazy_env(t_chaos, monkeypatch)
    assert got == _lazy_env(j_chaos, monkeypatch)
    assert got == ["raised", False, 5, False]


def _lose_host_filter(module, monkeypatch):
    """test_resilience.py:309: the clause fires in no task it does not
    name, on no retried attempt and at no other step."""
    killed = []
    monkeypatch.setattr(module, "os", types.SimpleNamespace(
        environ=os.environ, getpid=os.getpid,
        kill=lambda pid, sig: killed.append(sig)))
    monkeypatch.setenv("TPU_YARN_TASK", "worker:0")
    module.configure("lose_host_at_step=3@worker:1", n_try=0)
    module.on_train_step(3)
    module.configure("lose_host_at_step=3@worker:1", n_try=1)
    inactive = not module.active()
    monkeypatch.setenv("TPU_YARN_TASK", "worker:1")
    module.configure("lose_host_at_step=3@worker:1", n_try=0)
    module.on_train_step(2)
    before = list(killed)
    module.on_train_step(3)
    module.on_train_step(3)
    return inactive, before, killed


def test_lose_host_fires_once_in_the_named_task_as_jax(monkeypatch):
    got = _lose_host_filter(t_chaos, monkeypatch)
    assert got == _lose_host_filter(j_chaos, monkeypatch)
    assert got == (True, [], [signal.SIGKILL])


def _replica_notices(module):
    """test_resilience.py:246."""
    module.configure("preempt_replica_at=1.5@serving:0", n_try=0)
    out = [module.on_replica_poll("serving:0", 1.0),
           module.on_replica_poll("serving:1", 99.0),
           module.on_replica_poll("serving:0", 2.0),
           module.on_replica_poll("serving:0", 3.0)]
    module.configure("preempt_replica_at=1", n_try=0)
    out += [module.on_replica_poll("serving:0", 2.0),
            module.on_replica_poll("serving:1", 2.0),
            module.on_replica_poll("serving:0", 3.0)]
    return out


def test_replica_notice_fires_once_per_matching_task_as_jax():
    got = _replica_notices(t_chaos)
    assert got == _replica_notices(j_chaos)
    assert got == [False, False, True, False, True, True, False]


def _rate_step(module):
    """test_resilience.py:263."""
    out = [module.rate_step_plan()]
    module.configure("rate_step=0.25,4", n_try=0)
    out += [module.rate_step_plan(), module.rate_step_plan()]
    module.configure("rate_step=0.25,4", n_try=1)
    out.append(module.rate_step_plan())
    return out


def test_rate_step_plan_is_a_pure_read_as_jax():
    got = _rate_step(t_chaos)
    assert got == _rate_step(j_chaos)
    assert got == [None, (0.25, 4.0), (0.25, 4.0), None]


# -- the checkpoint commit ---------------------------------------------------

def _state(value):
    return {"params": {"w": torch.full((8, 8), float(value)),
                       "b": torch.arange(16.0) * value},
            "optimizer": {}, "step": value}


def test_truncate_ckpt_fires_once_at_the_commit(tmp_path):
    """test_resilience.py:417 on the port's synchronous save."""
    t_chaos.configure("truncate_ckpt=latest")
    model_dir = str(tmp_path)
    t_ckpt.save_checkpoint(model_dir, 1, _state(1))
    with pytest.raises(t_ckpt.CheckpointCorrupt):
        t_ckpt.verify_checkpoint(str(tmp_path / "ckpt-1"))
    t_ckpt.save_checkpoint(model_dir, 2, _state(2))
    t_ckpt.verify_checkpoint(str(tmp_path / "ckpt-2"))


def test_truncate_ckpt_corrupts_the_async_commit_then_restore_falls_back(
        tmp_path):
    """The async writer's commit: ckpt-1 lands intact, the next commit is
    truncated (armed between the saves), restore quarantines it and
    resumes from ckpt-1 (test_resilience.py:379)."""
    model_dir = str(tmp_path)
    with t_ckpt.CheckpointWriter() as writer:
        writer.save(model_dir, 1, _state(1))
        writer.wait()
        t_chaos.configure("truncate_ckpt=latest")
        writer.save(model_dir, 2, _state(2))
        writer.wait()
    restored, step = t_ckpt.restore_latest(model_dir)
    assert step == 1
    assert torch.equal(restored["params"]["w"], torch.full((8, 8), 1.0))
    assert t_ckpt.list_checkpoint_steps(model_dir) == [1]
    assert (tmp_path / "ckpt-2.corrupt").is_dir()
    assert t_ckpt.latest_verified_step(model_dir) == 1


def test_truncate_checkpoint_payload_halves_the_largest_file(tmp_path):
    t_ckpt.save_checkpoint(str(tmp_path), 1, _state(1))
    sizes = {p.name: p.stat().st_size for p in (tmp_path / "ckpt-1").iterdir()}
    largest = max((n for n in sizes if n != "MANIFEST.json"), key=sizes.get)
    assert t_chaos.truncate_checkpoint_payload(
        f"file://{tmp_path / 'ckpt-1'}") == largest
    assert (tmp_path / "ckpt-1" / largest).stat().st_size == \
        sizes[largest] // 2
    restored, step = t_ckpt.restore_latest(str(tmp_path))
    assert restored is None and step is None
    assert (tmp_path / "ckpt-1.corrupt").is_dir()
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_chaos.truncate_checkpoint_payload(str(empty)) is None
    with pytest.raises(NotImplementedError, match="item 5.4"):
        t_chaos.truncate_checkpoint_payload("gs://bucket/ckpt-1")


# -- the train loop ----------------------------------------------------------

def _mnist(model_dir, train_steps, checkpoint_every_steps=10):
    from tf_yarn_tpu_torch.experiment import as_core_experiment
    from tf_yarn_tpu_torch.models import mnist

    return as_core_experiment(mnist.make_experiment(
        model_dir=model_dir, train_steps=train_steps, batch_size=32,
        feature_dim=16, num_classes=4, hidden_sizes=(16,),
        log_every_steps=2, checkpoint_every_steps=checkpoint_every_steps))


def test_sigterm_at_step_drains_saves_and_classifies_preempted(tmp_path):
    """test_preemption.py:123 on the port: the injected SIGTERM lands in
    the preemption flag, the loop saves a drain checkpoint at that step,
    the raised Preempted classifies PREEMPTED, and a resumed run ends at
    the new step."""
    from tf_yarn_tpu_torch.training import train_and_evaluate

    model_dir = str(tmp_path / "model")
    previous = signal.getsignal(signal.SIGTERM)
    assert t_preemption.install()
    t_chaos.configure("sigterm_at_step=3")
    try:
        with pytest.raises(t_preemption.Preempted,
                           match="checkpoint saved") as raised:
            train_and_evaluate(_mnist(model_dir, 10), device="cpu")
        kind = t_resilience.classify_exception(raised.value)
        assert kind is t_resilience.FailureKind.PREEMPTED
    finally:
        t_chaos.reset()
        signal.signal(signal.SIGTERM, previous)
        t_preemption.reset()
    assert t_ckpt.list_checkpoint_steps(model_dir) == [3]
    t_ckpt.verify_checkpoint(f"{model_dir}/ckpt-3")
    metrics = train_and_evaluate(_mnist(model_dir, 6), device="cpu")
    assert np.isfinite(metrics["loss"])
    assert t_ckpt.list_checkpoint_steps(model_dir)[-1] == 6


def test_crash_at_step_raises_at_the_step_boundary_once(tmp_path):
    """An armed crash propagates out of the loop at its step, before the
    step's checkpoint cadence (JAX training.py:986-991); a second run in
    the same process (the clause has fired) resumes and finishes."""
    from tf_yarn_tpu_torch.training import train_and_evaluate

    model_dir = str(tmp_path / "model")
    t_chaos.configure("crash_at_step=4")
    with pytest.raises(t_chaos.InjectedFault, match="step 4"):
        train_and_evaluate(_mnist(model_dir, 6, 2), device="cpu")
    assert t_ckpt.list_checkpoint_steps(model_dir) == [2]
    train_and_evaluate(_mnist(model_dir, 6, 2), device="cpu")
    assert t_ckpt.list_checkpoint_steps(model_dir)[-1] == 6


def _deterministic_experiment_fn(model_dir, train_steps=10):
    """test_resilience.py:439's experiment on the port: the batch of step
    s is a pure function of s, so a resumed run replays the input and
    dropout chain an uninterrupted run sees."""

    def experiment_fn():
        import numpy as np

        from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
        from tf_yarn_tpu_torch.models import common, mnist

        def input_fn(start_step=0):
            def gen():
                step = start_step
                while True:
                    step += 1
                    rng = np.random.RandomState(10_000 + step)
                    yield {
                        "x": rng.normal(size=(16, 8)).astype(np.float32),
                        "y": rng.randint(0, 4, size=(16,)).astype(np.int32),
                    }

            return gen()

        return TorchExperiment(
            model=None,
            init_fn=lambda device, seed: mnist.make_model(8, (16,), 4, seed,
                                                          device),
            optimizer=mnist.adam(1e-2),
            loss_fn=common.classification_loss,
            train_input_fn=input_fn,
            train_params=TrainParams(
                train_steps=train_steps, log_every_steps=5,
                checkpoint_every_steps=2, seed=0),
            model_dir=model_dir,
        )

    return experiment_fn


def test_crash_at_step_driver_recovers_bit_for_bit(tmp_path):
    """test_resilience.py:487 on the port: crash_at_step injected on
    attempt 0, the driver classifies it TRANSIENT, backs off and
    relaunches; the resumed run restores a manifest-verified checkpoint
    and ends bit for bit equal to an uninterrupted run."""
    from tf_yarn_tpu_torch.client import run_on_gpu
    from tf_yarn_tpu_torch.topologies import TaskSpec

    base_env = {"TPU_YARN_PLATFORM": "cpu"}
    steps = 10
    clean_dir = str(tmp_path / "clean")
    run_on_gpu(_deterministic_experiment_fn(clean_dir, steps),
               {"worker": TaskSpec(instances=1)}, env=dict(base_env),
               poll_every_secs=0.2)
    chaos_dir = str(tmp_path / "chaos")
    policy = t_resilience.RetryPolicy.from_nb_retries(
        1, seed=7, base_backoff_secs=0.2, max_backoff_secs=1.0)
    metrics = run_on_gpu(
        _deterministic_experiment_fn(chaos_dir, steps),
        {"worker": TaskSpec(instances=1)},
        env=dict(base_env, TPU_YARN_FAULT="crash_at_step=5"),
        retry_policy=policy, poll_every_secs=0.2)
    assert metrics is not None
    assert [d.kind for d in policy.history] == [
        t_resilience.FailureKind.TRANSIENT]
    assert policy.history[0].delay > 0
    clean, step = t_ckpt.restore_latest(clean_dir)
    recovered, got = t_ckpt.restore_latest(chaos_dir)
    assert step == got == steps
    for part in ("params", "optimizer"):
        assert _leaves(clean[part]) == _leaves(recovered[part]), part


def _leaves(tree):
    """Every tensor of a state tree as bytes, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().contiguous().numpy().tobytes()]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree, key=str)
                for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [repr(tree)]


def test_silent_killed_primary_classifies_the_attempt_lost_task():
    """test_resilience.py:324 on the port's driver."""
    from tf_yarn_tpu_torch.client import _attempt_kind, _lost_primaries
    from tf_yarn_tpu_torch.utils.metrics import TaskOutcome

    transient = t_resilience.FailureKind.TRANSIENT
    outcomes = {
        "worker:0": TaskOutcome("FAILED", "ConnectionError: peer gone",
                                transient),
        "worker:1": TaskOutcome("KILLED", ""),
        "evaluator:0": TaskOutcome("KILLED", ""),
    }
    failures = {"worker:0": outcomes["worker:0"]}
    assert _attempt_kind(outcomes, failures, []) \
        is t_resilience.FailureKind.LOST_TASK
    assert _lost_primaries(outcomes, []) == ["worker:1"]
    assert _lost_primaries(outcomes, ["worker:1"]) == ["worker:1"]


# -- the serving replica's poll loop -----------------------------------------

def _replica_preemption(package):
    """run_serving of `package` under ``preempt_replica_at=0.3@serving:0``:
    serving:1 (not named) ends at its serve_seconds, serving:0 drains on
    the injected notice with /healthz "draining"."""
    PACKAGES[package.name].configure("preempt_replica_at=0.3@serving:0")
    thread, result, _ = package.start(
        package.experiment(serve_seconds=1.0, kv_layout="paged"),
        task="serving:1")
    _finished(thread, result)
    notice_before = package.preemption.requested()
    release = package.hold_drain()
    thread, result, port = package.start(
        package.experiment(kv_layout="paged"), task="serving:0")
    try:
        deadline = time.monotonic() + 60
        health = get(port, "/healthz")[1]["status"]
        while health != "draining" and time.monotonic() < deadline:
            time.sleep(0.05)
            health = get(port, "/healthz")[1]["status"]
    finally:
        release.set()
        try:
            stats = _finished(thread, result)
        finally:
            package.preemption.reset()
    return notice_before, health, stats["draining"]


def test_preempt_replica_at_drains_the_named_replica_as_jax(decoder_dir,
                                                            monkeypatch):
    outcomes = {name: _replica_preemption(Package(name, monkeypatch,
                                                  decoder_dir))
                for name in ("port", "jax")}
    assert outcomes["port"] == outcomes["jax"] == (False, "draining", True)


def test_serve_loop_without_a_task_never_asks_chaos():
    """The ranking replica's loop (no task: the JAX ranker has no chaos
    hook) ignores an armed replica clause."""
    from tf_yarn_tpu_torch.serving.server import serve_until_stopped

    t_chaos.configure("preempt_replica_at=0")
    drained = []
    started = time.monotonic()
    serve_until_stopped("ranking", 0.5, lambda: drained.append(1))
    assert not drained and not t_preemption.requested()
    assert time.monotonic() - started >= 0.5
    assert t_chaos.on_replica_poll("rank:0", 1.0)
