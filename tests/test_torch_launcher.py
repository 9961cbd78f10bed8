"""The port's launch path held against the JAX package without launching
anything: topology verdicts, ranks, task modules, event keys, failure
kinds, retry budgets, the KV wire both ways, the driver's event folding,
the train hook's KV broadcasts, what `run_on_gpu` refuses before it
launches, and `/healthz` under the preemption notice on both servers of
both packages."""

import http.client
import json
import os
import pickle
import sys
import time

import jax
import pytest
import torch

import tf_yarn_tpu._env as j_env
import tf_yarn_tpu._task_commons as j_commons
import tf_yarn_tpu.constants as j_constants
import tf_yarn_tpu.event as j_event
import tf_yarn_tpu.preemption as j_preemption
import tf_yarn_tpu.topologies as j_topo
from tf_yarn_tpu import resilience as j_res
from tf_yarn_tpu import training as j_training
from tf_yarn_tpu.coordination import kv as j_kv
from tf_yarn_tpu.ranking.server import RankServer as JRankServer
from tf_yarn_tpu.serving.server import ServingServer as JServingServer
from tf_yarn_tpu.utils import metrics as j_metrics
from tf_yarn_tpu_torch import _env as t_env
from tf_yarn_tpu_torch import _task_commons as t_commons
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import constants as t_constants
from tf_yarn_tpu_torch import event as t_event
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import resilience as t_res
from tf_yarn_tpu_torch import telemetry as t_telemetry
from tf_yarn_tpu_torch import topologies as t_topo
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch._device import resolve_device, task_device
from tf_yarn_tpu_torch._internal import dumps_fn
from tf_yarn_tpu_torch.coordination import kv as t_kv
from tf_yarn_tpu_torch.ranking.server import RankServer as TRankServer
from tf_yarn_tpu_torch.serving.server import ServingServer as TServingServer
from tf_yarn_tpu_torch.utils import metrics as t_metrics

PACKAGES = {"jax": (j_topo, j_topo.NodeLabel.TPU),
            "port": (t_topo, t_topo.NodeLabel.GPU)}


# -- topologies ---------------------------------------------------------------

def _spec(topo, chip_label, label="cpu", **kw):
    """A TaskSpec of `topo`'s package; "chips" maps to TPU or GPU."""
    return topo.TaskSpec(
        label=chip_label if label == "chips" else topo.NodeLabel.CPU, **kw)


TOPOLOGY_CASES = {
    "workers": lambda s: {"worker": s(instances=2)},
    "chief_and_workers": lambda s: {"chief": s(label="chips", chips_per_host=4),
                                    "worker": s(instances=3, label="chips",
                                                chips_per_host=4)},
    "two_chiefs": lambda s: {"chief": s(instances=2)},
    "ps": lambda s: {"ps": s(), "worker": s()},
    "empty": lambda s: {},
    "evaluator_only": lambda s: {"evaluator": s()},
    "two_evaluators": lambda s: {"worker": s(), "evaluator": s(instances=2)},
    "evaluator_on_chips": lambda s: {"worker": s(),
                                     "evaluator": s(label="chips",
                                                    chips_per_host=1)},
    "router_alone": lambda s: {"router": s(), "worker": s()},
    "router_and_serving": lambda s: {"router": s(), "serving": s(instances=2)},
    "router_on_chips": lambda s: {"router": s(label="chips", chips_per_host=1),
                                  "serving": s()},
    "prefill_alone": lambda s: {"prefill": s(), "worker": s()},
    "prefill_and_serving": lambda s: {"prefill": s(), "serving": s()},
    "nine_chips": lambda s: {"worker": s(label="chips", chips_per_host=9)},
    "chips_label_without_chips": lambda s: {"worker": s(label="chips")},
    "cpu_label_with_chips": lambda s: {"worker": s(chips_per_host=2)},
    "too_much_memory": lambda s: {"worker": s(memory_gib=500)},
    "too_many_vcores": lambda s: {"worker": s(vcores=300)},
    "no_processes": lambda s: {"worker": s(nb_proc_per_worker=0)},
    "zero_workers_with_rank": lambda s: {"worker": s(instances=0),
                                         "rank": s()},
}


def _verdict(topo, chip_label, case):
    try:
        specs = TOPOLOGY_CASES[case](
            lambda **kw: _spec(topo, chip_label, **kw))
        topo.check_topology(specs)
    except ValueError:
        return "ValueError", None
    return "ok", (topo.compute_nb_hosts(specs), topo.compute_nb_chips(specs))


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_check_topology_verdict_equals_jax(case):
    assert _verdict(*PACKAGES["port"], case) == _verdict(*PACKAGES["jax"], case)


def test_presets_equal_jax_with_the_chip_label_mapped():
    def fields(specs, chip_label):
        return {t: (s.memory_gib, s.vcores, s.instances, s.chips_per_host,
                    s.nb_proc_per_worker, s.label is chip_label)
                for t, s in specs.items()}

    assert fields(t_topo.single_server_topology(chips=4), t_topo.NodeLabel.GPU) \
        == fields(j_topo.single_server_topology(chips=4), j_topo.NodeLabel.TPU)
    for evaluator in (False, True):
        got = t_topo.allreduce_topology(3, chips_per_host=8,
                                        with_evaluator=evaluator)
        ref = j_topo.allreduce_topology(3, chips_per_host=8,
                                        with_evaluator=evaluator)
        assert fields(got, t_topo.NodeLabel.GPU) \
            == fields(ref, j_topo.NodeLabel.TPU)
    assert t_topo.NodeLabel.GPU.value == "gpu"
    assert t_topo.TaskKey.from_kv_str("worker:3") == ("worker", 3)


# The replica presets at their defaults and at other sizes (a CPU-only
# replica where chips_per_host is 0; a prefill tier of none), each
# call's arguments given to both packages.
REPLICA_PRESETS = {
    "serving": ("serving_topology", {}),
    "serving_three_on_two_chips": ("serving_topology",
                                   {"instances": 3, "chips_per_host": 2}),
    "serving_on_the_cpu": ("serving_topology", {"chips_per_host": 0}),
    "serving_none": ("serving_topology", {"instances": 0}),
    "disaggregated": ("disaggregated_topology", {}),
    "disaggregated_sized": ("disaggregated_topology", {
        "n_prefill": 2, "n_decode": 3, "decode_chips_per_host": 1,
        "prefill_chips_per_host": 4, "prefill_memory_gib": 64}),
    "disaggregated_cpu_prefill": ("disaggregated_topology",
                                  {"prefill_chips_per_host": 0}),
    "disaggregated_no_prefill": ("disaggregated_topology", {"n_prefill": 0}),
    "disaggregated_no_decode": ("disaggregated_topology", {"n_decode": 0}),
    "ranking": ("ranking_topology", {}),
    "ranking_two_on_eight_chips": ("ranking_topology",
                                   {"instances": 2, "chips_per_host": 8}),
    "ranking_nine_chips": ("ranking_topology", {"chips_per_host": 9}),
}


@pytest.mark.parametrize("case", sorted(REPLICA_PRESETS))
def test_replica_presets_equal_jax_with_the_chip_label_mapped(case):
    name, kwargs = REPLICA_PRESETS[case]

    def verdict(topo, chip_label):
        try:
            specs = getattr(topo, name)(**kwargs)
        except ValueError as exc:
            return "ValueError", str(exc)
        return {t: (s.memory_gib, s.vcores, s.instances, s.chips_per_host,
                    s.nb_proc_per_worker, s.label is chip_label)
                for t, s in specs.items()}

    assert verdict(*PACKAGES["port"]) == verdict(*PACKAGES["jax"])


# -- ranks, world size, chief ---------------------------------------------

CLUSTERS = {
    "workers": [("worker:0", 1), ("worker:1", 1)],
    "chief_first": [("worker:1", 2), ("chief:0", 1), ("worker:0", 3)],
    "with_side_types": [("serving:0", 1), ("worker:2", 1), ("worker:0", 2),
                        ("rank:1", 1)],
    "one": [("chief:0", 4)],
}


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_ranks_world_size_and_chief_equal_jax(cluster):
    def layout(commons, topo):
        tasks = [topo.TaskInstance(topo.TaskKey.from_kv_str(t), n)
                 for t, n in CLUSTERS[cluster]]
        out = {"world": commons.compute_world_size(tasks)}
        for ti in tasks:
            out[ti.to_kv_str()] = (
                [commons.compute_rank(ti.key, tasks, r) for r in range(ti.nb_proc)],
                commons.is_chief(ti.key, tasks))
        return out

    assert layout(t_commons, t_topo) == layout(j_commons, j_topo)


# -- task modules, keys -----------------------------------------------------

@pytest.mark.parametrize("custom", [None, "my.tasks.program"])
@pytest.mark.parametrize("task_type", sorted(j_topo.ALL_TASK_TYPES))
def test_gen_task_module_names_the_port_package(task_type, custom):
    got = t_env.gen_task_module(task_type, custom)
    ref = j_env.gen_task_module(task_type, custom)
    assert got == ref.replace("tf_yarn_tpu.", "tf_yarn_tpu_torch.", 1)


def _public_strings(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, str)}


def test_event_and_constant_keys_equal_jax():
    assert _public_strings(t_event) == _public_strings(j_event)
    assert _public_strings(t_constants) == _public_strings(j_constants)
    assert t_constants.elastic_env_vars("serving") \
        == j_constants.elastic_env_vars("serving")
    for name in ("serving_endpoint_event_name", "router_endpoint_event_name",
                 "rank_endpoint_event_name", "prefill_endpoint_event_name"):
        assert getattr(t_event, name)("serving:1") \
            == getattr(j_event, name)("serving:1")
    assert t_event.fleet_desired_event_name("router:0", "rank") \
        == j_event.fleet_desired_event_name("router:0", "rank")


# -- failure kinds, retries ----------------------------------------------------

class _Tagged(Exception):
    tpu_yarn_failure_kind = "PREEMPTED"


EXCEPTIONS = {
    "value": lambda pkg: ValueError("bad"),
    "key": lambda pkg: KeyError("k"),
    "type": lambda pkg: TypeError("t"),
    "not_implemented": lambda pkg: NotImplementedError("n"),
    "import": lambda pkg: ModuleNotFoundError("m"),
    "timeout": lambda pkg: TimeoutError("t"),
    "kv_timeout": lambda pkg: pkg["kv"].KVTimeoutError("w"),
    "connection_reset": lambda pkg: ConnectionResetError("c"),
    "os": lambda pkg: OSError("o"),
    "memory": lambda pkg: MemoryError(),
    "runtime": lambda pkg: RuntimeError("no CUDA device is available"),
    "no_device": lambda pkg: _missing_device_error(pkg["find_device"]),
    "preempted": lambda pkg: pkg["preemption"].Preempted("drain"),
    "tagged": lambda pkg: _Tagged("x"),
    "keyboard": lambda pkg: KeyboardInterrupt(),
}
PKG = {"jax": {"kv": j_kv, "preemption": j_preemption, "res": j_res,
               "find_device": lambda: jax.devices("tpu")},
       "port": {"kv": t_kv, "preemption": t_preemption, "res": t_res,
                "find_device": lambda: resolve_device(None)}}


def _missing_device_error(find_device):
    """What each package raises on a host without its accelerator: JAX
    asked for a TPU backend, the port for the CUDA device."""
    try:
        find_device()
    except RuntimeError as exc:
        return exc
    pytest.skip("this host has the accelerator")


def _raised(exc):
    try:
        raise exc
    except BaseException as caught:  # noqa: B036 - a traceback to encode
        return caught


@pytest.mark.parametrize("name", sorted(EXCEPTIONS))
def test_failure_kinds_and_stop_payloads_equal_jax(name):
    kinds = {}
    for side, pkg in PKG.items():
        exc = _raised(EXCEPTIONS[name](pkg))
        payload = pkg["res"].encode_failure(exc)
        # Each package decodes the other's payload.
        other = PKG["port" if side == "jax" else "jax"]["res"]
        kinds[side] = (pkg["res"].classify_exception(exc).value,
                       other.classify_stop_payload(payload)[0].value)
        # Legacy payloads: the bare traceback, classified by its last line.
        bare = pkg["res"].split_kind(payload)[1]
        kinds[side + "_legacy"] = (
            t_res.classify_stop_payload(bare)[0].value,
            j_res.classify_stop_payload(bare)[0].value)
    assert kinds["port"] == kinds["jax"]
    assert kinds["port_legacy"] == kinds["jax_legacy"]
    assert kinds["port"][0] == kinds["port"][1]


def test_worst_and_retry_budgets_equal_jax():
    for kinds in (["TRANSIENT", "LOST_TASK"], ["PREEMPTED", "LOST_TASK"],
                  ["FATAL_USER", "PREEMPTED"], []):
        got = t_res.worst(t_res.FailureKind(k) for k in kinds)
        ref = j_res.worst(j_res.FailureKind(k) for k in kinds)
        assert (got and got.value) == (ref and ref.value)
    for n in (0, 2):
        got = t_res.RetryPolicy.from_nb_retries(n, seed=7)
        ref = j_res.RetryPolicy.from_nb_retries(n, seed=7)
        assert {k.value: v for k, v in got.budgets.items()} \
            == {k.value: v for k, v in ref.budgets.items()}
        sequence = ["TRANSIENT", "TRANSIENT", "PREEMPTED", "FATAL_USER",
                    "LOST_TASK", "TRANSIENT", "LOST_TASK"]
        assert [got.next_delay(t_res.FailureKind(k)) for k in sequence] \
            == [ref.next_delay(j_res.FailureKind(k)) for k in sequence]
    clock = iter([0.0, 4.0, 11.0]).__next__
    deadline = t_res.Deadline(10.0, clock=clock)
    assert deadline.remaining() == 6.0 and deadline.expired()


# -- the KV wire both ways ------------------------------------------------------

def _kv_script(client, kv_mod):
    out = [client.put("a/x", b"1"), client.get("a/x"), client.get("missing"),
           client.incr("counter"), client.incr("counter", 5),
           client.put_str("a/y", "two"), client.wait("a/y", timeout=5),
           client.keys("a/"), client.keys(), client.delete("a/x"),
           client.get("a/x"), client.events(0), client.events(3),
           client.ping()]
    with pytest.raises(kv_mod.KVTimeoutError):
        client.wait("never", timeout=0.2)
    with pytest.raises(TypeError):
        client.put("b", "not bytes")  # the client base64s bytes only
    client.close()
    return out


@pytest.mark.parametrize("server_side, client_side",
                         [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_kv_wire_equals_jax_both_ways(server_side, client_side):
    def run(server_kv, client_kv):
        server = server_kv.KVServer().start()
        try:
            return _kv_script(client_kv.KVClient(server.endpoint), client_kv)
        finally:
            server.stop()

    sides = {"jax": j_kv, "port": t_kv}
    assert run(sides[server_side], sides[client_side]) == run(j_kv, j_kv)


def test_handle_events_and_task_metrics_equal_jax():
    def fold(kv_mod, event_mod, metrics_mod):
        kv = kv_mod.InProcessKV()
        event_mod.start_time_event(kv, "worker:0")
        event_mod.train_eval_start_event(kv, "worker:0")
        event_mod.metrics_event(kv, "worker:0", json.dumps({"train/x": 2.0}))
        event_mod.train_eval_stop_event(kv, "worker:0")
        event_mod.stop_event(kv, "worker:0")
        event_mod.stop_time_event(kv, "worker:0")
        event_mod.start_event(kv, "worker:1")
        event_mod.stop_event(kv, "worker:1", _raised(ValueError("boom")))
        event_mod.start_event(kv, "worker:2")
        event_mod.heartbeat_event(kv, "worker:2", timestamp=100.0)
        tasks = ["worker:0", "worker:1", "worker:2", "worker:3"]
        metrics, outcomes = metrics_mod.handle_events(kv, tasks)
        return (sorted(metrics.container_duration),
                metrics.total_training_duration is not None,
                {t: (o.status, o.kind and o.kind.value,
                     o.exception.strip().splitlines()[-1:])
                 for t, o in outcomes.items()},
                metrics_mod.collect_task_metrics(kv, tasks),
                metrics_mod.task_heartbeats(kv, tasks, now=130.0),
                metrics_mod.stopped_heartbeats(kv, tasks))

    assert fold(t_kv, t_event, t_metrics) == fold(j_kv, j_event, j_metrics)


def test_watchdog_declares_the_same_tasks_lost_as_jax():
    def lost(kv_mod, event_mod, res):
        kv = kv_mod.InProcessKV()
        event_mod.heartbeat_event(kv, "worker:0", timestamp=10.0)
        event_mod.heartbeat_event(kv, "worker:1", timestamp=10.0)
        event_mod.heartbeat_stopped_event(kv, "worker:1", timestamp=11.0)
        event_mod.heartbeat_event(kv, "worker:2", timestamp=29.0)
        dog = res.HeartbeatWatchdog(kv, ["worker:0", "worker:1", "worker:2",
                                         "worker:3"], 5.0, clock=lambda: 30.0)
        return dog.poll(), dog.poll()

    assert lost(t_kv, t_event, t_res) == lost(j_kv, j_event, j_res) \
        == (["worker:0"], [])


def test_steps_hook_broadcasts_the_keys_jax_broadcasts():
    class Runtime:
        task = "worker:0"
        n_try = 0

    def keys(kv_mod, hook):
        Runtime.kv = kv = kv_mod.InProcessKV()
        # The registry is process-global: steps an earlier test trained
        # in this process would count too.
        t_telemetry.get_registry().clear()
        hook.record_batch(8)
        hook.after_step(1, {"loss": 1.0}, force=True)
        return kv.keys(), json.loads(kv.get_str("worker:0/metrics"))

    got = keys(t_kv, t_training._StepsPerSecondHook(
        1, samples_per_step=8, tokens_per_step=64, runtime=Runtime))
    ref = keys(j_kv, j_training._StepsPerSecondHook(
        Runtime, 1, samples_per_step=8, tokens_per_step=64))
    assert got[0] == ref[0]
    assert "worker:0/last_training_step" in got[0]
    assert got[1]["train/steps_total"] == 1.0


def test_trace_files_land_where_jax_puts_them(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_YARN_TRACE", str(tmp_path))
    monkeypatch.setenv("TPU_YARN_TRACE_JSONL", "1")
    try:
        path = t_telemetry.enable_env_jsonl("worker:0")
        with t_telemetry.span("launcher/test", n=1):
            pass
        trace = t_telemetry.export_trace("worker:0")
    finally:
        t_telemetry.close_jsonl_sinks()
    assert os.path.basename(trace) == "trace_worker-0.json"
    assert os.path.basename(path) == "spans_worker-0.jsonl"
    lines = [json.loads(line) for line in open(path)]
    assert lines[-1]["name"] == "launcher/test"
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert "launcher/test" in names


# -- the device of a launched task -------------------------------------------

def test_task_device_follows_tpu_yarn_platform(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert task_device() == torch.device("cpu")
    for value in (None, "cuda", "gpu"):
        if value is None:
            monkeypatch.delenv("TPU_YARN_PLATFORM")
        else:
            monkeypatch.setenv("TPU_YARN_PLATFORM", value)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            task_device()
    monkeypatch.setenv("TPU_YARN_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="TPU_YARN_PLATFORM"):
        task_device()


# -- pickling and what run_on_gpu refuses -------------------------------------

def test_without_cloudpickle_only_importable_fns_are_sent(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    safe = t_client.get_safe_experiment_fn("os.path.join", "a", "b")
    assert pickle.loads(dumps_fn(safe))() == os.path.join("a", "b")

    def nested():
        return None

    for fn in (nested, lambda: None):
        with pytest.raises((pickle.PicklingError, AttributeError)):
            dumps_fn(fn)
    monkeypatch.setattr(t_client, "_setup_cluster", _no_launch)
    with pytest.raises(TypeError, match="get_safe_experiment_fn"):
        t_client.run_on_gpu(nested, {"worker": t_topo.TaskSpec()})


def _no_launch(*args, **kwargs):
    raise AssertionError("run_on_gpu launched a refused run")


class _RemoteBackend(t_client.SliceBackend):
    def launch(self, services, log_dir):
        raise AssertionError("launched through a refused backend")


REFUSED = {
    "remote_backend": ({"worker": 1}, {"backend": _RemoteBackend()}, "item 5"),
    "ship_code": ({"worker": 1}, {"ship_code": True}, "item 5"),
    "requirements": ({"worker": 1}, {"requirements": ["numpy"]}, "item 5"),
    "wheels_dir": ({"worker": 1}, {"wheels_dir": "/nowhere"}, "item 5"),
    "env_staging_dir": ({"worker": 1}, {"env_staging_dir": "/x"}, "item 5"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_parts_are_refused_before_launch(case, monkeypatch):
    counts, kwargs, item = REFUSED[case]
    monkeypatch.setattr(t_client, "_setup_cluster", _no_launch)
    specs = {t: t_topo.TaskSpec(instances=n) for t, n in counts.items()}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1") as err:
        t_client.run_on_gpu(t_client.get_safe_experiment_fn("os.getcwd"),
                            specs, **kwargs)
    assert item in str(err.value)


def test_get_safe_experiment_fn():
    fn = t_client.get_safe_experiment_fn("os.getcwd")
    assert fn() == os.getcwd()
    with pytest.raises(ValueError):
        t_client.get_safe_experiment_fn("not_a_path")


# -- the repair: /healthz under the preemption notice -------------------------

class _StubScheduler:
    """What /healthz reads of either scheduler: its stats."""

    def stats(self):
        return {"draining": False, "active_slots": 0, "queue_depth": 0,
                "queued_rows": 0}


def _healthz(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())["status"]
    finally:
        conn.close()


@pytest.mark.parametrize("server_cls, preemption", [
    (JServingServer, j_preemption), (JRankServer, j_preemption),
    (TServingServer, t_preemption), (TRankServer, t_preemption)],
    ids=["jax-serving", "jax-rank", "port-serving", "port-rank"])
def test_healthz_drains_on_the_preemption_notice(server_cls, preemption):
    server = server_cls(_StubScheduler(), "127.0.0.1", 0)
    server.start()
    try:
        assert _healthz(server.port) == "ok"
        preemption.request()
        try:
            assert _healthz(server.port) == "draining"
        finally:
            preemption.reset()
        assert _healthz(server.port) == "ok"
    finally:
        server.stop()


def test_heartbeat_beats_and_tombstones_like_jax():
    def beats(kv_mod, telemetry_mod):
        kv = kv_mod.InProcessKV()
        beat = telemetry_mod.Heartbeat(kv, "worker:0", every=0.05)
        with beat:
            deadline = time.monotonic() + 10
            while beat.beats < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        return sorted(kv.keys()), beat.beats >= 2

    from tf_yarn_tpu import telemetry as j_telemetry

    assert beats(t_kv, t_telemetry) == beats(j_kv, j_telemetry) == (
        ["worker:0/heartbeat", "worker:0/heartbeat.stopped"], True)
