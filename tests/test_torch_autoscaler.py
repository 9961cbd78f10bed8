"""The port's fleet autoscaler (`tf_yarn_tpu_torch.fleet.autoscaler`) held
against the JAX package's: every case of tests/test_autoscaler.py runs on
both packages' `FleetAutoscaler` with the same registry snapshots and
monitor aggregates, the same fake actuator and the same block pulls, and
the records must be equal — knob verdicts, actuations, cycle reports
(decisions, `ScaleEvent`s, warm starts), `stats()` and the decision
counters. Then the peer warm start on real port replicas over
``/v1/blocks``: a scale-out's newcomer and a replica relaunched at a new
port are primed from a veteran and hit the imported prefix, with streams
equal to JAX `generate_legacy` on the bridged weights."""

import json
import types

import numpy as np
import pytest

import jax.numpy as jnp

from tests.test_torch_swap import BUCKETS, jax_model, port_model
from tf_yarn_tpu import telemetry as j_telemetry
from tf_yarn_tpu.experiment import ServingExperiment as JServingExperiment
from tf_yarn_tpu.fleet import autoscaler as j_autoscaler
from tf_yarn_tpu_torch import telemetry as t_telemetry
from tf_yarn_tpu_torch.experiment import ServingExperiment as TServingExperiment
from tf_yarn_tpu_torch.fleet import autoscaler as t_autoscaler

PACKAGES = {
    "jax": types.SimpleNamespace(autoscaler=j_autoscaler,
                                 telemetry=j_telemetry,
                                 ServingExperiment=JServingExperiment),
    "port": types.SimpleNamespace(autoscaler=t_autoscaler,
                                  telemetry=t_telemetry,
                                  ServingExperiment=TServingExperiment),
}


def both(scenario):
    got = {name: scenario(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def verdict(fn, *args, **kwargs):
    try:
        result = fn(*args, **kwargs)
    except Exception as exc:  # the verdict is the exception
        return type(exc).__name__, str(exc)
    return "ok", result


class StubFleet:
    """The registry contract the autoscaler reads: `snapshot()`."""

    def __init__(self):
        self.replicas = {}

    def set(self, task, *, kind="generate", state="healthy", endpoint=None,
            queue_depth=0, active_slots=0, inflight=0, readmissions=0):
        self.replicas[task] = {
            "task": task, "kind": kind, "state": state,
            "endpoint": endpoint or f"127.0.0.1:9{task.split(':')[1]}00",
            "queue_depth": queue_depth, "active_slots": active_slots,
            "inflight": inflight, "readmissions": readmissions,
        }

    def snapshot(self):
        return {"replicas": {t: dict(r) for t, r in self.replicas.items()}}


class StubMonitor:
    def __init__(self):
        self.histograms = {}
        self.slo = {}

    def aggregate(self):
        return {"histograms": dict(self.histograms), "slo": dict(self.slo)}


def _autoscaler(p, policies, fleet=None, monitor=None, **kwargs):
    """`p`'s FleetAutoscaler over stubs, a recording actuator and a
    recording block pull; returns it and the record."""
    p.telemetry.get_registry().clear()
    record = {"actuations": [], "pulls": []}
    kwargs.setdefault(
        "actuate", lambda kind, cur, tgt, reason: record["actuations"].append(
            (kind, cur, tgt, reason)) or True)

    def fetch(endpoint):
        record["pulls"].append(("fetch", endpoint))
        return b'{"n_blocks": 2}'

    def push(endpoint, body):
        record["pulls"].append(("push", endpoint, body))
        return {"imported_blocks": 2, "registered_entries": 1}

    kwargs.setdefault("fetch_blocks", fetch)
    kwargs.setdefault("push_blocks", push)
    policies = {kind: (p.autoscaler.AutoscalePolicy(**policy)
                       if isinstance(policy, dict) else policy)
                for kind, policy in policies.items()}
    autoscaler = p.autoscaler.FleetAutoscaler(
        fleet if fleet is not None else StubFleet(), monitor, policies,
        **kwargs)
    return autoscaler, record


def _scale_counters(p):
    return {key: value for key, value in
            p.telemetry.get_registry().snapshot().items()
            if key.startswith(("fleet/scale_events_total",
                               "fleet/warm_start_blocks_total"))}


def _run(autoscaler, record, p, cycles, between=None):
    """`cycles` poll_once reports (with `between(i)` before cycle i), the
    record, stats() and the counters."""
    reports = []
    for index in range(cycles):
        if between is not None:
            between(index)
        reports.append(autoscaler.poll_once())
    return reports, record, autoscaler.stats(), _scale_counters(p)


# -- knob validation ------------------------------------------------------------

PARSE_CASES = {
    "ok": {"generate": {"min_replicas": 1, "max_replicas": 3},
           "rank": {"max_replicas": 2}},
    "empty": {},
    "not_dict": "generate",
    "unknown_kind": {"worker": {}},
    "unknown_field": {"generate": {"no_such_knob": 1}},
    "not_field_dict": {"generate": 3},
    "prefill": {"prefill": {"max_replicas": 2, "scale_out_p95_s": 0.5}},
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_autoscale_verdicts_equal_jax(case):
    def scenario(p):
        kind, result = verdict(p.autoscaler.parse_autoscale,
                               PARSE_CASES[case])
        if kind == "ok":
            import dataclasses

            result = {k: dataclasses.asdict(v) for k, v in result.items()}
        return kind, result

    kind, _ = both(scenario)
    assert (kind == "ok") == (case in ("ok", "prefill"))


POLICY_CASES = {
    "defaults": {},
    "min_negative": {"min_replicas": -1},
    "max_below_min": {"min_replicas": 3, "max_replicas": 2},
    "max_zero": {"min_replicas": 0, "max_replicas": 0},
    "step": {"step": 0},
    "cooldown": {"cooldown_cycles": -1},
    "queue_depth": {"scale_out_queue_depth": 0},
    "p95": {"scale_out_p95_s": -1.0},
    "scale_in": {"scale_in_load": -0.5},
    "all_none": {"scale_out_queue_depth": None, "scale_in_load": None},
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_verdicts_equal_jax(case):
    def scenario(p):
        kind, result = verdict(p.autoscaler.AutoscalePolicy,
                               **POLICY_CASES[case])
        return kind, (result if kind != "ok" else repr(result).split("(")[1])

    both(scenario)


def test_launch_eta_clamped_as_in_jax():
    def scenario(p):
        a = p.autoscaler
        clamps = [a.clamp_launch_eta(x) for x in (0.01, 7200.0, 42.0)]
        autoscaler, _ = _autoscaler(p, {"generate": {}},
                                    launch_eta_s=10_000.0)
        errors = [verdict(_autoscaler, p, {"generate": {}}, **kwargs)[1]
                  for kwargs in ({"launch_eta_s": 0}, {"interval_s": 0})]
        return clamps, autoscaler.launch_eta_hint(), errors

    clamps, hint, _ = both(scenario)
    assert clamps == [t_autoscaler.LAUNCH_ETA_FLOOR_S,
                      t_autoscaler.LAUNCH_ETA_CEILING_S, 42.0]
    assert hint == t_autoscaler.LAUNCH_ETA_CEILING_S


# -- triggers, cooldown, the self-healing floor --------------------------------

def _queue_depth_cooldown(p):
    fleet = StubFleet()
    fleet.set("serving:0", queue_depth=5)
    fleet.set("serving:1", queue_depth=5)
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 1, "max_replicas": 4,
                         "scale_out_queue_depth": 4.0,
                         "cooldown_cycles": 2}}, fleet=fleet)
    return _run(autoscaler, record, p, 4)


def _p95_and_burn(p):
    fleet = StubFleet()
    fleet.set("serving:0")
    fleet.set("rank:0", kind="rank")
    monitor = StubMonitor()
    monitor.histograms["serving/ttft_seconds"] = {"p95": 2.5}
    monitor.slo["ttft"] = {"metric": "serving/ttft_seconds",
                           "status": "violated"}
    policy = {"max_replicas": 3, "scale_out_queue_depth": None,
              "scale_out_p95_s": 1.0, "cooldown_cycles": 0}
    autoscaler, record = _autoscaler(
        p, {"generate": policy, "rank": policy}, fleet=fleet,
        monitor=monitor)

    def between(index):
        if index == 1:  # the burn alone scales generate
            del monitor.histograms["serving/ttft_seconds"]
        if index == 2:  # a rank latency and a ranking burn
            monitor.histograms["ranking/request_seconds"] = {"p95": 0.2}
            monitor.slo["rank"] = {"metric": "ranking/request_seconds",
                                   "status": "violated"}

    return _run(autoscaler, record, p, 3, between)


def _below_min(p):
    fleet = StubFleet()
    fleet.set("serving:0", queue_depth=50)
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 2, "max_replicas": 4,
                         "cooldown_cycles": 5}}, fleet=fleet)
    return _run(autoscaler, record, p, 2)


def _below_min_from_empty(p):
    """No replica seen yet: below_min from 0 toward min_replicas (the
    launched router's first cycle can come before its registry's first
    refresh)."""
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 2, "max_replicas": 2,
                         "scale_in_load": None}})
    return _run(autoscaler, record, p, 1)


def _scale_in(p):
    fleet = StubFleet()
    for i in range(3):
        fleet.set(f"serving:{i}")
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 1, "max_replicas": 4,
                         "scale_out_queue_depth": None, "scale_in_load": 0.5,
                         "cooldown_cycles": 0}}, fleet=fleet)

    def between(index):
        if index == 1:  # a booting replica blocks scale-in
            fleet.set("serving:3", state="pending")

    return _run(autoscaler, record, p, 2, between)


def _actuator_refuses(p):
    fleet = StubFleet()
    fleet.set("serving:0", queue_depth=9)
    policy = {"generate": {"max_replicas": 3, "scale_out_queue_depth": 1.0,
                           "cooldown_cycles": 0}}
    refused = _run(*_autoscaler(p, policy, fleet=fleet,
                                actuate=lambda *a: False), p, 1)

    def explode(kind, cur, tgt, reason):
        raise ConnectionError("driver unreachable")

    exploded = _run(*_autoscaler(p, policy, fleet=fleet, actuate=explode),
                    p, 1)
    return refused, exploded


def _max_replicas(p):
    fleet = StubFleet()
    fleet.set("serving:0", queue_depth=99)
    fleet.set("serving:1", queue_depth=99)
    autoscaler, record = _autoscaler(
        p, {"generate": {"max_replicas": 2, "scale_out_queue_depth": 1.0,
                         "cooldown_cycles": 0}}, fleet=fleet)
    return _run(autoscaler, record, p, 1)


def _decision_only(p):
    """`actuate=None`: decisions are recorded as actuated."""
    fleet = StubFleet()
    fleet.set("serving:0", state="ejected")
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 1, "max_replicas": 2}}, fleet=fleet,
        actuate=None)
    return _run(autoscaler, record, p, 2)


# -- the peer warm start: an endpoint change is the cold-cache signal ---------

def _warm_fixture(p, **kwargs):
    fleet = StubFleet()
    fleet.set("serving:0", endpoint="127.0.0.1:9000")
    fleet.set("serving:1", endpoint="127.0.0.1:9100")
    autoscaler, record = _autoscaler(
        p, {"generate": {"min_replicas": 1, "max_replicas": 4,
                         "scale_out_queue_depth": None,
                         "scale_in_load": None}}, fleet=fleet, **kwargs)
    return fleet, autoscaler, record


def _warm_on_endpoint_change(p):
    fleet, autoscaler, record = _warm_fixture(p)

    def between(index):
        if index == 1:
            fleet.set("serving:0", endpoint="127.0.0.1:9555")

    return _run(autoscaler, record, p, 3, between)


def _warm_same_endpoint(p):
    fleet, autoscaler, record = _warm_fixture(p)

    def between(index):
        if index == 1:
            fleet.set("serving:0", endpoint="127.0.0.1:9000", readmissions=1)

    return _run(autoscaler, record, p, 2, between)


def _warm_newcomers(p):
    fleet, autoscaler, record = _warm_fixture(p)

    def between(index):
        if index == 1:
            fleet.set("serving:2", endpoint="127.0.0.1:9200")
            fleet.set("serving:3", endpoint="127.0.0.1:9300")

    return _run(autoscaler, record, p, 2, between)


def _warm_without_peer(p):
    fleet = StubFleet()
    fleet.set("serving:0", endpoint="127.0.0.1:9000")
    autoscaler, record = _autoscaler(p, {"generate": {"max_replicas": 2}},
                                     fleet=fleet)

    def between(index):
        if index == 1:
            fleet.set("serving:0", endpoint="127.0.0.1:9555")

    return _run(autoscaler, record, p, 2, between)


def _warm_pull_fails(p):
    def broken(endpoint):
        raise ConnectionError("donor mid-drain")

    fleet, autoscaler, record = _warm_fixture(p, fetch_blocks=broken)

    def between(index):
        if index == 1:
            fleet.set("serving:0", endpoint="127.0.0.1:9555")

    return _run(autoscaler, record, p, 3, between)


def _warm_disabled(p):
    fleet, autoscaler, record = _warm_fixture(p, warm_start=False)

    def between(index):
        if index == 1:
            fleet.set("serving:0", endpoint="127.0.0.1:9555")

    return _run(autoscaler, record, p, 2, between)


def _stats_and_lifecycle(p):
    autoscaler, _record = _autoscaler(p, {"generate": {"max_replicas": 2}},
                                      launch_eta_s=30.0)
    stats = autoscaler.stats()
    autoscaler.start()
    autoscaler.start()  # idempotent
    autoscaler.stop()
    autoscaler.stop()
    return stats


CASES = {
    "queue_depth_with_cooldown": _queue_depth_cooldown,
    "p95_and_slo_burn_by_kind": _p95_and_burn,
    "below_min_ignores_cooldown": _below_min,
    "below_min_from_an_empty_view": _below_min_from_empty,
    "scale_in_when_idle": _scale_in,
    "actuator_failure": _actuator_refuses,
    "no_scale_out_past_max": _max_replicas,
    "decision_only": _decision_only,
    "warm_start_on_endpoint_change": _warm_on_endpoint_change,
    "warm_start_skips_same_endpoint": _warm_same_endpoint,
    "warm_start_newcomers_from_veterans": _warm_newcomers,
    "warm_start_without_peer": _warm_without_peer,
    "warm_start_pull_failure": _warm_pull_fails,
    "warm_start_disabled": _warm_disabled,
    "stats_and_lifecycle": _stats_and_lifecycle,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autoscaler_decides_as_jax(case):
    """Equal reports (decisions, actuated ScaleEvents, warm-start
    records), actuator calls, block pulls, stats() and counters."""
    record = both(CASES[case])
    if case == "queue_depth_with_cooldown":
        reports, calls, _stats, counters = record
        assert [len(r["actuated"]) for r in reports] == [1, 0, 0, 1]
        assert calls["actuations"][0] == ("generate", 2, 3,
                                          "queue_depth_5.00")
        assert counters["fleet/scale_events_total"
                        "{direction=in,kind=generate}"] == 0
    if case == "below_min_from_an_empty_view":
        reports, _calls, _stats, _counters = record
        assert reports[0]["actuated"][0]["from_replicas"] == 0
        assert reports[0]["actuated"][0]["reason"] == "below_min"
    if case == "warm_start_on_endpoint_change":
        _reports, calls, stats, _counters = record
        assert [pull[:2] for pull in calls["pulls"]] == [
            ("fetch", "127.0.0.1:9100"), ("push", "127.0.0.1:9555")]
        assert stats["warm_starts"][-1]["imported_blocks"] == 2


EXPERIMENT_CASES = {
    "defaults": {},
    "autoscale": {"autoscale": {"generate": {"min_replicas": 1,
                                             "max_replicas": 3}}},
    "unknown_kind": {"autoscale": {"worker": {}}},
    "max_zero": {"autoscale": {"generate": {"max_replicas": 0}}},
    "eta_zero": {"autoscale_launch_eta_s": 0.0},
    "eta": {"autoscale_launch_eta_s": 2.5, "autoscale_warm_start": False},
}


@pytest.mark.parametrize("case", sorted(EXPERIMENT_CASES))
def test_serving_experiment_autoscale_knobs_as_jax(case):
    def scenario(p):
        kind, result = verdict(p.ServingExperiment, model=None,
                               model_dir="x", **EXPERIMENT_CASES[case])
        if kind == "ok":
            result = (result.autoscale, result.autoscale_launch_eta_s,
                      result.autoscale_warm_start)
        return kind, result

    both(scenario)


# -- the warm start on real port replicas --------------------------------------

def _legacy(prompt, max_new):
    from tf_yarn_tpu.models.generate import generate_legacy

    model, params = jax_model("bf16")
    out = generate_legacy(model, params, jnp.asarray([prompt], jnp.int32),
                          max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _paged_replica(kv, task):
    from tf_yarn_tpu_torch import event
    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler
    from tf_yarn_tpu_torch.serving.server import ServingServer

    scheduler = SlotScheduler(
        DecodeEngine(port_model("bf16"), prompt_buckets=BUCKETS),
        max_slots=2, kv_layout="paged", block_size=4, num_blocks=32)
    scheduler.start()
    server = ServingServer(scheduler, "127.0.0.1", 0)
    server.start()
    event.serving_endpoint_event(kv, task, server.endpoint)
    event.heartbeat_event(kv, task)
    return {"task": task, "scheduler": scheduler, "server": server}


def _post(port, body):
    import urllib.request

    request = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as reply:
        return reply.status, json.loads(reply.read())


def test_port_fleet_scales_out_and_warm_starts_readmission():
    """tests/test_fleet.py's autoscaled fleet on port replicas: an SLO
    burn scales the generate pool out through the actuator; the newcomer
    is warm-started from the veteran over real /v1/blocks; a replica
    relaunched at a new port is re-admitted and warm-started from the
    survivor; each warm replica's stream equals `generate_legacy` and
    hits the imported prefix."""
    from tf_yarn_tpu_torch.coordination.kv import InProcessKV
    from tf_yarn_tpu_torch.fleet import (
        AutoscalePolicy,
        FleetAutoscaler,
        ReplicaRegistry,
    )

    kv = InProcessKV()
    fleet = {"serving:0": _paged_replica(kv, "serving:0")}
    registry = ReplicaRegistry(kv, probe_interval_s=0.0)
    registry.refresh(force=True)

    class BurnMonitor:
        def aggregate(self):
            return {"slo": {"ttft": {"metric": "serving/ttft_seconds",
                                     "status": "violated"}}}

    def actuate(kind, current, target, reason):
        for index in range(current, target):
            task = f"serving:{index}"
            fleet[task] = _paged_replica(kv, task)
        return kind == "generate"

    autoscaler = FleetAutoscaler(
        registry, BurnMonitor(),
        {"generate": AutoscalePolicy(
            min_replicas=1, max_replicas=2, scale_out_queue_depth=None,
            scale_in_load=None, cooldown_cycles=0)},
        actuate=actuate, launch_eta_s=5.0)
    metrics = t_telemetry.get_registry()
    blocks = metrics.counter("fleet/warm_start_blocks_total").value
    prompt = np.random.RandomState(11).randint(0, 256, (9,)).tolist()
    body = {"prompt": prompt, "max_new_tokens": 6}
    expected = _legacy(prompt, 6)

    def hits(task):
        return fleet[task]["scheduler"].stats()["prefix_cache"]["hits"]

    try:
        status, reply = _post(fleet["serving:0"]["server"].port, body)
        assert status == 200 and reply["tokens"] == expected
        report = autoscaler.poll_once()
        assert report["actuated"][0]["reason"] == "slo_burn_ttft"
        assert report["warm_starts"] == []
        registry.refresh(force=True)
        assert len(registry.healthy()) == 2
        report = autoscaler.poll_once()
        warm = [w for w in report["warm_starts"] if w["task"] == "serving:1"]
        assert warm and warm[0]["imported_blocks"] >= 1, report
        before = hits("serving:1")
        status, reply = _post(fleet["serving:1"]["server"].port, body)
        assert status == 200 and reply["tokens"] == expected
        assert hits("serving:1") > before
        # The veteran is preempted and relaunched at a new port.
        fleet["serving:0"]["server"].stop()
        fleet["serving:0"]["scheduler"].close()
        registry.report_failure("serving:0",
                                ConnectionResetError("preempted"))
        assert [r.task for r in registry.healthy()] == ["serving:1"]
        fleet["serving:0"] = _paged_replica(kv, "serving:0")
        registry.refresh(force=True)
        replica = registry.get("serving:0")
        assert replica.state == "healthy" and replica.readmissions == 1
        assert replica.endpoint == fleet["serving:0"]["server"].endpoint
        report = autoscaler.poll_once()
        warm = [w for w in report["warm_starts"] if w["task"] == "serving:0"]
        assert warm and warm[0]["imported_blocks"] >= 1, report
        status, reply = _post(fleet["serving:0"]["server"].port, body)
        assert status == 200 and reply["tokens"] == expected
        assert hits("serving:0") >= 1
        assert metrics.counter("fleet/warm_start_blocks_total").value \
            >= blocks + 2
        assert {w["task"] for w in autoscaler.stats()["warm_starts"]
                if "imported_blocks" in w} == {"serving:0", "serving:1"}
    finally:
        for entry in fleet.values():
            entry["server"].stop()
            entry["scheduler"].close()
