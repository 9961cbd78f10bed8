"""The port's serving fleet (`tf_yarn_tpu_torch.fleet`: policies, replica
registry, router, fleet monitor) held against the JAX package's on the
CPU. Each scenario runs once on each package's classes with the same
scripted inputs — replica lists, probe answers, KV contents and injected
clocks, fake upstream replicas over HTTP, `signals` payloads — and the
two records must be equal: picks, states, ejection reasons, counters,
HTTP statuses, bodies and headers, aggregates. Then the routers across
packages (the JAX router in front of port replicas and the other way
round) and the port's fleet in process, against JAX `generate_legacy` on
the bridged weights: a replica stopped mid-traffic, the pooled TTFT p95
against the raw timings, and one X-Request-Id in the router's and the
owning replica's spans. Registry refreshes and monitor cycles are driven
explicitly (`refresh(force=True)`, `poll_once()`): nothing waits on a
background interval or asserts on wall time."""

import http.client
import json
import re
import socket
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import jax.numpy as jnp

from tests.test_torch_swap import BUCKETS, jax_model, port_model
from tf_yarn_tpu import event as j_event
from tf_yarn_tpu import fleet as j_fleet
from tf_yarn_tpu import telemetry as j_telemetry
from tf_yarn_tpu.coordination.kv import InProcessKV as JInProcessKV
from tf_yarn_tpu.telemetry import registry as j_registry
from tf_yarn_tpu_torch import event as t_event
from tf_yarn_tpu_torch import fleet as t_fleet
from tf_yarn_tpu_torch import telemetry as t_telemetry
from tf_yarn_tpu_torch.coordination.kv import InProcessKV as TInProcessKV
from tf_yarn_tpu_torch.telemetry import registry as t_registry

PACKAGES = {
    "jax": types.SimpleNamespace(
        fleet=j_fleet, event=j_event, telemetry=j_telemetry,
        KV=JInProcessKV, Histogram=j_registry.Histogram),
    "port": types.SimpleNamespace(
        fleet=t_fleet, event=t_event, telemetry=t_telemetry,
        KV=TInProcessKV, Histogram=t_registry.Histogram),
}
OK = {"status": "ok", "queue_depth": 0, "active_slots": 0}


def both(scenario):
    """`scenario(package)` on each package; the records must be equal.
    Returns the port's."""
    got = {name: scenario(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def counters(p, before=None):
    """The fleet counters of `p`'s process registry (as deltas from
    `before`)."""
    snap = {key: value for key, value in p.telemetry.get_registry()
            .snapshot().items()
            if key.startswith("fleet/") and "_total" in key}
    if before is None:
        return snap
    return {key: value - before.get(key, 0) for key, value in snap.items()
            if value != before.get(key, 0)}


# -- policies ------------------------------------------------------------------

def _replicas(p, rng, n):
    replicas = []
    for index in rng.permutation(n):
        replica = p.fleet.Replica(f"serving:{index}",
                                  endpoint=f"127.0.0.1:{9000 + index}")
        replica.queue_depth = int(rng.randint(0, 4))
        replica.active_slots = int(rng.randint(0, 3))
        replica.inflight = int(rng.randint(0, 2))
        replicas.append(replica)
    return replicas


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_pick_as_jax(policy, seed):
    """The same replica lists (random loads, task order shuffled) and
    exclusions: the same picks, None once everything is excluded."""
    def scenario(p):
        rng = np.random.RandomState(seed)
        chooser = p.fleet.make_policy(policy)
        picks = []
        for _ in range(20):
            replicas = _replicas(p, rng, int(rng.randint(1, 6)))
            exclude = {r.task for r in replicas if rng.rand() < 0.3}
            picked = chooser.pick(replicas, exclude=exclude)
            picks.append(None if picked is None else picked.task)
        everyone = _replicas(p, rng, 3)
        picks.append(chooser.pick(everyone,
                                  exclude={r.task for r in everyone}))
        return chooser.name, picks

    name, picks = both(scenario)
    assert name == policy and None in picks


def test_round_robin_cycles_in_task_order_as_jax():
    def scenario(p):
        replicas = [p.fleet.Replica(t) for t in
                    ("serving:1", "serving:0", "serving:2")]
        policy = p.fleet.RoundRobinPolicy()
        return [policy.pick(replicas).task for _ in range(6)]

    assert both(scenario) == ["serving:0", "serving:1", "serving:2"] * 2


def test_make_policy_names_and_unknown_as_jax():
    def scenario(p):
        with pytest.raises(ValueError) as err:
            p.fleet.make_policy("random")
        return sorted(p.fleet.POLICIES), str(err.value)

    assert both(scenario)[0] == ["least_loaded", "round_robin"]


# -- the registry ----------------------------------------------------------------

class ProbeScript:
    """An injectable /healthz probe steered per endpoint, with the
    registry's two clocks."""

    def __init__(self):
        self.responses = {}
        self.calls = []
        self.now = 100.0
        self.wall = 1.0e9

    def set(self, endpoint, response):
        self.responses[endpoint] = response

    def __call__(self, endpoint):
        self.calls.append(endpoint)
        response = self.responses.get(
            endpoint, ConnectionRefusedError(f"no script for {endpoint}"))
        if isinstance(response, Exception):
            raise response
        return dict(response)


class FlakyKV:
    def __init__(self, kv):
        self._kv = kv
        self.fail = False

    def get_str(self, key):
        if self.fail:
            raise ConnectionError("coordination link down")
        return self._kv.get_str(key)

    def keys(self, prefix=""):
        if self.fail:
            raise ConnectionError("coordination link down")
        return self._kv.keys(prefix)


def _registry(p, kv, script, tasks, **kwargs):
    kwargs.setdefault("probe_interval_s", 0.0)
    return p.fleet.ReplicaRegistry(
        kv, tasks=tasks, probe=script, clock=lambda: script.now,
        wall_clock=lambda: script.wall, **kwargs)


def _observe(p, registry, force=True):
    healthy = [r.task for r in registry.refresh(force=force)]
    return (healthy, registry.snapshot(),
            p.telemetry.get_registry().gauge("fleet/healthy_replicas").value)


def _admission_hold(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7001")
    registry = _registry(p, kv, script, None)  # discovery by KV scan
    script.set("127.0.0.1:7001", ConnectionRefusedError("still booting"))
    steps = [_observe(p, registry), _observe(p, registry)]
    script.set("127.0.0.1:7001", OK)
    steps.append(_observe(p, registry))
    return steps


def _unreachable_readmit(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7002")
    registry = _registry(p, kv, script, ["serving:0"])
    script.set("127.0.0.1:7002", OK)
    steps = [_observe(p, registry)]
    script.set("127.0.0.1:7002", ConnectionResetError("gone"))
    steps.append(_observe(p, registry))
    script.set("127.0.0.1:7002", OK)
    steps.append(_observe(p, registry))
    return steps


def _draining(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7003")
    registry = _registry(p, kv, script, ["serving:0"])
    script.set("127.0.0.1:7003", OK)
    steps = [_observe(p, registry)]
    script.set("127.0.0.1:7003", {**OK, "status": "draining"})
    steps.append(_observe(p, registry))
    script.set("127.0.0.1:7003", {**OK, "status": None})
    steps.append(_observe(p, registry))
    return steps


def _heartbeat_silence(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7004")
    script.set("127.0.0.1:7004", OK)
    registry = _registry(p, kv, script, ["serving:0"], dead_heartbeat_s=5.0)
    steps = [_observe(p, registry)]  # never beat: not flagged
    p.event.heartbeat_event(kv, "serving:0", timestamp=script.wall - 60.0)
    steps.append(_observe(p, registry))
    p.event.heartbeat_event(kv, "serving:0", timestamp=script.wall - 1.0)
    steps.append(_observe(p, registry))
    script.wall += 30.0  # silent again, by the injected wall clock
    steps.append(_observe(p, registry))
    p.event.heartbeat_event(kv, "serving:0", timestamp=script.wall)
    steps.append(_observe(p, registry))
    p.event.heartbeat_stopped_event(kv, "serving:0")
    steps.append(_observe(p, registry))
    return steps


def _kv_flake(p, kv, script):
    inner = kv
    flaky = FlakyKV(inner)
    p.event.serving_endpoint_event(inner, "serving:0", "127.0.0.1:7005")
    p.event.serving_endpoint_event(inner, "serving:1", "127.0.0.1:7006")
    script.set("127.0.0.1:7005", OK)
    script.set("127.0.0.1:7006", OK)
    explicit = _registry(p, flaky, script, ["serving:0"])
    scanned = _registry(p, flaky, script, None)
    steps = [_observe(p, explicit), _observe(p, scanned)]
    flaky.fail = True
    steps += [_observe(p, explicit), _observe(p, scanned)]
    flaky.fail = False
    steps += [_observe(p, explicit), _observe(p, scanned)]
    return steps


def _report_failure(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7007")
    script.set("127.0.0.1:7007", OK)
    registry = _registry(p, kv, script, ["serving:0"],
                         probe_interval_s=3600.0)
    steps = [_observe(p, registry)]
    registry.report_failure("serving:0", ConnectionResetError("mid-request"))
    registry.report_failure("serving:9", ConnectionResetError("unknown"))
    replica = registry.get("serving:0")
    steps.append((registry.snapshot(), replica.last_probe_at,
                  [r.task for r in registry.healthy()]))
    # The probe clock was cleared: a rate-limited refresh probes at once.
    steps.append(_observe(p, registry, force=False))
    script.now += 10.0  # inside the hour: no probe
    calls = len(script.calls)
    steps.append((_observe(p, registry, force=False),
                  len(script.calls) - calls))
    registry.report_failure("serving:0", ValueError("bad upstream body"))
    steps.append(registry.snapshot())
    return steps


def _relaunch_new_port(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7010")
    script.set("127.0.0.1:7010", OK)
    registry = _registry(p, kv, script, ["serving:0"])
    steps = [_observe(p, registry)]
    script.set("127.0.0.1:7010", ConnectionResetError("preempted"))
    steps.append(_observe(p, registry))
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7011")
    script.set("127.0.0.1:7011", OK)
    steps.append(_observe(p, registry))
    return steps


def _endpoint_change_while_healthy(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7012")
    script.set("127.0.0.1:7012", OK)
    registry = _registry(p, kv, script, ["serving:0"])
    steps = [_observe(p, registry)]
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7013")
    script.set("127.0.0.1:7013", ConnectionRefusedError("still booting"))
    steps.append(_observe(p, registry))
    script.set("127.0.0.1:7013", OK)
    steps.append(_observe(p, registry))
    return steps


def _stale_tombstone(p, kv, script):
    """A stopped replica relaunched at a new endpoint: the old tombstone
    belongs to the previous incarnation."""
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7014")
    script.set("127.0.0.1:7014", OK)
    registry = _registry(p, kv, script, ["serving:0"])
    steps = [_observe(p, registry)]
    p.event.heartbeat_stopped_event(kv, "serving:0")
    steps.append(_observe(p, registry))
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7015")
    script.set("127.0.0.1:7015", OK)
    steps.append(_observe(p, registry))
    return steps


def _kinds(p, kv, script):
    """Generate, rank and prefill replicas, by explicit list and by KV
    scan: each kind from the key it advertised under."""
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7020")
    p.event.rank_endpoint_event(kv, "rank:0", "127.0.0.1:7021")
    p.event.prefill_endpoint_event(kv, "prefill:0", "127.0.0.1:7022")
    for port in (7020, 7021, 7022):
        script.set(f"127.0.0.1:{port}", {**OK, "queue_depth": port % 7,
                                         "schema_version": 2})
    script.set("127.0.0.1:7021", {**OK, "schema_version": "two"})
    steps = []
    for tasks in (["prefill:0", "rank:0", "serving:0", "serving:1"], None):
        registry = _registry(p, kv, script, tasks)
        steps.append(_observe(p, registry))
        steps.append({kind: [r.task for r in registry.healthy(kind=kind)]
                      for kind in ("generate", "rank", "prefill")})
        steps.append(registry.healthy()[0].load)
    return steps


def _throttle(p, kv, script):
    p.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7030")
    script.set("127.0.0.1:7030", OK)
    registry = _registry(p, kv, script, ["serving:0"], probe_interval_s=1.0)
    steps = []
    for advance in (0.0, 0.5, 0.6, 0.2, 2.0):
        script.now += advance
        calls = len(script.calls)
        steps.append((_observe(p, registry, force=False),
                      len(script.calls) - calls))
    return steps


REGISTRY_CASES = {
    "admission_hold": _admission_hold,
    "unreachable_readmit": _unreachable_readmit,
    "draining": _draining,
    "heartbeat_silence": _heartbeat_silence,
    "kv_flake": _kv_flake,
    "report_failure": _report_failure,
    "relaunch_new_port": _relaunch_new_port,
    "endpoint_change_while_healthy": _endpoint_change_while_healthy,
    "stale_tombstone": _stale_tombstone,
    "kinds": _kinds,
    "probe_throttle": _throttle,
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_walks_the_states_of_jax(case):
    """The same probes, KV contents and clocks: the same healthy sets,
    snapshots (states, ejection reasons, counts, kinds, schema versions),
    healthy gauge and counter deltas."""
    def scenario(p):
        script = ProbeScript()
        before = counters(p)
        steps = REGISTRY_CASES[case](p, p.KV(), script)
        return steps, script.calls, counters(p, before)

    steps, _calls, deltas = both(scenario)
    if case == "heartbeat_silence":
        assert steps[-1][1]["replicas"]["serving:0"]["state"] == "stopped"
        assert deltas == {"fleet/replica_ejections_total"
                          "{reason=heartbeat_silent}": 2,
                          "fleet/replica_readmissions_total": 2}
    if case == "relaunch_new_port":
        replica = steps[-1][1]["replicas"]["serving:0"]
        assert (replica["endpoint"], replica["state"],
                replica["readmissions"]) == ("127.0.0.1:7011", "healthy", 1)


# -- the router over fake upstream replicas -----------------------------------

def _fake_upstream(reply):
    """A minimal replica: /healthz ok, POST delegated to `reply(handler,
    body)`; it keeps the X-Request-Id of each POST. Returns (httpd,
    endpoint, seen ids)."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, status, payload, headers=()):
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._json(200, OK)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            seen.append(self.headers.get("X-Request-Id"))
            reply(self, body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"127.0.0.1:{httpd.server_address[1]}", seen


def _canned(payload):
    def reply(handler, body):
        handler._json(200, payload)

    return reply


def _always_busy(retry_after=3):
    def reply(handler, body):
        handler._json(429, {"error": "queue full",
                            "retry_after_s": retry_after},
                      headers=(("Retry-After", str(retry_after)),))

    return reply


def _streamer(n_lines=2, finish=True):
    def reply(handler, body):
        handler.send_response(200)
        handler.send_header("Content-Type", "application/jsonl")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        lines = [{"token": index} for index in range(n_lines)]
        if finish:
            lines.append({"done": True, "finish_reason": "length"})
        for line in lines:
            data = (json.dumps(line) + "\n").encode()
            handler.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            handler.wfile.flush()
        if finish:
            handler.wfile.write(b"0\r\n\r\n")
            return
        # Die mid-stream: FIN without the terminating chunk.
        handler.connection.shutdown(socket.SHUT_WR)
        handler.close_connection = True

    return reply


def _dead_endpoint():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return f"127.0.0.1:{port}"


def _request(port, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = raw if raw is not None else (
            None if body is None else json.dumps(body))
        conn.request(method, path, payload,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        heads = {k: v for k, v in resp.getheaders() if k != "Date"}
        rid = heads.get("X-Request-Id")
        if rid is not None and re.fullmatch(r"req-[0-9a-f]{16}", rid):
            heads["X-Request-Id"] = "minted"
        lines = data.splitlines()
        try:
            parsed = [json.loads(line) for line in lines]
        except ValueError:
            parsed = data.decode()
        return resp.status, heads, parsed
    finally:
        conn.close()


class RouterCase:
    """One router of package `p` over fake upstreams, torn down after."""

    def __init__(self, p, upstreams, kinds=None, router_kwargs=None,
                 registry_kwargs=None, autoscaler=None):
        self.p = p
        self.kv = p.KV()
        self.script = ProbeScript()
        self.httpds, self.seen = [], {}
        for task, reply in upstreams.items():
            if reply is None:
                endpoint = _dead_endpoint()
            else:
                httpd, endpoint, seen = _fake_upstream(reply)
                self.httpds.append(httpd)
                self.seen[task] = seen
            kind = (kinds or {}).get(task, "generate")
            {"generate": p.event.serving_endpoint_event,
             "rank": p.event.rank_endpoint_event}[kind](
                self.kv, task, endpoint)
            self.script.set(endpoint, OK)
        self.registry = p.fleet.ReplicaRegistry(
            self.kv, tasks=sorted(upstreams), probe=self.script,
            probe_interval_s=0.0, **(registry_kwargs or {}))
        self.registry.refresh(force=True)
        if autoscaler is not None:
            autoscaler = p.fleet.FleetAutoscaler(
                self.registry, None,
                {"generate": p.fleet.AutoscalePolicy(max_replicas=2)},
                launch_eta_s=autoscaler)
        kwargs = dict({"retries": 2}, **(router_kwargs or {}))
        self.router = p.fleet.RouterServer(
            self.registry, p.fleet.make_policy(kwargs.pop("policy",
                                                          "round_robin")),
            "127.0.0.1", 0, autoscaler=autoscaler, **kwargs)
        self.router.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.stop()
        for httpd in self.httpds:
            httpd.shutdown()
            httpd.server_close()
        return False

    def post(self, body, path="/v1/generate", **kwargs):
        return _request(self.router.port, "POST", path, body, **kwargs)

    def routed(self):
        """The router's stats, less the upstreams' ports and the in-flight
        counts (a handler lowers its count after the reply is out)."""
        stats = self.router.stats()
        for replica in stats["replicas"].values():
            replica.pop("endpoint")
            replica.pop("inflight")
        return {key: stats[key] for key in (
            "routed_requests", "replicas", "healthy_replicas",
            "ejections_total", "readmissions_total", "policy", "retries",
            "role", "schema_version")}


def _failover_429(p):
    with RouterCase(p, {"serving:0": _always_busy(3),
                        "serving:1": _canned({"tokens": [5, 6, 7]})}) as c:
        return c.post({"prompt": [1, 2], "max_new_tokens": 3}), c.routed()


def _failover_all_busy(p):
    """Every replica answers 429: the loop backs off (never below the
    upstream's Retry-After, capped) and sheds with it."""
    with RouterCase(p, {"serving:0": _always_busy(1)},
                    router_kwargs={"retries": 0}) as c:
        return c.post({"prompt": [1], "max_new_tokens": 1}), c.routed()


def _connect_error(p):
    with RouterCase(p, {"serving:0": None,
                        "serving:1": _canned({"tokens": [9]})}) as c:
        first = c.post({"prompt": [1], "max_new_tokens": 1})
        second = c.post({"prompt": [2], "max_new_tokens": 1})
        return first, second, c.routed()


def _no_replica(p):
    with RouterCase(p, {}, router_kwargs={"retries": 1,
                                          "retry_after_s": 2.0,
                                          "policy": "least_loaded"}) as c:
        return c.post({"prompt": [1], "max_new_tokens": 1}), c.routed()


def _autoscaler_eta(p):
    with RouterCase(p, {}, router_kwargs={"retry_after_s": 2.0},
                    autoscaler=37.0) as c:
        reply = c.post({"prompt": [1], "max_new_tokens": 1})
        stats = c.router.stats()
        return reply, stats["autoscaler"], c.routed()


def _midstream_death(p):
    with RouterCase(p, {"serving:0": _streamer(2, finish=False),
                        "serving:1": _canned({"tokens": [4, 2]})}) as c:
        streamed = c.post({"prompt": [1, 2], "max_new_tokens": 8,
                           "stream": True})
        after = c.post({"prompt": [1], "max_new_tokens": 2})
        return streamed, after, c.routed()


def _stream_passthrough(p):
    with RouterCase(p, {"serving:0": _streamer(3)}) as c:
        return c.post({"prompt": [1], "max_new_tokens": 3, "stream": True},
                      headers={"X-Request-Id": "req-parity-7"}), \
            c.seen, c.routed()


def _passthrough_4xx(p):
    def bad(handler, body):
        handler._json(400, {"error": "prompt too long"})

    with RouterCase(p, {"serving:0": bad}, router_kwargs={"retries": 3}) as c:
        return c.post({"prompt": [1] * 999, "max_new_tokens": 1}), c.routed()


def _bad_json(p):
    with RouterCase(p, {"serving:0": _canned({"tokens": [1]})}) as c:
        return (c.post(None, raw="{not json"), c.post(None, raw="[1, 2"),
                c.routed())


def _request_ids(p):
    with RouterCase(p, {"serving:0": _canned({"tokens": [1]})}) as c:
        given = c.post({"prompt": [1]},
                       headers={"X-Request-Id": "req-parity-1"})
        minted = c.post({"prompt": [1]})
        ids = c.seen["serving:0"]
        return given, minted, [ids[0], ids[1].startswith("req-"),
                               len(ids[1])], c.routed()


def _surface(p):
    with RouterCase(p, {"serving:0": _canned({"tokens": [1]})},
                    router_kwargs={"policy": "least_loaded"}) as c:
        health = _request(c.router.port, "GET", "/healthz")
        stats = _request(c.router.port, "GET", "/stats")
        metrics = _request(c.router.port, "GET", "/metrics")
        return (health, stats[0], sorted(stats[2][0]),
                sorted(stats[2][0]["signals"]), metrics[0],
                metrics[1]["Content-Type"], c.routed())


def _unknown_path(p):
    with RouterCase(p, {"serving:0": _canned({"tokens": [1]})}) as c:
        return (_request(c.router.port, "GET", "/nope"),
                c.post({"prompt": [1]}, path="/v1/nope"),
                c.post({"prompt": [1]}, path="/v1/prefill"), c.routed())


def _pools_apart(p):
    with RouterCase(p, {"serving:0": _canned({"tokens": [3]}),
                        "rank:0": _canned({"scores": [0.5]})},
                    kinds={"rank:0": "rank"}) as c:
        replies = [c.post({"cat": [[1]]}, path="/v1/rank"),
                   c.post({"prompt": [1]}),
                   c.post({"cat": [[2]]}, path="/v1/rank"),
                   c.post({"prompt": [2]})]
        health = _request(c.router.port, "GET", "/healthz")
        routed = c.routed()
    with RouterCase(p, {"serving:0": _canned({"tokens": [3]})}) as c:
        missing = c.post({"cat": [[1]]}, path="/v1/rank")
    return replies, health, routed, missing


ROUTER_CASES = {
    "failover_429": _failover_429,
    "failover_all_busy": _failover_all_busy,
    "connect_error": _connect_error,
    "no_replica_503": _no_replica,
    "autoscaler_eta_503": _autoscaler_eta,
    "midstream_death": _midstream_death,
    "stream_passthrough": _stream_passthrough,
    "passthrough_4xx": _passthrough_4xx,
    "bad_json_400": _bad_json,
    "request_ids": _request_ids,
    "healthz_stats_metrics": _surface,
    "unknown_path_404": _unknown_path,
    "pools_apart": _pools_apart,
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_answers_as_jax(case):
    """Both routers in front of the same fake upstreams: equal statuses,
    headers (less Date; a minted X-Request-Id by its form), bodies line by
    line, and router stats (routes by replica and outcome, replica
    states, ejections)."""
    record = both(ROUTER_CASES[case])
    if case == "autoscaler_eta_503":
        (status, headers, body), _auto, _routed = record
        assert (status, headers["Retry-After"]) == (503, "37")
        assert body[0]["scale_out_eta_s"] == 37.0
    if case == "midstream_death":
        (status, _headers, lines), _after, routed = record
        assert lines[-1]["finish_reason"] == "error"
        assert routed["replicas"]["serving:0"]["state"] == "ejected"
    if case == "pools_apart":
        replies, _health, routed, missing = record
        assert routed["routed_requests"] == {"rank:0": {"ok": 2},
                                             "serving:0": {"ok": 2}}
        assert missing[0] == 503 and "no rank replica" in \
            missing[2][0]["error"]


# -- the monitor ----------------------------------------------------------------

def _signals_payload(p, values, scheme_version=None):
    hist = p.Histogram()
    for value in values:
        hist.observe(value)
    signal = hist.to_signal(window=False)
    if scheme_version is not None:
        signal = dict(signal, version=scheme_version)
    return {
        "schema_version": p.telemetry.STATS_SCHEMA_VERSION,
        "signals": {
            "version": p.telemetry.SIGNALS_VERSION,
            "histograms": {"serving/ttft_seconds": signal,
                           "serving/ttft_seconds{tier=batch}": signal},
            "scalars": {},
        },
    }


def _monitor_fleet(p, n, kv=None):
    kv = kv or p.KV()
    script = ProbeScript()
    for index in range(n):
        endpoint = f"127.0.0.1:{7100 + index}"
        p.event.serving_endpoint_event(kv, f"serving:{index}", endpoint)
        script.set(endpoint, OK)
    registry = _registry(p, kv, script, None)
    registry.refresh(force=True)
    return registry, script


def _monitor(p, registry, scrape, **kwargs):
    return p.fleet.FleetMonitor(registry, scrape=scrape,
                                clock=lambda: 0.0, **kwargs)


def _merge(p):
    registry, _script = _monitor_fleet(p, 3)
    payloads = {"127.0.0.1:7100": _signals_payload(p, [0.1] * 5 + [0.4]),
                "127.0.0.1:7101": _signals_payload(p, [0.2] * 5),
                "127.0.0.1:7102": {"schema_version": 1}}  # legacy
    monitor = _monitor(p, registry, lambda e: payloads[e],
                       slo={"ttft_p95_s": 0.3, "ttft_p50_s": 1.0})
    first = monitor.poll_once()
    metrics = p.telemetry.get_registry()
    gauges = {agg: metrics.gauge("fleet/serving/ttft_seconds",
                                 agg=agg).value
              for agg in ("p50", "p95", "p99", "count")}
    return first, gauges, monitor.aggregate() == first


def _stale(p):
    registry, _script = _monitor_fleet(p, 2)
    fail = {"127.0.0.1:7100": False, "127.0.0.1:7101": True}

    def scrape(endpoint):
        if fail[endpoint]:
            raise ConnectionResetError("scrape failed")
        return _signals_payload(p, [0.1, 0.2, 0.3])

    monitor = _monitor(p, registry, scrape)
    cycles = [monitor.poll_once()]  # serving:1 never scraped
    fail["127.0.0.1:7101"] = False
    cycles.append(monitor.poll_once())
    fail["127.0.0.1:7101"] = True  # last good from cycle 2
    cycles.append(monitor.poll_once())
    return cycles, p.telemetry.get_registry().gauge(
        "fleet/monitor_stale_replicas").value


def _empty_and_mismatch(p):
    registry, _script = _monitor_fleet(p, 0)
    monitor = _monitor(p, registry, lambda e: {})
    empty = monitor.poll_once()
    registry, _script = _monitor_fleet(p, 1)
    monitor = _monitor(p, registry,
                       lambda e: _signals_payload(p, [0.1], scheme_version=99))
    return empty, monitor.poll_once(), monitor.interval_s


def _churn(p):
    """A replica leaves and another joins while a scrape is on the wire:
    the reader sees the previous complete aggregate, and the next cycle
    merges the new healthy set."""
    kv = p.KV()
    registry, script = _monitor_fleet(p, 2, kv)
    seen = {}

    def scrape(endpoint):
        if endpoint == "127.0.0.1:7100":
            if not seen:
                script.set("127.0.0.1:7101", ConnectionResetError("gone"))
                registry.report_failure(
                    "serving:1", ConnectionResetError("preempted"))
                p.event.serving_endpoint_event(kv, "serving:2",
                                               "127.0.0.1:7102")
                script.set("127.0.0.1:7102", OK)
                registry.refresh(force=True)
                seen["mid"] = monitor.aggregate()
            return _signals_payload(p, [0.1] * 5)
        if endpoint == "127.0.0.1:7101":
            return _signals_payload(p, [0.2] * 5)
        return _signals_payload(p, [0.3] * 7)

    monitor = _monitor(p, registry, scrape, interval_s=0.01)
    first = monitor.poll_once()
    second = monitor.poll_once()
    return first, seen["mid"], second


MONITOR_CASES = {"merge_and_slo": _merge, "stale_last_good": _stale,
                 "no_data_and_version_mismatch": _empty_and_mismatch,
                 "churn_mid_scrape": _churn}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_aggregates_equal_jax(case):
    """The same `signals` payloads (each package's own histogram sketch,
    equal on the wire): equal aggregates (``==``: merged summaries,
    stale/legacy views, the fleet SLO), gauges and cycles."""
    record = both(MONITOR_CASES[case])
    if case == "churn_mid_scrape":
        first, mid, second = record
        assert first["histograms"]["serving/ttft_seconds"]["count"] == 10
        assert mid["status"] == "no_data"
        assert set(second["replicas"]) == {"serving:0", "serving:2"}
        assert second["histograms"]["serving/ttft_seconds"]["count"] == 12


def test_signals_payloads_are_equal_on_the_wire():
    values = [0.001, 0.02, 0.3, 4.0, 4.0, 50.0]
    assert _signals_payload(PACKAGES["port"], values) == \
        _signals_payload(PACKAGES["jax"], values)


# -- across packages and in process -----------------------------------------

MAX_NEW = 6
PROMPTS = [np.random.RandomState(7).randint(0, 256, (n,)).tolist()
           for n in (5, 9, 3, 6)]


def _legacy(prompt, max_new=MAX_NEW):
    from tf_yarn_tpu.models.generate import generate_legacy

    model, params = jax_model("bf16")
    out = generate_legacy(model, params, jnp.asarray([prompt], jnp.int32),
                          max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _port_replica(kv, event, task):
    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler
    from tf_yarn_tpu_torch.serving.server import ServingServer

    scheduler = SlotScheduler(DecodeEngine(port_model("bf16"),
                                           prompt_buckets=BUCKETS),
                              max_slots=2)
    return _serve(scheduler, ServingServer, kv, event, task)


def _jax_replica(kv, event, task):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine
    from tf_yarn_tpu.serving import ServingServer, SlotScheduler

    model, params = jax_model("bf16")
    engine = DecodeEngine(model, batch_buckets=(1, 2, 4),
                          prompt_buckets=BUCKETS)
    return _serve(SlotScheduler(engine, params, max_slots=2), ServingServer,
                  kv, event, task)


def _serve(scheduler, server_cls, kv, event, task):
    scheduler.start()
    server = server_cls(scheduler, "127.0.0.1", 0)
    server.start()
    event.serving_endpoint_event(kv, task, server.endpoint)
    event.heartbeat_event(kv, task)
    return {"task": task, "scheduler": scheduler, "server": server}


def _close(replicas):
    for replica in replicas:
        replica["server"].stop()
        replica["scheduler"].close()


def _concurrent(port, bodies, headers=None):
    results = {}

    def call(index):
        results[index] = _request(port, "POST", "/v1/generate",
                                  bodies[index],
                                  headers=(headers or {}).get(index))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    assert not any(thread.is_alive() for thread in threads)
    return [results[i] for i in range(len(bodies))]


@pytest.mark.parametrize("router_side, replica_side",
                         [("jax", "port"), ("port", "jax")],
                         ids=["jax-router-port-replicas",
                              "port-router-jax-replicas"])
def test_router_across_packages_streams_equal_legacy(router_side,
                                                     replica_side):
    """One package's router in front of two of the other's replicas:
    concurrent requests and a stream through it equal JAX
    `generate_legacy` on the bridged weights, on both replicas."""
    router_p, replica_p = PACKAGES[router_side], PACKAGES[replica_side]
    kv = replica_p.KV()
    make = _port_replica if replica_side == "port" else _jax_replica
    replicas = [make(kv, replica_p.event, f"serving:{i}") for i in range(2)]
    registry = router_p.fleet.ReplicaRegistry(
        kv, tasks=["serving:0", "serving:1"], probe_interval_s=0.05)
    registry.refresh(force=True)
    router = router_p.fleet.RouterServer(
        registry, router_p.fleet.make_policy("round_robin"), "127.0.0.1", 0)
    router.start()
    try:
        assert len(registry.healthy()) == 2
        bodies = [{"prompt": p, "max_new_tokens": MAX_NEW} for p in PROMPTS]
        for prompt, (status, _h, body) in zip(
                PROMPTS, _concurrent(router.port, bodies)):
            assert status == 200, body
            assert body[0]["tokens"] == _legacy(prompt)
        status, _h, lines = _request(
            router.port, "POST", "/v1/generate",
            dict(bodies[1], stream=True))
        assert status == 200
        assert [line["token"] for line in lines if "token" in line] == \
            _legacy(PROMPTS[1])
        assert lines[-1]["done"]
        routed = router.stats()["routed_requests"]
        assert routed["serving:0"]["ok"] >= 2 and routed["serving:1"]["ok"] >= 2
    finally:
        router.stop()
        _close(replicas)


def _port_fleet():
    kv = TInProcessKV()
    replicas = [_port_replica(kv, t_event, f"serving:{i}") for i in range(2)]
    registry = t_fleet.ReplicaRegistry(kv, tasks=["serving:0", "serving:1"],
                                       probe_interval_s=0.05)
    registry.refresh(force=True)
    return replicas, registry


def test_port_fleet_matches_legacy_and_survives_a_stopped_replica():
    """Two port replicas behind the port's router: concurrent requests
    equal JAX `generate_legacy`, both replicas serve; one replica stopped
    mid-traffic is ejected on the connect error and every later request
    succeeds on the survivor."""
    replicas, registry = _port_fleet()
    router = t_fleet.RouterServer(registry, t_fleet.make_policy("round_robin"),
                                  "127.0.0.1", 0, retries=3)
    router.start()
    try:
        bodies = [{"prompt": p, "max_new_tokens": MAX_NEW} for p in PROMPTS]
        for prompt, (status, _h, body) in zip(
                PROMPTS, _concurrent(router.port, bodies)):
            assert status == 200 and body[0]["tokens"] == _legacy(prompt)
        routed = router.stats()["routed_requests"]
        assert routed["serving:0"]["ok"] >= 1 and routed["serving:1"]["ok"] >= 1
        _close(replicas[:1])  # serving:0 stops
        for prompt in PROMPTS[:3]:
            status, _h, body = _request(router.port, "POST", "/v1/generate",
                                        {"prompt": prompt,
                                         "max_new_tokens": MAX_NEW})
            assert status == 200 and body[0]["tokens"] == _legacy(prompt)
        assert [r.task for r in registry.healthy()] == ["serving:1"]
        stats = router.stats()
        assert stats["replicas"]["serving:0"]["state"] == "ejected"
        assert stats["ejections_total"] >= 1
        assert stats["routed_requests"]["serving:1"]["ok"] >= 3
    finally:
        router.stop()
        _close(replicas[1:])


def _settled(read, done, seconds=5.0):
    """`read()` once `done` holds of it, or its last value after
    `seconds`. The router observes a request's
    ``fleet/routed_request_seconds`` and closes its ``router/route`` span
    after the reply is written (fleet/router.py, as in the JAX router), so
    a reader that has every reply may still be ahead of the last handler
    thread."""
    deadline = time.monotonic() + seconds
    value = read()
    while not done(value) and time.monotonic() < deadline:
        time.sleep(0.05)
        value = read()
    return value


def test_port_fleet_pools_the_ttft_p95_and_joins_request_ids():
    """Two port replicas, the router and a `FleetMonitor`, one monitor
    cycle driven after the traffic: the merged ``serving/ttft_seconds``
    p95 (in the aggregate and the router's /metrics) is within
    HIST_ALPHA of the raw timings' p95; a caller's X-Request-Id is
    honoured, a minted one has the minted form, and one id is on the router's span,
    the owning replica's submit span and exactly one replica's trace
    ring."""
    replicas, registry = _port_fleet()
    metrics = t_telemetry.get_registry()
    monitor = t_fleet.FleetMonitor(registry, slo={"ttft_p95_s": 60.0})
    router = t_fleet.RouterServer(registry, t_fleet.make_policy("round_robin"),
                                  "127.0.0.1", 0, monitor=monitor)
    router.start()

    def routed():
        return sum(hist.summary()["count"] for _, hist in
                   metrics.find_histograms("fleet/routed_request_seconds"))

    try:
        before = routed()
        _concurrent(router.port, [{"prompt": p, "max_new_tokens": 4}
                                  for p in PROMPTS])  # warm both
        # The warm requests' observations land before the clear.
        _settled(routed, lambda n: n >= before + len(PROMPTS))
        metrics.clear()
        hist = metrics.histogram("serving/ttft_seconds")
        raw, observe = [], hist.observe
        hist.observe = lambda value: (raw.append(float(value)),
                                      observe(value))[-1]
        bodies = [{"prompt": PROMPTS[i % 4], "max_new_tokens": 3 + i % 3}
                  for i in range(8)]
        headers = {i: {"X-Request-Id": f"req-pooled-{i}"}
                   for i in range(8) if i % 2}
        replies = _concurrent(router.port, bodies, headers)
        del hist.observe
        ids = {}
        for index, (status, heads, body) in enumerate(replies):
            assert status == 200, body
            ids[index] = heads["X-Request-Id"]
        assert ids[1] == "req-pooled-1" and ids[3] == "req-pooled-3"
        assert all(ids[i] == "minted" for i in range(0, 8, 2))
        aggregate = monitor.poll_once()
        assert aggregate["status"] == "ok"
        assert aggregate["contributing_replicas"] == 2
        assert aggregate["stale_replicas"] == 0
        merged = aggregate["histograms"]["serving/ttft_seconds"]
        # One process registry: both replicas ship the same sketch.
        assert merged["count"] == 2 * len(raw) == 16
        pooled = sorted(raw * 2)
        oracle = pooled[int(0.95 * (len(pooled) - 1))]
        alpha = t_telemetry.HIST_ALPHA
        assert abs(merged["p95"] - oracle) / oracle <= alpha
        assert aggregate["slo"]["ttft_p95_s"]["status"] == "ok"
        routed_ok = (r'fleet_routed_request_seconds_count\{outcome="ok",'
                     r'path="/v1/generate"\} 8.0')

        def metrics_text():
            _status, _h, text = _request(router.port, "GET", "/metrics")
            return "\n".join(text) if isinstance(text, list) else text

        text = _settled(metrics_text, lambda t: re.search(routed_ok, t))
        match = re.search(r'^fleet_serving_ttft_seconds\{agg="p95"\} (\S+)$',
                          text, re.M)
        assert match and float(match.group(1)) == merged["p95"]
        assert re.search(routed_ok, text), text
        rid = ids[1]

        def routes():
            return [s for s in t_telemetry.get_tracer().records()
                    if s.name == "router/route"
                    and s.args.get("request_id") == rid]

        assert len(_settled(routes, lambda found: len(found) >= 1)) == 1
        spans = t_telemetry.get_tracer().records()
        assert len([s for s in spans if s.name == "serving/submit"
                    and s.args.get("request_id") == rid]) == 1
        owners = [r["task"] for r in replicas
                  if any(rid in entry.get("trace", {}).values()
                         for entry in list(r["scheduler"].trace))]
        assert len(owners) == 1
    finally:
        router.stop()
        _close(replicas)
