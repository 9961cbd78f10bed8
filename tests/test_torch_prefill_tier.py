"""The disaggregated prefill tier in the port (`serving/prefill.py`) held
against the JAX package's on the CPU.

* `parse_prefill_tier`'s verdicts.
* `PrefillWorker`: the wire of a prompt on the tiny f32 decoder with
  bridged weights and int8 KV — entries, content keys and leaves (int8
  codes and f32 scales) equal to the JAX worker's over the JAX worker's
  padded group — and across packages both ways: a JAX worker's wire
  imported by the port's scheduler, and the port worker's by the JAX
  scheduler, each serving the stream of local prefill. Then the worker's
  outcomes against the JAX worker's on its paged fake engine at the same
  geometry (block 4, buckets 4 and 8, 32 positions): longest-first
  entries, the prefix-cache repeat, the short and the pool-full empty
  wires, its errors.
* `PrefillClient`: the outcomes, stats and counters of the JAX client's
  scripted events (tests/test_prefill_tier.py, the client's ladder),
  each package's client over its own worker and scheduler.
* `kv_prefill_resolver`, ``/v1/prefill``'s statuses, bodies and drain,
  and ``/stats``' ``prefill_offload`` block against the JAX servers';
  a prefill replica gone before the ship, and a tier of none, degrade to
  the local stream over HTTP."""

import functools
import http.client
import json

import numpy as np
import pytest
import torch

from tests.test_serving import FakePagedEngine
from tests.test_serving import _drive as j_drive
from tests.test_serving import _paged_scheduler as j_paged_scheduler
from tests.test_torch_swap import BUCKETS, Side, drive, jax_model, port_model
from tf_yarn_tpu import event as j_event
from tf_yarn_tpu import preemption as j_preemption
from tf_yarn_tpu import telemetry as j_telemetry
from tf_yarn_tpu.coordination.kv import InProcessKV as JInProcessKV
from tf_yarn_tpu.serving import prefill as j_prefill
from tf_yarn_tpu.serving import server as j_server
from tf_yarn_tpu_torch import event as t_event
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import telemetry as t_telemetry
from tf_yarn_tpu_torch.coordination.kv import InProcessKV as TInProcessKV
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.serving import prefill as t_prefill
from tf_yarn_tpu_torch.serving import server as t_server
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler, _payload_from_wire

# Bucket 8 of 13 tokens at block 4: two whole blocks, two entries.
PROMPT = np.random.RandomState(7).randint(0, 256, (13,)).tolist()
FUSED = dict(kv_layout="paged", decode_attention="fused", block_size=4)


# -- the config ---------------------------------------------------------------

TIER_CASES = {
    "defaults": {},
    "threshold": {"offload_threshold": 128, "backoff_s": 1.0},
    "threshold_zero": {"offload_threshold": 0},
    "timeout": {"timeout_s": 0.0},
    "backoff": {"backoff_s": -2},
    "ttl": {"resolve_ttl_s": 0},
    "num_blocks": {"num_blocks": 1},
    "num_blocks_two": {"num_blocks": 2},
    "endpoint": {"endpoint": "127.0.0.1:9"},
    "unknown_key": {"offload_tokens": 5},
    "not_a_dict": [128],
}


def _tier_verdict(module, spec):
    try:
        config = module.parse_prefill_tier(spec)
    except ValueError as exc:
        return "ValueError", str(exc)
    assert module.parse_prefill_tier(config) is config
    return "ok", {field: getattr(config, field) for field in (
        "offload_threshold", "endpoint", "timeout_s", "backoff_s",
        "resolve_ttl_s", "num_blocks")}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_parse_prefill_tier_verdict_equals_jax(case):
    assert _tier_verdict(t_prefill, TIER_CASES[case]) \
        == _tier_verdict(j_prefill, TIER_CASES[case])
    assert t_prefill.DEFAULT_OFFLOAD_THRESHOLD \
        == j_prefill.DEFAULT_OFFLOAD_THRESHOLD


# -- the worker's wire on the real decoder ------------------------------------

def jax_worker(scan_layers=False, **kwargs):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine

    model, params = jax_model("int8", 2, scan_layers)
    engine = JaxEngine(model, batch_buckets=(1, 2, 4), prompt_buckets=BUCKETS)
    return j_prefill.PrefillWorker(engine, params, block_size=4, **kwargs)


def port_worker(**kwargs):
    engine = DecodeEngine(port_model("int8", 2, False), prompt_buckets=BUCKETS)
    return t_prefill.PrefillWorker(engine, block_size=4, **kwargs)


def test_worker_wire_equals_jax():
    ours, theirs = port_worker(), jax_worker()
    mine, ref = ours.prefill_prompt(PROMPT), theirs.prefill_prompt(PROMPT)
    assert mine["entries"] == ref["entries"]
    assert [len(e["blocks"]) for e in mine["entries"]] == [2, 1]
    for key in ("schema_version", "block_size", "n_blocks"):
        assert mine[key] == ref[key]
    # The port ships exactly the valid blocks; the JAX worker pads its
    # group to the block table's 16.
    assert mine["group_width"] == 2 and ref["group_width"] == 16
    n = mine["n_blocks"]
    got = _payload_from_wire(mine["groups"][0]["leaves"], ours._pool, n)
    want = _payload_from_wire(ref["groups"][0]["leaves"], ours._pool, n)
    # The int8 codes are bitwise equal. A scale is a row's abs-max / 127,
    # and the f32 K and V of XLA's and torch's matmuls differ in their
    # last bits: the scales agree within a few f32 ulps (measured 9.2e-7
    # relative on this prompt).
    for name in ("key", "value"):
        assert torch.equal(getattr(got, name)[:, :n],
                           getattr(want, name)[:, :n]), name
    for name in ("key_scale", "value_scale"):
        torch.testing.assert_close(getattr(got, name)[:, :n],
                                   getattr(want, name)[:, :n],
                                   rtol=2e-6, atol=0)
    assert ours.stats()["exported_blocks"] == theirs.stats()[
        "exported_blocks"] == 2


def _local_stream(side, prompt=PROMPT, max_new=6):
    scheduler = side.scheduler(max_slots=2, **FUSED)
    response = scheduler.submit(prompt, side.params(max_new_tokens=max_new))
    drive(scheduler, [response])
    scheduler.close()
    return response.result(timeout=1)


def _imported_stream(side, wire, prompt=PROMPT, max_new=6):
    scheduler = side.scheduler(max_slots=2, **FUSED)
    assert scheduler.import_prefixes(wire) == {
        "imported_blocks": 2, "registered_entries": 2, "skipped_entries": 0}
    response = scheduler.submit(prompt, side.params(max_new_tokens=max_new))
    drive(scheduler, [response])
    hits = scheduler.stats()["prefix_cache"]["hits"]
    scheduler.close()
    return response.result(timeout=1), hits


def test_jax_worker_wire_serves_the_port_its_local_stream():
    wire = t_server.decode_block_wire(json.loads(json.dumps(
        j_server.encode_block_wire(jax_worker().prefill_prompt(PROMPT)))))
    port = Side("port")
    got, hits = _imported_stream(port, wire)
    assert hits == 1 and got == _local_stream(port)


def test_port_worker_wire_serves_jax_its_local_stream():
    # The port writes the scanned-layer leaves: a scanned JAX grid reads
    # them (tests/test_torch_warm_start.py).
    jax_side = Side("jax", scan_layers=True)
    engine = DecodeEngine(port_model("int8", 2, True), prompt_buckets=BUCKETS)
    worker = t_prefill.PrefillWorker(engine, block_size=4)
    wire = j_server.decode_block_wire(json.loads(json.dumps(
        t_server.encode_block_wire(worker.prefill_prompt(PROMPT)))))
    got, hits = _imported_stream(jax_side, wire)
    assert hits == 1 and got == _local_stream(jax_side)
    assert got == _local_stream(Side("port", scan_layers=True))


# -- the worker's outcomes at the JAX fake engine's geometry ------------------

@functools.lru_cache(maxsize=None)
def small_model():
    """A decoder of 32 positions, the JAX fake engine's."""
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=32,
                                    kv_cache_dtype="int8")
    return tt.make_model(cfg, seed=0, device="cpu")


def small_engine():
    return DecodeEngine(small_model(), prompt_buckets=(4, 8))


class Package:
    """One package's prefill tier at block 4, buckets (4, 8), 32 positions:
    the JAX package's on its paged fake engine (tests/test_serving.py),
    the port's on the real decoder."""

    def __init__(self, name):
        self.name = name
        self.prefill = j_prefill if name == "jax" else t_prefill
        self.server = j_server if name == "jax" else t_server
        self.telemetry = j_telemetry if name == "jax" else t_telemetry
        self.event = j_event if name == "jax" else t_event
        self.preemption = j_preemption if name == "jax" else t_preemption

    def worker(self, block_size=4, **kwargs):
        if self.name == "jax":
            return j_prefill.PrefillWorker(FakePagedEngine(), params=None,
                                           block_size=block_size, **kwargs)
        return t_prefill.PrefillWorker(small_engine(), block_size=block_size,
                                       **kwargs)

    def scheduler(self):
        if self.name == "jax":
            return j_paged_scheduler()[1]
        return SlotScheduler(small_engine(), max_slots=2, kv_layout="paged",
                             block_size=4)

    def serve(self, scheduler, prompt, max_new=3):
        if self.name == "jax":
            from tf_yarn_tpu.serving import SamplingParams as JParams

            response = scheduler.submit(prompt, JParams(max_new_tokens=max_new))
            j_drive(scheduler, [response])
        else:
            response = scheduler.submit(prompt, SamplingParams(
                max_new_tokens=max_new))
            drive(scheduler, [response])
        return response.result(timeout=1)

    def kv(self):
        return JInProcessKV() if self.name == "jax" else TInProcessKV()

    def offload_counts(self):
        snap = self.telemetry.get_registry().snapshot()
        return {key: value for key, value in snap.items()
                if key.startswith(("serving/prefill_offload_total",
                                   "serving/prefill_requests_total"))}


def _worker_stats(worker):
    stats = worker.stats()
    stats.pop("decode_engine", None)
    return stats


def _worker_outcomes(package):
    prompt = list(range(1, 10))
    out = {}
    worker = package.worker()
    first = worker.prefill_prompt(prompt)
    out["wire"] = {key: first[key] for key in (
        "schema_version", "block_size", "n_blocks", "entries")}
    out["repeat_entries_equal"] = \
        worker.prefill_prompt(prompt)["entries"] == first["entries"]
    out["repeat_stats"] = _worker_stats(worker)
    out["short"] = package.worker().prefill_prompt([5, 6, 7, 8])["n_blocks"]
    full = package.worker(num_blocks=2)
    out["pool_full"] = (full.prefill_prompt(prompt)["n_blocks"],
                        _worker_stats(full)["block_pool"])
    errors = []
    for call in (lambda: package.worker().prefill_prompt([]),
                 lambda: package.worker().prefill_prompt(list(range(40))),
                 lambda: package.worker(block_size=5)):
        with pytest.raises(ValueError) as err:
            call()
        errors.append(str(err.value))
    out["errors"] = errors
    return out


def test_worker_outcomes_equal_jax():
    got = _worker_outcomes(Package("port"))
    assert got == _worker_outcomes(Package("jax"))
    assert got["repeat_stats"]["prefill_cache_hits"] == 1


# -- the client's ladder --------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _wire_post(package, worker, failures):
    """The ``post=`` seam: answers from a live in-process worker, or
    raises while `failures[0]` > 0 (a replica gone mid-ship)."""
    calls = []

    def post(endpoint, prompt, timeout_s):
        calls.append(endpoint)
        if failures[0] > 0:
            failures[0] -= 1
            raise ConnectionError("replica preempted mid-ship")
        return json.dumps(package.server.encode_block_wire(
            worker.prefill_prompt(prompt))).encode()

    post.calls = calls
    return post


PROMPT9 = list(range(1, 10))
# Each scenario: the client's knobs, the worker's, and the steps — "ship
# <prompt>", "clock <seconds>", "endpoint <value>" (what the resolver
# answers next) or "fail <n>" (the next n POSTs raise).
CLIENT_SCENARIOS = {
    "ships_and_admission_skips_the_span": (
        {}, {}, ["ship 9", "serve 9"]),
    "below_threshold_and_memo": (
        {}, {}, ["ship 3", "ship 9", "ship 9"]),
    "no_replica_then_recheck_after_ttl": (
        {"resolve_ttl_s": 2.0, "resolver": True}, {},
        ["ship 9", "endpoint 127.0.0.1:7201", "ship 9", "clock 2.5",
         "ship 9"]),
    "ship_failure_quarantines_then_recovers": (
        {"backoff_s": 5.0}, {}, ["fail 1", "ship 9", "ship 9", "clock 6",
                                 "ship 9"]),
    "empty_wire_without_quarantine": (
        {}, {"num_blocks": 2}, ["ship 9", "ship 9"]),
    "import_refused": (
        {"block_size": 8}, {"block_size": 8}, ["ship 17"]),
    "never_raises": ({}, {}, ["ship words"]),
}


def _client_run(package, scenario):
    knobs, worker_knobs, steps = CLIENT_SCENARIOS[scenario]
    knobs = dict(knobs)
    block_size = knobs.pop("block_size", 4)
    worker = package.worker(**worker_knobs)
    scheduler = package.scheduler()
    failures, answers, clock = [0], [None], _Clock()
    post = _wire_post(package, worker, failures)
    use_resolver = knobs.pop("resolver", False)
    config = package.prefill.PrefillTierConfig(
        offload_threshold=5,
        endpoint=None if use_resolver else "127.0.0.1:1", **knobs)
    client = package.prefill.PrefillClient(
        config, scheduler, block_size=block_size, clock=clock, post=post,
        resolver=(lambda: answers[0]) if use_resolver else None)
    before = package.offload_counts()
    outcomes = []
    for step in steps:
        verb, _, arg = step.partition(" ")
        if verb == "ship":
            prompt = (["not", "tokens", "at", "all", "x", "y"]
                      if arg == "words" else list(range(1, int(arg) + 1)))
            outcomes.append(client.maybe_ship(prompt))
        elif verb == "serve":
            package.serve(scheduler, list(range(1, int(arg) + 1)))
            outcomes.append(("hits", scheduler.stats()["prefix_cache"]["hits"]))
        elif verb == "clock":
            clock.now += float(arg)
        elif verb == "endpoint":
            answers[0] = arg
        elif verb == "fail":
            failures[0] = int(arg)
    after = package.offload_counts()
    stats = client.stats()
    wire_bytes = stats.pop("shipped_wire_bytes")
    counts = {key: after[key] - before.get(key, 0) for key in after
              if after[key] != before.get(key, 0)}
    return {"outcomes": outcomes, "stats": stats, "wire": wire_bytes > 0,
            "posts": len(post.calls), "counts": counts}


@pytest.mark.parametrize("scenario", sorted(CLIENT_SCENARIOS))
def test_client_ladder_equals_jax(scenario):
    assert _client_run(Package("port"), scenario) \
        == _client_run(Package("jax"), scenario)


# -- discovery ----------------------------------------------------------------

def _resolver_run(package):
    kv = package.kv()
    package.event.prefill_endpoint_event(kv, "prefill:0", "127.0.0.1:7401")
    package.event.prefill_endpoint_event(kv, "prefill:1", "127.0.0.1:7402")
    package.event.serving_endpoint_event(kv, "serving:0", "127.0.0.1:7403")
    resolve = package.prefill.kv_prefill_resolver(kv)
    picks = [resolve() for _ in range(3)]
    package.event.heartbeat_stopped_event(kv, "prefill:1")
    picks += [resolve() for _ in range(2)]
    package.event.stop_event(kv, "prefill:0", None)
    picks.append(resolve())
    return picks


def test_kv_resolver_round_robins_and_skips_stopped_tasks_as_jax():
    picks = _resolver_run(Package("port"))
    assert picks == _resolver_run(Package("jax"))
    assert picks[-1] is None


# -- HTTP ---------------------------------------------------------------------

def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body)),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _keys(raw):
    return sorted(json.loads(raw))


def _prefill_server_run(package):
    worker = package.worker()
    server = package.prefill.PrefillServer(worker)
    server.start()
    out = []
    try:
        status, _type, raw = _call(server.port, "GET", "/healthz")
        out.append(("healthz", status, json.loads(raw)))
        status, _type, raw = _call(server.port, "POST", "/v1/prefill",
                                   {"prompt": PROMPT9})
        wire = package.server.decode_block_wire(json.loads(raw))
        out.append(("prefill", status, wire["n_blocks"], wire["entries"]))
        for body in ({"prompt": []}, {"nope": 1}, {"prompt": ["x"]},
                     {"prompt": list(range(40))}, b"{broken"):
            status, _type, raw = _call(server.port, "POST", "/v1/prefill",
                                       body)
            out.append(("bad", status, json.loads(raw)))
        out.append(("404", _call(server.port, "POST", "/v1/other", {})[0],
                    _call(server.port, "GET", "/nope")[0]))
        status, _type, raw = _call(server.port, "GET", "/stats")
        stats = json.loads(raw)
        # The JAX fake engine keeps no stats; the port's engine does.
        assert ("decode_engine" in stats) == (package.name == "port")
        stats.pop("decode_engine", None)
        out.append(("stats", status, sorted(stats), stats["kind"],
                    stats["prefill_requests"]))
        status, ctype, raw = _call(server.port, "GET", "/metrics")
        out.append(("metrics", status, ctype,
                    b"serving_prefill_requests_total" in raw))
        worker.drain()
        out.append(("drained", json.loads(
            _call(server.port, "GET", "/healthz")[2])["status"]))
    finally:
        server.stop()
    # A fresh worker under the preemption notice reports draining at once.
    other = package.prefill.PrefillServer(package.worker())
    other.start()
    package.preemption.request()
    try:
        out.append(("preempted", json.loads(
            _call(other.port, "GET", "/healthz")[2])["status"]))
    finally:
        package.preemption.reset()
        other.stop()
    return out


def test_prefill_server_statuses_and_drain_equal_jax():
    got = _prefill_server_run(Package("port"))
    assert got == _prefill_server_run(Package("jax"))
    assert got[-2:] == [("drained", "draining"), ("preempted", "draining")]


def _decode_stack(package, client_config=None, resolver=None):
    scheduler = package.scheduler()
    client = None
    if client_config is not None:
        client = package.prefill.PrefillClient(
            client_config, scheduler, block_size=4, resolver=resolver)
    scheduler.start()
    server = package.server.ServingServer(scheduler, "127.0.0.1", 0,
                                          prefill_client=client)
    server.start()
    return scheduler, server, client


def _generate(server, prompt=PROMPT9):
    status, _type, raw = _call(server.port, "POST", "/v1/generate",
                               {"prompt": prompt, "max_new_tokens": 3})
    assert status == 200, raw
    return json.loads(raw)["tokens"]


def _stop(scheduler, server):
    server.stop()
    scheduler.close()


def _stats_surface(package):
    config = package.prefill.PrefillTierConfig(offload_threshold=5)
    scheduler, server, _client = _decode_stack(package, config,
                                               resolver=lambda: None)
    try:
        _generate(server)
        snap = json.loads(_call(server.port, "GET", "/stats")[2])
    finally:
        _stop(scheduler, server)
    plain_scheduler, plain, _ = _decode_stack(package)
    try:
        bare = json.loads(_call(plain.port, "GET", "/stats")[2])
    finally:
        _stop(plain_scheduler, plain)
    return snap["prefill_offload"], "prefill_offload" in bare


def test_stats_prefill_offload_equals_jax():
    got = _stats_surface(Package("port"))
    assert got == _stats_surface(Package("jax"))
    assert got[0]["local_fallbacks"] == 1 and got[1] is False


@pytest.mark.parametrize("tier", ["gone_before_the_ship", "none_advertised"])
def test_http_degrades_to_the_local_stream(tier):
    """A replica gone between resolution and the POST (a real refused
    connect), or no replica at all: 200 with the local stream."""
    package = Package("port")
    scheduler, server, _ = _decode_stack(package)
    try:
        local = _generate(server)
    finally:
        _stop(scheduler, server)
    if tier == "gone_before_the_ship":
        dead = t_prefill.PrefillServer(package.worker())
        dead.start()
        endpoint = dead.endpoint
        dead.stop()
        config = t_prefill.PrefillTierConfig(offload_threshold=5,
                                             endpoint=endpoint, timeout_s=2.0)
        resolver = None
    else:
        config = t_prefill.PrefillTierConfig(offload_threshold=5)
        resolver = t_prefill.kv_prefill_resolver(TInProcessKV())
    scheduler, server, client = _decode_stack(package, config, resolver)
    try:
        assert _generate(server) == local
        assert client.stats()["local_fallbacks"] == 1
        assert client.stats()["ships"] == 0
    finally:
        _stop(scheduler, server)


def test_http_ship_through_a_prefill_server_serves_the_local_stream():
    """The whole tier over real HTTP: a PrefillServer's blocks installed
    by the decode replica's client; the request streams as local prefill
    does, with no prefill in the decode engine."""
    package = Package("port")
    scheduler, server, _ = _decode_stack(package)
    try:
        local = _generate(server)
    finally:
        _stop(scheduler, server)
    tier = t_prefill.PrefillServer(package.worker())
    tier.start()
    config = t_prefill.PrefillTierConfig(offload_threshold=5,
                                         endpoint=tier.endpoint)
    scheduler, server, client = _decode_stack(package, config)
    try:
        assert _generate(server) == local
        assert client.stats()["ships"] == 1
        assert client.stats()["shipped_blocks"] == 2
        assert scheduler.engine.stats["prefill_calls"] == 0
    finally:
        _stop(scheduler, server)
        tier.stop()
