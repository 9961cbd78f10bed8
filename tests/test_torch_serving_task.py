"""The serving task's body in the port (`serving.server.run_serving`,
`experiment.ServingExperiment`, `advertised_endpoint`) held against the
JAX package's on the CPU: the experiment's verdict on every validation
branch, the advertised address, and `run_serving` in a thread with an
in-process KV store on the fused, gather and dense grids — the same
greedy streams as the JAX `run_serving` over the same weights (the port
restores a port checkpoint of the bridged flax variables; the JAX side's
restore is patched to return those variables, as its own
test_run_serving_task_body_advertises_and_serves does), the advertised
key, `ckpt_step`, the final stats' keys and the ``{task}/metrics`` flush,
ended once by the preemption drain (``/healthz`` answering "draining")
and once by ``serve_seconds``. The JAX side runs its plain RMSNorm
(tests/test_torch_swap.py)."""

import functools
import http.client
import json
import socket
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu import experiment as j_experiment
from tf_yarn_tpu import preemption as j_preemption
from tf_yarn_tpu.coordination.kv import InProcessKV as JInProcessKV
from tf_yarn_tpu.parallel.mesh import MeshSpec
from tf_yarn_tpu.serving import server as j_server
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch.coordination.kv import InProcessKV as TInProcessKV
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.weights import from_flax
from tf_yarn_tpu_torch.serving import server as t_server
from tf_yarn_tpu_torch.topologies import TaskKey

MAX_SEQ = 64
PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5,
                             2, 3])
NEW_TOKENS = 5
GRIDS = {"fused": dict(kv_layout="paged", decode_attention="fused"),
         "gather": dict(kv_layout="paged", decode_attention="gather"),
         "dense": dict(kv_layout="dense")}


# -- the experiment's verdicts ------------------------------------------------

def _stand_in_model():
    """What the validation reads of a decoder: its head counts."""
    return types.SimpleNamespace(
        config=types.SimpleNamespace(n_heads=4, n_kv_heads=2))


def _draft(context, k):
    return [0] * k


# Each case: the kwargs, on which the port's verdict is the JAX package's.
SERVING_CASES = {
    "defaults": {},
    "max_slots": {"max_slots": 0},
    "queue_capacity": {"queue_capacity": 0},
    "serve_seconds_negative": {"serve_seconds": -1},
    "serve_seconds_zero": {"serve_seconds": 0},
    "serve_seconds": {"serve_seconds": 2.5},
    "kv_layout": {"kv_layout": "ring"},
    "dense": {"kv_layout": "dense"},
    "block_size": {"block_size": 0},
    "num_blocks": {"num_blocks": 1},
    "num_blocks_two": {"num_blocks": 2},
    "prefix_cache_capacity": {"prefix_cache_capacity": -1},
    "spec_k": {"spec_k": -1},
    "spec_draft": {"spec_draft": "medusa"},
    "spec_draft_callable": {"spec_k": 2, "spec_draft": _draft},
    "spec_draft_none": {"spec_draft": None},
    "decode_attention": {"decode_attention": "flash"},
    "fused_dense": {"decode_attention": "fused", "kv_layout": "dense"},
    "fused": {"decode_attention": "fused"},
    "prefill_chunk_negative": {"prefill_chunk": -1},
    "prefill_chunk_word": {"prefill_chunk": "big"},
    "prefill_chunk_float": {"prefill_chunk": 2.5},
    "prefill_chunk_auto": {"prefill_chunk": "auto"},
    "budget_unchunked": {"prefill_budget_per_tick": 8},
    "budget_zero": {"prefill_chunk": 4, "prefill_budget_per_tick": 0},
    "budget": {"prefill_chunk": 4, "prefill_budget_per_tick": 8},
    "kv_host_blocks": {"kv_host_blocks": -1},
    "kv_host_blocks_dense": {"kv_host_blocks": 4, "kv_layout": "dense"},
    "tier_caps_unknown": {"tier_caps": {"gold": 1}},
    "tier_caps_negative": {"tier_caps": {"batch": -1}},
    "tier_caps_float": {"tier_caps": {"batch": 1.5}},
    "tier_caps": {"tier_caps": {"batch": 2, "interactive": 8}},
    "mesh_tp": {"mesh_spec": MeshSpec(tp=2)},
    "mesh_one_device": {"mesh_spec": MeshSpec()},
    "slo_unknown": {"slo": {"ttft_p100_s": 1.0}},
    "slo_unit": {"slo": {"interactive_ttft_p95_ms": 1.0}},
    "slo_not_dict": {"slo": [1]},
    "slo": {"slo": {"interactive_ttft_p95_s": 0.5}},
    "autoscale": {"autoscale": {"generate": {"min_replicas": 1,
                                             "max_replicas": 4}}},
    "autoscale_broken": {"autoscale": {"generate": {"min_replicas": -1}}},
    "autoscale_unknown_kind": {"autoscale": {"worker": {}}},
    "autoscale_not_dict": {"autoscale": ["generate"]},
    "autoscale_launch_eta_s": {"autoscale_launch_eta_s": 0.0},
    "router_policy": {"router_policy": "random"},
    "router_retries": {"router_retries": -1},
    "router_probe_interval_s": {"router_probe_interval_s": 0},
    "router_with_mesh": {"router_policy": "random",
                         "mesh_spec": MeshSpec(tp=2)},
    "prefill_tier_threshold": {"prefill_tier": {"offload_threshold": 0}},
    "prefill_tier_timeout": {"prefill_tier": {"timeout_s": 0.0}},
    "prefill_tier_backoff": {"prefill_tier": {"backoff_s": -1}},
    "prefill_tier_ttl": {"prefill_tier": {"resolve_ttl_s": 0}},
    "prefill_tier_num_blocks": {"prefill_tier": {"num_blocks": 1}},
    "prefill_tier_unknown_key": {"prefill_tier": {"offload_tokens": 5}},
    "prefill_tier_not_dict": {"prefill_tier": [128]},
    "prefill_tier": {"prefill_tier": {"offload_threshold": 128,
                                      "endpoint": "127.0.0.1:1"}},
}


def verdict(cls, **kwargs):
    try:
        cls(**kwargs)
    except Exception as exc:  # the verdict is the exception
        return type(exc).__name__, str(exc)
    return "ok", None


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_serving_experiment_verdict_equals_jax(case):
    args = dict(model=_stand_in_model(), model_dir="/x",
                **SERVING_CASES[case])
    assert verdict(t_experiment.ServingExperiment, **args) == \
        verdict(j_experiment.ServingExperiment, **args)


# The fields that only the router reads, each with a value both packages
# take and, where the JAX package validates the field, one it refuses
# (experiment.py:537-568): the same verdicts in the port, and the value
# kept as given.
ROUTER_FIELDS = {"router_host": ("127.0.0.1", None),
                 "router_port": (8080, None),
                 "router_policy": ("round_robin", "random"),
                 "router_retries": (0, -1),
                 "router_probe_interval_s": (2.0, 0.0),
                 "autoscale_launch_eta_s": (5.0, -1.0),
                 "autoscale_warm_start": (False, None)}


@pytest.mark.parametrize("field", sorted(ROUTER_FIELDS))
def test_serving_experiment_refuses_router_fields(field):
    """Each router field is a field of the port's ServingExperiment with
    the JAX default, takes what JAX takes and refuses what JAX refuses,
    with its message."""
    good, bad = ROUTER_FIELDS[field]
    base = {"model": _stand_in_model(), "model_dir": "/x"}
    assert getattr(t_experiment.ServingExperiment(**base), field) == \
        getattr(j_experiment.ServingExperiment(**base), field)
    args = dict(base, **{field: good})
    assert verdict(t_experiment.ServingExperiment, **args) == \
        verdict(j_experiment.ServingExperiment, **args) == ("ok", None)
    assert getattr(t_experiment.ServingExperiment(**args), field) == good
    if bad is not None:
        args = dict(base, **{field: bad})
        kind, message = verdict(t_experiment.ServingExperiment, **args)
        assert (kind, message) == verdict(j_experiment.ServingExperiment,
                                          **args)
        assert kind == "ValueError" and field in message


# -- the advertised endpoint --------------------------------------------------

class _UdpSocket:
    """socket.socket's stand-in: connect() fails (no route) or reports
    `address`, so no test reaches outside the host."""

    address = None

    def __init__(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def connect(self, target):
        if self.address is None:
            raise OSError("Network is unreachable")

    def getsockname(self):
        return (self.address, 40000)


@pytest.mark.parametrize("host", ["0.0.0.0", "", "::", "127.0.0.1",
                                  "replica-7.example"])
@pytest.mark.parametrize("route", [None, "10.1.2.3"])
def test_advertised_endpoint_equals_jax(host, route, monkeypatch):
    stand_in = type("Udp", (_UdpSocket,), {"address": route})
    monkeypatch.setattr(socket, "socket", stand_in)
    monkeypatch.setattr(socket, "getfqdn", lambda *a: "host.example")
    got = t_server.advertised_endpoint(host, 8123)
    assert got == j_server.advertised_endpoint(host, 8123)
    wildcard = host in ("0.0.0.0", "", "::")
    assert got == (f"{route or 'host.example'}:8123" if wildcard
                   else f"{host}:8123")


# -- run_serving on both packages ---------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_decoder():
    """The JAX tiny f32 decoder (int8 KV, plain norms) and its variables."""
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=False,
        scan_layers=False, remat=False, max_seq_len=MAX_SEQ)
    model = jt.Transformer(cfg)
    variables = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, variables


def port_config():
    return tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                     kv_cache_dtype="int8")


def write_port_checkpoint(model_dir, step=3):
    """`jax_decoder`'s variables as the port checkpoint ckpt-<step>."""
    _, variables = jax_decoder()
    state = from_flax(jax.tree_util.tree_map(np.asarray, variables),
                      port_config())
    t_ckpt.save_checkpoint(str(model_dir), step,
                           {"params": state, "optimizer": {}, "step": step})
    return str(model_dir)


@pytest.fixture(scope="module")
def decoder_dir(tmp_path_factory):
    return write_port_checkpoint(tmp_path_factory.mktemp("decoder"))


class Runtime:
    """What a task body reads of `tasks._bootstrap.TaskRuntime`."""

    def __init__(self, kv, task):
        task_type, _, task_id = task.partition(":")
        self.kv, self.task = kv, task
        self.task_key = TaskKey(task_type, int(task_id))


def post(port, body, path="/v1/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class Package:
    """One package's serving task body behind one interface."""

    def __init__(self, name, monkeypatch, model_dir):
        self.name = name
        self.monkeypatch = monkeypatch
        self.model_dir = model_dir
        if name == "jax":
            from tf_yarn_tpu import inference as j_inference
            from tf_yarn_tpu.models.decode_engine import clear_engines

            clear_engines()
            variables = jax_decoder()[1]
            monkeypatch.setattr(j_inference, "_restore_params",
                                lambda model_dir, step: (variables, 3))
            self.kv, self.preemption = JInProcessKV(), j_preemption
            self.server = j_server
        else:
            self.kv, self.preemption = TInProcessKV(), t_preemption
            self.server = t_server

    def experiment(self, **kwargs):
        kwargs = dict(host="127.0.0.1", max_slots=2, **kwargs)
        if self.name == "jax":
            return j_experiment.ServingExperiment(
                model=jax_decoder()[0], model_dir="/restore-is-patched",
                **kwargs)
        return t_experiment.ServingExperiment(
            model=tt.Transformer(port_config(), device="cpu"),
            model_dir=self.model_dir, **kwargs)

    def start(self, experiment, task="serving:0"):
        """run_serving on a thread; returns (thread, result, port)."""
        result = {}

        def serve():
            try:
                result["stats"] = self.server.run_serving(
                    experiment, runtime=Runtime(self.kv, task))
            except BaseException as exc:  # surfaced by the test
                result["error"] = exc

        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        endpoint = self.kv.wait_str(f"{task}/serving_endpoint", timeout=120)
        return thread, result, int(endpoint.rsplit(":", 1)[1])

    def hold_drain(self):
        """Make the scheduler's drain wait until the returned event is
        set, so the test reads /healthz before the frontend stops."""
        release = threading.Event()
        cls = self.server.SlotScheduler
        original = cls.drain

        def drain(scheduler):
            original(scheduler)
            release.wait(60)

        self.monkeypatch.setattr(cls, "drain", drain)
        return release


def _finished(thread, result):
    thread.join(timeout=120)
    assert not thread.is_alive()
    if "error" in result:
        raise result["error"]
    return result["stats"]


def serve_and_drain(package, grid):
    """The prompts one at a time through run_serving, then the
    preemption notice: returns the streams, /healthz during the drain,
    the final stats and the metrics the body flushed."""
    release = package.hold_drain()
    thread, result, port = package.start(package.experiment(**grid))
    try:
        streams = []
        for prompt in PROMPTS:
            status, body = post(port, {"prompt": prompt,
                                       "max_new_tokens": NEW_TOKENS})
            assert status == 200, body
            streams.append(body["tokens"])
        assert get(port, "/healthz")[1]["status"] == "ok"
        package.preemption.request()
        health = get(port, "/healthz")[1]["status"]
    finally:
        release.set()
        try:
            stats = _finished(thread, result)
        finally:
            package.preemption.reset()
    metrics = json.loads(package.kv.get_str("serving:0/metrics"))
    return streams, health, stats, port, metrics


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_run_serving_streams_equal_jax(grid, decoder_dir, monkeypatch):
    got = serve_and_drain(Package("port", monkeypatch, decoder_dir),
                          GRIDS[grid])
    ref = serve_and_drain(Package("jax", monkeypatch, decoder_dir),
                          GRIDS[grid])
    streams, health, stats, port, metrics = got
    assert streams == ref[0]
    assert all(len(s) == NEW_TOKENS for s in streams)
    assert health == ref[1] == "draining"
    assert stats["ckpt_step"] == ref[2]["ckpt_step"] == 3
    assert stats["endpoint"] == f"127.0.0.1:{port}"
    assert sorted(stats) == sorted(ref[2])
    assert stats["draining"] is True and ref[2]["draining"] is True
    layout = GRIDS[grid]["kv_layout"]
    for key in (f"serving/kv_cache_hbm_bytes{{layout={layout}}}",
                "serving/ttft_seconds_count"):
        assert key in metrics and key in ref[4], key
    assert metrics["serving/ttft_seconds_count"] >= len(PROMPTS)


def test_run_serving_ends_after_serve_seconds(decoder_dir, monkeypatch):
    ends = {}
    for side in ("jax", "port"):
        package = Package(side, monkeypatch, decoder_dir)
        experiment = package.experiment(serve_seconds=0.5, kv_layout="paged")
        thread, result, port = package.start(experiment, task="serving:1")
        stats = _finished(thread, result)
        assert stats["endpoint"] == f"127.0.0.1:{port}"
        assert stats["ckpt_step"] == 3
        assert package.kv.get_str("serving:1/metrics") is not None
        ends[side] = {key: stats[key] for key in ("draining", "ticks",
                                                  "active_slots")}
    assert ends["port"] == ends["jax"]


def test_port_run_serving_refuses_a_missing_checkpoint(tmp_path):
    experiment = t_experiment.ServingExperiment(
        model=tt.Transformer(port_config(), device="cpu"),
        model_dir=str(tmp_path), host="127.0.0.1")
    with pytest.raises(FileNotFoundError, match="no ckpt-<step>"):
        t_server.run_serving(experiment)
