"""The port's ``router`` task (`fleet.router.run_router`, tasks/router.py)
and its presets, held against the JAX package's on the CPU: `run_router`
as a task body over a fake replica in both packages (routes, the
advertised endpoint, the flushed metrics and the autoscaler's
``fleet_desired`` key), `fleet_topology` and `mixed_fleet_topology`
specs and verdicts, the task program's refusal of another experiment,
the router's meta device with CUDA never touched, and README's "A
serving fleet" script launched by `run_on_gpu(fleet_topology(
nb_replicas=2))` with ``TPU_YARN_PLATFORM=cpu``: the driver logs the
router's endpoint once and the streams through it equal the same
checkpoint's in-process grid."""

import http.client
import json
import os
import subprocess
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

import chip_smoke
from tf_yarn_tpu import experiment as j_experiment
from tf_yarn_tpu import preemption as j_preemption
from tf_yarn_tpu import topologies as j_topo
from tf_yarn_tpu.coordination.kv import InProcessKV as JInProcessKV
from tf_yarn_tpu.fleet import router as j_router
from tf_yarn_tpu.tasks import router as j_router_task
from tf_yarn_tpu_torch import _device
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import topologies as t_topo
from tf_yarn_tpu_torch.coordination.kv import InProcessKV as TInProcessKV
from tf_yarn_tpu_torch.fleet import router as t_router
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.tasks import router as t_router_task

PACKAGES = {
    "jax": types.SimpleNamespace(
        experiment=j_experiment, preemption=j_preemption, KV=JInProcessKV,
        router=j_router, task=j_router_task, topo=j_topo,
        chip_label=j_topo.NodeLabel.TPU),
    "port": types.SimpleNamespace(
        experiment=t_experiment, preemption=t_preemption, KV=TInProcessKV,
        router=t_router, task=t_router_task, topo=t_topo,
        chip_label=t_topo.NodeLabel.GPU),
}


def _upstream():
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, payload):
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._json({"status": "ok", "queue_depth": 0, "active_slots": 0})

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            self._json({"tokens": [3, 1, 4], "finish_reason": "length"})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"127.0.0.1:{httpd.server_address[1]}"


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _runtime(p, kv):
    key = p.topo.TaskKey("router", 0)
    return types.SimpleNamespace(
        kv=kv, task_key=key, task="router:0",
        cluster_tasks=[p.topo.TaskInstance(p.topo.TaskKey("serving", 0), 1),
                       p.topo.TaskInstance(key, 1)])


def _route_as_task(p, run):
    """`run(experiment, runtime)` (a router task body) in a thread over one
    fake replica until the preemption notice; returns what the client
    saw, the body's result and the KV keys it wrote."""
    httpd, endpoint = _upstream()
    kv = p.KV()
    kv.put_str("serving:0/serving_endpoint", endpoint)
    experiment = p.experiment.ServingExperiment(
        model=None, model_dir="/unused-the-router-never-restores",
        router_host="127.0.0.1", router_probe_interval_s=0.05,
        router_policy="round_robin",
        autoscale={"generate": {"min_replicas": 2, "max_replicas": 2,
                                "scale_in_load": None}},
        autoscale_warm_start=False)
    result = {}

    def route():
        result["stats"] = run(experiment, _runtime(p, kv))

    thread = threading.Thread(target=route)
    thread.start()
    try:
        advertised = kv.wait_str("router:0/router_endpoint", timeout=60)
        port = int(advertised.rsplit(":", 1)[1])
        reply = _request(port, "POST", "/v1/generate",
                         {"prompt": [1, 2], "max_new_tokens": 3})
        routed = _request(port, "GET", "/stats")[1]["routed_requests"]
        desired = json.loads(kv.wait_str("router:0/fleet_desired_generate",
                                         timeout=60))
    finally:
        p.preemption.request()
        thread.join(timeout=60)
        p.preemption.reset()
        httpd.shutdown()
        httpd.server_close()
    assert not thread.is_alive()
    stats = result["stats"]
    assert stats["endpoint"] == advertised
    return {"reply": reply, "routed": routed, "desired": desired,
            "policy": stats["policy"], "retries": stats["retries"],
            "role": stats["role"], "stats_keys": sorted(stats),
            "autoscaler_policies": stats["autoscaler"]["policies"],
            "fleet_keys": sorted(stats["fleet"]),
            "keys": sorted(k for k in kv.keys("router:0/"))}


def test_run_router_task_body_advertises_and_routes_as_jax():
    got = {name: _route_as_task(p, p.router.run_router)
           for name, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["reply"] == (200, {"tokens": [3, 1, 4],
                                   "finish_reason": "length"})
    assert port["routed"] == {"serving:0": {"ok": 1}}
    assert port["desired"] == {"kind": "generate", "replicas": 2,
                               "reason": "below_min"}
    assert port["keys"] == ["router:0/fleet_desired_generate",
                            "router:0/metrics", "router:0/router_endpoint"]


def test_router_task_program_refuses_another_experiment():
    def refusal(p, experiment):
        with pytest.raises(TypeError) as err:
            p.task._run(_runtime(p, p.KV()), experiment)
        return str(err.value)

    assert refusal(PACKAGES["port"], object()) == \
        refusal(PACKAGES["jax"], object())
    assert "RankingExperiment" in refusal(
        PACKAGES["port"],
        t_experiment.RankingExperiment(types.SimpleNamespace(
            config=types.SimpleNamespace(table_sizes=(4,)))))


def test_the_router_builds_its_model_on_meta_and_never_touches_cuda(
        monkeypatch):
    """In a ``router:*`` task `task_device()` is the meta device even
    where a card is visible: the experiment fn's 8B decoder holds shapes
    only, its validation reads no weight, and the router's whole body
    (registry, monitor, autoscaler, frontend, one routed request) runs
    with CUDA's initialisation made to fail."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("the router initialised CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    monkeypatch.setenv("TPU_YARN_TASK", "router:0")
    device = _device.task_device()
    assert device == torch.device("meta")
    model = tt.Transformer(tt.TransformerConfig.llama3_8b(
        dtype=torch.bfloat16, kv_cache_dtype="int8"), device=device)
    assert model.device.type == "meta"
    experiment = t_experiment.ServingExperiment(
        model, "/unused", router_host="127.0.0.1",
        router_probe_interval_s=0.05,
        autoscale={"generate": {"min_replicas": 2, "max_replicas": 2}})
    record = _route_as_task(
        PACKAGES["port"],
        lambda exp, runtime: t_router.run_router(experiment, runtime))
    assert record["reply"][0] == 200
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("TPU_YARN_TASK", "serving:0")
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert _device.task_device() == torch.device("cpu")


def test_the_driver_launches_and_logs_the_router():
    assert t_client.ENDPOINT_EVENTS["router"][1] == "router endpoint"
    assert t_client.ENDPOINT_EVENTS["router"][0]("router:0") == \
        "router:0/router_endpoint"


# Each case: the preset and its arguments, given to both packages.
FLEET_PRESETS = {
    "fleet": ("fleet_topology", {}),
    "fleet_three_on_the_cpu": ("fleet_topology", {"nb_replicas": 3,
                                                  "chips_per_host": 0}),
    "fleet_sized_router": ("fleet_topology", {"router_memory_gib": 16,
                                              "router_vcores": 2}),
    "fleet_none": ("fleet_topology", {"nb_replicas": 0}),
    "fleet_router_too_big": ("fleet_topology", {"router_memory_gib": 999}),
    "fleet_nine_chips": ("fleet_topology", {"chips_per_host": 9}),
    "mixed": ("mixed_fleet_topology", {}),
    "mixed_two_one": ("mixed_fleet_topology", {"nb_serving": 2,
                                               "nb_rank": 1}),
    "mixed_no_serving": ("mixed_fleet_topology", {"nb_serving": 0}),
    "mixed_no_rank": ("mixed_fleet_topology", {"nb_rank": 0}),
    "mixed_router_vcores": ("mixed_fleet_topology", {"router_vcores": 300}),
}


@pytest.mark.parametrize("case", sorted(FLEET_PRESETS))
def test_fleet_presets_equal_jax_with_the_chip_label_mapped(case):
    name, kwargs = FLEET_PRESETS[case]

    def verdict(p):
        try:
            specs = getattr(p.topo, name)(**kwargs)
        except ValueError as exc:
            return "ValueError", str(exc)
        return {t: (s.memory_gib, s.vcores, s.instances, s.chips_per_host,
                    s.nb_proc_per_worker, s.label is p.chip_label)
                for t, s in specs.items()}

    got = verdict(PACKAGES["port"])
    assert got == verdict(PACKAGES["jax"])
    if case == "mixed_two_one":
        assert got["router"] == (8, 4, 1, 0, 1, False)


def test_phase_ten_mixed_fleet_is_a_valid_topology():
    specs = chip_smoke.mixed_fleet(t_topo)
    assert {t: s.instances for t, s in specs.items()} == {
        "serving": 2, "rank": 1, "router": 1, "prefill": 1}
    assert specs["router"].label is t_topo.NodeLabel.CPU
    assert t_topo.compute_nb_chips(specs) == 4


def test_the_readme_fleet_recipe_runs(tmp_path):
    """README's "A serving fleet" script, run as a user would (its repo
    path, model directory and router port filled in): the driver logs
    the router's endpoint once, and both routed replies equal the same
    checkpoint served in process on the same grid."""
    from tf_yarn_tpu_torch import inference
    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.serving.request import SamplingParams
    from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    text = open(os.path.join(repo, "README.md")).read()
    start = text.index("```python", text.index("A serving fleet:"))
    script = text[start + len("```python"):text.index("```", start + 9)]
    port = chip_smoke.free_port()
    model_dir = tmp_path / "model"
    script = (script.replace("/path/to/repo", repo)
              .replace('"/tmp/fleet-model"', repr(str(model_dir)))
              .replace("8920", str(port)))
    (tmp_path / "my_fleet.py").write_text(script)
    out = subprocess.run([sys.executable, "my_fleet.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    replies = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert out.stderr.count("router endpoint ") == 1
    assert f"router endpoint 127.0.0.1:{port}" in out.stderr
    assert out.stderr.count("serving endpoint ") == 2

    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=128,
                                    kv_cache_dtype="int8")
    model = tt.Transformer(cfg, device="cpu")
    inference._restore_params(model, str(model_dir), None)
    grid = SlotScheduler(DecodeEngine(model), max_slots=8,
                         kv_layout="paged", decode_attention="fused")
    try:
        response = grid.submit(list(range(40)),
                               SamplingParams(max_new_tokens=8))
        for _ in range(200):
            if response.done:
                break
            grid.tick()
        expected = response.result(timeout=1)
    finally:
        grid.close()
    assert replies == [expected, expected]
