"""The port's serving, prefill, rank and router task programs launched by
`run_on_gpu` on the CPU (``TPU_YARN_PLATFORM=cpu``), with the experiment
fn of `chip_smoke.py`'s phase 10 sent by name at the small f32 size:

* phase 10 rehearsed once (`chip_smoke.fleet_slice`): one launch of the
  mixed fleet — two decode replicas, a prefill replica, a rank replica
  and the router. On the first decode replica the shipped prompts stream
  as local serving does; the rank replica's scores equal a direct
  forward of the same seed's model; through the router the streams equal
  the local ones on both decode replicas, the rank scores equal the
  replica's own, the fleet aggregate pools the decode replicas' TTFT
  counts; a drained decode replica is ejected, the next requests land
  on the other, and the autoscaler records a below_min event; the
  driver logs each endpoint once and the router never touches CUDA;
* a serving task without that setting fails with the no-CUDA error,
  classified as the JAX package classifies its missing accelerator;
* a serving task whose checkpoint is missing fails as the JAX package's
  serving task does: the same kind and the same exception in its stop
  event."""

import os
import re

import pytest
import torch

import chip_smoke
from tf_yarn_tpu.client import RunFailed as JRunFailed
from tf_yarn_tpu.client import run_on_tpu
from tf_yarn_tpu.topologies import serving_topology as j_serving_topology
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import topologies as t_topo
from tf_yarn_tpu_torch.models import decode_engine as t_engine
from tf_yarn_tpu_torch.models import dlrm as t_dlrm
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.resilience import FailureKind
from tf_yarn_tpu_torch.serving import scheduler as t_scheduler
from tf_yarn_tpu_torch.serving import server as t_server

CPU = {"TPU_YARN_PLATFORM": "cpu"}


@pytest.fixture(scope="module")
def fleet():
    """Phase 10 on the CPU at the small size: one launch of the mixed
    fleet, every part's checks made by `fleet_slice` itself."""
    return chip_smoke.fleet_slice(
        torch, tt, t_engine, t_scheduler, t_server, t_ckpt, t_client, t_topo,
        t_dlrm, torch.device("cpu"), tiny=True, env=CPU)


def test_decode_and_prefill_replicas_serve_the_local_streams(fleet):
    launched = fleet["b_launched"]
    assert launched["streams_equal_in_process"]
    assert launched["streams"] == fleet["a_in_process"]["streams"]
    assert launched["prefill_offload"]["ships"] == 2
    assert launched["prefill_offload"]["local_fallbacks"] == 0
    assert launched["prefill_offload"]["shipped_blocks"] == 2 + 16
    assert {label: len(found) for label, found in
            launched["endpoints"].items()} == chip_smoke.FLEET_ENDPOINTS
    assert sorted(launched["container_duration_s"]) == chip_smoke.FLEET_TASKS
    for task in ("decode_task", "serving_1_task", "prefill_task"):
        assert not launched[task]["built_kernels_here"]
    assert launched["prefill_task"]["spans_s"]["checkpoint/verify"]


def test_rank_replica_scores_equal_a_direct_forward(fleet):
    result = fleet["c_ranking"]
    assert result["bitwise_equal"]
    assert max(result["max_abs_err"].values()) == 0.0
    assert result["task"]["spans_s"]["ranking/warmup"]


def test_the_router_routes_the_mixed_fleet(fleet):
    routed = fleet["d_routed"]
    assert routed["healthy_by_kind"] == chip_smoke.FLEET_KINDS
    assert routed["streams_equal_in_process"]
    assert routed["routed_one_at_a_time"]["serving:0"] == {"ok": 3}
    assert routed["routed_one_at_a_time"]["serving:1"] == {"ok": 3}
    assert all(routed["rank_scores_equal_direct"].values())
    assert routed["routed_requests"]["rank:0"] == {"ok": 3}
    aggregate = routed["fleet"]
    assert (aggregate["status"], aggregate["stale_replicas"]) == ("ok", 0)
    assert aggregate["ttft"]["count"] == sum(
        aggregate["replica_ttft_counts"].values())
    assert routed["unknown_path_status"] == 404
    router = routed["router_task"]
    assert not (router["cuda_initialized"] or router["built_kernels_here"]
                or router["kernel_library_loaded"])


def test_a_drained_replica_fails_over_to_the_other(fleet):
    failover = fleet["e_failover"]
    assert failover["serving_1"]["ejections"] == 1
    assert failover["serving_1"]["eject_reason"] in ("draining",
                                                     "unreachable")
    assert failover["streams_equal_in_process"]
    assert failover["healthy_by_kind"] == dict(chip_smoke.FLEET_KINDS,
                                               generate=1)
    event = failover["scale_event"]
    assert (event["kind"], event["reason"], event["from_replicas"],
            event["to_replicas"]) == ("generate", "below_min", 1, 2)
    assert set(fleet["seconds"]) >= {"launch_to_router_endpoint",
                                     "d_routed", "e_failover", "drain"}


def test_a_serving_task_without_the_cpu_setting_fails_without_a_card(
        tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    with pytest.raises(t_client.RunFailed) as err:
        t_client.run_on_gpu(
            t_client.get_safe_experiment_fn(
                "chip_smoke.fleet_experiment", str(tmp_path),
                str(tmp_path), 0, True),
            t_topo.serving_topology(),
            env={"PYTHONPATH": os.path.dirname(chip_smoke.__file__)},
            poll_every_secs=0.2)
    assert "no CUDA device is available" in str(err.value)
    # The kind the JAX package gives its own missing-accelerator error
    # (tests/test_torch_launcher.py, case "no_device").
    assert err.value.kind is FailureKind.TRANSIENT


def _jax_serving_fn(model_dir):
    def experiment_fn():
        import jax.numpy as jnp

        from tf_yarn_tpu.experiment import ServingExperiment
        from tf_yarn_tpu.models import transformer

        cfg = transformer.TransformerConfig.tiny(
            dtype=jnp.float32, max_seq_len=64, scan_layers=False,
            remat=False)
        return ServingExperiment(model=transformer.Transformer(cfg),
                                 model_dir=model_dir, host="127.0.0.1")

    return experiment_fn


def _failure(exc):
    """The attempt's kind and the exception type the stop event names."""
    names = re.findall(r"^(\w+Error): ", str(exc), re.MULTILINE)
    return exc.kind.value, names[-1]


def test_a_missing_checkpoint_fails_as_in_jax(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(JRunFailed) as ref:
        run_on_tpu(_jax_serving_fn(str(empty)), j_serving_topology(
            chips_per_host=0), poll_every_secs=0.2)
    with pytest.raises(t_client.RunFailed) as got:
        t_client.run_on_gpu(
            t_client.get_safe_experiment_fn(
                "chip_smoke.fleet_experiment", str(empty),
                str(tmp_path), 0, True),
            t_topo.serving_topology(chips_per_host=0),
            env=dict(CPU, PYTHONPATH=os.path.dirname(chip_smoke.__file__)),
            poll_every_secs=0.2)
    assert _failure(got.value) == _failure(ref.value)
    assert _failure(got.value)[1] == "FileNotFoundError"
    assert "no ckpt-<step>" in str(got.value)


def test_the_readme_serving_recipe_runs(tmp_path):
    """README's "Serving replicas on the CPU" script, run as a user would
    (its repo path, model directory and port filled in): the reply's
    tokens, and both endpoints in the driver's log."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    text = open(os.path.join(repo, "README.md")).read()
    start = text.index("```python", text.index("Serving replicas on the CPU"))
    script = text[start + len("```python"):text.index("```", start + 9)]
    port = chip_smoke.free_port()
    script = (script.replace("/path/to/repo", repo)
              .replace('"/tmp/fleet-model"', repr(str(tmp_path / "model")))
              .replace("8910", str(port)))
    (tmp_path / "my_fleet.py").write_text(script)
    out = subprocess.run([sys.executable, "my_fleet.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tokens = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(tokens) == 8 and all(0 <= t < 256 for t in tokens)
    assert f"serving endpoint 127.0.0.1:{port}" in out.stderr
    assert "prefill endpoint 127.0.0.1:" in out.stderr
