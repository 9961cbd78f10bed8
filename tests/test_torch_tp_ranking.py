"""Embedding-sharded ranking in the port (`RankEngine(mesh=)`,
`serving.tp_replica.ranker_shard`, `run_ranking` under
``mesh_spec=MeshSpec(tp=2)``, `ranking_topology(chips_per_host=2)`) held
against the JAX package on `DLRMConfig.tiny` in f32 with weights bridged
from `DLRM.init` (`models/weights.dlrm_from_flax`): the JAX side is a
tp=2 mesh over the conftest's virtual CPU devices, as
tests/test_ranking.py builds it.

The port's replica is two gloo ranks on the CPU: this process leads (one
group shared by the `TestReplica` cases), a spawned follower runs every
forward on its rows of the table. Checked: scores bitwise equal to the
port's one-device engine and within 1e-5 of the JAX tp=2 engine (f32
sums in another order) at batches 1 and 5; each rank's (128, 8) shard
and its bytes (the total less half the table, JAX's figure); the
``embed`` all-reduce and the headers as spans; a `RankServer` over the
tp engine (its ``/stats``, its 400s); the engine's and the experiment's
mesh verdicts against JAX's. Then `run_ranking` through the rank task's
body, each in a group of its own: the seeded init served bit for bit as
one device serves it, a checkpoint each rank reads its rows of, and a
killed follower failing the leader, classified; and one launched
`run_on_gpu` of `ranking_topology(chips_per_host=2)`.

This module imports JAX only inside functions: the launched rank task
imports it by name for `launched_tp_ranker`."""

import functools
import http.client
import json
import os
import signal
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.coordination.kv import InProcessKV
from tf_yarn_tpu_torch.models import dlrm as t_dlrm
from tf_yarn_tpu_torch.models.rank_engine import RankEngine
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.mesh import MeshSpec
from tf_yarn_tpu_torch.ranking import MicroBatchScheduler, RankServer
from tf_yarn_tpu_torch.resilience import taxonomy
from tf_yarn_tpu_torch.serving import tp_replica
from tf_yarn_tpu_torch.topologies import TaskKey

BUCKETS = (1, 4, 8)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_BYTES = 256 * 8 * 4  # DLRMConfig.tiny's stacked [256, 8] f32 table


def port_config():
    return t_dlrm.DLRMConfig.tiny(dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def jax_ranker():
    """The JAX tiny f32 DLRM and its variables."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import dlrm as j_dlrm

    model = j_dlrm.DLRM(j_dlrm.DLRMConfig.tiny(dtype=jnp.float32))
    args = (jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4), jnp.float32))
    return model, nn.meta.unbox(model.init(jax.random.PRNGKey(0), *args))


@functools.lru_cache(maxsize=None)
def port_state():
    """`jax_ranker`'s variables as the port's one-device state dict."""
    import jax

    from tf_yarn_tpu_torch.models.weights import dlrm_from_flax

    _, variables = jax_ranker()
    return dlrm_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                          port_config())


@functools.lru_cache(maxsize=None)
def one_device():
    """The port's one-device engine over the same weights."""
    model = t_dlrm.DLRM(port_config(), device="cpu")
    model.load_state_dict(port_state())
    return RankEngine(model, batch_buckets=BUCKETS)


@functools.lru_cache(maxsize=None)
def jax_tp2():
    """The JAX engine on a tp=2 mesh of two virtual CPU devices."""
    import jax

    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from tf_yarn_tpu.parallel.mesh import build_mesh

    model, _ = jax_ranker()
    mesh = build_mesh(JMeshSpec(tp=2), jax.devices("cpu")[:2])
    return JaxEngine(model, batch_buckets=BUCKETS, mesh=mesh)


def features(rows, seed, low=0, high=64):
    rng = np.random.RandomState(seed)
    cat = rng.randint(low, high, (rows, 4)).astype(np.int32)
    dense = rng.standard_normal((rows, 4)).astype(np.float32)
    return cat, dense


def post(port, body, path="/v1/rank"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        raw = body if isinstance(body, bytes) else json.dumps(body)
        conn.request("POST", path, raw, {"Content-Type": "application/json"})
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


def rank_over_http(port, cat, dense):
    status, body = post(port, {"cat": cat.tolist(), "dense": dense.tolist()})
    assert status == 200, body
    return np.asarray(body["scores"], np.float32)


# -- one replica shared by the cases that rank --------------------------------

@pytest.fixture(scope="class")
def replica():
    group = tp_replica.start(MeshSpec(tp=2))
    try:
        group.load(port_config(), builder=tp_replica.ranker_shard,
                   state=port_state(), batch_buckets=BUCKETS)
        yield group
    finally:
        group.close()
    assert [p.exitcode for p in group.processes] == [0]
    assert [r["rank"] for r in group.reports] == [0, 1]
    assert not torch.distributed.is_initialized()


class TestReplica:

    @pytest.mark.parametrize("batch", [1, 5])
    def test_scores_bitwise_one_device_and_near_jax_tp2(self, replica, batch):
        """Ids inside their tables, negative and past them (each folds
        into its own table, then into the rank that holds its row)."""
        _, params = jax_ranker()
        cat, dense = features(batch, seed=batch, low=-300, high=300)
        got = replica.engine.rank(cat, dense)
        assert got.dtype == np.float32 and got.shape == (batch,)
        np.testing.assert_array_equal(got, one_device().rank(cat, dense))
        np.testing.assert_allclose(got, jax_tp2().rank(params, cat, dense),
                                   **F32_TOL)

    def test_each_rank_holds_its_rows(self, replica):
        _, params = jax_ranker()
        engine = replica.engine
        assert engine.tp_degree == 2 and jax_tp2().tp_degree == 2
        table = port_state()["embedding"]
        assert tuple(engine.model.embedding.shape) == (128, 8)
        assert torch.equal(engine.model.embedding, table[:128])
        for name, value in port_state().items():
            if name != "embedding":
                assert torch.equal(engine.model.get_parameter(name), value)
        total = one_device().params_nbytes_per_device()
        assert engine.params_nbytes_per_device() == total - TABLE_BYTES // 2
        assert engine.params_nbytes_per_device() == \
            jax_tp2().params_nbytes_per_device(params)
        reports = engine.rank_report()
        assert [(r["rank"], r["table_rows"], r["params_bytes"])
                for r in reports] == [(0, 128, total - TABLE_BYTES // 2),
                                      (1, 128, total - TABLE_BYTES // 2)]

    def test_the_lookup_is_one_embed_allreduce_a_forward(self, replica):
        tracer = telemetry.get_tracer()
        tracer.clear()
        cat, dense = features(3, seed=7)
        replica.engine.rank(cat, dense)
        spans = tracer.records()
        reduces = [s for s in spans if s.name == "train/tp_allreduce"]
        # The bucket of 4 rows, 4 tables, 8 wide, in f32.
        assert [(s.args["op"], s.args["bytes"]) for s in reduces] == \
            [("embed", 4 * 4 * 8 * 4)]
        headers = [s for s in spans if s.name == "ranking/tp_header"
                   and s.args["op"] != "noop"]
        assert [s.args["op"] for s in headers] == ["score"]
        assert headers[0].args["bytes"] > 4 * 4 * 4

    def test_rank_server_over_the_tp_engine(self, replica):
        scheduler = MicroBatchScheduler(replica.engine, max_batch=8,
                                        max_wait_ms=0)
        server = RankServer(scheduler, "127.0.0.1", 0)
        scheduler.start()
        server.start()
        try:
            for rows in (1, 3, 8):
                cat, dense = features(rows, seed=10 + rows)
                np.testing.assert_array_equal(
                    rank_over_http(server.port, cat, dense),
                    one_device().rank(cat, dense))
            status, body = post(server.port, {"cat": [[1, 2]],
                                              "dense": [[0.0] * 4]})
            assert status == 400 and "cat must be [batch, 4]" in body["error"]
            status, _ = post(server.port, b"{not json")
            assert status == 400
            status, stats = get(server.port, "/stats")
            assert status == 200
            assert stats["tp_degree"] == 2
            assert stats["params_hbm_bytes_per_device"] == \
                replica.engine.params_nbytes_per_device()
            assert stats["rank_engine"]["calls"] >= 3
        finally:
            server.stop()
            scheduler.close()


# -- the engine's and the experiment's verdicts on a mesh ----------------------

def _stand_in_mesh(**axes):
    """What the engine reads of a mesh before it joins a group: its dims
    and their sizes."""
    names = ("pp", "dp", "fsdp", "sp", "tp")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 shape=tuple(axes.get(n, 1) for n in names))


@pytest.mark.parametrize("axes, match", [
    ({"dp": 2}, "tensor-parallel only"), ({"tp": 2, "fsdp": 2},
                                          "tensor-parallel only"),
    ({"tp": 3}, "does not divide")], ids=["dp2", "tp2_fsdp2", "tp3"])
def test_engine_mesh_verdicts_equal_jax(axes, match):
    """tests/test_ranking.py:244-256's refusals: the JAX engine on meshes
    of the virtual devices, the port's on a stand-in of the same dims
    (a refusal comes before any group is joined)."""
    import jax

    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from tf_yarn_tpu.parallel.mesh import build_mesh

    model, _ = jax_ranker()
    spec = JMeshSpec(**axes)
    mesh = build_mesh(spec, jax.devices("cpu")[:spec.total_devices])
    with pytest.raises(ValueError, match=match) as reference:
        JaxEngine(model, mesh=mesh)
    with pytest.raises(ValueError, match=match) as got:
        RankEngine(t_dlrm.DLRM(port_config(), device="cpu"),
                   mesh=_stand_in_mesh(**axes))
    if match == "does not divide":
        assert str(got.value) == str(reference.value)
    else:  # the dims differ by JAX's ep, which the port's mesh lacks
        head = "every mesh axis but 'tp' must be 1, got"
        assert head in str(got.value) and head in str(reference.value)


@pytest.mark.parametrize("spec", [MeshSpec(tp=2), MeshSpec(tp=3),
                                  MeshSpec(dp=2), MeshSpec(tp=2, sp=2)],
                         ids=["tp2", "tp3", "dp2", "tp2_sp2"])
def test_ranking_experiment_mesh_verdict_equals_jax(spec):
    """The tiny DLRM's 256 rows: the experiment refuses what the JAX
    experiment refuses, with its message, before anything loads."""
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec

    def verdict(cls, model, mesh_spec):
        try:
            cls(model=model, mesh_spec=mesh_spec)
        except ValueError as exc:
            return str(exc)
        return "ok"

    jax_spec = JMeshSpec(**{name: size for name, size
                            in zip(spec.axis_names, spec.axis_sizes)})
    got = verdict(t_experiment.RankingExperiment,
                  t_dlrm.DLRM(port_config(), device="meta"), spec)
    assert got == verdict(j_experiment.RankingExperiment, jax_ranker()[0],
                          jax_spec)
    assert (got == "ok") == (spec.tp != 3 and spec.total_devices == spec.tp)


# -- run_ranking through the rank task's body, a group each --------------------

class Runtime:
    """What a task body reads of `tasks._bootstrap.TaskRuntime`."""

    def __init__(self, kv, task):
        task_type, _, task_id = task.partition(":")
        self.kv, self.task = kv, task
        self.task_key = TaskKey(task_type, int(task_id))


def start_task(monkeypatch, **kwargs):
    """The rank task's body on a thread over a tp=2 experiment of the tiny
    f32 DLRM built on the meta device: (thread, result, port, replica,
    kv)."""
    from tf_yarn_tpu_torch.tasks import rank as rank_task

    started = []
    real_start = tp_replica.start

    def start(*args, **kw):
        started.append(real_start(*args, **kw))
        return started[-1]

    monkeypatch.setattr(tp_replica, "start", start)
    kv = InProcessKV()
    experiment = t_experiment.RankingExperiment(
        model=t_dlrm.DLRM(port_config(), device="meta"), host="127.0.0.1",
        max_batch=8, batch_buckets=BUCKETS, mesh_spec=MeshSpec(tp=2),
        **kwargs)
    result = {}

    def serve():
        try:
            rank_task._run(Runtime(kv, "rank:0"), experiment)
        except BaseException as exc:  # noqa: B036 — surfaced by the test
            result["error"] = exc

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    endpoint = kv.wait_str("rank:0/rank_endpoint", timeout=120)
    return thread, result, int(endpoint.rsplit(":", 1)[1]), started[0], kv


def drain(thread):
    t_preemption.request()  # the drain the body polls
    thread.join(timeout=120)
    t_preemption.reset()
    assert not thread.is_alive()


def test_rank_task_tp2_serves_the_one_device_seeded_init(monkeypatch):
    """init_seed=3 drawn whole on each rank, each keeping its rows: the
    replica's scores are those of `dlrm.make_model(cfg, 3)` on one
    device, bit for bit."""
    thread, result, port, replica, kv = start_task(monkeypatch, init_seed=3)
    try:
        reference = RankEngine(t_dlrm.make_model(port_config(), seed=3,
                                                 device="cpu"),
                               batch_buckets=BUCKETS)
        for rows in (1, 3, 8):
            cat, dense = features(rows, seed=rows)
            np.testing.assert_array_equal(rank_over_http(port, cat, dense),
                                          reference.rank(cat, dense))
        status, body = post(port, {"cat": [[1, 2, 3, 4]], "dense": [[0.0]]})
        assert status == 400 and "dense must be [batch, 4]" in body["error"]
        status, stats = get(port, "/stats")
        assert stats["tp_degree"] == 2
        assert stats["params_hbm_bytes_per_device"] == \
            reference.params_nbytes_per_device() - TABLE_BYTES // 2
        assert [p.is_alive() for p in replica.processes] == [True]
    finally:
        drain(thread)
    assert "error" not in result, result
    assert [p.exitcode for p in replica.processes] == [0]
    assert [r["table_rows"] for r in replica.reports] == [128, 128]
    assert "ranking/params_hbm_bytes_per_device" in kv.get_str(
        "rank:0/metrics")
    assert not torch.distributed.is_initialized()


def test_rank_task_tp2_restores_each_ranks_rows(tmp_path, monkeypatch):
    """A port checkpoint of the bridged JAX weights: each rank takes its
    rows (through the memory-mapped state), and the replica scores as
    the one-device engine does and within 1e-5 of jitted JAX."""
    import jax

    t_ckpt.save_checkpoint(str(tmp_path), 2, {"params": port_state(),
                                              "optimizer": {}, "step": 2})
    thread, result, port, replica, _kv = start_task(
        monkeypatch, model_dir=str(tmp_path))
    try:
        model, params = jax_ranker()
        for rows in (1, 5):
            cat, dense = features(rows, seed=20 + rows)
            got = rank_over_http(port, cat, dense)
            np.testing.assert_array_equal(got, one_device().rank(cat, dense))
            want = np.asarray(jax.jit(model.apply)(params, cat, dense),
                              np.float32).squeeze(-1)
            np.testing.assert_allclose(got, want, **F32_TOL)
    finally:
        drain(thread)
    assert "error" not in result, result
    assert [p.exitcode for p in replica.processes] == [0]


def test_killed_follower_fails_the_ranker_classified(monkeypatch):
    monkeypatch.setattr(tp_lib, "DEFAULT_TIMEOUT_S", 20.0)
    thread, result, port, replica, _kv = start_task(monkeypatch)
    cat, dense = features(2, seed=1)
    rank_over_http(port, cat, dense)
    killed = time.monotonic()
    os.kill(replica.processes[0].pid, signal.SIGKILL)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert time.monotonic() - killed < 20
    error = result["error"]
    assert isinstance(error, tp_lib.TPGroupError)
    assert taxonomy.classify_exception(error) is taxonomy.FailureKind.LOST_TASK
    assert "tp-follower-1" in str(error)
    assert not torch.distributed.is_initialized()


def test_chip_smoke_phase8_tp_part_rehearsed(monkeypatch):
    """Phase 8's tp part on the CPU at a narrow criteo (26 tables of 64
    rows, 13 dense features): the follower started beside the one-device
    ranker, the same bursts served over tp=2, every tick's scores bitwise
    the one-device engine's, each rank's bytes, and the group closed."""
    import chip_smoke
    from tf_yarn_tpu_torch import ranking
    from tf_yarn_tpu_torch.models import rank_engine, weights
    from tf_yarn_tpu_torch.ops import rmsnorm
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    ranker = types.SimpleNamespace(
        dlrm=t_dlrm, weights=weights, engine=rank_engine,
        MicroBatchScheduler=ranking.MicroBatchScheduler,
        RankServer=ranking.RankServer)
    # The profiled burst's stand-in: the CPU has no device timeline.
    monkeypatch.setattr(chip_smoke, "device_profile",
                        lambda torch, run, node=None: (run(), {
                            "device_busy_s": 1.0})[1])
    cfg = t_dlrm.DLRMConfig.tiny(table_sizes=(64,) * 26, n_dense=13)
    cpu = torch.device("cpu")
    wait = chip_smoke.concurrently_started({
        "replica": lambda: chip_smoke.rank_tp_replica(
            ranker, tp_replica, mesh_lib, cfg)})
    try:
        one = chip_smoke.rank_slice(torch, ranker, telemetry,
                                    (rmsnorm.rmsnorm,), cpu, cfg=cfg)
        replica, _ = wait()["replica"]
        result = chip_smoke.rank_tp_slice(torch, ranker, telemetry,
                                          (rmsnorm.rmsnorm,), cpu, replica,
                                          one, cfg=cfg)
    finally:
        try:
            wait()
        finally:
            tp_replica.close_all()
    assert result["scores_bitwise_one_device"]
    assert result["rank_table_rows"] == [26 * 64 // 2] * 2
    table = 26 * 64 * 8 * 4
    assert result["rank_params_bytes"] == \
        [one["params_hbm_bytes"] - table // 2] * 2
    assert result["rows_served"] == sum(r * n for r, n in
                                        chip_smoke.RANK_BURSTS)
    assert all(burst["embed_allreduces"] == burst["ticks"] > 0
               for burst in result["bursts"].values())
    assert [p.exitcode for p in replica.processes] == [0]
    assert not torch.distributed.is_initialized()


# -- a launched tp ranker ------------------------------------------------------

STOP = "stop"


def launched_tp_ranker(out_dir: str, port: int):
    """The launched rank task's experiment fn: the tiny f32 DLRM's seeded
    init (seed 0) at MeshSpec(tp=2) on `port`, drained once
    <out_dir>/stop exists."""
    stop = Path(out_dir) / STOP

    def watch():
        while not stop.exists():
            time.sleep(0.05)
        t_preemption.request()

    threading.Thread(target=watch, name="rank-stop", daemon=True).start()
    return t_experiment.RankingExperiment(
        model=t_dlrm.DLRM(port_config(), device="meta"), host="127.0.0.1",
        port=port, max_batch=8, batch_buckets=BUCKETS, init_seed=0,
        mesh_spec=MeshSpec(tp=2))


def test_launched_ranking_topology_tp2_scores_as_one_device(tmp_path):
    import chip_smoke
    from tf_yarn_tpu_torch import client as t_client
    from tf_yarn_tpu_torch import topologies as t_topo

    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    port = chip_smoke.free_port()
    thread, outcome = chip_smoke.launch_in_background(
        t_client,
        t_client.get_safe_experiment_fn(
            "tests.test_torch_tp_ranking.launched_tp_ranker", str(tmp_path),
            port),
        t_topo.ranking_topology(chips_per_host=2),
        env={"TPU_YARN_PLATFORM": "cpu", "PYTHONPATH": repo},
        poll_every_secs=0.2)
    try:
        deadline = time.monotonic() + 180
        while True:
            assert thread.is_alive(), outcome
            try:
                if get(port, "/healthz")[1]["status"] == "ok":
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no rank endpoint"
            time.sleep(0.2)
        reference = RankEngine(t_dlrm.make_model(port_config(), seed=0,
                                                 device="cpu"),
                               batch_buckets=BUCKETS)
        for rows in (1, 8):
            cat, dense = features(rows, seed=30 + rows)
            np.testing.assert_array_equal(rank_over_http(port, cat, dense),
                                          reference.rank(cat, dense))
        assert get(port, "/stats")[1]["tp_degree"] == 2
    finally:
        (tmp_path / STOP).write_text("")
        thread.join(timeout=180)
    assert not thread.is_alive()
    assert "error" not in outcome, outcome
