"""The rank task's body in the port (`ranking.server.run_ranking`,
`experiment.RankingExperiment`) and the task programs' type checks, held
against the JAX package's on the CPU: the experiment's verdict on every
validation branch; the JAX package's checkpointless `run_ranking`
(``init_seed=0``) against the port's `run_ranking` over a port
checkpoint of those same weights (`models/weights.dlrm_from_flax`) —
scores within 1e-5 (f32, sums in another order), the advertised key,
``ckpt_step`` and the final stats' keys; the port's own checkpointless
replicas bit-identical to each other and to a direct forward of
`dlrm.make_model(cfg, 0)`; and the TypeError each task program raises
for another experiment type."""

import functools
import http.client
import json
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_serving_task import Runtime, verdict
from tf_yarn_tpu import experiment as j_experiment
from tf_yarn_tpu import preemption as j_preemption
from tf_yarn_tpu.coordination.kv import InProcessKV as JInProcessKV
from tf_yarn_tpu.parallel.mesh import MeshSpec
from tf_yarn_tpu.ranking import server as j_server
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch.coordination.kv import InProcessKV as TInProcessKV
from tf_yarn_tpu_torch.models import dlrm as t_dlrm
from tf_yarn_tpu_torch.models.weights import dlrm_from_flax
from tf_yarn_tpu_torch.ranking import server as t_server

BUCKETS = (1, 4, 8)
ROWS = (1, 3, 8)


# -- the experiment's verdicts ------------------------------------------------

def _stand_in_ranker():
    """What the validation reads of a ranker: its tables."""
    return types.SimpleNamespace(
        config=types.SimpleNamespace(table_sizes=(10, 6)))


# The stand-in's stacked table has 16 rows: tp=2 and 4 divide them, tp=3
# does not; any axis but tp is refused, beside tp or alone.
RANKING_CASES = {
    "defaults": {},
    "max_batch": {"max_batch": 0},
    "max_wait_ms": {"max_wait_ms": -1},
    "max_wait_ms_zero": {"max_wait_ms": 0},
    "queue_capacity": {"queue_capacity": 0},
    "serve_seconds": {"serve_seconds": 0},
    "serve_seconds_positive": {"serve_seconds": 3},
    "batch_buckets_empty": {"batch_buckets": ()},
    "batch_buckets_zero": {"batch_buckets": (0, 4)},
    "batch_buckets": {"batch_buckets": (1, 4)},
    "model_without_tables": {"model": types.SimpleNamespace(
        config=types.SimpleNamespace(n_heads=4))},
    "model_without_config": {"model": object()},
    "mesh_tp": {"mesh_spec": MeshSpec(tp=2)},
    "mesh_tp4": {"mesh_spec": MeshSpec(tp=4)},
    "mesh_one_device": {"mesh_spec": MeshSpec()},
    "mesh_tp_ragged": {"mesh_spec": MeshSpec(tp=3)},
    "mesh_dp": {"mesh_spec": MeshSpec(dp=2)},
    "mesh_tp_fsdp": {"mesh_spec": MeshSpec(tp=2, fsdp=2)},
    "model_dir": {"model_dir": "/x", "step": 4},
}


@pytest.mark.parametrize("case", sorted(RANKING_CASES))
def test_ranking_experiment_verdict_equals_jax(case):
    args = dict({"model": _stand_in_ranker()}, **RANKING_CASES[case])
    got = verdict(t_experiment.RankingExperiment, **args)
    assert got == verdict(j_experiment.RankingExperiment, **args)


# -- run_ranking on both packages ---------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_ranker():
    """The JAX tiny f32 DLRM and the variables its checkpointless
    run_ranking draws for init_seed=0."""
    import flax.linen as nn

    from tf_yarn_tpu.models import dlrm as j_dlrm

    cfg = j_dlrm.DLRMConfig.tiny(dtype=jnp.float32)
    model = j_dlrm.DLRM(cfg)
    args = (jnp.zeros((1, len(cfg.table_sizes)), jnp.int32),
            jnp.zeros((1, cfg.n_dense), jnp.float32))
    return model, nn.meta.unbox(model.init(jax.random.PRNGKey(0), *args))


def port_config():
    return t_dlrm.DLRMConfig.tiny(dtype=torch.float32)


def features(rows, seed):
    cfg = port_config()
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, max(cfg.table_sizes),
                      (rows, len(cfg.table_sizes))).astype(np.int32)
    dense = np.log1p(rng.lognormal(0.0, 1.0, (rows, cfg.n_dense)))
    return cat, dense.astype(np.float32)


def rank(port, cat, dense):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/rank", json.dumps(
            {"cat": cat.tolist(), "dense": dense.tolist()}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200, body
        return body["scores"]
    finally:
        conn.close()


def serve(server_mod, kv, preemption, experiment, task="rank:0"):
    """run_ranking on a thread: each ROWS request's scores, then the
    preemption notice; returns (scores, final stats, port)."""
    result = {}

    def body():
        try:
            result["stats"] = server_mod.run_ranking(
                experiment, runtime=Runtime(kv, task))
        except BaseException as exc:  # surfaced below
            result["error"] = exc

    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    try:
        port = int(kv.wait_str(f"{task}/rank_endpoint", timeout=120)
                   .rsplit(":", 1)[1])
        scores = [rank(port, *features(rows, seed=rows)) for rows in ROWS]
    finally:
        preemption.request()
        thread.join(timeout=120)
        preemption.reset()
    assert not thread.is_alive()
    if "error" in result:
        raise result["error"]
    return scores, result["stats"], port


def _experiment(module, model, **kwargs):
    return module.RankingExperiment(
        model=model, host="127.0.0.1", max_batch=8, batch_buckets=BUCKETS,
        **kwargs)


def test_run_ranking_over_a_checkpoint_equals_jax_checkpointless(tmp_path):
    model, variables = jax_ranker()
    want, ref_stats, _ = serve(
        j_server, JInProcessKV(), j_preemption,
        _experiment(j_experiment, model, init_seed=0))
    state = dlrm_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                           port_config())
    t_ckpt.save_checkpoint(str(tmp_path), 2,
                           {"params": state, "optimizer": {}, "step": 2})
    kv = TInProcessKV()
    got, stats, port = serve(
        t_server, kv, t_preemption,
        _experiment(t_experiment, t_dlrm.DLRM(port_config(), device="cpu"),
                    model_dir=str(tmp_path)))
    for mine, theirs in zip(got, want):
        np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5)
    assert [len(s) for s in got] == list(ROWS)
    assert stats["ckpt_step"] == 2 and ref_stats["ckpt_step"] == -1
    assert stats["endpoint"] == kv.get_str("rank:0/rank_endpoint") \
        == f"127.0.0.1:{port}"
    assert sorted(stats) == sorted(ref_stats)
    assert stats["draining"] is ref_stats["draining"] is True
    assert kv.get_str("rank:0/metrics") is not None


def test_port_checkpointless_replicas_are_bit_identical():
    replicas = [serve(t_server, TInProcessKV(), t_preemption, _experiment(
        t_experiment, t_dlrm.DLRM(port_config(), device="cpu"), init_seed=0),
        task=f"rank:{i}") for i in range(2)]
    (first, stats, _), (second, _, _) = replicas
    assert first == second and stats["ckpt_step"] == -1
    # The direct forward at the engine's bucket (zero rows padding the
    # 3-row request to 4): no bits are promised across batch sizes.
    direct = t_dlrm.make_model(port_config(), seed=0, device="cpu")
    with torch.inference_mode():
        for rows, scores in zip(ROWS, first):
            cat, dense = features(rows, seed=rows)
            pad = min(b for b in BUCKETS if b >= rows) - rows
            ref = direct(
                torch.from_numpy(np.pad(cat, ((0, pad), (0, 0)))),
                torch.from_numpy(np.pad(dense, ((0, pad), (0, 0)))))
            assert scores == ref.squeeze(-1)[:rows].tolist()


def test_run_ranking_serve_seconds_and_seed():
    """Another seed serves other weights; serve_seconds ends the body."""
    kv = TInProcessKV()
    model = t_dlrm.DLRM(port_config(), device="cpu")
    stats = t_server.run_ranking(
        _experiment(t_experiment, model, init_seed=1, serve_seconds=0.3),
        runtime=Runtime(kv, "rank:0"))
    assert stats["ckpt_step"] == -1 and kv.get_str("rank:0/rank_endpoint")
    other = t_dlrm.make_model(port_config(), seed=0, device="cpu")
    assert not torch.equal(model.embedding, other.embedding)
    assert torch.equal(model.embedding, t_dlrm.make_model(
        port_config(), seed=1, device="cpu").embedding)


# -- the task programs --------------------------------------------------------

@pytest.mark.parametrize("task_type", ["serving", "prefill", "rank"])
def test_task_program_refuses_another_experiment_type_as_jax(task_type):
    import importlib

    messages = []
    for package in ("tf_yarn_tpu", "tf_yarn_tpu_torch"):
        module = importlib.import_module(f"{package}.tasks.{task_type}")
        with pytest.raises(TypeError) as err:
            module._run(None, 42)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
