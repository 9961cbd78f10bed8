"""The port's DLRM ranker held against the JAX package on the CPU: the
model (`models.dlrm`), its weight bridge, `RankEngine`,
`MicroBatchScheduler`, `RankServer`, the loss and the adagrad recipe.

Tiny configs with inputs from `np.random.RandomState` and weights bridged
from `DLRM.init` through `models/weights.dlrm_from_flax`. The reference
scores are `jax.jit(model.apply)` on the unpadded batch. Tolerances:
f32 scores 1e-5 (sums in another order; the tiny model's scores are
O(1)), bf16 scores 1e-2 (one bf16 rounding step of a product), training
1e-5 on losses and parameters over three adagrad steps. Padding to a
bucket is held against the port's own unpadded forward at 1e-6 and
against JAX at 1e-5: no bits are promised across batch sizes.
"""

import functools
import http.client
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch import training as t_training
from tf_yarn_tpu_torch.models import common as t_common
from tf_yarn_tpu_torch.models import dlrm as t_dlrm
from tf_yarn_tpu_torch.models.rank_engine import RankEngine
from tf_yarn_tpu_torch.models.weights import dlrm_from_flax
from tf_yarn_tpu_torch.ranking import (
    FINISH_COMPLETE,
    MicroBatchScheduler,
    RankServer,
)
from tf_yarn_tpu_torch.serving.request import (
    FINISH_DEADLINE,
    FINISH_ERROR,
    QueueFull,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(**overrides):
    from tf_yarn_tpu.models import dlrm as j_dlrm

    jdtype = overrides.pop("dtype", "f32")
    return (j_dlrm.DLRMConfig.tiny(
                dtype=jnp.float32 if jdtype == "f32" else jnp.bfloat16,
                **overrides),
            t_dlrm.DLRMConfig.tiny(
                dtype=torch.float32 if jdtype == "f32" else torch.bfloat16,
                **overrides))


@functools.lru_cache(maxsize=None)
def _pair(n_dense=4, dtype="f32", seed=0):
    """(JAX model, its params, port model on the CPU with the same
    weights)."""
    import flax.linen as nn

    from tf_yarn_tpu.models import dlrm as j_dlrm

    jcfg, tcfg = _configs(n_dense=n_dense, dtype=dtype)
    jmodel = j_dlrm.DLRM(jcfg)
    args = (jnp.zeros((1, 4), jnp.int32),)
    if n_dense:
        args += (jnp.zeros((1, n_dense), jnp.float32),)
    params = nn.meta.unbox(jmodel.init(jax.random.PRNGKey(seed), *args))
    model = t_dlrm.DLRM(tcfg, device="cpu")
    model.load_state_dict(
        dlrm_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jmodel, params, model


def _features(batch, seed=0, n_dense=4, low=0, high=64):
    rng = np.random.RandomState(seed)
    cat = rng.randint(low, high, (batch, 4)).astype(np.int32)
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    return cat, (dense if n_dense else None)


def _jax_scores(jmodel, params, cat, dense=None):
    args = (jnp.asarray(cat),)
    if dense is not None:
        args += (jnp.asarray(dense),)
    return np.asarray(jax.jit(jmodel.apply)(params, *args),
                      np.float32).squeeze(-1)


def _port_scores(model, cat, dense=None):
    with torch.no_grad():
        out = model(torch.from_numpy(cat),
                    None if dense is None else torch.from_numpy(dense))
    return out.float().numpy().squeeze(-1)


# --------------------------------------------------------------------------
# the model and its bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_dense,dtype,tol", [
    (4, "f32", F32_TOL), (0, "f32", F32_TOL),
    (4, "bf16", dict(rtol=1e-2, atol=1e-2))], ids=["dense", "no_dense", "bf16"])
def test_scores_equal_jitted_jax_forward(n_dense, dtype, tol):
    """Ids inside their tables, negative, and past their table's size (or
    the stacked table's): each folds into its own table (a floor mod in
    both packages) and the scores agree."""
    jmodel, params, model = _pair(n_dense, dtype)
    cat, dense = _features(16, seed=3, n_dense=n_dense, low=-300, high=300)
    cat[0] = [64, -1, 255, -65]
    cat[1] = [2**30, -2**30, 1000, 0]
    got = _port_scores(model, cat, dense)
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_allclose(got, _jax_scores(jmodel, params, cat, dense),
                               **tol)


def test_model_layout_and_errors():
    """The parameters are the flax tree's names and shapes; the head
    computes in f32; a wrong arity names both counts."""
    _, params, model = _pair()
    flat = {"/".join(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    names = {name.replace(".", "/"): tuple(p.shape)
             for name, p in model.named_parameters()}
    assert names == {k: tuple(v) for k, v in flat.items()}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.head.dtype == torch.float32
    with pytest.raises(ValueError, match="cat has 3 features, config has 4 "
                                         "tables"):
        model(torch.zeros(2, 3, dtype=torch.int32),
              torch.zeros(2, 4))
    with pytest.raises(ValueError, match="takes 4 dense features"):
        model(torch.zeros(2, 4, dtype=torch.int32))


def test_binary_logistic_loss_equals_jax():
    """`common.binary_logistic_loss` on the same logits and labels as the
    JAX package's (a stand-in model that returns fixed logits)."""
    from tf_yarn_tpu.models import common as j_common

    rng = np.random.RandomState(5)
    logits = rng.standard_normal((12, 1)).astype(np.float32) * 3
    labels = rng.randint(0, 2, 12).astype(np.int32)

    class JaxStub:
        def apply(self, params, x, rngs=None, deterministic=True):
            return jnp.asarray(logits)

    def port_stub(x, deterministic=True):
        return torch.from_numpy(logits)

    ref_loss, ref_aux = j_common.binary_logistic_loss(
        JaxStub(), None, {"x": None, "y": jnp.asarray(labels)}, None)
    loss, aux = t_common.binary_logistic_loss(
        port_stub, {"x": None, "y": torch.from_numpy(labels)})
    # jnp's mean of bools divides in another order: 1 ulp.
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(aux["accuracy"]),
                               float(ref_aux["accuracy"]), rtol=1e-6)


# --------------------------------------------------------------------------
# training: dlrm_loss + the port's adagrad against optax.adagrad
# --------------------------------------------------------------------------

def test_three_adagrad_steps_track_optax():
    """Three steps of `dlrm_loss` and `common.adagrad` from the bridged
    weights on the JAX synthetic batches: the losses, every parameter
    and every accumulator agree with `optax.adagrad` (1e-5); table rows
    no batch touched keep their weights and their accumulator of 0.1."""
    import optax

    from tf_yarn_tpu.models import dlrm as j_dlrm

    jmodel, params, _ = _pair()
    jcfg, tcfg = _configs()
    model = t_dlrm.DLRM(tcfg, device="cpu")
    model.load_state_dict(
        dlrm_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    exp = t_dlrm.make_experiment(tcfg, batch_size=8, learning_rate=0.05)
    jexp = j_dlrm.make_experiment(jcfg, batch_size=8, learning_rate=0.05)
    optimizer = exp.optimizer(model)
    assert isinstance(optimizer, t_common.Adagrad)
    step = t_training.build_train_step(model, exp.loss_fn, optimizer)
    state = t_training.TrainState(0, model, optimizer)
    place = t_training._batch_placer(torch.device("cpu"))
    tx = optax.adagrad(0.05)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(p, o, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jexp.loss_fn(jmodel, q, batch, jax.random.PRNGKey(0)),
            has_aux=True)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    batches = exp.train_input_fn()
    touched = set()
    offsets = np.arange(4) * 64
    for _ in range(3):
        batch = next(batches)
        touched.update((batch["cat"] % 64 + offsets).ravel().tolist())
        state, metrics = step(state, place(batch))
        params, opt_state, ref_loss = jax_step(
            params, opt_state, jax.tree_util.tree_map(jnp.asarray, batch))
        np.testing.assert_allclose(float(metrics["loss"]), float(ref_loss),
                                   rtol=1e-5)
    ref = {name.replace("/", "."): np.asarray(leaf) for name, leaf in (
        ("/".join(k.key for k in path), leaf) for path, leaf in
        jax.tree_util.tree_flatten_with_path(params["params"])[0])}
    sums = jax.tree_util.tree_flatten_with_path(
        opt_state[0].sum_of_squares["params"])[0]
    ref_sums = {"/".join(k.key for k in path).replace("/", "."):
                np.asarray(leaf) for path, leaf in sums}
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), ref[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(
            optimizer.state[param]["sum_of_squares"].numpy(),
            ref_sums[name], rtol=1e-5, atol=1e-6, err_msg=name)
    untouched = sorted(set(range(256)) - touched)
    assert untouched
    _, _, initial = _pair()
    np.testing.assert_array_equal(
        model.embedding.detach().numpy()[untouched],
        initial.embedding.detach().numpy()[untouched])
    assert (optimizer.state[model.embedding]["sum_of_squares"][untouched]
            == np.float32(0.1)).all()


def test_adagrad_is_not_torch_adagrad():
    """One step on g = 1 from p = 0: optax's rule moves p by
    −lr·rsqrt(1.1 + 1e-7); torch.optim.Adagrad's by −lr·1/(1 + 1e-10)."""
    param = torch.nn.Parameter(torch.zeros(3))
    opt = t_common.Adagrad([param], lr=0.5)
    param.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(param.detach().numpy(),
                               -0.5 / np.sqrt(1.1 + 1e-7), rtol=1e-6)


def test_adagrad_leaves_zero_gradient_entries_alone():
    """Entries whose gradient is 0 keep their value and their sum of 0.1,
    and the others follow optax over two steps."""
    import optax

    start = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    grads = [np.array([0.0, 0.5, 0.0, -1.0], np.float32),
             np.array([0.0, -0.25, 0.0, 2.0], np.float32)]
    param = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = t_common.Adagrad([param], lr=0.3)
    tx = optax.adagrad(0.3)
    ref = jnp.asarray(start)
    state = tx.init(ref)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, ref)
        ref = optax.apply_updates(ref, updates)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(ref),
                               rtol=1e-6)
    assert param[0].item() == 1.0 and param[2].item() == 3.0
    assert opt.state[param]["sum_of_squares"][0].item() == np.float32(0.1)


def test_make_experiment_matches_jax_and_trains_on_cpu():
    """The synthetic stream is the JAX package's bit for bit; the
    defaults are its; `train_and_evaluate` runs it on the CPU."""
    from tf_yarn_tpu.models import dlrm as j_dlrm

    jcfg, tcfg = _configs()
    jexp = j_dlrm.make_experiment(jcfg, batch_size=16)
    exp = t_dlrm.make_experiment(tcfg, batch_size=16, train_steps=3,
                                 log_every_steps=1)
    ours, theirs = exp.train_input_fn(), jexp.train_input_fn()
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"cat", "dense", "y"}
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    default = t_dlrm.make_experiment()
    jdefault = j_dlrm.make_experiment()
    assert default.train_params == t_experiment.TrainParams(
        train_steps=200, log_every_steps=20)
    assert jdefault.train_params.train_steps == 200
    assert jdefault.train_params.log_every_steps == 20
    metrics = t_training.train_and_evaluate(
        t_experiment.as_core_experiment(exp), device="cpu")
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1


# --------------------------------------------------------------------------
# RankEngine
# --------------------------------------------------------------------------

def test_rank_engine_config_checks_and_buckets():
    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine

    class NotADLRM:
        pass

    for cls in (JaxEngine, RankEngine):
        with pytest.raises(ValueError, match="config.table_sizes"):
            cls(NotADLRM())
    _, _, model = _pair()
    with pytest.raises(ValueError, match="must be positive"):
        RankEngine(model, batch_buckets=())
    # A mesh is validated as the JAX engine validates it (the tp=2
    # engine itself is held in tests/test_torch_tp_ranking.py).
    with pytest.raises(ValueError, match="tensor-parallel only"):
        RankEngine(model, mesh=types.SimpleNamespace(
            mesh_dim_names=("dp", "tp"), shape=(2, 1)))
    engine = RankEngine(model, batch_buckets=(4, 8, 16))
    assert engine.device == torch.device("cpu")
    assert [engine.select_bucket(b) for b in (1, 4, 5, 16, 17)] == \
        [4, 4, 8, 16, 17]
    assert engine.params_nbytes_per_device() == 4 * sum(
        p.numel() for p in model.parameters())


def test_rank_pads_to_buckets_and_counts_forwards():
    """Batches 1, 3 and 5 pad to buckets 4 and 8, 9 runs off the grid:
    the scores match the port's unpadded forward (1e-6) and the jitted
    JAX forward (1e-5); `stats` counts the calls and the distinct
    forwards, where the JAX engine counts its compiles."""
    jmodel, params, model = _pair()
    engine = RankEngine(model, batch_buckets=(4, 8))
    for batch in (1, 3, 5, 9):
        cat, dense = _features(batch, seed=batch, low=-100, high=100)
        got = engine.rank(cat, dense)
        assert got.dtype == np.float32 and got.shape == (batch,)
        np.testing.assert_allclose(got, _port_scores(model, cat, dense),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            got, _jax_scores(jmodel, params, cat, dense), **F32_TOL)
    assert engine.stats == {"calls": 4, "forward_buckets": 3,
                            "unbucketed_shapes": 1}
    free_jmodel, free_params, free = _pair(n_dense=0)
    engine = RankEngine(free, batch_buckets=(4,))
    cat, _ = _features(3, n_dense=0)
    np.testing.assert_allclose(
        engine.rank(cat), _jax_scores(free_jmodel, free_params, cat),
        **F32_TOL)
    assert engine.warmup() == 1
    assert engine.stats["forward_buckets"] == 1


def test_rank_engine_warmup_runs_each_bucket():
    _, _, model = _pair()
    engine = RankEngine(model, batch_buckets=(1, 2, 4))
    assert engine.warmup(max_batch=2) == 2
    assert engine.stats["forward_buckets"] == 2
    assert engine.warmup() == 3
    assert engine.stats == {"calls": 5, "forward_buckets": 3,
                            "unbucketed_shapes": 0}


# The malformed feature batches of the frontend's 400s: (cat, dense).
BAD_FEATURES = {
    "narrow_cat": lambda cat, dense: (cat[:, :3], dense),
    "flat_cat": lambda cat, dense: (cat[0], dense),
    "no_dense": lambda cat, dense: (cat, None),
    "narrow_dense": lambda cat, dense: (cat, dense[:, :2]),
    "short_dense": lambda cat, dense: (cat, dense[:1]),
}


@pytest.mark.parametrize("case", sorted(BAD_FEATURES))
def test_feature_arity_messages_equal_jax(case):
    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine

    jmodel, _, model = _pair()
    cat, dense = BAD_FEATURES[case](*_features(2))
    errors = []
    for engine in (JaxEngine(jmodel), RankEngine(model)):
        with pytest.raises(ValueError) as info:
            engine.feature_arrays(cat, dense)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_dense_free_model_rejects_dense_like_jax():
    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine

    jmodel, _, model = _pair(n_dense=0)
    cat, _ = _features(2, n_dense=0)
    errors = []
    for engine in (JaxEngine(jmodel), RankEngine(model)):
        with pytest.raises(ValueError, match="takes no dense features") as e:
            engine.feature_arrays(cat, np.zeros((2, 2), np.float32))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="empty batch"):
        RankEngine(model).rank(cat[:0])


# --------------------------------------------------------------------------
# MicroBatchScheduler
# --------------------------------------------------------------------------

def _scheduler(max_batch=4, max_wait_ms=1000.0, **kwargs):
    jmodel, params, model = _pair()
    engine = RankEngine(model, batch_buckets=(4, 8))
    return engine, MicroBatchScheduler(engine, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms, **kwargs)


def _expected(cat, dense):
    jmodel, params, _ = _pair()
    return _jax_scores(jmodel, params, cat, dense)


def _fill(engine, scheduler):
    """Two 2-row submits fill max_batch=4: ONE tick, ONE engine call,
    each response its own rows' scores."""
    a, b = _features(2, seed=1), _features(2, seed=2)
    responses = [scheduler.submit(*a), scheduler.submit(*b)]
    ready, _ = scheduler._ready(time.monotonic())
    assert ready
    assert scheduler.tick() is True
    for response, feats in zip(responses, (a, b)):
        assert response.finish_reason == FINISH_COMPLETE
        np.testing.assert_allclose(np.asarray(response.result(), np.float32),
                                   _expected(*feats), **F32_TOL)
    assert engine.stats["calls"] == 1
    snap = scheduler.stats()
    assert (snap["ticks"], snap["rows_scored"], snap["avg_batch_rows"]) == \
        (1, 4, 4.0)
    assert snap["rank_engine"]["forward_buckets"] == 1


def _timeout(engine, scheduler):
    """A lone 2-row request never fills max_batch=4: the max_wait_ms
    timeout ticks it out anyway."""
    scheduler.max_wait_ms = 20.0
    scheduler.start()
    feats = _features(2, seed=7)
    response = scheduler.submit(*feats)
    scores = response.result(timeout=30)
    assert response.finish_reason == FINISH_COMPLETE
    np.testing.assert_allclose(np.asarray(scores, np.float32),
                               _expected(*feats), **F32_TOL)


def _admission(engine, scheduler):
    """Malformed features die at submit; nothing is admitted, and the
    next valid request scores normally."""
    cat, dense = _features(2)
    for bad, match in (((cat[:, :2], dense), r"cat must be \[batch, 4\]"),
                       ((cat, None), "carried none"),
                       (_features(5), "coalesces at most max_batch=4"),
                       ((cat[:0], dense[:0]), "empty feature batch")):
        with pytest.raises(ValueError, match=match):
            scheduler.submit(*bad)
    response = scheduler.submit(cat, dense)
    scheduler.tick()
    assert response.finish_reason == FINISH_COMPLETE
    assert scheduler.stats()["queue_depth"] == 0
    assert scheduler.stats()["requests_total"] == 1
    with pytest.raises(ValueError, match="largest batch bucket"):
        MicroBatchScheduler(engine, max_batch=16)


def _engine_failure(engine, scheduler):
    """A tick that raises fails its requests as `error`; the loop keeps
    ticking and the next request completes."""
    scheduler.max_wait_ms = 0.0
    real_rank = engine.rank
    state = {"failures": 0}

    def flaky(cat, dense=None):
        if state["failures"] == 0:
            state["failures"] += 1
            raise RuntimeError("injected tick failure")
        return real_rank(cat, dense)

    engine.rank = flaky
    scheduler.start()
    feats = _features(2, seed=3)
    doomed = scheduler.submit(*feats)
    doomed.result(timeout=30)
    assert doomed.finish_reason == FINISH_ERROR and doomed.result() == []
    healthy = scheduler.submit(*feats)
    scores = healthy.result(timeout=30)
    assert healthy.finish_reason == FINISH_COMPLETE
    np.testing.assert_allclose(np.asarray(scores, np.float32),
                               _expected(*feats), **F32_TOL)


def _deadline(engine, scheduler):
    """An expired request is evicted at pop, never scored."""
    feats = _features(1)
    expired = scheduler.submit(*feats, timeout_s=0.02)
    time.sleep(0.06)
    fresh = scheduler.submit(*feats, timeout_s=60)
    scheduler.tick()
    assert expired.finish_reason == FINISH_DEADLINE
    assert expired.result() == []
    assert fresh.finish_reason == FINISH_COMPLETE
    assert len(fresh.result()) == 1


def _queue_full(engine, scheduler):
    """At capacity, submit raises QueueFull with the static hint; the
    tick frees the capacity."""
    feats = _features(1)
    first = scheduler.submit(*feats)
    with pytest.raises(QueueFull) as info:
        scheduler.submit(*feats)
    assert info.value.retry_after_s == 2.5
    scheduler.tick()
    assert first.finish_reason == FINISH_COMPLETE
    assert scheduler.submit(*feats) is not None


def _fifo_hold(engine, scheduler):
    """A request that would overflow max_batch is held, ahead of the
    queue, for the next tick, never split."""
    three, two = _features(3, seed=1), _features(2, seed=2)
    resp3, resp2 = scheduler.submit(*three), scheduler.submit(*two)
    scheduler.tick()
    assert resp3.finish_reason == FINISH_COMPLETE
    assert resp2.finish_reason is None
    assert scheduler.stats()["queued_rows"] == 2
    scheduler.tick()
    assert resp2.finish_reason == FINISH_COMPLETE
    np.testing.assert_allclose(np.asarray(resp2.result(), np.float32),
                               _expected(*two), **F32_TOL)


SCHEDULER_CASES = {
    "fill": (_fill, {}),
    "timeout": (_timeout, {}),
    "admission_reject": (_admission, {}),
    "engine_failure": (_engine_failure, {}),
    "deadline_eviction": (_deadline, {}),
    "queue_full": (_queue_full, dict(queue_capacity=1, retry_after_s=2.5)),
    "fifo_hold": (_fifo_hold, {}),
}


@pytest.mark.parametrize("case", list(SCHEDULER_CASES))
def test_scheduler_behaviour_mirrors_jax(case):
    body, kwargs = SCHEDULER_CASES[case]
    engine, scheduler = _scheduler(**kwargs)
    try:
        body(engine, scheduler)
    finally:
        scheduler.close()


def test_scheduler_stats_keys_equal_jax():
    """`stats()` has the JAX scheduler's keys; under ``rank_engine`` the
    port counts ``forward_buckets`` where the JAX engine counts
    ``forward_compiles`` and ``forward_cache_hits``. The gauges read
    the same parameter bytes and tp degree."""
    from tf_yarn_tpu import telemetry as j_telemetry
    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine
    from tf_yarn_tpu.ranking.scheduler import MicroBatchScheduler as JaxSched

    jmodel, params, model = _pair()
    feats = _features(2)
    snaps = []
    for sched, registry in (
            (JaxSched(JaxEngine(jmodel, batch_buckets=(4, 8)), params,
                      max_batch=4), j_telemetry.get_registry()),
            (MicroBatchScheduler(RankEngine(model, batch_buckets=(4, 8)),
                                 max_batch=4), telemetry.get_registry())):
        sched.submit(*feats)
        sched.tick()
        snaps.append(sched.stats())
        assert registry.gauge(
            "ranking/params_hbm_bytes_per_device").value == \
            snaps[-1]["params_hbm_bytes_per_device"]
        assert registry.gauge("ranking/tp_degree").value == 1
        sched.close()
    ref, got = snaps
    assert set(got) == set(ref)
    assert set(ref["rank_engine"]) - set(got["rank_engine"]) == {
        "forward_compiles", "forward_cache_hits"}
    assert set(got["rank_engine"]) - set(ref["rank_engine"]) == {
        "forward_buckets"}
    for key in got:
        if key != "rank_engine":
            assert got[key] == ref[key], key


# --------------------------------------------------------------------------
# RankServer
# --------------------------------------------------------------------------

def _post(port, body, path="/v1/rank", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        raw = body if isinstance(body, (bytes, str)) else json.dumps(body)
        conn.request("POST", path, raw, {"Content-Type": "application/json",
                                         **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _servers(**kwargs):
    """A JAX and a port RankServer over the same weights, loops started."""
    from tf_yarn_tpu.models.rank_engine import RankEngine as JaxEngine
    from tf_yarn_tpu.ranking.scheduler import MicroBatchScheduler as JaxSched
    from tf_yarn_tpu.ranking.server import RankServer as JaxServer

    jmodel, params, model = _pair()
    jax_sched = JaxSched(JaxEngine(jmodel, batch_buckets=(4, 8)), params,
                         max_batch=4, **kwargs)
    port_sched = MicroBatchScheduler(RankEngine(model, batch_buckets=(4, 8)),
                                     max_batch=4, **kwargs)
    return [(JaxServer(jax_sched, "127.0.0.1", 0), jax_sched),
            (RankServer(port_sched, "127.0.0.1", 0), port_sched)]


def _stop(servers):
    for server, scheduler in servers:
        server.stop()
        scheduler.close()


def test_http_statuses_bodies_and_scores_equal_jax():
    """The same requests to both servers: the same statuses and error
    bodies, scores within 1e-5, `X-Request-Id` echoed, /healthz and the
    /stats key set alike, /metrics served."""
    cat, dense = _features(3, seed=11, low=-80, high=200)
    bodies = {
        "ok": {"cat": cat.tolist(), "dense": dense.tolist()},
        "narrow_cat": {"cat": cat[:, :2].tolist(), "dense": dense.tolist()},
        "no_cat": {"dense": dense.tolist()},
        "no_dense": {"cat": cat.tolist()},
        "too_many_rows": {"cat": np.zeros((5, 4), int).tolist(),
                          "dense": np.zeros((5, 4)).tolist()},
        "empty": {"cat": [], "dense": []},
        "bad_priority": {"cat": cat.tolist(), "dense": dense.tolist(),
                         "priority": "high"},
        "bad_timeout": {"cat": cat.tolist(), "dense": dense.tolist(),
                        "timeout_s": -1},
        "string_ids": {"cat": [["a", "b", "c", "d"]], "dense": [[0.0] * 4]},
        "broken_json": b"{not json",
    }
    servers = _servers(max_wait_ms=0.0)
    replies = []
    try:
        for server, scheduler in servers:
            scheduler.start()
            server.start()
            got = {}
            for name, body in bodies.items():
                status, headers, raw = _post(server.port, body,
                                             headers={"X-Request-Id": "r-7"})
                got[name] = (status, json.loads(raw), headers)
            got["unknown_post"] = _post(server.port, {}, "/v1/generate")[0]
            got["unknown_get"] = _get(server.port, "/v1/nothing")[0]
            status, raw = _get(server.port, "/healthz")
            got["healthz"] = (status, json.loads(raw))
            status, raw = _get(server.port, "/stats")
            got["stats"] = (status, json.loads(raw))
            status, raw = _get(server.port, "/metrics")
            got["metrics"] = (status, raw.decode())
            replies.append(got)
    finally:
        _stop(servers)
    ref, port = replies
    for name in bodies:
        if name == "ok":
            continue
        assert port[name][0] == ref[name][0] == 400, name
        assert port[name][1] == ref[name][1], name
    assert port["ok"][0] == ref["ok"][0] == 200
    np.testing.assert_allclose(port["ok"][1]["scores"],
                               ref["ok"][1]["scores"], **F32_TOL)
    assert port["ok"][1]["finish_reason"] == FINISH_COMPLETE
    assert isinstance(port["ok"][1]["request_id"], int)
    assert port["ok"][2]["X-Request-Id"] == "r-7"
    assert port["unknown_post"] == ref["unknown_post"] == 404
    assert port["unknown_get"] == ref["unknown_get"] == 404
    assert port["healthz"] == ref["healthz"]
    assert port["healthz"][1]["status"] == "ok"
    assert port["stats"][0] == 200
    assert set(port["stats"][1]) == set(ref["stats"][1])
    assert port["stats"][1]["rank_engine"]["calls"] >= 1
    assert "ranking_requests_total" in port["metrics"][1]


def test_http_429_and_draining_equal_jax():
    """A full queue answers 429 with Retry-After and the static hint on
    both servers; a drained scheduler reports "draining" on /healthz."""
    servers = _servers(queue_capacity=1)
    cat, dense = _features(1)
    replies = []
    try:
        for server, scheduler in servers:
            scheduler.submit(cat, dense)  # loop not started: queue pinned
            server.start()
            status, headers, raw = _post(
                server.port, {"cat": cat.tolist(), "dense": dense.tolist()})
            scheduler.drain()
            health = json.loads(_get(server.port, "/healthz")[1])
            replies.append((status, headers.get("Retry-After"),
                            json.loads(raw), health))
    finally:
        _stop(servers)
    assert replies[0] == replies[1]
    status, retry_after, body, health = replies[1]
    assert (status, retry_after, body["retry_after_s"]) == (429, "1", 0.5)
    assert health["status"] == "draining"


def test_server_answers_concurrent_posts_in_fewer_ticks():
    """Eight concurrent 1-row POSTs coalesce: fewer ticks than requests,
    every reply 200 with its row's score."""
    _, _, model = _pair()
    engine = RankEngine(model, batch_buckets=(1, 2, 4, 8))
    scheduler = MicroBatchScheduler(engine, max_batch=8, max_wait_ms=50.0)
    server = RankServer(scheduler, "127.0.0.1", 0)
    engine.warmup()
    scheduler.start()
    server.start()
    feats = [_features(1, seed=s) for s in range(8)]
    replies = [None] * 8

    def send(i):
        cat, dense = feats[i]
        replies[i] = _post(server.port, {"cat": cat.tolist(),
                                         "dense": dense.tolist()})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        stats = scheduler.stats()
    finally:
        server.stop()
        scheduler.close()
    for (status, _, raw), (cat, dense) in zip(replies, feats):
        assert status == 200
        np.testing.assert_allclose(json.loads(raw)["scores"],
                                   _expected(cat, dense), **F32_TOL)
    assert stats["requests_total"] == 8
    assert stats["ticks"] < 8
