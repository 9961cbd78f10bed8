"""Tensor-parallel serving in the port (`serving.tp_replica`,
`DecodeEngine(mesh=)`, `SlotScheduler` at tp_degree 2, `run_serving`
under ``mesh_spec=MeshSpec(tp=2)``) held against the JAX package on the
tiny f32 decoder with bridged weights: the JAX side is a tp=2 mesh over
the conftest's virtual CPU devices, as tests/test_tp_serving.py builds
it, and JAX's `generate_legacy` on one device.

The port's replica is two gloo ranks on the CPU: this process leads
(one group shared by the `TestReplica` cases), a spawned follower runs
every engine op on its heads. Checked: the build verdicts and messages
of the experiment, the engine and the scheduler; greedy streams over
HTTP on the dense grid, the paged gather grid (a prefix hit and a
whole-prompt replay), spec_k=2 and chunked prefill, equal to the JAX
tp=2 scheduler's and to generate_legacy; sampled streams equal to the
port's one-device streams; the host swap tier; the block wire (a JAX
tp=2 export read and re-exported byte for byte, tp=2 -> tp=1 -> tp=2
with a prefix hit each way, values against JAX's export); the prefill
tier; the KV accounting against JAX's per-device figure; each rank's
shards; the headers' spans. Then `run_serving` through the serving
task's body, each in a group of its own: its endpoint, its drain
stopping both ranks, a checkpoint verification longer than the group's
timeout (done before any follower exists), and a killed follower
failing the leader, classified, within the group's timeout."""

import functools
import http.client
import json
import multiprocessing
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import experiment as t_experiment
from tf_yarn_tpu_torch import preemption as t_preemption
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.coordination.kv import InProcessKV
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.mesh import MeshSpec
from tf_yarn_tpu_torch.resilience import taxonomy
from tf_yarn_tpu_torch.serving import tp_replica
from tf_yarn_tpu_torch.serving.prefill import PrefillWorker
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler
from tf_yarn_tpu_torch.serving.server import (
    ServingServer,
    decode_block_wire,
    encode_block_wire,
)
from tf_yarn_tpu_torch.topologies import TaskKey

MAX_SEQ = 64
BUCKETS = (4, 8, 16)
NEW = 6
LONG = list(range(40, 57))  # prefill 16: two whole blocks of 8
# The long prompt twice (the second admits through the prefix cache on
# the paged grids), a 2-token prompt (no bucket fits: the whole prompt
# replays) and a repeating one the n-gram drafter exploits.
PROMPTS = (LONG, LONG, [3, 5], ([7, 9, 11] * 4)[:10])
PAGED = dict(kv_layout="paged", block_size=8, num_blocks=17)
GRIDS = {
    "dense": dict(kv_layout="dense"),
    "paged_gather": PAGED,
    "spec_k2": dict(PAGED, spec_k=2),
    "chunked": dict(PAGED, prefill_chunk=4, prefill_budget_per_tick=8),
}
SAMPLING = dict(temperature=1.0, top_k=8)
# The host swap tier's oversubscribed pool (tests/test_torch_swap.py):
# the 9-token batch stream with 20 new tokens needs the whole pool.
BATCH = [3, 1, 4, 1, 5, 9, 2, 6, 5]
INTER = [2, 7, 1, 8, 2]
SWAP = dict(max_slots=2, kv_layout="paged", block_size=8, num_blocks=5,
            kv_host_blocks=8)


# -- the models ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_decoder(kv_cache_dtype="bf16"):
    """The JAX tiny f32 decoder (plain norms) and its variables."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype=kv_cache_dtype, fused_norms=False,
        scan_layers=False, remat=False, max_seq_len=MAX_SEQ)
    model = jt.Transformer(cfg)
    variables = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, variables


def port_config(kv_cache_dtype="bf16", **overrides):
    return tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                     kv_cache_dtype=kv_cache_dtype,
                                     **overrides)


@functools.lru_cache(maxsize=None)
def port_state(kv_cache_dtype="bf16"):
    """`jax_decoder`'s variables as the port's one-device state dict."""
    import jax

    from tf_yarn_tpu_torch.models.weights import from_flax

    _, variables = jax_decoder(kv_cache_dtype)
    return from_flax(jax.tree_util.tree_map(np.asarray, variables),
                     port_config(kv_cache_dtype))


@functools.lru_cache(maxsize=None)
def port_engine(kv_cache_dtype="bf16"):
    """The port's one-device engine over the same weights."""
    model = tt.Transformer(port_config(kv_cache_dtype), device="cpu")
    model.load_state_dict(port_state(kv_cache_dtype))
    return DecodeEngine(model, prompt_buckets=BUCKETS)


_JAX_ENGINES = {}


def jax_scheduler(tp, **kwargs):
    """A JAX SlotScheduler over one engine a tp (2: a tp mesh of the
    virtual CPU devices, the params placed by the sharded restore)."""
    import jax

    from tf_yarn_tpu import inference as j_inference
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from tf_yarn_tpu.parallel.mesh import build_mesh
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, variables = jax_decoder()
    if tp not in _JAX_ENGINES:
        mesh, placed = None, variables
        if tp > 1:
            mesh = build_mesh(JMeshSpec(tp=tp), jax.devices()[:tp])
            placed = j_inference.shard_restored_params(model, variables, mesh)
        _JAX_ENGINES[tp] = (JaxEngine(model, batch_buckets=(1, 2, 4),
                                      prompt_buckets=BUCKETS, mesh=mesh),
                            placed)
    engine, placed = _JAX_ENGINES[tp]
    return JaxScheduler(engine, placed, max_slots=2, **kwargs)


@functools.lru_cache(maxsize=None)
def legacy(prompt, max_new):
    """JAX `generate_legacy`'s greedy stream of `prompt` (a tuple)."""
    import jax.numpy as jnp

    from tf_yarn_tpu.models.generate import generate_legacy

    model, variables = jax_decoder()
    out = generate_legacy(model, variables, jnp.asarray([prompt], jnp.int32),
                          max_new)
    return np.asarray(out)[0, len(prompt):].tolist()


def drive(scheduler, responses, limit=400):
    for _ in range(limit):
        if all(r.done for r in responses):
            return
        scheduler.tick()
    raise AssertionError(f"not done after {limit} ticks")


def served_by_ticks(scheduler, prompts, params_cls, **sampling):
    """The prompts one after another through `tick()`: their streams."""
    streams = []
    for i, prompt in enumerate(prompts):
        response = scheduler.submit(list(prompt), params_cls(
            max_new_tokens=NEW, seed=i, **sampling))
        drive(scheduler, [response])
        streams.append(response.result(timeout=1))
    return streams


def jax_params_cls():
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams

    return JaxParams


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


def over_json(wire, encode, decode):
    return decode(json.loads(json.dumps(encode(wire))))


def entry_blocks(wire, kv_cache_dtype="bf16"):
    """{entry key: the entry's blocks, each a tuple of numpy leaves [L,
    bs, Hkv, *]} of a decoded block wire, in either package's layer
    layout and group width (read as the port's import reads it)."""
    from tf_yarn_tpu_torch.serving.scheduler import _payload_from_wire

    cfg = port_config(kv_cache_dtype)
    like = tt.PagedKVPool(**tt.zeroed_kv(cfg, (cfg.n_layers, 1, 8), "cpu"))
    width = wire["group_width"]
    groups = [_payload_from_wire(group["leaves"], like, group["n_blocks"])
              for group in wire["groups"]]

    def block(j):
        payload = groups[j // width]
        return tuple(None if getattr(payload, name) is None
                     else np.asarray(getattr(payload, name)[:, j % width])
                     for name in tt.KV_NAMES)

    return {entry["key"]: [block(j) for j in entry["blocks"]]
            for entry in wire["entries"]}


def same_bytes(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            for u, v in zip(x, y):
                assert (u is None) == (v is None)
                if u is not None:
                    assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


# -- the verdicts ---------------------------------------------------------------

def verdict(build):
    try:
        build()
    except Exception as exc:  # noqa: BLE001 — the verdict is compared
        return type(exc).__name__, str(exc)
    return "ok", None


def stand_in(n_heads=4, n_kv_heads=2):
    return types.SimpleNamespace(config=types.SimpleNamespace(
        n_heads=n_heads, n_kv_heads=n_kv_heads, max_seq_len=MAX_SEQ))


# (mesh axes, heads, extra experiment kwargs)
EXPERIMENT_CASES = {
    "tp3_heads": ({"tp": 3}, (4, 2), {}),
    "tp4_kv_heads": ({"tp": 4}, (4, 2), {}),
    "dp2": ({"dp": 2}, (4, 2), {}),
    "fused_tp2": ({"tp": 2}, (4, 2), dict(kv_layout="paged",
                                          decode_attention="fused")),
    "tp1": ({"tp": 1}, (4, 2), {}),
    "tp2": ({"tp": 2}, (4, 2), {}),
    # Training's tp % n_kv_heads == 0 (parallel/tensor_parallel.kv_span)
    # is refused for serving, as in JAX.
    "kv1_tp2": ({"tp": 2}, (4, 1), {}),
}


@pytest.mark.parametrize("case", sorted(EXPERIMENT_CASES))
def test_serving_experiment_verdict_equals_jax(case):
    from tf_yarn_tpu import experiment as j_experiment
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec

    axes, heads, kwargs = EXPERIMENT_CASES[case]
    got = verdict(lambda: t_experiment.ServingExperiment(
        model=stand_in(*heads), model_dir="/x", mesh_spec=MeshSpec(**axes),
        **kwargs))
    want = verdict(lambda: j_experiment.ServingExperiment(
        model=stand_in(*heads), model_dir="/x", mesh_spec=JMeshSpec(**axes),
        **kwargs))
    assert got == want
    assert (got[0] == "ok") == (case in ("tp1", "tp2"))


class StubMesh:
    """What the engine's validation reads of a mesh: its dim sizes."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


# (mesh axes, heads; None: a model without a config)
ENGINE_CASES = {
    "tp3_heads": ({"tp": 3}, (4, 2)),
    "tp4_kv_heads": ({"tp": 4}, (4, 2)),
    "kv1_tp2": ({"tp": 2}, (4, 1)),
    "no_config": ({"tp": 2}, None),
    "tp1": ({"tp": 1}, (4, 2)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_verdict_equals_jax(case):
    """A refusal comes before any group is touched, so a stand-in mesh
    carries the port's side."""
    import jax

    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.parallel.mesh import MeshSpec as JMeshSpec
    from tf_yarn_tpu.parallel.mesh import build_mesh

    axes, heads = ENGINE_CASES[case]
    size = axes["tp"]
    mesh = build_mesh(JMeshSpec(tp=size), jax.devices()[:size])
    if heads is None:
        port_model, jax_model = object(), object()
    else:
        port_model = tt.Transformer(
            port_config(n_heads=heads[0], n_kv_heads=heads[1]), device="meta")
        jax_model = jt.Transformer(jt.TransformerConfig.tiny(
            n_heads=heads[0], n_kv_heads=heads[1], max_seq_len=MAX_SEQ))
    got = verdict(lambda: DecodeEngine(port_model, mesh=StubMesh(**axes)))
    want = verdict(lambda: JaxEngine(jax_model, mesh=mesh))
    assert got == want
    assert (got[0] == "ok") == (case == "tp1")


def test_scheduler_refuses_fused_at_tp_like_jax():
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    class TpStub:
        tp_degree = 2

    kwargs = dict(max_slots=1, kv_layout="paged", decode_attention="fused",
                  max_seq_len=MAX_SEQ, block_size=8)
    got = verdict(lambda: SlotScheduler(TpStub(), **kwargs))
    want = verdict(lambda: JaxScheduler(TpStub(), None, **kwargs))
    assert got == want and "sharded block pool" in got[1]


# -- one replica shared by the cases that serve -------------------------------

@pytest.fixture(scope="class")
def replica():
    group = tp_replica.start(MeshSpec(tp=2))
    try:
        group.load(port_config(), state=port_state(), prompt_buckets=BUCKETS)
        yield group
    finally:
        group.close()
    assert [p.exitcode for p in group.processes] == [0]
    assert not torch.distributed.is_initialized()


class TestReplica:

    @pytest.mark.parametrize("grid", sorted(GRIDS))
    def test_greedy_streams_equal_jax_tp2_and_legacy(self, replica, grid):
        scheduler = SlotScheduler(replica.engine, max_slots=2, **GRIDS[grid])
        server = ServingServer(scheduler, "127.0.0.1", 0)
        scheduler.start()
        server.start()
        try:
            streams = []
            for prompt in PROMPTS:
                status, body = post(server.port, {"prompt": list(prompt),
                                                  "max_new_tokens": NEW})
                assert status == 200, body
                streams.append(body["tokens"])
            status, stats = get(server.port, "/stats")
        finally:
            server.stop()
            scheduler.close()
        reference = jax_scheduler(2, **GRIDS[grid])
        try:
            want = served_by_ticks(reference, PROMPTS, jax_params_cls())
            ref_stats = reference.stats()
        finally:
            reference.close()
        assert streams == want
        assert streams == [legacy(tuple(p), NEW) for p in PROMPTS]
        assert stats["tp_degree"] == ref_stats["tp_degree"] == 2
        if grid != "dense":
            assert stats["prefix_cache"]["hits"] >= 1
            assert ref_stats["prefix_cache"]["hits"] >= 1
        if grid == "spec_k2":
            assert stats["spec"]["proposed_tokens"] > 0

    @pytest.mark.parametrize("grid", ["dense", "paged_gather"])
    def test_sampled_streams_equal_one_device(self, replica, grid):
        got, want = [], []
        for engine, out in ((replica.engine, got), (port_engine(), want)):
            scheduler = SlotScheduler(engine, max_slots=2, **SAMPLING,
                                      **GRIDS[grid])
            try:
                out.extend(served_by_ticks(scheduler, PROMPTS, SamplingParams,
                                           **SAMPLING))
            finally:
                scheduler.close()
        assert got == want
        assert got != [legacy(tuple(p), NEW) for p in PROMPTS]

    def test_swap_tier_resumes_equal_to_the_request_alone(self, replica):
        def displaced(engine):
            scheduler = SlotScheduler(engine, **SWAP)
            try:
                batch = scheduler.submit(BATCH, SamplingParams(
                    max_new_tokens=20), tier="batch")
                for _ in range(3):
                    scheduler.tick()
                inter = scheduler.submit(INTER, SamplingParams(
                    max_new_tokens=8), tier="interactive")
                drive(scheduler, [batch, inter])
                return (batch.result(timeout=1), inter.result(timeout=1),
                        scheduler.stats())
            finally:
                scheduler.close()

        def alone(engine, prompt, max_new, tier):
            scheduler = SlotScheduler(engine, **SWAP)
            try:
                response = scheduler.submit(prompt, SamplingParams(
                    max_new_tokens=max_new), tier=tier)
                drive(scheduler, [response])
                return response.result(timeout=1)
            finally:
                scheduler.close()

        batch, inter, stats = displaced(replica.engine)
        assert stats["swap"]["suspends"] == stats["swap"]["resumes"] == 1
        assert batch == alone(replica.engine, BATCH, 20, "batch")
        assert inter == alone(replica.engine, INTER, 8, "interactive")
        one_batch, one_inter, one_stats = displaced(port_engine())
        assert (batch, inter) == (one_batch, one_inter)
        assert stats["swap"] == one_stats["swap"]
        assert stats["host_block_store"] == one_stats["host_block_store"]

    def test_jax_tp2_export_imports_and_reexports_byte_for_byte(self, replica):
        from tf_yarn_tpu.serving.server import encode_block_wire as jax_encode

        donor = jax_scheduler(2, **PAGED)
        try:
            (stream,) = served_by_ticks(donor, [LONG], jax_params_cls())
            raw = json.loads(json.dumps(jax_encode(
                donor.export_hot_prefixes())))
        finally:
            donor.close()
        wire = decode_block_wire(raw)
        receiver = SlotScheduler(replica.engine, max_slots=2, **PAGED)
        try:
            assert receiver.import_prefixes(wire) == {
                "imported_blocks": 2, "registered_entries": 2,
                "skipped_entries": 0}
            hits = receiver.stats()["prefix_cache"]["hits"]
            (got,) = served_by_ticks(receiver, [LONG], SamplingParams)
            assert got == stream
            assert receiver.stats()["prefix_cache"]["hits"] == hits + 1
            again = over_json(receiver.export_hot_prefixes(),
                              encode_block_wire, decode_block_wire)
        finally:
            receiver.close()
        same_bytes(entry_blocks(again), entry_blocks(wire))

    def test_wire_tp2_to_tp1_and_back_with_a_prefix_hit_each(self, replica):
        def export(engine):
            donor = SlotScheduler(engine, max_slots=2, **PAGED)
            try:
                (stream,) = served_by_ticks(donor, [LONG], SamplingParams)
                return stream, over_json(donor.export_hot_prefixes(),
                                         encode_block_wire, decode_block_wire)
            finally:
                donor.close()

        def import_and_serve(engine, wire):
            receiver = SlotScheduler(engine, max_slots=2, **PAGED)
            try:
                assert receiver.import_prefixes(wire)["imported_blocks"] == 2
                (stream,) = served_by_ticks(receiver, [LONG], SamplingParams)
                assert receiver.stats()["prefix_cache"]["hits"] == 1
                return stream, over_json(receiver.export_hot_prefixes(),
                                         encode_block_wire, decode_block_wire)
            finally:
                receiver.close()

        stream, wire = export(replica.engine)
        assert wire["group_width"] == 2
        one_stream, one_wire = import_and_serve(port_engine(), wire)
        back_stream, back_wire = import_and_serve(replica.engine, one_wire)
        assert stream == one_stream == back_stream
        blocks = entry_blocks(wire)
        same_bytes(entry_blocks(one_wire), blocks)
        same_bytes(entry_blocks(back_wire), blocks)

    def test_tp2_export_values_equal_jax_tp2_export(self, replica):
        from tf_yarn_tpu.serving.server import decode_block_wire as jax_decode
        from tf_yarn_tpu.serving.server import encode_block_wire as jax_encode

        donor = jax_scheduler(2, **PAGED)
        try:
            served_by_ticks(donor, [LONG], jax_params_cls())
            want = over_json(donor.export_hot_prefixes(), jax_encode,
                             jax_decode)
        finally:
            donor.close()
        mine = SlotScheduler(replica.engine, max_slots=2, **PAGED)
        try:
            served_by_ticks(mine, [LONG], SamplingParams)
            got = over_json(mine.export_hot_prefixes(), encode_block_wire,
                            jax_decode)
        finally:
            mine.close()
        assert got["block_size"] == want["block_size"] == 8
        got_blocks, want_blocks = entry_blocks(got), entry_blocks(want)
        assert sorted(got_blocks) == sorted(want_blocks)
        for key in got_blocks:
            for x, y in zip(got_blocks[key], want_blocks[key]):
                for u, v in zip(x, y):
                    assert (u is None) == (v is None)
                    if u is not None:
                        assert u.shape == v.shape and u.dtype == v.dtype
                        np.testing.assert_allclose(u, v, rtol=1e-5,
                                                   atol=1e-6)

    def test_prefill_worker_feeds_a_one_device_grid(self, replica):
        worker = PrefillWorker(replica.engine, block_size=8)
        wire = over_json(worker.prefill_prompt(LONG), encode_block_wire,
                         decode_block_wire)
        assert wire["n_blocks"] == 2
        fed = SlotScheduler(port_engine(), max_slots=2, **PAGED)
        local = SlotScheduler(port_engine(), max_slots=2, **PAGED)
        try:
            assert fed.import_prefixes(wire)["imported_blocks"] == 2
            (got,) = served_by_ticks(fed, [LONG], SamplingParams)
            assert fed.stats()["prefix_cache"]["hits"] == 1
            (want,) = served_by_ticks(local, [LONG], SamplingParams)
            assert local.stats()["prefix_cache"]["hits"] == 0
        finally:
            fed.close()
            local.close()
        assert got == want == legacy(tuple(LONG), NEW)

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_kv_bytes_per_device_equal_jax(self, replica, layout):
        grid = dict(kv_layout=layout)
        if layout == "paged":
            grid["block_size"] = 8
        mine = SlotScheduler(replica.engine, max_slots=2, **grid)
        one = SlotScheduler(port_engine(), max_slots=2, **grid)
        reference = jax_scheduler(2, **grid)
        try:
            got, whole, want = mine.stats(), one.stats(), reference.stats()
        finally:
            for scheduler in (mine, one, reference):
                scheduler.close()
        for key in ("kv_cache_hbm_bytes", "kv_cache_hbm_bytes_per_device",
                    "tp_degree"):
            assert got[key] == want[key], key
        assert got["kv_cache_hbm_bytes"] == whole["kv_cache_hbm_bytes"]
        assert got["kv_cache_hbm_bytes_per_device"] < \
            whole["kv_cache_hbm_bytes_per_device"]

    def test_each_rank_holds_its_shards(self, replica):
        model = replica.engine.model
        cfg = model.config
        assert model.kv_heads == cfg.n_kv_heads // 2
        local = sum(p.numel() * p.element_size() for p in model.parameters())
        whole = sum(t.numel() * t.element_size()
                    for t in port_state().values())
        # wk/wv and the norm scales stay whole (the "kv": None rule).
        assert local < 0.62 * whole
        assert tuple(model.embedding.shape) == (cfg.vocab_size // 2,
                                                cfg.d_model)
        reports = replica.engine.rank_report()
        assert [r["rank"] for r in reports] == [0, 1]
        assert [r["kv_heads"] for r in reports] == [1, 1]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            replica.engine.generate([[1, 2, 3]], 2)

    def test_each_header_is_a_span_with_its_bytes(self, replica):
        tracer = telemetry.get_tracer()
        seen = len([s for s in tracer.records()
                    if s.name == "serving/tp_header"])
        replica.engine.prefill([[1, 2, 3, 4]])
        headers = [s for s in tracer.records()
                   if s.name == "serving/tp_header"]
        assert len(headers) == seen + 1
        assert headers[-1].args["op"] == "prefill"
        # The header pickles the prompt: more than a bare op name.
        assert headers[-1].args["bytes"] > 64
        assert headers[-1].duration >= 0


# -- run_serving through the serving task, a group each -----------------------

class Runtime:
    """What a task body reads of `tasks._bootstrap.TaskRuntime`."""

    def __init__(self, kv, task):
        task_type, _, task_id = task.partition(":")
        self.kv, self.task = kv, task
        self.task_key = TaskKey(task_type, int(task_id))


@pytest.fixture(scope="module")
def int8_dir(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("tp_decoder"))
    t_ckpt.save_checkpoint(model_dir, 3, {"params": port_state("int8"),
                                          "optimizer": {}, "step": 3})
    return model_dir


def start_task(model_dir, monkeypatch, task="serving:0"):
    """The serving task's body on a thread over a tp=2 experiment (int8
    KV, paged gather): (thread, result, port, replica, kv)."""
    from tf_yarn_tpu_torch.tasks import serving as serving_task

    started = []
    real_start = tp_replica.start

    def start(*args, **kwargs):
        started.append(real_start(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(tp_replica, "start", start)
    kv = InProcessKV()
    experiment = t_experiment.ServingExperiment(
        model=tt.Transformer(port_config("int8"), device="meta"),
        model_dir=model_dir, host="127.0.0.1", max_slots=2, **PAGED,
        mesh_spec=MeshSpec(tp=2))
    result = {}

    def serve():
        try:
            serving_task._run(Runtime(kv, task), experiment)
        except BaseException as exc:  # noqa: B036 — surfaced by the test
            result["error"] = exc

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    endpoint = kv.wait_str(f"{task}/serving_endpoint", timeout=120)
    return thread, result, int(endpoint.rsplit(":", 1)[1]), started[0], kv


def one_device_stream(prompt):
    scheduler = SlotScheduler(port_engine("int8"), max_slots=2, **PAGED)
    try:
        (stream,) = served_by_ticks(scheduler, [prompt], SamplingParams)
        return stream
    finally:
        scheduler.close()


def test_serving_task_tp2_advertises_serves_and_drains(int8_dir, monkeypatch):
    thread, result, port, replica, kv = start_task(int8_dir, monkeypatch)
    try:
        status, body = post(port, {"prompt": LONG, "max_new_tokens": NEW})
        assert status == 200, body
        assert body["tokens"] == one_device_stream(LONG)
        status, stats = get(port, "/stats")
        assert stats["tp_degree"] == 2
        assert stats["kv_cache_hbm_bytes_per_device"] * 2 == \
            stats["kv_cache_hbm_bytes"]
        assert stats["decode_engine"]["paged_step_calls"] > 0
        assert [p.is_alive() for p in replica.processes] == [True]
    finally:
        t_preemption.request()  # the drain the body polls
        thread.join(timeout=120)
        t_preemption.reset()
    assert not thread.is_alive()
    assert "error" not in result, result
    assert [p.exitcode for p in replica.processes] == [0]
    assert [r["rank"] for r in replica.reports] == [0, 1]
    assert kv.get_str("serving:0/metrics") is not None
    assert not torch.distributed.is_initialized()


def test_slow_verify_outlasts_the_group_timeout(int8_dir, monkeypatch):
    """The step is verified before any follower exists: a verification
    longer than the group's timeout does not fail the replica."""
    from tf_yarn_tpu_torch import inference

    timeout_s = 15.0
    monkeypatch.setattr(tp_lib, "DEFAULT_TIMEOUT_S", timeout_s)
    real_verify = inference.verified_step
    alive = []

    def slow_verify(*args, **kwargs):
        alive.append([p.name for p in multiprocessing.active_children()
                      if p.name.startswith("tp-follower")])
        time.sleep(timeout_s + 1)
        return real_verify(*args, **kwargs)

    monkeypatch.setattr(inference, "verified_step", slow_verify)
    thread, result, port, replica, _kv = start_task(int8_dir, monkeypatch)
    try:
        status, body = post(port, {"prompt": [3, 5], "max_new_tokens": 2})
        assert status == 200, body
    finally:
        t_preemption.request()
        thread.join(timeout=120)
        t_preemption.reset()
    assert alive == [[]]
    assert not thread.is_alive()
    assert "error" not in result, result
    assert [p.exitcode for p in replica.processes] == [0]


def test_killed_follower_fails_the_leader_classified(int8_dir, monkeypatch):
    monkeypatch.setattr(tp_lib, "DEFAULT_TIMEOUT_S", 20.0)
    thread, result, port, replica, _kv = start_task(int8_dir, monkeypatch)
    status, _body = post(port, {"prompt": [3, 5], "max_new_tokens": 2})
    assert status == 200
    killed = time.monotonic()
    os.kill(replica.processes[0].pid, signal.SIGKILL)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert time.monotonic() - killed < 20
    error = result["error"]
    assert isinstance(error, tp_lib.TPGroupError)
    assert taxonomy.classify_exception(error) is taxonomy.FailureKind.LOST_TASK
    assert "tp-follower-1" in str(error)
    # The broken group is gone: this process trains on one device again.
    assert not torch.distributed.is_initialized()
