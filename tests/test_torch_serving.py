"""The port's serving stack (SlotScheduler + ServingServer over HTTP)
held against the JAX package's SlotScheduler in the same configuration:
paged KV, fused decode attention, int8 KV, fused norms."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.models.weights import from_flax
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler
from tf_yarn_tpu_torch.serving.server import ServingServer

BUCKETS = (4, 8, 16)
MAX_NEW = 6
# Lengths 2 (no prefill bucket fits: the whole prompt replays), 9 and 13
# (bucketed prefill plus a replayed remainder).
PROMPTS = [np.random.RandomState(seed).randint(0, 256, (n,)).tolist()
           for seed, n in ((10, 2), (11, 9), (12, 13))]


@pytest.fixture(scope="module")
def weights():
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=True,
        scan_layers=False, remat=False, max_seq_len=64)
    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port_engine(params):
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                    kv_cache_dtype="int8")
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return DecodeEngine(model, prompt_buckets=BUCKETS)


def _jax_streams(model, params):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    engine = JaxEngine(model, batch_buckets=(1, 2, 4), prompt_buckets=BUCKETS)
    scheduler = JaxScheduler(engine, params, max_slots=2, kv_layout="paged",
                             block_size=8, decode_attention="fused")
    try:
        responses = [scheduler.submit(p, JaxParams(max_new_tokens=MAX_NEW))
                     for p in PROMPTS]
        for _ in range(200):
            scheduler.tick()
            if all(r.done for r in responses):
                break
        return [r.result(timeout=1) for r in responses]
    finally:
        scheduler.close()


def _get(server, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=30) as reply:
        return reply.status, json.loads(reply.read())


def _post(server, body):
    request = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as reply:
        return reply.status, json.loads(reply.read())


def test_http_greedy_streams_equal_jax_scheduler(weights):
    model, params = weights
    expected = _jax_streams(model, params)
    scheduler = SlotScheduler(_port_engine(params), max_slots=2,
                              block_size=8, kv_layout="paged",
                              decode_attention="fused")
    server = ServingServer(scheduler, "127.0.0.1", 0)
    scheduler.start()
    server.start()
    try:
        results = [None] * len(PROMPTS)

        def call(i):
            results[i] = _post(server, {"prompt": PROMPTS[i],
                                        "max_new_tokens": MAX_NEW})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(PROMPTS))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
            assert not thread.is_alive()
        for (status, body), stream in zip(results, expected):
            assert status == 200
            assert body["finish_reason"] == "length"
            assert body["tokens"] == stream
        status, health = _get(server, "/healthz")
        assert status == 200 and health["status"] == "ok"
        status, stats = _get(server, "/stats")
        assert status == 200
        assert stats["decode_engine"]["paged_spec_step_calls"] > 0
        assert stats["decode_attention"] == "fused"
        assert stats["block_pool"]["used_blocks"] >= 0
    finally:
        server.stop()
        scheduler.close()


def test_context_overflow_and_sampling_mismatch_are_rejected(weights):
    _, params = weights
    scheduler = SlotScheduler(_port_engine(params), max_slots=1,
                              block_size=8)
    try:
        with pytest.raises(ValueError, match="max_seq_len"):
            scheduler.submit([1] * 60, SamplingParams(max_new_tokens=8))
        with pytest.raises(ValueError, match="temperature"):
            scheduler.submit([1, 2], SamplingParams(temperature=0.5))
    finally:
        scheduler.close()


@pytest.mark.parametrize("option", [
    {"kv_host_blocks": 4},
    {"kv_host_blocks": -1},
])
def test_unported_options_raise(weights, option):
    """The host swap tier is ported: its knob is validated as the JAX
    scheduler validates it (the paged layout only, never negative), with
    the same ValueError on the default dense layout."""
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, params = weights
    with pytest.raises(ValueError) as port_error:
        SlotScheduler(_port_engine(params), max_slots=1, block_size=8,
                      **option)
    with pytest.raises(ValueError) as jax_error:
        JaxScheduler(JaxEngine(model), params, max_slots=1, block_size=8,
                     **option)
    assert str(port_error.value) == str(jax_error.value)
    assert "kv_host_blocks" in str(port_error.value)


def test_unported_engine_paths_raise(weights):
    """Tensor-parallel decode is ported (tests/test_torch_tp_serving.py
    holds `DecodeEngine(mesh=)` against JAX); what stays unported is
    `generate` on a tp replica's engine, which serves through the slot
    grid: an engine joined to a group's control channel refuses it,
    naming its ROADMAP item."""
    _, params = weights
    engine = _port_engine(params)
    engine.channel = object()  # what joining a tp group sets
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.generate([[1, 2, 3]], 2)
