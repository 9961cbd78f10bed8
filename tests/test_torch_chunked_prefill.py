"""Chunked prefill in the port's SlotScheduler (``prefill_chunk``,
``prefill_budget_per_tick``), held against the JAX package's
SlotScheduler on the tiny f32 decoder with int8 KV and bridged weights:
greedy streams on the paged fused, paged gather and dense grids, the
knobs' validation, the no-stall contract, the budget's round robin,
the paged layout's incremental prefix registration, eviction mid-prefill
and the stats surface. The JAX side runs its plain RMSNorm (its fused
norm has no batching rule under the dense step's vmap); the port's norms
give the plain f32 norm's numbers either way. Also the serving test of
prefix hits, an eos that fires and a block pool too small for every slot
at once, on the blocking and the chunked paged grids."""

import collections
import functools
import time

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

BUCKETS = (4, 8, 16)
MAX_NEW = 6
MAX_SEQ = 64
# Lengths 2, 9 and 13 (the third waits for a free slot), and one that
# repeats itself so the n-gram drafter proposes.
PROMPTS = [np.random.RandomState(seed).randint(0, 256, (n,)).tolist()
           for seed, n in ((10, 2), (11, 9), (12, 13))]
PROMPTS.append([5, 6, 7, 8, 5, 6, 7, 8, 5, 6])
GRIDS = {"fused": dict(kv_layout="paged", decode_attention="fused"),
         "gather": dict(kv_layout="paged", decode_attention="gather"),
         "dense": dict(kv_layout="dense")}
# (prefill_chunk, prefill_budget_per_tick, spec_k)
CASES = [(4, None, 0), (4, 8, 0), ("auto", None, 0), (4, 8, 2)]


@functools.lru_cache(maxsize=None)
def _weights():
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=False,
        scan_layers=False, remat=False, max_seq_len=MAX_SEQ)
    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


@functools.lru_cache(maxsize=None)
def _port_model():
    _, params = _weights()
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                    kv_cache_dtype="int8")
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _port(**kwargs):
    kwargs.setdefault("block_size", 8)
    return SlotScheduler(DecodeEngine(_port_model(), prompt_buckets=BUCKETS),
                         **kwargs)


def _jax(**kwargs):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, params = _weights()
    kwargs.setdefault("block_size", 8)
    engine = JaxEngine(model, batch_buckets=(1, 2, 4), prompt_buckets=BUCKETS)
    return JaxScheduler(engine, params, **kwargs)


def _jax_params(**kwargs):
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams

    return JaxParams(**kwargs)


def _drive(scheduler, responses, limit=400):
    for _ in range(limit):
        if all(r.done for r in responses):
            return
        scheduler.tick()
    raise AssertionError(f"not done after {limit} ticks")


def _run(scheduler, prompts, params):
    """Submit every prompt, tick to the end; (streams, finish reasons,
    stats). Closes the scheduler."""
    try:
        responses = [scheduler.submit(p, params) for p in prompts]
        _drive(scheduler, responses)
        return ([r.result(timeout=1) for r in responses],
                [r.finish_reason for r in responses], scheduler.stats())
    finally:
        scheduler.close()


CHUNK_KEYS = ("prefill_chunk", "prefill_budget_per_tick", "prefill_tokens",
              "decode_tokens", "spec_k", "peak_streams", "ticks")


@pytest.mark.parametrize("chunk,budget,spec_k", CASES,
                         ids=[f"c{c}-b{b}-k{k}" for c, b, k in CASES])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_chunked_streams_equal_jax_and_blocking(grid, chunk, budget, spec_k):
    knobs = dict(max_slots=2, spec_k=spec_k, **GRIDS[grid])
    chunked = dict(knobs, prefill_chunk=chunk, prefill_budget_per_tick=budget)
    ref, ref_reasons, ref_stats = _run(_jax(**chunked), PROMPTS,
                                       _jax_params(max_new_tokens=MAX_NEW))
    port = _port(**chunked)
    streams, reasons, stats = _run(port, PROMPTS,
                                   SamplingParams(max_new_tokens=MAX_NEW))
    blocking, _, _ = _run(_port(**knobs), PROMPTS,
                          SamplingParams(max_new_tokens=MAX_NEW))
    assert streams == ref == blocking
    assert reasons == ref_reasons == ["length"] * len(PROMPTS)
    assert set(stats) == set(ref_stats)
    for key in CHUNK_KEYS:
        assert stats[key] == ref_stats[key], key
    assert stats["prefill_tokens"] == sum(len(p) for p in PROMPTS)
    engine = stats["decode_engine"]
    # Chunked admission never runs the prefill program.
    assert engine.get("prefill_calls", 0) == 0
    assert engine.get("pack_calls", 0) == 0
    step = "spec_step_calls" if grid == "dense" else "paged_spec_step_calls"
    assert engine[step] == stats["ticks"] > 0
    if grid != "dense":
        assert stats["prefix_cache"] == ref_stats["prefix_cache"]
        assert stats["block_pool"] == ref_stats["block_pool"]


BAD_KNOBS = [
    dict(prefill_chunk=-2),
    dict(prefill_budget_per_tick=8),
    dict(prefill_chunk=8, prefill_budget_per_tick=4),
    dict(prefill_chunk=2, spec_k=5, prefill_budget_per_tick=3),
]


@pytest.mark.parametrize("knobs", BAD_KNOBS,
                         ids=["negative", "budget-alone", "budget-under-chunk",
                              "budget-under-spec"])
def test_chunked_knobs_raise_as_jax(knobs):
    with pytest.raises(ValueError) as ref:
        _jax(max_slots=1, **knobs)
    with pytest.raises(ValueError) as got:
        _port(max_slots=1, **knobs)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("knobs", [
    dict(prefill_chunk="auto"), dict(prefill_chunk="auto", spec_k=20),
    dict(prefill_chunk=8), dict(prefill_chunk=2, spec_k=5),
    dict(prefill_chunk=0), dict(prefill_chunk=None, spec_k=3)])
def test_chunk_resolution_and_headroom_match_jax(knobs):
    ref, port = _jax(max_slots=1, **knobs), _port(max_slots=1, **knobs)
    try:
        assert port.prefill_chunk == ref.prefill_chunk
        assert port.context_limit == ref.context_limit
        if knobs.get("prefill_chunk") == "auto":
            assert port.prefill_chunk == max(BUCKETS + (knobs.get("spec_k", 0)
                                                        + 1,))
        limit = port.context_limit
        if limit < MAX_SEQ:
            with pytest.raises(ValueError) as got:
                port.submit([1] * (limit - 1), SamplingParams(max_new_tokens=2))
            with pytest.raises(ValueError) as want:
                ref.submit([1] * (limit - 1), _jax_params(max_new_tokens=2))
            assert "headroom" in str(got.value)
            assert str(got.value) == str(want.value)
        port.submit([1] * (limit - 2), SamplingParams(max_new_tokens=2))
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("grid", list(GRIDS))
def test_decode_slot_emits_every_tick_while_prompt_chunks(grid):
    port = _port(max_slots=2, prefill_chunk=4, prefill_budget_per_tick=4,
                 **GRIDS[grid])
    try:
        decode = port.submit([1, 2], SamplingParams(max_new_tokens=40))
        port.tick()  # admits; the window consumes [1, 2] and emits
        assert len(decode.token_times) == 1
        prompt = np.random.RandomState(3).randint(0, 256, (38,)).tolist()
        long = port.submit(prompt, SamplingParams(max_new_tokens=1))
        admit_tick = port._ticks + 1
        while long.first_token_at is None:
            port.tick()
            assert port._ticks < 100
        ticks = [t for t in port.trace if t["tick"] >= admit_tick]
        # 38 prompt tokens at 4 a tick: ceil(38 / 4) ticks.
        assert len(ticks) == -(-len(prompt) // 4)
        assert all(t["accepted"].get(decode.request.id) == 1 for t in ticks)
        _drive(port, [decode, long])
    finally:
        port.close()
    blocking = _port(max_slots=1, **GRIDS[grid])
    expected, _, _ = _run(blocking, [prompt],
                          SamplingParams(max_new_tokens=1))
    assert long.result(timeout=1) == expected[0]


def _record_windows(engine, calls):
    """Wrap the engine's windowed steps to record (mask, n_known) a call."""
    for name in ("spec_step", "paged_spec_step"):
        step = getattr(engine, name)

        def recorded(*args, step=step, **kwargs):
            n_known, mask = (args[4], args[7]) if len(args) > 7 else (
                args[2], args[5])
            calls.append((np.array(mask), np.array(n_known)))
            return step(*args, **kwargs)

        setattr(engine, name, recorded)


@pytest.mark.parametrize("grid", ["fused", "dense"])
def test_budget_alternates_two_chunking_slots(grid):
    prompts = [np.random.RandomState(20 + i).randint(0, 256, (24,)).tolist()
               for i in range(2)]
    port = _port(max_slots=2, prefill_chunk=4, prefill_budget_per_tick=4,
                 **GRIDS[grid])
    calls = []
    _record_windows(port.engine, calls)
    streams, _, _ = _run(port, prompts, SamplingParams(max_new_tokens=3))
    blocking, _, _ = _run(_port(max_slots=2, **GRIDS[grid]), prompts,
                          SamplingParams(max_new_tokens=3))
    assert streams == blocking
    # While both chunk, the 4-token budget admits one window a tick, and
    # the rotation alternates the slots.
    advanced = [int(np.argmax(mask)) for mask, known in calls
                if mask.sum() == 1 and known[int(np.argmax(mask))] > 0]
    assert len(advanced) >= 2 * (24 // 4) - 2
    assert set(advanced) == {0, 1}
    assert all(a != b for a, b in zip(advanced, advanced[1:]))


def _paged_chunked(**kwargs):
    return _port(kv_layout="paged", decode_attention="fused", block_size=4,
                 prefill_chunk=4, **kwargs)


def test_paged_chunked_registers_whole_blocks_incrementally():
    prompt = np.random.RandomState(30).randint(0, 256, (14,)).tolist()
    port = _paged_chunked(max_slots=1)
    try:
        response = port.submit(prompt, SamplingParams(max_new_tokens=3))
        entries = []
        while not response.done:
            port.tick()
            entries.append(port._prefix.entries)
        # 14 prompt tokens at 4 a tick: one whole 4-token block a chunk,
        # the partial tail never registered.
        assert entries[:4] == [1, 2, 3, 3]
        stream = response.result(timeout=1)
        repeat = port.submit(prompt, SamplingParams(max_new_tokens=3))
        _drive(port, [repeat])
        assert repeat.result(timeout=1) == stream
        assert port._prefix.hits == 1
    finally:
        port.close()
    blocking, _, _ = _run(_port(max_slots=1, kv_layout="paged",
                                decode_attention="fused", block_size=4),
                          [prompt], SamplingParams(max_new_tokens=3))
    assert stream == blocking[0]


@pytest.mark.parametrize("how", ["deadline", "shutdown"])
def test_mid_prefill_eviction_releases_blocks_exactly_once(how):
    port = _paged_chunked(max_slots=1, prefill_budget_per_tick=4)
    pool = port._blocks
    free_before = pool.free_blocks
    prompt = list(range(1, 25))  # 6 blocks of prompt
    victim = port.submit(prompt, SamplingParams(max_new_tokens=2),
                         timeout_s=2.0 if how == "deadline" else None)
    port.tick()
    port.tick()
    assert not victim.done
    assert port._prefix.entries == 2
    assert pool.used_blocks > 2
    if how == "deadline":
        time.sleep(max(0.0, victim.request.deadline - time.monotonic()) + 0.01)
        port.tick()
    else:
        port.close()
    assert victim.finish_reason == how
    # Only the prefix cache's references stay: one per entry holding
    # the block, none of the slot's.
    refs = collections.Counter(b for ids in port._prefix._entries.values()
                               for b in ids)
    assert {b: pool.refcount(b) for b in refs} == dict(refs)
    assert pool.used_blocks == port._prefix.cached_blocks == 2
    assert pool.free_blocks + port._prefix.cached_blocks == free_before
    if how == "deadline":
        repeat = port.submit(prompt, SamplingParams(max_new_tokens=2))
        _drive(port, [repeat])
        assert port._prefix.hits == 1
        port.close()
    port._prefix.clear()
    assert pool.free_blocks == free_before


def test_paused_slot_never_writes_shared_blocks():
    """A slot that hit the prefix cache and is paused by the budget
    writes its window's garbage rows past its length, into its own
    blocks or the trash block: the shared blocks keep their bytes."""
    rng = np.random.RandomState(40)
    base = rng.randint(0, 256, (12,)).tolist()
    port = _paged_chunked(max_slots=2, prefill_budget_per_tick=4)
    try:
        first = port.submit(base, SamplingParams(max_new_tokens=1))
        _drive(port, [first])
        shared = sorted({b for ids in port._prefix._entries.values()
                         for b in ids})
        assert len(shared) == 3
        snapshot = [t[:, shared].clone() for t in (port._pool.key,
                                                    port._pool.value)]
        hit = port.submit(base + rng.randint(0, 256, (10,)).tolist(),
                          SamplingParams(max_new_tokens=2))
        other = port.submit(rng.randint(0, 256, (20,)).tolist(),
                            SamplingParams(max_new_tokens=2))
        calls = []
        _record_windows(port.engine, calls)
        _drive(port, [hit, other])
        assert any(mask.sum() == 1 for mask, _ in calls)  # one was paused
        for before, leaf in zip(snapshot, (port._pool.key, port._pool.value)):
            assert torch.equal(leaf[:, shared], before)
        assert port._prefix.hits == 1
    finally:
        port.close()


# Prompts sharing a 16-token prefix (two whole 8-token blocks), and one
# that does not.
_SHARED = np.random.RandomState(50).randint(0, 256, (16,)).tolist()
SERVE_PROMPTS = [_SHARED + [7, 9, 11], _SHARED + [3, 1], _SHARED + [4],
                 np.random.RandomState(51).randint(0, 256, (6,)).tolist()]


@pytest.mark.parametrize("chunk", [None, 4], ids=["blocking", "chunked"])
def test_serving_prefix_hits_eos_and_small_pool_match_jax(chunk):
    knobs = dict(max_slots=3, kv_layout="paged", decode_attention="fused",
                 num_blocks=5, prefill_chunk=chunk)
    first, _, _ = _run(_port(**knobs), SERVE_PROMPTS[:1],
                       SamplingParams(max_new_tokens=MAX_NEW))
    eos = first[0][2]  # fires on the first request's third token
    results = {}
    for name, build, params in (
            ("jax", _jax, _jax_params(max_new_tokens=MAX_NEW, eos_token=eos)),
            ("port", _port, SamplingParams(max_new_tokens=MAX_NEW,
                                           eos_token=eos))):
        scheduler = build(**knobs)
        # The pool's 4 blocks hold the first request (3) and one more
        # sharing its prefix: the third waits.
        responses = [scheduler.submit(p, params) for p in SERVE_PROMPTS]
        held = 0
        try:
            for _ in range(400):
                if all(r.done for r in responses):
                    break
                scheduler.tick()
                held += scheduler._held is not None
            results[name] = ([r.result(timeout=1) for r in responses],
                             [r.finish_reason for r in responses],
                             scheduler.stats(), held)
        finally:
            scheduler.close()
    (streams, reasons, stats, held), ref = results["port"], results["jax"]
    assert streams == ref[0]
    assert reasons == ref[1]
    assert reasons[0] == "eos" and streams[0] == first[0][:3]
    assert held > 0 and held == ref[3]
    assert stats["peak_streams"] == ref[2]["peak_streams"] < len(SERVE_PROMPTS)
    assert stats["prefix_cache"] == ref[2]["prefix_cache"]
    assert stats["prefix_cache"]["hits"] >= 2
    assert stats["block_pool"] == ref[2]["block_pool"]
