"""The host swap tier in the port's SlotScheduler (``kv_host_blocks``:
suspend and resume by SLO tier), held against the JAX package's
SlotScheduler on the tiny f32 decoder with bridged weights (int8 KV on
the fused and gather grids, the compute dtype's KV on gather), both
driven by ``tick()`` through the same events: the host store's ledger,
the queue's resume arbiter, the oversubscribed pool (block 8, 5 blocks,
8 host blocks) with the displaced stream equal to the JAX scheduler's
and to an uncontended run, the victim choice, holding without host
blocks, deadlines and shutdown of parked streams, a prefix storm that
keeps every refcount, and a chunked slot parked mid-prompt. Sampled
streams survive a swap bit for bit within the port (its generators and
the JAX keys cannot match). The JAX side runs its plain RMSNorm, as in
tests/test_torch_chunked_prefill.py."""

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
from tf_yarn_tpu_torch.serving import paging as port_paging
from tf_yarn_tpu_torch.serving import request as port_request
from tf_yarn_tpu_torch.serving import scheduler as port_scheduler
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

BUCKETS = (4, 8, 16)
MAX_SEQ = 64
# The oversubscribed geometry: a 9-token prompt with 20 new tokens needs
# ceil(28 / 8) = 4 blocks, the whole usable pool, so the interactive
# request (2 blocks) must displace it.
BATCH = [3, 1, 4, 1, 5, 9, 2, 6, 5]
INTER = [2, 7, 1, 8, 2]
OVERSUBSCRIBED = dict(max_slots=2, block_size=8, num_blocks=5,
                      kv_host_blocks=8)
GRIDS = {"fused": dict(kv_layout="paged", decode_attention="fused"),
         "gather": dict(kv_layout="paged", decode_attention="gather"),
         "gather_bf16": dict(kv_layout="paged", decode_attention="gather")}


@functools.lru_cache(maxsize=None)
def jax_model(kv_cache_dtype="int8", n_layers=2, scan_layers=False):
    """The JAX tiny f32 decoder and its parameters (seed 0)."""
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype=kv_cache_dtype, fused_norms=False,
        scan_layers=scan_layers, remat=False, max_seq_len=MAX_SEQ,
        n_layers=n_layers)
    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


@functools.lru_cache(maxsize=None)
def port_model(kv_cache_dtype="int8", n_layers=2, scan_layers=False):
    """The port's decoder with `jax_model`'s weights."""
    _, params = jax_model(kv_cache_dtype, n_layers, scan_layers)
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                    kv_cache_dtype=kv_cache_dtype,
                                    n_layers=n_layers)
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


class Side:
    """One package's serving stack behind one interface: `scheduler(**kw)`
    and `params(**kw)`, so one scenario runs on both."""

    def __init__(self, name, kv_cache_dtype="int8", n_layers=2,
                 scan_layers=False):
        self.name = name
        self.model_args = (kv_cache_dtype, n_layers, scan_layers)

    def scheduler(self, **kwargs):
        kwargs.setdefault("block_size", 8)
        if self.name == "port":
            engine = DecodeEngine(port_model(*self.model_args),
                                  prompt_buckets=BUCKETS)
            return SlotScheduler(engine, **kwargs)
        from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
        from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

        model, params = jax_model(*self.model_args)
        engine = JaxEngine(model, batch_buckets=(1, 2, 4),
                           prompt_buckets=BUCKETS)
        return JaxScheduler(engine, params, **kwargs)

    def params(self, **kwargs):
        if self.name == "port":
            return SamplingParams(**kwargs)
        from tf_yarn_tpu.serving.request import SamplingParams as JaxParams

        return JaxParams(**kwargs)

    @property
    def module(self):
        if self.name == "port":
            return port_scheduler
        from tf_yarn_tpu.serving import scheduler as jax_scheduler

        return jax_scheduler


def sides(kv_cache_dtype="int8"):
    return [Side("jax", kv_cache_dtype), Side("port", kv_cache_dtype)]


def drive(scheduler, responses, limit=400):
    for _ in range(limit):
        if all(r.done for r in responses):
            return
        scheduler.tick()
    raise AssertionError(f"not done after {limit} ticks")


def retire_order(scheduler):
    return [rid for entry in scheduler.trace for rid, _ in entry["retired"]]


def refcount_invariant(scheduler):
    """Every block's refcount is its prefix entries plus the slots that
    hold it."""
    pool = scheduler._blocks
    expected = {}
    for ids in scheduler._prefix._entries.values():
        for block in ids:
            expected[block] = expected.get(block, 0) + 1
    for state in scheduler._slots:
        if state is not None:
            for block in state.blocks or ():
                expected[block] = expected.get(block, 0) + 1
    for block in range(1, pool.num_blocks):
        assert pool.refcount(block) == expected.get(block, 0), block


def displaced(side, grid, temperature=0.0, seed=0, ticks_first=3):
    """The oversubscribed run: the batch stream ticks alone, then the
    interactive request arrives. Returns (batch, interactive, stats)."""
    scheduler = side.scheduler(temperature=temperature, **OVERSUBSCRIBED,
                               **GRIDS[grid])
    try:
        batch = scheduler.submit(BATCH, side.params(
            max_new_tokens=20, temperature=temperature, seed=seed),
            tier="batch")
        for _ in range(ticks_first):
            scheduler.tick()
        assert not batch.done
        inter = scheduler.submit(INTER, side.params(
            max_new_tokens=8, temperature=temperature, seed=seed),
            tier="interactive")
        drive(scheduler, [batch, inter])
        order = retire_order(scheduler)
        assert order.index(inter.request.id) < order.index(batch.request.id)
        return (batch.result(timeout=1), inter.result(timeout=1),
                scheduler.stats())
    finally:
        scheduler.close()


def uncontended(side, grid, prompt, max_new, tier, temperature=0.0, seed=0):
    scheduler = side.scheduler(temperature=temperature, **OVERSUBSCRIBED,
                               **GRIDS[grid])
    try:
        response = scheduler.submit(prompt, side.params(
            max_new_tokens=max_new, temperature=temperature, seed=seed),
            tier=tier)
        drive(scheduler, [response])
        return response.result(timeout=1)
    finally:
        scheduler.close()


# -- host-side units ----------------------------------------------------------

def test_host_block_store_matches_jax():
    from tf_yarn_tpu.serving.paging import HostBlockStore as JaxStore

    def run(store_cls):
        out = []
        store = store_cls(capacity_blocks=4, block_size=8)

        def call(fn, *args):
            try:
                out.append(("ok", fn(*args)))
            except (ValueError, KeyError) as exc:
                out.append((type(exc).__name__, str(exc)))

        call(lambda: (store.free_blocks, store.used_blocks, store.entries))
        call(lambda: (store.can_hold(4), store.can_hold(5)))
        call(store.put, "a", 3, {"kv": "opaque"})
        call(lambda: ("a" in store, store.used_blocks, store.free_blocks))
        call(store.put, "a", 1, None)
        call(store.put, "b", 2, None)
        call(store.put, "b", -1, None)
        call(store.put, "b", 1, None)
        call(store.pop, "a")
        call(store.pop, "a")
        call(store.put, "c", 0, None)
        call(store.pop, "c")
        call(lambda: (store.free_blocks, store.entries, store.capacity_blocks,
                      store.block_size))
        call(store_cls, -1, 8)
        call(store_cls, 4, 0)
        return out

    assert run(port_paging.HostBlockStore) == run(JaxStore)


def test_queue_peek_rank_matches_jax():
    from tf_yarn_tpu.serving import request as jax_request

    def run(module):
        queue = module.AdmissionQueue(capacity=8)
        ranks = [queue.peek_rank()]
        for tier, priority in (("batch", 5), ("standard", 0),
                               ("interactive", -1), ("batch", 9)):
            queue.submit(module.Request(prompt=(1, 2), tier=tier,
                                        priority=priority))
            ranks.append(queue.peek_rank())
        while queue.pop() is not None:
            ranks.append(queue.peek_rank())
        return ranks

    assert run(port_request) == run(jax_request)
    assert run(port_request)[:3] == [None, 0, 1]


# -- the oversubscribed pool -----------------------------------------------

@pytest.mark.parametrize("grid", list(GRIDS))
def test_displaced_stream_equals_jax_and_uncontended(grid):
    dtype = "bf16" if grid == "gather_bf16" else "int8"
    ref_side, port = sides(dtype)
    ref_batch, ref_inter, ref_stats = displaced(ref_side, grid)
    batch, inter, stats = displaced(port, grid)
    assert batch == ref_batch
    assert inter == ref_inter
    assert batch == uncontended(port, grid, BATCH, 20, "batch")
    assert inter == uncontended(port, grid, INTER, 8, "interactive")
    # Parked after its 8-token prefill and 3 ticks: its valid blocks go
    # out and come back in, none of them shared.
    assert stats["swap"] == ref_stats["swap"]
    assert stats["swap"]["suspends"] == stats["swap"]["resumes"] == 1
    for key in ("host_block_store", "suspended_streams", "peak_streams",
                "block_pool", "prefix_cache"):
        assert stats[key] == ref_stats[key], key
    assert stats["peak_streams"] == 2
    engine = stats["decode_engine"]
    assert engine["extract_calls"] == engine["inject_calls"] == 1


@pytest.mark.parametrize("grid", ["fused", "gather"])
def test_sampled_stream_survives_the_swap_bit_for_bit(grid):
    port = Side("port")
    batch, inter, stats = displaced(port, grid, temperature=0.8, seed=7)
    assert stats["swap"]["suspends"] == 1
    assert batch == uncontended(port, grid, BATCH, 20, "batch",
                                temperature=0.8, seed=7)
    assert inter == uncontended(port, grid, INTER, 8, "interactive",
                                temperature=0.8, seed=7)
    greedy, _, _ = displaced(port, grid)
    assert batch != greedy  # the draws did happen


def test_victim_is_youngest_of_lowest_tier_like_jax():
    outcomes = []
    for side in sides():
        scheduler = side.scheduler(max_slots=3, block_size=4, num_blocks=9,
                                   kv_host_blocks=16,
                                   **GRIDS["fused"])
        params = side.params(max_new_tokens=6)
        older = scheduler.submit([1, 2, 3, 4, 5, 6, 7, 8], params,
                                 tier="batch")
        scheduler.tick()
        younger = scheduler.submit([8, 7, 6, 5, 4, 3, 2, 1], params,
                                   tier="batch")
        scheduler.tick()
        inter = scheduler.submit([2, 3, 4, 5, 6, 7, 8, 9], params,
                                 tier="interactive")
        scheduler.tick()
        parked = [entry.request.id for entry in scheduler._suspended]
        assert parked == [younger.request.id]
        responses = [older, younger, inter]
        drive(scheduler, responses)
        refcount_invariant(scheduler)
        outcomes.append(([r.result(timeout=1) for r in responses],
                         [r.finish_reason for r in responses],
                         scheduler.stats()["swap"]))
        scheduler.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][2]["suspends"] == 1


def test_without_host_blocks_the_request_is_held_like_jax():
    for side in sides():
        scheduler = side.scheduler(max_slots=2, block_size=8, num_blocks=5,
                                   **GRIDS["fused"])
        batch = scheduler.submit(BATCH, side.params(max_new_tokens=20),
                                 tier="batch")
        for _ in range(3):
            scheduler.tick()
        inter = scheduler.submit(INTER, side.params(max_new_tokens=8),
                                 tier="interactive")
        drive(scheduler, [batch, inter])
        order = retire_order(scheduler)
        assert order.index(batch.request.id) < order.index(inter.request.id)
        stats = scheduler.stats()
        assert "swap" not in stats and "host_block_store" not in stats
        if side.name == "port":
            assert stats["decode_engine"]["extract_calls"] == 0
        scheduler.close()


class _Clock:
    """A scheduler module's `time`, run ahead of the real clock."""

    def __init__(self, ahead_s):
        self.ahead_s = ahead_s

    def monotonic(self):
        return time.monotonic() + self.ahead_s


def _parked(side):
    """A batch stream (60 s deadline) parked by an interactive request."""
    scheduler = side.scheduler(temperature=0.0, **OVERSUBSCRIBED,
                               **GRIDS["fused"])
    batch = scheduler.submit(BATCH, side.params(max_new_tokens=20),
                             tier="batch", timeout_s=60.0)
    for _ in range(3):
        scheduler.tick()
    inter = scheduler.submit(INTER, side.params(max_new_tokens=8),
                             tier="interactive")
    scheduler.tick()
    assert len(scheduler._suspended) == 1 and not batch.done
    return scheduler, batch, inter


def test_deadline_retires_parked_stream_and_frees_host_blocks(monkeypatch):
    outcomes = []
    for side in sides():
        scheduler, batch, inter = _parked(side)
        with monkeypatch.context() as patch:
            # The batch request's deadline passes while it is parked.
            patch.setattr(side.module, "time", _Clock(120.0))
            scheduler.tick()
        assert batch.done and not inter.done
        stats = scheduler.stats()
        assert stats["host_block_store"]["used_blocks"] == 0
        assert stats["host_block_store"]["entries"] == 0
        drive(scheduler, [inter])
        refcount_invariant(scheduler)
        outcomes.append((batch.finish_reason, batch.result(timeout=1),
                         inter.result(timeout=1), scheduler.stats()["swap"]))
        scheduler.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "deadline"


def test_close_fails_parked_stream_as_shutdown():
    outcomes = []
    for side in sides():
        scheduler, batch, inter = _parked(side)
        scheduler.close()
        stats = scheduler.stats()
        assert stats["host_block_store"]["entries"] == 0
        assert stats["suspended_streams"] == {}
        outcomes.append((batch.finish_reason, inter.finish_reason,
                         stats["swap"]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][:2] == ("shutdown", "shutdown")


def test_prefix_storm_keeps_refcounts_and_streams_like_jax(monkeypatch):
    """The same prompt twice: the interactive admission evicts the batch
    stream's (slot-held) prefix entries, suspends it, prefills and
    registers the prefix again in new blocks; the batch stream resumes
    THROUGH that prefix, so only its unshared tail block goes back in,
    never into a cached block."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]  # prefill 8 = 2 whole blocks
    grid = dict(max_slots=2, block_size=4, num_blocks=5, kv_host_blocks=8,
                **GRIDS["fused"])
    original = DecodeEngine.inject_blocks
    current = {}

    def guarded(engine, pool, block_ids, payload, block_size):
        scheduler = current["scheduler"]
        cached = {block for ids in scheduler._prefix._entries.values()
                  for block in ids}
        assert not set(block_ids) & cached
        return original(engine, pool, block_ids, payload, block_size)

    monkeypatch.setattr(DecodeEngine, "inject_blocks", guarded)
    outcomes = []
    for side in sides():
        scheduler = current["scheduler"] = side.scheduler(**grid)
        params = side.params(max_new_tokens=6)
        batch = scheduler.submit(prompt, params, tier="batch")
        for _ in range(3):
            scheduler.tick()
        refcount_invariant(scheduler)
        inter = scheduler.submit(prompt, params, tier="interactive")
        scheduler.tick()
        assert len(scheduler._suspended) == 1
        refcount_invariant(scheduler)
        drive(scheduler, [batch, inter])
        refcount_invariant(scheduler)
        stats = scheduler.stats()
        outcomes.append((batch.result(timeout=1), inter.result(timeout=1),
                         stats["swap"], stats["prefix_cache"]))
        scheduler.close()
    assert outcomes[0] == outcomes[1]
    swap = outcomes[1][2]
    assert swap["swap_out_blocks"] == 3 and swap["swap_in_blocks"] == 1
    assert outcomes[1][0] == outcomes[1][1]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_chunked_slot_parked_mid_prompt_like_jax(spec_k):
    """A 20-token prompt replaying 4 tokens a tick is parked after two
    chunks; it resumes with its pending replay, length and registered
    blocks as they were."""
    prompt = np.random.RandomState(3).randint(0, 256, (20,)).tolist()
    grid = dict(max_slots=2, block_size=8, num_blocks=5, kv_host_blocks=8,
                prefill_chunk=4, spec_k=spec_k, **GRIDS["fused"])
    outcomes = []
    for side in sides():
        scheduler = side.scheduler(**grid)
        batch = scheduler.submit(prompt, side.params(max_new_tokens=12),
                                 tier="batch")
        for _ in range(2):
            scheduler.tick()
        inter = scheduler.submit(INTER, side.params(max_new_tokens=8),
                                 tier="interactive")
        scheduler.tick()
        (entry,) = scheduler._suspended
        parked = (entry.length, len(entry.state.pending),
                  entry.state.prompt_filled, entry.state.registered_blocks)
        assert parked[1] > 0  # parked mid-prompt
        drive(scheduler, [batch, inter])
        refcount_invariant(scheduler)
        stats = scheduler.stats()
        outcomes.append((parked, batch.result(timeout=1),
                         inter.result(timeout=1),
                         [batch.finish_reason, inter.finish_reason],
                         stats["swap"], stats["prefill_tokens"]))
        scheduler.close()
    assert outcomes[0] == outcomes[1]
    solo = Side("port").scheduler(**grid)
    response = solo.submit(prompt, SamplingParams(max_new_tokens=12),
                           tier="batch")
    drive(solo, [response])
    assert response.result(timeout=1) == outcomes[1][1]
    solo.close()


# -- validation -------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(kv_host_blocks=-1),
                                   dict(kv_host_blocks=4, kv_layout="dense")])
def test_host_tier_validation_matches_jax(knobs):
    errors = []
    for side in sides():
        with pytest.raises(ValueError) as err:
            side.scheduler(max_slots=1, **knobs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
