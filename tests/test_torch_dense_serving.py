"""The port's SlotScheduler on the dense slot grid and in the paged
gather mode, with and without speculative drafts, held against the JAX
package's SlotScheduler in the same configuration (tiny f32 decoder,
int8 KV; the JAX side's Pallas kernels in interpret mode). The JAX side
runs its plain RMSNorm: its fused norm is partition-aware and has no
batching rule under the dense step's vmap; the port's norms compute the
plain f32 norm's numbers either way."""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.models.weights import from_flax
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

BUCKETS = (4, 8, 16)
MAX_NEW = 6
# Lengths 2 (the whole prompt replays), 9 and 13 (bucketed prefill plus
# a replayed remainder); the third waits for a free slot.
PROMPTS = [np.random.RandomState(seed).randint(0, 256, (n,)).tolist()
           for seed, n in ((10, 2), (11, 9), (12, 13))]
# A prompt that repeats itself, so the n-gram drafter proposes.
PROMPTS.append([5, 6, 7, 8, 5, 6, 7, 8, 5, 6])
LAYOUTS = {"dense": dict(kv_layout="dense"),
           "gather": dict(kv_layout="paged", decode_attention="gather")}


@functools.lru_cache(maxsize=None)
def _weights():
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=False,
        scan_layers=False, remat=False, max_seq_len=64)
    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port_engine():
    _, params = _weights()
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                    kv_cache_dtype="int8")
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return DecodeEngine(model, prompt_buckets=BUCKETS)


def _drive(scheduler, sampling):
    """Submit every prompt, tick to the end; the streams in order."""
    try:
        responses = [scheduler.submit(p, sampling(i))
                     for i, p in enumerate(PROMPTS)]
        for _ in range(300):
            scheduler.tick()
            if all(r.done for r in responses):
                break
        return [r.result(timeout=1) for r in responses]
    finally:
        scheduler.close()


def _jax_streams(layout, spec_k):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, params = _weights()
    engine = JaxEngine(model, batch_buckets=(1, 2, 4), prompt_buckets=BUCKETS)
    scheduler = JaxScheduler(engine, params, max_slots=2, block_size=8,
                             spec_k=spec_k, **LAYOUTS[layout])
    return _drive(scheduler, lambda i: JaxParams(max_new_tokens=MAX_NEW))


def test_defaults_are_dense_and_gather():
    """The JAX defaults: the dense slot grid, and the gather mode for the
    paged layout and for `paged_spec_step`."""
    defaults = inspect.signature(SlotScheduler).parameters
    assert defaults["kv_layout"].default == "dense"
    assert defaults["decode_attention"].default == "gather"
    engine = _port_engine()
    scheduler = SlotScheduler(engine, max_slots=1)
    try:
        assert scheduler.kv_layout == "dense"
        assert scheduler.decode_attention == "gather"
    finally:
        scheduler.close()
    sig = inspect.signature(DecodeEngine.paged_spec_step)
    assert sig.parameters["decode_attention"].default == "gather"
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        SlotScheduler(engine, max_slots=1, decode_attention="fused")


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_equal_jax_scheduler(layout, spec_k):
    expected = _jax_streams(layout, spec_k)
    engine = _port_engine()
    scheduler = SlotScheduler(engine, max_slots=2, block_size=8,
                              spec_k=spec_k, **LAYOUTS[layout])
    stats_before = dict(engine.stats)
    got = _drive(scheduler,
                 lambda i: SamplingParams(max_new_tokens=MAX_NEW))
    assert got == expected
    assert all(len(stream) == MAX_NEW for stream in got)
    calls = {("dense", 0): "step_calls", ("dense", 2): "spec_step_calls",
             ("gather", 0): "paged_step_calls",
             ("gather", 2): "paged_spec_step_calls"}[(layout, spec_k)]
    assert engine.stats[calls] > stats_before[calls]
    stats = scheduler.stats()
    assert stats["kv_layout"] == LAYOUTS[layout]["kv_layout"]
    if spec_k:
        assert stats["spec"]["proposed_tokens"] > 0


def test_sampled_streams_equal_between_dense_and_gather():
    """Per-request seeds drive per-slot generators: at temperature 0.8
    with top_k the dense grid and the gather mode draw the same streams,
    with and without drafts (acceptance keeps the target's own draws)."""
    def sampling(i):
        return SamplingParams(max_new_tokens=MAX_NEW, temperature=0.8,
                              top_k=20, seed=100 + i)

    runs = {}
    for spec_k in (0, 2):
        for layout in sorted(LAYOUTS):
            scheduler = SlotScheduler(_port_engine(), max_slots=2,
                                      block_size=8, temperature=0.8, top_k=20,
                                      spec_k=spec_k, **LAYOUTS[layout])
            runs[layout, spec_k] = _drive(scheduler, sampling)
    first = runs["dense", 0]
    assert all(stream == first for stream in runs.values())
    greedy = _drive(SlotScheduler(_port_engine(), max_slots=2),
                    lambda i: SamplingParams(max_new_tokens=MAX_NEW))
    assert greedy != first


def test_dense_grid_reports_its_bytes_and_evicts_replayed_slots():
    engine = _port_engine()
    scheduler = SlotScheduler(engine, max_slots=2)
    cache = scheduler._cache
    try:
        cfg = engine.model.config
        rows = cfg.n_layers * 2 * cfg.max_seq_len * cfg.n_kv_heads
        assert cache.key.shape == (cfg.n_layers, 2, cfg.max_seq_len,
                                   cfg.n_kv_heads, cfg.head_dim)
        # One int32 index per slot and layer, as the JAX cache keeps it.
        assert cache.nbytes() == (rows * (2 * cfg.head_dim + 2 * 4)
                                  + cfg.n_layers * 2 * 4)
        assert scheduler.stats()["kv_cache_hbm_bytes"] == cache.nbytes()
        gauge = telemetry.get_registry().gauge("serving/kv_cache_hbm_bytes",
                                               layout="dense")
        assert gauge.value == cache.nbytes()
        # A slot left dirty by an earlier occupant starts from zeros when
        # the whole prompt replays (no prefill bucket fits).
        cache.key[:, 0] = 1
        cache.index[0] = 9
        stream = _drive(scheduler,
                        lambda i: SamplingParams(max_new_tokens=MAX_NEW))
        clean = _drive(SlotScheduler(_port_engine(), max_slots=2),
                       lambda i: SamplingParams(max_new_tokens=MAX_NEW))
        assert stream == clean
    finally:
        scheduler.close()


# The stats surface's grids: the layouts above, and the gather grid with
# the host swap tier on (its host_block_store, suspended_streams and swap
# keys).
STATS_GRIDS = dict(LAYOUTS, gather_host=dict(
    kv_layout="paged", decode_attention="gather", kv_host_blocks=8))


@pytest.mark.parametrize("layout", sorted(STATS_GRIDS))
def test_stats_surface_matches_jax_scheduler(layout):
    """`stats()` carries the JAX grid's keys, no more and no fewer; the KV
    bytes, global and per device, agree in the snapshot and in the gauges
    (one device: per device is global), and so do the peak of concurrent
    streams and the host tier's keys after the same requests."""
    from tf_yarn_tpu import telemetry as jax_telemetry
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, params = _weights()
    grids = {
        "jax": (JaxScheduler(JaxEngine(model, batch_buckets=(1, 2, 4),
                                       prompt_buckets=BUCKETS), params,
                             max_slots=2, block_size=8,
                             **STATS_GRIDS[layout]),
                JaxParams, jax_telemetry.get_registry()),
        "port": (SlotScheduler(_port_engine(), max_slots=2, block_size=8,
                               **STATS_GRIDS[layout]),
                 SamplingParams, telemetry.get_registry()),
    }
    kv_layout = STATS_GRIDS[layout]["kv_layout"]
    snaps, gauges = {}, {}
    for name, (scheduler, params_cls, registry) in grids.items():
        gauges[name] = tuple(
            registry.gauge(metric, layout=kv_layout).value
            for metric in ("serving/kv_cache_hbm_bytes",
                           "serving/kv_cache_hbm_bytes_per_device"))
        _drive(scheduler, lambda i: params_cls(max_new_tokens=MAX_NEW))
        snaps[name] = scheduler.stats()
    port, ref = snaps["port"], snaps["jax"]
    assert set(port) == set(ref)
    for key in ("prefill_chunk", "prefill_budget_per_tick"):
        assert port[key] == ref[key], key
    for key in ("kv_cache_hbm_bytes", "kv_cache_hbm_bytes_per_device",
                "peak_streams"):
        assert port[key] == ref[key], key
    for key in ("host_block_store", "suspended_streams", "swap"):
        assert port.get(key) == ref.get(key), key
    assert ("swap" in port) == (layout == "gather_host")
    assert port["peak_streams"] == 2
    assert port["kv_cache_hbm_bytes_per_device"] == port["kv_cache_hbm_bytes"]
    assert gauges["port"] == gauges["jax"] == (port["kv_cache_hbm_bytes"],) * 2
    if layout == "dense":
        assert port["kv_cache_hbm_bytes"] == 20496
