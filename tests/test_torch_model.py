"""The port's decoder and decode engine held against the JAX package.

One tiny int8-KV config with fused norms, f32 compute, the same flax
weights crossing through `models.weights.from_flax`; the JAX side runs
its Pallas kernels in interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.models.weights import from_flax

BUCKETS = (4, 8, 16)
BLOCK = 8


def _jax_config(**overrides):
    from tf_yarn_tpu.models import transformer as jt

    kwargs = dict(dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=True,
                  scan_layers=False, remat=False, max_seq_len=64)
    kwargs.update(overrides)
    return jt.TransformerConfig.tiny(**kwargs)


def _jax_params(cfg):
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port_model(params):
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64,
                                    kv_cache_dtype="int8")
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def stacks():
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine

    jax_model, params = _jax_params(_jax_config())
    jax_engine = JaxEngine(jax_model, batch_buckets=(1, 2, 4),
                           prompt_buckets=BUCKETS)
    engine = DecodeEngine(_port_model(params), prompt_buckets=BUCKETS)
    return jax_engine, params, engine


@pytest.mark.parametrize("scan_layers", [True, False])
def test_bridge_covers_every_leaf(scan_layers):
    _, params = _jax_params(_jax_config(scan_layers=scan_layers))
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64)
    flat = jax.tree_util.tree_map(np.asarray, params)
    state = from_flax(flat, cfg)
    model = tt.Transformer(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    inner = flat["params"]
    if scan_layers:
        wq = inner["layers"]["block"]["attn"]["wq"]["kernel"][1]
    else:
        wq = inner["layer_1"]["block"]["attn"]["wq"]["kernel"]
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.kernel.numpy(), wq)  # [in, out], untransposed
    inner["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        from_flax(flat, cfg)


def test_prefill_matches_jax(stacks):
    jax_engine, params, engine = stacks
    # Seeded prompts; at an int8 rounding boundary a one-ulp difference
    # in K flips one code and moves the logits by ~1e-4, which the
    # 99.9% code-agreement bound below admits.
    prompt = np.random.RandomState(1).randint(0, 256, (1, 16)).astype(np.int32)
    j_cache, j_logits = jax_engine.prefill(params, prompt)
    cache, logits = engine.prefill(prompt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
    equal = total = 0
    for layer in range(2):
        attn = j_cache[f"layer_{layer}"]["block"]["attn"]
        for j_name, name in (("cached_key", "key"), ("cached_value", "value")):
            ref = np.asarray(attn[j_name])[0, :16]
            got = cache[name][layer, 0].numpy()
            equal += int((ref == got).sum())
            total += ref.size
    assert equal / total >= 0.999


def test_fused_paged_spec_step_matches_jax(stacks):
    """One fused window step from an identical packed state (mirrors
    tests/test_spec.py's fused-vs-gather bar): emitted tokens and counts
    equal, and the window's dequantized pool rows within quantization
    tolerance."""
    jax_engine, params, engine = stacks
    prompt = [int(t) for t in np.random.RandomState(8).randint(0, 256, (9,))]
    width = 3
    tables = np.zeros((2, 64 // BLOCK), np.int32)
    tables[0, :2] = [1, 2]
    lengths = np.array([8, 0], np.int32)
    tokens = np.full((2, width), -1, np.int32)
    tokens[0, 0] = prompt[8]
    n_known = np.zeros((2,), np.int32)
    eos = np.full((2,), -1, np.int32)
    active = np.array([True, False])

    j_pool = jax_engine.make_paged_pool(params, 9, BLOCK)
    j_row, _ = jax_engine.prefill(params, np.asarray([prompt[:8]], np.int32))
    j_pool = jax_engine.pack_prefill(j_pool, np.array([1], np.int32), j_row,
                                     8, BLOCK)
    j_pool, j_emitted, j_counts, _ = jax_engine.paged_spec_step(
        params, j_pool, tables, lengths, tokens, n_known, eos,
        np.zeros((2, 2), np.uint32), active, block_size=BLOCK,
        decode_attention="fused")

    pool = engine.make_paged_pool(9, BLOCK)
    row, _ = engine.prefill(np.asarray([prompt[:8]], np.int32))
    pool = engine.pack_prefill(pool, np.array([1], np.int32), row, 8, BLOCK)
    pool, emitted, counts, _ = engine.paged_spec_step(
        pool, tables, lengths, tokens, n_known, eos, [None, None], active,
        block_size=BLOCK, decode_attention="fused")

    np.testing.assert_array_equal(counts, np.asarray(j_counts))
    assert int(counts[0]) == 1
    np.testing.assert_array_equal(emitted, np.asarray(j_emitted))
    for layer in range(2):
        attn = j_pool[f"layer_{layer}"]["block"]["attn"]
        for name in ("key", "value"):
            # JAX pool leaves keep a vestigial batch-1 axis [1, NB, ...];
            # the window wrote block 2, offsets 0..2.
            ref = (np.asarray(attn[f"cached_{name}"])[0, 2, :3]
                   * np.asarray(attn[f"cached_{name}_scale"])[0, 2, :3])
            got = (getattr(pool, name)[layer, 2, :3].float()
                   * getattr(pool, f"{name}_scale")[layer, 2, :3]).numpy()
            np.testing.assert_allclose(got, ref, atol=0.1, rtol=0.05)
        # The packed prefill block is bit-equal in codes.
        np.testing.assert_array_equal(
            pool.key[layer, 1].numpy(),
            np.asarray(attn["cached_key"])[0, 1])


def test_make_model_is_seeded():
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64)
    a = tt.make_model(cfg, seed=3, device="cpu")
    b = tt.make_model(cfg, seed=3, device="cpu")
    assert torch.equal(a.layers[0].attn.wq.kernel, b.layers[0].attn.wq.kernel)
    assert torch.equal(a.final_norm.scale, torch.ones(64))
