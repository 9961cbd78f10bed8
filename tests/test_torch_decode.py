"""The port's dense-cache decode held against the JAX package: the dense
int8 decode attention's plain version, `Transformer.prefill`/`decode`
over both cache dtypes, and `generate` through the decode engine.

Tiny f32 configs, the same flax weights crossing through
`models.weights.from_flax`; the JAX side runs its Pallas kernels in
interpret mode on the CPU, as its own tests do.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.models import decode_engine as t_engine
from tf_yarn_tpu_torch.models import generate as t_generate
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.weights import from_flax
from tf_yarn_tpu_torch.ops import attention as t_attention
from tf_yarn_tpu_torch.ops import decode_attention as t_decode
from tf_yarn_tpu_torch.ops import quantize as t_quantize

MAX_SEQ = 64


@functools.lru_cache(maxsize=None)
def _stacks(kv_cache_dtype):
    """(JAX model, flax params, port model) of one tiny f32 config; the
    tests only read the weights, so one build per dtype serves them."""
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    jcfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype=kv_cache_dtype, fused_norms=True,
        scan_layers=False, remat=False, max_seq_len=MAX_SEQ)
    jmodel = jt.Transformer(jcfg)
    params = nn.meta.unbox(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                    kv_cache_dtype=kv_cache_dtype)
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model


def _jit_decode(jmodel):
    """JAX's decode apply, jitted: (variables, tokens) -> (logits,
    {"cache": ...})."""
    return jax.jit(functools.partial(jmodel.apply, decode=True,
                                     mutable=["cache"]))


@pytest.fixture(scope="module", params=["bf16", "int8"])
def stacks(request):
    return (request.param,) + _stacks(request.param)


def _dense_cache(rng, batch, seq, n_kv, lengths):
    """int8 K/V [B, S, Hkv, 128] with NaN scales on each row's dead
    positions (they must not leak)."""
    x = rng.randn(batch, seq, n_kv, 128).astype(np.float32)
    kq, ks = t_quantize.quantize_int8_reference(torch.as_tensor(x * 2))
    vq, vs = t_quantize.quantize_int8_reference(
        torch.as_tensor(rng.randn(*x.shape).astype(np.float32)))
    dead = (np.arange(seq)[None, :] >= np.asarray(lengths)[:, None])
    dead = torch.as_tensor(dead)[:, :, None, None]
    ks = torch.where(dead, float("nan"), ks)
    vs = torch.where(dead, float("nan"), vs)
    return kq, ks, vq, vs


# (group, per-row lengths) over S = 40 with JAX block_k = 16 (S is not a
# multiple of the tile): lengths 1, mid and S, mixed within one batch.
DECODE_CASES = {
    "g1_short": (1, [1, 1]),
    "g1_mixed": (1, [1, 23, 40]),
    "g2_mid": (2, [20, 7]),
    "g2_mixed": (2, [40, 1, 17]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_int8_decode_reference_matches_jax(case):
    from tf_yarn_tpu.ops.decode_attention import int8_decode_attention

    group, lengths = DECODE_CASES[case]
    rng = np.random.RandomState(len(lengths) * 10 + group)
    batch, seq, n_kv = len(lengths), 40, 2
    q = rng.randn(batch, n_kv * group, 128).astype(np.float32)
    kq, ks, vq, vs = _dense_cache(rng, batch, seq, n_kv, lengths)
    got = t_decode.int8_decode_attention_reference(
        torch.as_tensor(q), kq, ks, vq, vs,
        torch.tensor(lengths, dtype=torch.int32))
    assert torch.isfinite(got).all()
    # The TPU kernel takes one scalar length for the batch: each row is
    # checked against the call at its own length. f32: 1e-5.
    for length in sorted(set(lengths)):
        ref = int8_decode_attention(
            jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()),
            jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()), length,
            block_k=16, interpret=True)
        for row in (i for i, n in enumerate(lengths) if n == length):
            np.testing.assert_allclose(got[row].numpy(),
                                       np.asarray(ref)[row],
                                       atol=1e-5, rtol=1e-5)


def test_int8_decode_reference_empty_inputs_give_zeros():
    q = torch.randn(2, 4, 128)
    empty = torch.zeros(2, 0, 2, 128, dtype=torch.int8)
    scale = torch.zeros(2, 0, 2, 1)
    lengths = torch.zeros(2, dtype=torch.int32)
    out = t_decode.int8_decode_attention(q, empty, scale, empty, scale, lengths)
    assert out.shape == q.shape and not out.any()
    kq, ks, vq, vs = _dense_cache(np.random.RandomState(0), 2, 8, 2, [0, 0])
    out = t_decode.int8_decode_attention(q, kq, ks, vq, vs, lengths)
    assert not out.any()  # a row of length 0: the clamped normaliser


def test_xla_attention_per_row_offset_matches_per_row_calls():
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(3, 2, 4, 16, generator=gen)
    k = torch.randn(3, 9, 2, 16, generator=gen)
    v = torch.randn(3, 9, 2, 16, generator=gen)
    offsets = torch.tensor([0, 4, 7], dtype=torch.int32)
    got = t_attention.xla_attention(q, k, v, segment_offset=offsets)
    for row, offset in enumerate(offsets.tolist()):
        ref = t_attention.xla_attention(q[row:row + 1], k[row:row + 1],
                                        v[row:row + 1], segment_offset=offset)
        torch.testing.assert_close(got[row:row + 1], ref, atol=0, rtol=0)


def test_default_bf16_cache_prefill_matches_jax():
    """The default kv_cache_dtype ("bf16") stores K/V in the compute
    dtype and never quantizes, as the JAX package does: prefill logits
    within 1e-5 of JAX's, and the cache rows equal its within 1e-5."""
    jmodel, params, model = _stacks("bf16")
    assert tt.TransformerConfig().kv_cache_dtype == "bf16"
    prompt = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    j_logits, state = _jit_decode(jmodel)(params, prompt)
    logits, rows = model.prefill(torch.as_tensor(prompt).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits[:, -1]),
                               atol=1e-5, rtol=1e-5)
    assert set(rows) == {"key", "value"}
    for layer in range(2):
        attn = state["cache"][f"layer_{layer}"]["block"]["attn"]
        for j_name, name in (("cached_key", "key"), ("cached_value", "value")):
            assert rows[name].dtype == torch.float32
            np.testing.assert_allclose(rows[name][layer].numpy(),
                                       np.asarray(attn[j_name])[:, :12],
                                       atol=1e-5, rtol=1e-5)


def test_kv_cache_dtype_is_validated_and_fused_needs_int8():
    _, _, model = _stacks("bf16")
    bad = tt.Transformer(
        tt.TransformerConfig.tiny(dtype=torch.float32, kv_cache_dtype="fp8"),
        device="cpu")
    with pytest.raises(ValueError, match="expected 'bf16' or 'int8'"):
        bad.prefill(torch.zeros(1, 4, dtype=torch.long))
    engine = t_engine.DecodeEngine(model)
    pool = engine.make_paged_pool(3, 16)
    assert pool.key.dtype == torch.float32 and pool.key_scale is None
    tables = np.zeros((1, MAX_SEQ // 16), np.int32)
    with pytest.raises(ValueError, match="kv_cache_dtype='int8'"):
        engine.paged_spec_step(pool, tables, [0], [[1]], [0], [-1], [None],
                               [True], block_size=16,
                               decode_attention="fused")
    sig = inspect.signature(t_engine.DecodeEngine.paged_spec_step)
    assert sig.parameters["decode_attention"].default == "gather"


def test_decode_matches_jax(stacks):
    """Prefill, three single-token steps and one W = 3 window through
    `Transformer.decode` against JAX's decode apply: logits within 1e-4
    (f32, sums in another order); int8 codes bit-equal (quantize is
    bit-equal on equal input; K and V come out of products summed in
    another order, which moves a row's absmax, so its scale, by a few
    ulps: rtol 1e-5), f32 rows within 1e-5."""
    kv, jmodel, params, model = stacks
    prompt = np.random.RandomState(2).randint(0, 256, (2, 10)).astype(np.int32)
    apply = _jit_decode(jmodel)
    _, state = apply(params, prompt)
    j_cache = state["cache"]
    _, rows = model.prefill(torch.as_tensor(prompt).long())
    cache = model.make_cache(2)
    cache.insert(rows)
    for window in ([[3], [4]], [[5], [6]], [[7], [8]],
                   [[1, 2, 3], [4, 5, 6]]):
        window = np.asarray(window, np.int32)
        j_logits, state = apply({**params, "cache": j_cache}, window)
        j_cache = state["cache"]
        logits = model.decode(torch.as_tensor(window).long(), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4, rtol=1e-4)
    assert cache.index.tolist() == [16, 16]
    for layer in range(2):
        attn = j_cache[f"layer_{layer}"]["block"]["attn"]
        for name in ("key", "value"):
            ref = np.asarray(attn[f"cached_{name}"])[:, :16]
            got = getattr(cache, name)[layer, :, :16].numpy()
            if kv == "int8":
                np.testing.assert_array_equal(got, ref)
                np.testing.assert_allclose(
                    getattr(cache, f"{name}_scale")[layer, :, :16].numpy(),
                    np.asarray(attn[f"cached_{name}_scale"])[:, :16],
                    rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# (batch, prompt length, eos): batch 1 on a prompt bucket; batch 3
# (padded to the bucket 4) with a prompt of 11 (prefill at 8, three
# replayed) and an eos that ends generation early.
GENERATE_CASES = {"b1_bucket": (1, 8, False), "b3_rest_eos": (3, 11, True)}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_greedy_matches_jax(stacks, case):
    from tf_yarn_tpu.models.generate import generate as jax_generate

    kv, jmodel, params, model = stacks
    batch, prompt_len, with_eos = GENERATE_CASES[case]
    prompt = np.random.RandomState(prompt_len).randint(
        0, 256, (batch, prompt_len)).astype(np.int32)
    eos = None
    if with_eos:
        # An eos the greedy stream emits early in row 0.
        free = t_generate.generate(model, prompt, 6).numpy()
        eos = int(free[0, prompt_len + 1])
    got = t_generate.generate(model, prompt, 6, eos_token=eos)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len + 6)
    ref = jax_generate(jmodel, params, prompt, 6, eos_token=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if with_eos:
        assert (got.numpy()[0, prompt_len + 1:] == eos).all()
        stats = t_engine.get_engine(model).stats
        assert stats["calls"] >= 2 and stats["prefill_calls"] >= 2


def test_generate_equals_legacy_sampled_and_greedy():
    """At temperature 0.8 with top_k the engine's generate (bucketed
    prefill + replay) draws exactly what generate_legacy draws at the
    same seed, on a batch that is its own bucket; greedy agrees on a
    padded batch too."""
    _, _, model = _stacks("int8")
    engine = t_engine.DecodeEngine(model)
    prompt = np.random.RandomState(5).randint(0, 256, (2, 11)).astype(np.int32)
    kwargs = dict(temperature=0.8, top_k=20, seed=7)
    sampled = engine.generate(prompt, 8, **kwargs)
    legacy = t_generate.generate_legacy(model, prompt, 8, **kwargs)
    np.testing.assert_array_equal(sampled.numpy(), legacy.numpy())
    other_seed = engine.generate(prompt, 8, temperature=0.8, top_k=20, seed=8)
    assert not torch.equal(other_seed, sampled)
    prompt3 = np.random.RandomState(6).randint(0, 256, (3, 13)).astype(np.int32)
    np.testing.assert_array_equal(
        engine.generate(prompt3, 5).numpy(),
        t_generate.generate_legacy(model, prompt3, 5).numpy())
    assert engine.generate(prompt, 0).shape == (2, 11)
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.generate(prompt, MAX_SEQ)


def test_generate_chunks_oversized_batches():
    _, _, model = _stacks("bf16")
    engine = t_engine.DecodeEngine(model, batch_buckets=(1, 2))
    prompt = np.random.RandomState(9).randint(0, 256, (3, 8)).astype(np.int32)
    got = engine.generate(prompt, 4)
    assert engine.stats["oversize_batch_chunks"] == 1
    assert engine.stats["calls"] == 2
    np.testing.assert_array_equal(
        got.numpy(), t_generate.generate_legacy(model, prompt, 4).numpy())
