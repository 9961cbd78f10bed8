"""The port's ops (tf_yarn_tpu_torch/ops) held against the JAX package.

Each op's plain torch version gets the same seeded numpy inputs as its
JAX counterpart; the JAX side runs its Pallas kernels in interpret mode
on the CPU, as tests/test_ops.py does. The CUDA kernels themselves are
held against the plain versions by tests/test_torch_kernels.py, which
needs the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.ops import attention as t_attention
from tf_yarn_tpu_torch.ops import decode_attention as t_decode
from tf_yarn_tpu_torch.ops import quantize as t_quantize
from tf_yarn_tpu_torch.ops import rmsnorm as t_rmsnorm
from tf_yarn_tpu_torch.models import generate as t_generate


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rmsnorm_matches_jax_kernel():
    from tf_yarn_tpu.ops.rmsnorm import rmsnorm

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 3).astype(np.float32)
    scale = rng.randn(64).astype(np.float32)
    expected = np.asarray(rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = t_rmsnorm.rmsnorm(_t(x), _t(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 40.0])
def test_quantize_int8_bit_equal_to_jax_kernel(magnitude):
    from tf_yarn_tpu.ops.quantize import quantize_int8

    rng = np.random.RandomState(1)
    x = (rng.randn(4, 6, 128) * magnitude).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    values, scales = quantize_int8(jnp.asarray(x))
    got_v, got_s = t_quantize.quantize_int8(_t(x))
    assert got_v.dtype == torch.int8 and got_s.shape == (4, 6, 1)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(values))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scales))


def test_quantize_rounds_half_to_even_and_refuses_stochastic():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    values, scales = t_quantize.quantize_int8(x)
    assert float(scales) == 1.0
    assert values.tolist() == [[127, 0, 2, 2, 0, -2]]
    with pytest.raises(ValueError, match="stochastic"):
        t_quantize.quantize_int8(x, stochastic=True)


def _paged_pool(rng, num_blocks, block_size, n_kv, head_dim):
    x = rng.randn(num_blocks, block_size, n_kv, head_dim).astype(np.float32)
    from tf_yarn_tpu_torch.ops.quantize import quantize_int8_reference

    kq, ks = quantize_int8_reference(_t(x * 2.0))
    vq, vs = quantize_int8_reference(_t(rng.randn(*x.shape).astype(np.float32)))
    kq, ks, vq, vs = (a.numpy().copy() for a in (kq, ks, vq, vs))
    # Trash block 0 holds garbage, NaN scales included: any position
    # that reads it is dead and must not leak into the output.
    ks[0] = np.nan
    vs[0] = np.nan
    return kq, ks, vq, vs


def test_paged_window_attention_matches_jax_kernel():
    """W = 3 windows over a shuffled pool with per-row scales; table
    tails point at the NaN-garbage trash block."""
    from tf_yarn_tpu.ops.decode_attention import paged_int8_window_attention

    slots, width, n_heads, n_kv, head_dim = 3, 3, 8, 2, 32
    block_size, max_blocks, num_blocks = 8, 5, 16
    rng = np.random.RandomState(2)
    kq, ks, vq, vs = _paged_pool(rng, num_blocks, block_size, n_kv, head_dim)
    lengths = np.array([0, 9, 30], np.int32)
    tables = np.zeros((slots, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, num_blocks))
    for s, length in enumerate(lengths):
        used = -(-(int(length) + width) // block_size)
        tables[s, :used] = ids[s * max_blocks:s * max_blocks + used]
    q = rng.randn(slots, width, n_heads, head_dim).astype(np.float32)
    expected = np.asarray(paged_int8_window_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(tables), jnp.asarray(lengths)))
    got = t_decode.paged_int8_window_attention(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(tables), _t(lengths))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-5)
    # The one-token form is the window at W = 1 with no length offset.
    one = t_decode.paged_int8_decode_attention(
        _t(q[:, 0]), _t(kq), _t(ks), _t(vq), _t(vs), _t(tables),
        _t(lengths + 1))
    np.testing.assert_allclose(one.numpy(), expected[:, 0], atol=1e-5)


# (width, lengths, block_size, max_blocks, n_heads, n_kv) at head_dim 32,
# the card tests' shape families at a CPU size: pages of 4 and 16; lengths
# that fill whole pages, and a slot whose window runs to the table's end;
# windows of 5; one kv head (a group of 4) and three.
PAGED_CASES = {
    "pages4_w5": (5, [0, 3, 12], 4, 5, 4, 2),
    "pages16_multiples": (1, [16, 32, 15], 16, 3, 8, 2),
    "full_table": (2, [30, 7], 8, 4, 8, 2),
    "kv1": (3, [5, 21], 8, 4, 4, 1),
    "kv3": (1, [1, 40], 8, 6, 6, 3),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_window_attention_shapes_match_jax_kernel(case):
    """The plain version against the TPU kernel (interpret mode) over a
    shuffled pool whose table tails point at the NaN trash block."""
    from tf_yarn_tpu.ops.decode_attention import paged_int8_window_attention

    width, lengths, block_size, max_blocks, n_heads, n_kv = PAGED_CASES[case]
    slots, head_dim = len(lengths), 32
    num_blocks = slots * max_blocks + 1
    rng = np.random.RandomState(len(case))
    kq, ks, vq, vs = _paged_pool(rng, num_blocks, block_size, n_kv, head_dim)
    lengths = np.array(lengths, np.int32)
    tables = np.zeros((slots, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, num_blocks))
    for s, length in enumerate(lengths):
        used = min(max_blocks, -(-(int(length) + width) // block_size))
        tables[s, :used] = ids[s * max_blocks:s * max_blocks + used]
    q = rng.randn(slots, width, n_heads, head_dim).astype(np.float32)
    expected = np.asarray(paged_int8_window_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(tables), jnp.asarray(lengths)))
    got = t_decode.paged_int8_window_attention(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(tables), _t(lengths))
    assert np.isfinite(got.numpy()).all()
    # f32 on both sides, sums in another order.
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-5)


# (key scale rows, value scale rows) a block of 8 that neither layout
# has: 2 or 4 rows a block, or K and V in different layouts.
OTHER_SCALE_ROWS = {"sb2": (2, 2), "sb4": (4, 4), "row_key_block_value": (8, 1),
                    "block_key_row_value": (1, 8)}


@pytest.mark.parametrize("case", sorted(OTHER_SCALE_ROWS))
def test_paged_window_attention_rejects_other_scale_rows(case):
    """Scale pools must be per-row (sb = bs) or per-block (sb = 1), the
    same for K and V: anything else is refused with the JAX package's
    message, by both packages."""
    from tf_yarn_tpu.ops.decode_attention import paged_int8_decode_attention

    key_rows, value_rows = OTHER_SCALE_ROWS[case]
    pool = np.zeros((4, 8, 2, 32), np.int8)
    key_scale = np.ones((4, key_rows, 2, 1), np.float32)
    value_scale = np.ones((4, value_rows, 2, 1), np.float32)
    tables = np.zeros((1, 2), np.int32)
    lengths = np.ones(1, np.int32)
    with pytest.raises(ValueError, match="per-row \\(8\\) or per-block") as got:
        t_decode.paged_int8_window_attention(
            torch.zeros(1, 1, 4, 32), _t(pool), _t(key_scale), _t(pool),
            _t(value_scale), _t(tables), _t(lengths))
    with pytest.raises(ValueError, match="per-row") as reference:
        paged_int8_decode_attention(
            jnp.zeros((1, 4, 32)), jnp.asarray(pool), jnp.asarray(key_scale),
            jnp.asarray(pool), jnp.asarray(value_scale), jnp.asarray(tables),
            jnp.asarray(lengths))
    assert str(got.value) == str(reference.value)


@pytest.mark.parametrize("offset", [0, 5])
def test_xla_attention_matches_jax(offset):
    from tf_yarn_tpu.ops.attention import xla_attention

    rng = np.random.RandomState(3)
    q = rng.randn(2, 6, 8, 16).astype(np.float32)
    k = rng.randn(2, 6 + offset, 2, 16).astype(np.float32)
    v = rng.randn(2, 6 + offset, 2, 16).astype(np.float32)
    expected = np.asarray(xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_offset=offset))
    got = t_attention.xla_attention(_t(q), _t(k), _t(v), causal=True,
                                    segment_offset=offset)
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6)


@pytest.mark.parametrize("top_k, top_p", [(5, None), (None, 0.7), (40, 0.9)])
def test_sample_filter_masks_match_jax(monkeypatch, top_k, top_p):
    """The logits the JAX `_sample` hands to `jax.random.categorical`
    carry the top-k/top-p mask; the port's `filter_logits` must mask the
    same entries."""
    from tf_yarn_tpu.models import generate as j_generate

    captured = {}

    def spy(key, logits, axis=-1):
        captured["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[:-1], jnp.int32)

    monkeypatch.setattr(j_generate.jax.random, "categorical", spy)
    logits = np.random.RandomState(4).randn(3, 64).astype(np.float32)
    logits[1, 10] = logits[1, 11]  # a tie at the threshold survives both
    j_generate._sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.8,
                       top_k, top_p)
    masked = t_generate.filter_logits(_t(logits), 0.8, top_k, top_p).numpy()
    np.testing.assert_array_equal(masked <= -1e29,
                                  captured["logits"] <= -1e29)
    kept = masked > -1e29
    np.testing.assert_allclose(masked[kept], captured["logits"][kept],
                               rtol=1e-6)


def test_greedy_sample_is_argmax_and_sampling_uses_the_generator():
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    assert t_generate._sample(logits, None, 0.0, None).tolist() == \
        logits.argmax(-1).tolist()
    draws = [t_generate._sample(logits, torch.Generator().manual_seed(7),
                                1.0, 8, 0.9).tolist() for _ in range(2)]
    assert draws[0] == draws[1]


def test_cpu_tensors_take_the_plain_versions():
    before = (t_rmsnorm.rmsnorm.launches, t_quantize.quantize_int8.launches,
              t_decode.paged_int8_window_attention.launches)
    x = torch.randn(2, 64)
    t_rmsnorm.rmsnorm(x, torch.ones(64))
    t_quantize.quantize_int8(x)
    after = (t_rmsnorm.rmsnorm.launches, t_quantize.quantize_int8.launches,
             t_decode.paged_int8_window_attention.launches)
    assert after == before


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 128)])
def test_rmsnorm_dx_and_dscale_match_jax_vjp(shape):
    """The port's autograd through `rmsnorm` (the plain dx on the CPU)
    against `jax.vjp` of the JAX `rmsnorm` with the dx kernel
    (``kernel_bwd=True``, interpret mode). f32: sums in another order."""
    from tf_yarn_tpu.ops.rmsnorm import rmsnorm

    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s: rmsnorm(x, s, 1e-5, kernel_bwd=True),
                     jnp.asarray(x), jnp.asarray(scale))
    dx, dscale = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    t_rmsnorm.rmsnorm(tx, ts, 1e-5).backward(torch.tensor(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(dscale),
                               atol=1e-4, rtol=1e-5)
    # The plain dx alone is the same function.
    direct = t_rmsnorm.rmsnorm_bwd_dx(torch.tensor(x), torch.tensor(g),
                                      torch.tensor(scale))
    np.testing.assert_allclose(direct.numpy(), np.asarray(dx), atol=1e-5,
                               rtol=1e-5)


def test_cpu_rmsnorm_backward_takes_the_plain_versions():
    before = (t_rmsnorm.rmsnorm.launches, t_rmsnorm.rmsnorm_bwd_dx.launches)
    x = torch.randn(4, 64, requires_grad=True)
    t_rmsnorm.rmsnorm(x, torch.ones(64)).sum().backward()
    assert x.grad is not None
    assert (t_rmsnorm.rmsnorm.launches,
            t_rmsnorm.rmsnorm_bwd_dx.launches) == before


def test_quantize_int8_bf16_input_bit_equal_to_jax_kernel():
    """bf16 input, as the serving path hands the kernel K and V: the codes
    and scales of its exact f32 value, bit-equal to the JAX kernel
    (interpret mode) on that f32 copy; with an all-zero row (the 1e-8
    floor) and a row whose x / scale lands on exact halves."""
    from tf_yarn_tpu.ops.quantize import quantize_int8

    rng = np.random.RandomState(6)
    x = (rng.randn(3, 5, 128) * 3).astype(np.float32)
    x[0, 0] = 0.0
    halves = np.zeros(128, np.float32)
    halves[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]
    x[1, 2] = halves
    x_bf16 = _t(x).to(torch.bfloat16)
    exact = x_bf16.float().numpy()
    values, scales = quantize_int8(jnp.asarray(exact))
    got_v, got_s = t_quantize.quantize_int8(x_bf16)
    assert got_v.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(values))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scales))
    assert float(got_s[1, 2]) == 1.0
    assert got_v[1, 2, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows, d", [(3, 1024), (2, 4096)])
def test_rmsnorm_at_model_widths_matches_jax_kernel(rows, d, dtype):
    """The widths of the card's row layouts (a warp a row at d 1024, a
    block a row at Llama-3-8B's 4096) against the JAX kernel in interpret
    mode, from the same bf16 or f32 input. bf16: rtol 1/128, one ulp of
    the output; f32: 1e-6, sums in another order."""
    from tf_yarn_tpu.ops.rmsnorm import rmsnorm

    rng = np.random.RandomState(d + rows)
    x = (rng.randn(rows, d) * 3).astype(np.float32)
    scale = (rng.rand(d) + 0.5).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    expected = np.asarray(rmsnorm(jx, jnp.asarray(scale), 1e-5)
                          .astype(jnp.float32))
    got = t_rmsnorm.rmsnorm(tx, _t(scale), 1e-5)
    assert got.dtype == tx.dtype
    rtol = 1 / 128 if dtype == "bf16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=rtol,
                               atol=1e-6)


def test_serving_paths_quantize_kv_in_the_compute_dtype(monkeypatch):
    """`_cache_rows` (prefill) and the fused paged step of a bf16 config
    hand `quantize_int8` K and V in bf16, not cast to f32 first: the
    kernel converts in registers, so a cast would be a launch of its own
    on the card."""
    from tf_yarn_tpu_torch.models import transformer as tt

    seen = []
    real = tt.quantize_int8

    def spy(x, **kwargs):
        seen.append(x.dtype)
        return real(x, **kwargs)

    monkeypatch.setattr(tt, "quantize_int8", spy)
    cfg = tt.TransformerConfig.tiny(dtype=torch.bfloat16,
                                    kv_cache_dtype="int8")
    model = tt.make_model(cfg, seed=0, device="cpu")
    _logits, rows = model.prefill(torch.tensor([[1, 2, 3, 4, 5]]))
    assert rows["key"].dtype == torch.int8
    assert seen == [torch.bfloat16] * (2 * cfg.n_layers)
    seen.clear()
    pool = tt.PagedKVPool(**tt.zeroed_kv(cfg, (cfg.n_layers, 4, 8), "cpu"))
    logits = model.paged_decode(
        torch.tensor([[6]]), pool, torch.tensor([[1, 2]], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    assert seen == [torch.bfloat16] * (2 * cfg.n_layers)
