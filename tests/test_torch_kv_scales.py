"""Per-block KV scales in the port held against the JAX package: the
grouped quantize (`ops.quantize.quantize_int8_grouped` and its inverse)
bit for bit, and the paged decode and window attention's plain versions
over scale pools of one scale a (block, kv head) — ``sb = 1`` — against
the TPU kernel in interpret mode, at the shapes of tests/test_ops.py's
per-block cases, with a trash block whose scales are NaN. The CUDA
kernels at ``sb = 1`` are held against these plain versions by
tests/test_torch_kernels.py on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf_yarn_tpu_torch.ops import decode_attention as t_decode
from tf_yarn_tpu_torch.ops import quantize as t_quantize


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (shape, group_rows, magnitude): tests/test_ops.py:557's shape and group,
# one row a group, the whole axis as one group, a leading axis of none,
# and an all-zero group (the 1e-8 floor).
GROUPED_CASES = {
    "test_ops_shape": ((4, 64, 16), 8, 2.0),
    "one_row_a_group": ((3, 12, 16), 1, 1.0),
    "whole_axis": ((2, 32, 8), 32, 40.0),
    "no_lead": ((24, 16), 4, 1e-3),
    "zero_group": ((2, 16, 16), 8, 0.0),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_quantize_bit_equal_to_jax(case):
    from tf_yarn_tpu.ops.quantize import (
        dequantize_int8_grouped,
        quantize_int8_grouped,
    )

    shape, group_rows, magnitude = GROUPED_CASES[case]
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * magnitude).astype(np.float32)
    values, scales = quantize_int8_grouped(jnp.asarray(x), group_rows)
    got_v, got_s = t_quantize.quantize_int8_grouped(_t(x), group_rows)
    assert got_v.dtype == torch.int8 and got_v.shape == x.shape
    assert tuple(got_s.shape) == tuple(scales.shape) == \
        shape[:-2] + (shape[-2] // group_rows, 1)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(values))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scales))
    back = np.asarray(dequantize_int8_grouped(values, scales, group_rows))
    got = t_quantize.dequantize_int8_grouped(got_v, got_s, group_rows)
    np.testing.assert_array_equal(got.numpy(), back)
    # The JAX test's bound: half the group's coarser step.
    step = float(got_s.max())
    assert np.abs(got.numpy() - x).max() <= step * 0.51 + 1e-6


def test_grouped_quantize_is_the_kernel_on_grouped_rows():
    """A group of rows is one long row: the scales are those of
    `quantize_int8` on the rows joined, and bf16 input is read exactly."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(3, 8, 16, 32).astype(np.float32)) \
        .to(torch.bfloat16)
    values, scales = t_quantize.quantize_int8_grouped(x, 16)
    ref_v, ref_s = t_quantize.quantize_int8_reference(x.reshape(3, 8, 1, 512))
    assert torch.equal(values, ref_v.reshape(x.shape))
    assert torch.equal(scales, ref_s)


@pytest.mark.parametrize("group_rows, match", [(0, "group_rows must be >= 1"),
                                               (-2, "group_rows must be >= 1"),
                                               (7, "must divide by")])
def test_grouped_quantize_refuses_like_jax(group_rows, match):
    from tf_yarn_tpu.ops.quantize import quantize_int8_grouped

    x = np.zeros((4, 64, 16), np.float32)
    with pytest.raises(ValueError, match=match) as port:
        t_quantize.quantize_int8_grouped(_t(x), group_rows)
    with pytest.raises(ValueError, match=match) as reference:
        quantize_int8_grouped(jnp.asarray(x), group_rows)
    assert str(port.value) == str(reference.value)


def _per_block_pool(rng, num_blocks, block_size, n_kv, head_dim):
    """K and V pools [NB, bs, Hkv, D] quantized with one scale a (block,
    kv head) through the port's grouped quantize; trash block 0's scales
    are NaN garbage."""
    pools = []
    for magnitude in (2.0, 1.0):
        x = (rng.randn(num_blocks, block_size, n_kv, head_dim)
             * magnitude).astype(np.float32)
        # [NB, Hkv, bs, D]: each (block, head)'s rows as one group.
        grouped = _t(x).permute(0, 2, 1, 3)
        values, scales = t_quantize.quantize_int8_grouped(grouped, block_size)
        values = values.permute(0, 2, 1, 3).contiguous().numpy()
        scales = scales.reshape(num_blocks, 1, n_kv, 1).numpy().copy()
        scales[0] = np.nan
        pools += [values, scales]
    return pools


def _tables(rng, lengths, width, block_size, max_blocks, num_blocks):
    """Shuffled tables whose entries past each slot's window point at the
    trash block."""
    tables = np.zeros((len(lengths), max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, num_blocks))
    for s, length in enumerate(lengths):
        used = min(max_blocks, -(-(int(length) + width) // block_size))
        tables[s, :used] = ids[s * max_blocks:s * max_blocks + used]
    return tables


# (width, lengths, block_size, max_blocks, n_heads, n_kv, head_dim):
# tests/test_ops.py:676's case (slots 2, 4/2 heads, D 64, bs 32, lengths
# [40, 64]) one token and windowed; a window that crosses blocks; a slot
# with no position; one kv head.
PER_BLOCK_CASES = {
    "test_ops_shape": (1, [40, 64], 32, 3, 4, 2, 64),
    "test_ops_shape_window3": (3, [40, 64], 32, 3, 4, 2, 64),
    "window5_pages8": (5, [0, 6, 21], 8, 4, 8, 2, 32),
    "kv1": (2, [3, 17], 16, 2, 4, 1, 32),
}


@pytest.mark.parametrize("case", sorted(PER_BLOCK_CASES))
def test_per_block_paged_attention_matches_jax_kernel(case):
    from tf_yarn_tpu.ops.decode_attention import (
        paged_int8_decode_attention,
        paged_int8_window_attention,
    )

    width, lengths, block_size, max_blocks, n_heads, n_kv, head_dim = \
        PER_BLOCK_CASES[case]
    slots = len(lengths)
    num_blocks = slots * max_blocks + 1
    rng = np.random.RandomState(7)
    kq, ks, vq, vs = _per_block_pool(rng, num_blocks, block_size, n_kv,
                                     head_dim)
    lengths = np.array(lengths, np.int32)
    tables = _tables(rng, lengths, width, block_size, max_blocks, num_blocks)
    q = rng.randn(slots, width, n_heads, head_dim).astype(np.float32)
    pool = [jnp.asarray(a) for a in (kq, ks, vq, vs, tables)]
    ported = [_t(a) for a in (kq, ks, vq, vs, tables)]
    expected = np.asarray(paged_int8_window_attention(
        jnp.asarray(q), *pool, jnp.asarray(lengths)))
    got = t_decode.paged_int8_window_attention(_t(q), *ported, _t(lengths))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-5)
    # The one-token form over each slot's whole length (the window's first
    # position), against the JAX single-token kernel.
    expected_one = np.asarray(paged_int8_decode_attention(
        jnp.asarray(q[:, 0]), *pool, jnp.asarray(lengths + 1)))
    one = t_decode.paged_int8_decode_attention(_t(q[:, 0]), *ported,
                                               _t(lengths + 1))
    assert np.isfinite(one.numpy()).all()
    np.testing.assert_allclose(one.numpy(), expected_one, atol=1e-5)
    np.testing.assert_allclose(one.numpy(), got.numpy()[:, 0], atol=1e-6)


def test_per_block_scales_equal_their_per_row_broadcast():
    """A per-block pool gives the output of the per-row pool that repeats
    each block's scale over its rows, the NaN trash block included."""
    width, lengths, block_size, max_blocks = 2, [5, 30], 8, 5
    num_blocks = len(lengths) * max_blocks + 1
    rng = np.random.RandomState(11)
    kq, ks, vq, vs = _per_block_pool(rng, num_blocks, block_size, 2, 32)
    tables = _tables(rng, lengths, width, block_size, max_blocks, num_blocks)
    q = _t(rng.randn(len(lengths), width, 4, 32).astype(np.float32))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    per_block = t_decode.paged_int8_window_attention(
        q, _t(kq), _t(ks), _t(vq), _t(vs), _t(tables), lengths)
    per_row = t_decode.paged_int8_window_attention(
        q, _t(kq), _t(ks).expand(-1, block_size, -1, -1).contiguous(),
        _t(vq), _t(vs).expand(-1, block_size, -1, -1).contiguous(),
        _t(tables), lengths)
    assert torch.isfinite(per_block).all()
    assert torch.equal(per_block, per_row)
