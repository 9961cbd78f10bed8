"""The port's CUDA kernels held against their plain torch versions on the
card. Every test here needs a CUDA device (the kernels have no CPU mode)
and skips without one. The file imports no JAX, so it runs on a machine
that has only torch (``--noconftest``: tests/conftest.py sets JAX up):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch.ops import decode_attention as t_decode
from tf_yarn_tpu_torch.ops import flash_attention as t_flash
from tf_yarn_tpu_torch.ops import groupnorm as t_groupnorm
from tf_yarn_tpu_torch.ops import layernorm as t_layernorm
from tf_yarn_tpu_torch.ops import quantize as t_quantize
from tf_yarn_tpu_torch.ops import rmsnorm as t_rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rows, dtype", [(8, torch.bfloat16),
                                         (512, torch.bfloat16),
                                         (3, torch.float32)])
def test_cuda_rmsnorm_kernel_matches_plain(cuda, rows, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, 4096, device=cuda, generator=gen) * 3).to(dtype)
    scale = torch.rand(4096, device=cuda, generator=gen) + 0.5
    launches = t_rmsnorm.rmsnorm.launches
    got = t_rmsnorm.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert t_rmsnorm.rmsnorm.launches == launches + 1
    assert got.dtype == dtype
    ref = t_rmsnorm.rmsnorm_reference(x, scale)
    # bf16: one ulp of the output; f32: sums in another order.
    rtol = 1 / 128 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("rows", [8 * 8, 512 * 8])
def test_cuda_quantize_kernel_matches_plain(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 128, device=cuda, generator=gen) * 3
    x[0] = 0.0  # the 1e-8 floor
    values, scales = t_quantize.quantize_int8(x)
    ref_v, ref_s = t_quantize.quantize_int8_reference(x)
    assert torch.equal(scales, ref_s)
    # At most one code may differ, where x / scale sits on a half.
    assert int((values != ref_v).sum()) <= 1


# (rows, d) of the RMSNorm forward's layouts: a block a row at d 4096 (one
# row, a decode tick's 4, a prefill's 300, the training slice's 2048), a
# warp a row at d 1024, and the looped kernel at d 64 and 771.
RMSNORM_CASES = [(1, 4096), (4, 4096), (300, 4096), (2048, 4096), (37, 1024),
                 (5, 64), (33, 771)]


def _rmsnorm_check(got, x, scale):
    ref = t_rmsnorm.rmsnorm_reference(x, scale)
    assert got.dtype == x.dtype
    # bf16: one ulp of the output; f32: sums in another order.
    rtol = 1 / 128 if x.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-6)


def _one_kernel(run, name):
    """`run()` launched exactly one device kernel, and its name holds
    `name`."""
    kernels = _device_kernels(run)
    assert len(kernels) == 1 and name in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 1, kernels


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("rows, d", RMSNORM_CASES)
def test_cuda_rmsnorm_forward_layouts_match_plain(cuda, rows, d, dtype):
    """Each layout against the plain version, bitwise equal over two
    calls, in one launch of the kernel its shape picks (the row kernel
    where d is a whole number of 16-byte vectors for each thread of a
    warp or a block, the looped one elsewhere)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, device=cuda, generator=gen) * 3).to(dtype)
    scale = torch.rand(d, device=cuda, generator=gen) + 0.5
    got, again = t_rmsnorm.rmsnorm(x, scale), t_rmsnorm.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _rmsnorm_check(got, x, scale)
    _one_kernel(lambda: t_rmsnorm.rmsnorm(x, scale),
                "rmsnorm_kernel<" if d in (64, 771) else "rmsnorm_row_kernel<")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_rmsnorm_unaligned_view_takes_the_looped_kernel(cuda, dtype):
    """A contiguous view one element into its storage is off 16-byte
    alignment: the looped kernel takes it."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    flat = (torch.randn(4 * 4096 + 1, device=cuda, generator=gen) * 3).to(dtype)
    x = flat[1:].view(4, 4096)
    assert x.is_contiguous() and x.data_ptr() % 16
    scale = torch.rand(4096, device=cuda, generator=gen) + 0.5
    got = t_rmsnorm.rmsnorm(x, scale)
    torch.cuda.synchronize()
    _rmsnorm_check(got, x, scale)
    _one_kernel(lambda: t_rmsnorm.rmsnorm(x, scale), "rmsnorm_kernel<")


def _quantize_check(x, values, scales):
    ref_v, ref_s = t_quantize.quantize_int8_reference(x)
    assert values.dtype == torch.int8 and scales.dtype == torch.float32
    assert torch.equal(scales, ref_s)
    # At most one code may differ, where x / scale sits on a half.
    diff = values != ref_v
    assert int(diff.sum()) <= 1
    if int(diff.sum()):
        ratio = (x.float() / ref_s)[diff]
        assert float((ratio.abs().frac() - 0.5).abs().max()) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [128, 200])
@pytest.mark.parametrize("rows", [1, 32, 4096])
def test_cuda_quantize_from_f32_and_bf16_matches_plain(cuda, rows, d, dtype):
    """bf16 input (the serving path's K and V) and f32, at head_dim 128
    (the row kernel) and 200 (the looped kernel's four-element loads):
    scales bit-equal, bitwise equal over two calls, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, device=cuda, generator=gen) * 3).to(dtype)
    x[0] = 0.0  # the 1e-8 floor
    values, scales = t_quantize.quantize_int8(x)
    again = t_quantize.quantize_int8(x)
    torch.cuda.synchronize()
    assert scales.shape == (rows, 1)
    assert torch.equal(values, again[0]) and torch.equal(scales, again[1])
    _quantize_check(x, values, scales)
    _one_kernel(lambda: t_quantize.quantize_int8(x),
                "quantize_int8_row_kernel<" if d == 128
                else "quantize_int8_kernel<")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_quantize_halves_and_unaligned_view(cuda, dtype):
    """Exact halves round to even as the plain version does; a view one
    element into its storage takes the looped kernel's scalar loads."""
    halves = torch.zeros(2, 128, device=cuda, dtype=dtype)
    halves[:, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5,
                                  -126.5], device=cuda, dtype=dtype)
    values, scales = t_quantize.quantize_int8(halves)
    torch.cuda.synchronize()
    assert scales.flatten().tolist() == [1.0, 1.0]
    assert values[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    gen = torch.Generator(device=cuda).manual_seed(12)
    flat = (torch.randn(32 * 128 + 1, device=cuda, generator=gen) * 3).to(dtype)
    x = flat[1:].view(32, 128)
    assert x.is_contiguous() and x.data_ptr() % 8
    values, scales = t_quantize.quantize_int8(x)
    torch.cuda.synchronize()
    _quantize_check(x, values, scales)
    _one_kernel(lambda: t_quantize.quantize_int8(x), "quantize_int8_kernel<")


def test_cuda_rmsnorm_and_quantize_refuse_bad_inputs(cuda):
    """A dtype the kernels do not take, or a non-contiguous tensor,
    raises instead of launching."""
    half = torch.randn(4, 128, device=cuda, dtype=torch.float16)
    strided = torch.randn(128, 4, device=cuda).t()
    scale = torch.ones(128, device=cuda)
    for bad, match in ((half, "dtype"), (strided, "contiguous")):
        with pytest.raises(ValueError, match=match):
            t_quantize.quantize_int8(bad)
        with pytest.raises(ValueError, match=match):
            t_rmsnorm.rmsnorm(bad, scale)


def _pool(gen, num_blocks, block_size, n_kv, head_dim, device):
    x = torch.randn(num_blocks, block_size, n_kv, head_dim, device=device,
                    generator=gen)
    kq, ks = t_quantize.quantize_int8_reference(x * 2)
    vq, vs = t_quantize.quantize_int8_reference(
        torch.randn(x.shape, device=device, generator=gen))
    ks[0] = float("nan")  # trash-block garbage must never leak
    vs[0] = float("nan")
    return kq, ks, vq, vs


# (dtype, width, lengths, block_size, max_blocks, n_heads, n_kv, head_dim)
# for the kernel's two instantiations (bf16 at GQA group 4, f32 at group
# 2, head_dim 128): windows over a short table; lengths on and around
# the kernel's 256-position split boundaries; a slot whose window runs
# past its table (positions are capped there); block sizes 8, 16 and 64;
# one slot of 8192 beside 63 of length 1 (33 splits merged by the last
# one, 63 slots of one split); lengths that are multiples of the page and
# of the split in the one-token form (the window form sees one more); 4,
# 2, 1 and 6 kv heads; windows of 3 in f32 and of 5 in bf16.
CASES = {
    "window3": (torch.bfloat16, 3, [1, 17, 60, 100], 16, 8, 32, 8, 128),
    "splits": (torch.bfloat16, 1, [0, 254, 255, 256, 511, 1000], 16, 64,
               32, 8, 128),
    "full_table": (torch.bfloat16, 3, [16 * 64 - 1, 300], 16, 64, 32, 8, 128),
    "block8": (torch.bfloat16, 2, [5, 130, 700], 8, 96, 32, 8, 128),
    "block64": (torch.bfloat16, 1, [5, 64, 130, 700, 0], 64, 12, 32, 8, 128),
    "skewed": (torch.bfloat16, 1, [8192] + [1] * 63, 16, 513, 32, 8, 128),
    "multiples": (torch.bfloat16, 1, [16, 32, 128, 256, 1024, 15, 127], 16,
                  65, 32, 8, 128),
    "kv4": (torch.bfloat16, 2, [3, 300, 1500], 16, 96, 16, 4, 128),
    "kv2": (torch.bfloat16, 1, [0, 129, 700], 16, 48, 8, 2, 128),
    "kv1": (torch.bfloat16, 3, [1, 200, 2000], 8, 256, 4, 1, 128),
    "window5": (torch.bfloat16, 5, [0, 31, 400], 16, 32, 32, 8, 128),
    "kv6": (torch.bfloat16, 2, [3, 300, 1500], 16, 96, 24, 6, 128),
    "f32_splits": (torch.float32, 2, [5, 255, 256, 700], 16, 48, 8, 4, 128),
    "f32_block8": (torch.float32, 1, [0, 130], 8, 32, 4, 2, 128),
    "f32_window3": (torch.float32, 3, [0, 40, 1000], 16, 72, 4, 2, 128),
}


def _inputs(device, width, lengths, block_size, max_blocks, n_heads, n_kv,
            head_dim, dtype):
    slots = len(lengths)
    gen = torch.Generator(device=device).manual_seed(5)
    num_blocks = slots * max_blocks + 1
    kq, ks, vq, vs = _pool(gen, num_blocks, block_size, n_kv, head_dim, device)
    rng = np.random.RandomState(5)
    tables = torch.tensor(
        rng.permutation(np.arange(1, num_blocks)).reshape(slots, max_blocks),
        dtype=torch.int32, device=device)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    # Table entries past each slot's window point at the trash block.
    live = (lengths.long() + width + block_size - 1) // block_size
    cols = torch.arange(max_blocks, device=device)[None, :]
    tables = torch.where(cols < live[:, None], tables, torch.zeros_like(tables))
    q = torch.randn(slots, width, n_heads, head_dim, device=device,
                    generator=gen).to(dtype)
    return q, kq, ks, vq, vs, tables, lengths


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_paged_window_kernel_matches_plain(cuda, case):
    dtype, width, *shape = CASES[case]
    args = _inputs(cuda, width, *shape, dtype)
    q, kq, ks, vq, vs, tables, lengths = args
    launches = t_decode.paged_int8_window_attention.launches
    got = t_decode.paged_int8_window_attention(*args)
    torch.cuda.synchronize()
    assert t_decode.paged_int8_window_attention.launches == launches + 1
    ref = t_decode.paged_int8_window_attention_reference(*args)
    assert torch.isfinite(got).all()
    # bf16: a bf16 output and sums in another order; f32: the order only.
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    # The one-token form: no length offset, so an empty slot gives zeros.
    one = t_decode.paged_int8_decode_attention(q[:, 0].contiguous(), kq, ks,
                                               vq, vs, tables, lengths)
    one_ref = t_decode.paged_int8_window_attention_reference(
        q[:, :1], kq, ks, vq, vs, tables, lengths, length_offset=0)[:, 0]
    torch.testing.assert_close(one.float(), one_ref.float(), atol=tol, rtol=tol)


def _per_block(kq, ks, vq, vs, block_size):
    """The pools re-quantized with one scale a (block, kv head) through
    `quantize_int8_grouped` (on the pools' device), trash block 0's
    scales NaN: (kq, ks [NB, 1, Hkv, 1], vq, vs)."""
    out = []
    for values, scales in ((kq, ks), (vq, vs)):
        x = (values.float() * torch.nan_to_num(scales)).permute(0, 2, 1, 3)
        q, s = t_quantize.quantize_int8_grouped(x, block_size)
        s = s.reshape(x.shape[0], 1, x.shape[1], 1).clone()
        s[0] = float("nan")
        out += [q.permute(0, 2, 1, 3).contiguous(), s]
    return out


# CASES at per-block scales: splits whose 256-position boundaries fall
# inside blocks of 8, 16 and 64, the skewed slots, windows, f32.
PER_BLOCK_CASES = ("splits", "block8", "block64", "skewed", "window5",
                   "kv1", "f32_splits", "f32_window3")


@pytest.mark.parametrize("case", PER_BLOCK_CASES)
def test_cuda_paged_kernels_take_per_block_scales(cuda, case):
    """sb = 1: each position reads its physical block's scale, and a dead
    row gets exactly 0 whatever its block's scale."""
    dtype, width, *shape = CASES[case]
    q, kq, ks, vq, vs, tables, lengths = _inputs(cuda, width, *shape, dtype)
    kq, ks, vq, vs = _per_block(kq, ks, vq, vs, shape[1])
    args = (q, kq, ks, vq, vs, tables, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    launches = t_decode.paged_int8_window_attention.launches
    got = t_decode.paged_int8_window_attention(*args)
    torch.cuda.synchronize()
    assert t_decode.paged_int8_window_attention.launches == launches + 1
    assert torch.isfinite(got).all()
    ref = t_decode.paged_int8_window_attention_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    one = t_decode.paged_int8_decode_attention(q[:, 0].contiguous(), kq, ks,
                                               vq, vs, tables, lengths)
    one_ref = t_decode.paged_int8_window_attention_reference(
        q[:, :1], kq, ks, vq, vs, tables, lengths, length_offset=0)[:, 0]
    torch.testing.assert_close(one.float(), one_ref.float(), atol=tol, rtol=tol)
    assert torch.equal(one, t_decode.paged_int8_decode_attention(
        q[:, 0].contiguous(), kq, ks, vq, vs, tables, lengths))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_grouped_quantize_is_one_kernel_launch(cuda, dtype):
    """The paged pool's per-(block, head) groups of 16 rows of 128: one
    launch of the general kernel at row width 2048, its codes and scales
    those of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = (torch.randn(64, 8, 16, 128, device=cuda, generator=gen) * 3).to(dtype)
    launches = t_quantize.quantize_int8.launches
    values, scales = t_quantize.quantize_int8_grouped(x, 16)
    torch.cuda.synchronize()
    assert t_quantize.quantize_int8.launches == launches + 1
    assert values.shape == x.shape and scales.shape == (64, 8, 1, 1)
    _quantize_check(x.reshape(64, 8, 1, 2048), values.reshape(64, 8, 1, 2048),
                    scales)
    _one_kernel(lambda: t_quantize.quantize_int8_grouped(x, 16),
                "quantize_int8_kernel<")


# (dtype, n_heads, n_kv, head_dim) the kernel is not built for.
@pytest.mark.parametrize("dtype, n_heads, n_kv, head_dim", [
    (torch.bfloat16, 64, 8, 128), (torch.bfloat16, 16, 4, 64),
    (torch.float32, 32, 8, 128)])
def test_cuda_paged_window_kernel_refuses_other_configs(cuda, dtype, n_heads,
                                                        n_kv, head_dim):
    args = _inputs(cuda, 1, [3, 40], 16, 4, n_heads, n_kv, head_dim, dtype)
    launches = t_decode.paged_int8_window_attention.launches
    with pytest.raises(ValueError, match="paged kernel is built for"):
        t_decode.paged_int8_window_attention(*args)
    assert t_decode.paged_int8_window_attention.launches == launches


def _dense_inputs(device, lengths, seq, n_heads, n_kv, head_dim, dtype):
    """A dense int8 cache [B, S, Hkv, D] whose dead rows (past each row's
    length) carry NaN scales, which must never leak."""
    batch = len(lengths)
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(batch, seq, n_kv, head_dim, device=device, generator=gen)
    kq, ks = t_quantize.quantize_int8_reference(x * 2)
    vq, vs = t_quantize.quantize_int8_reference(
        torch.randn(x.shape, device=device, generator=gen))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    dead = (torch.arange(seq, device=device)[None, :]
            >= lengths.long()[:, None])[:, :, None, None]
    ks = torch.where(dead, float("nan"), ks)
    vs = torch.where(dead, float("nan"), vs)
    q = torch.randn(batch, n_heads, head_dim, device=device,
                    generator=gen).to(dtype)
    return q, kq, ks, vq, vs, lengths


# (dtype, lengths, seq_len, n_heads, n_kv, head_dim) for the dense
# kernel's two instantiations: lengths 1, 15, 16, 17 and S; S not a
# multiple of the 128-row tile or the 256-row split; around the split
# boundary; one row of length 0; batches from 1 to 64; one row of 8192
# beside 63 of length 1; 2 and 6 kv heads in bf16.
DENSE_CASES = {
    "short": (torch.bfloat16, [1, 15, 16, 17, 200], 200, 32, 8, 128),
    "tail": (torch.bfloat16, [300, 257, 256, 255, 0, 129], 300, 32, 8, 128),
    "one_row": (torch.bfloat16, [1000], 1000, 32, 8, 128),
    "batch64": (torch.bfloat16, [(37 * i) % 700 + 1 for i in range(64)], 700,
                32, 8, 128),
    "skewed": (torch.bfloat16, [8192] + [1] * 63, 8192, 32, 8, 128),
    "kv2": (torch.bfloat16, [1, 300, 129], 300, 8, 2, 128),
    "kv6": (torch.bfloat16, [1, 300, 1029], 1100, 24, 6, 128),
    "f32_short": (torch.float32, [1, 15, 16, 17, 90], 90, 8, 4, 128),
    "f32_tail": (torch.float32, [513, 1, 256, 40], 513, 4, 2, 128),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_cuda_dense_decode_kernel_matches_plain(cuda, case):
    dtype, lengths, seq, n_heads, n_kv, head_dim = DENSE_CASES[case]
    args = _dense_inputs(cuda, lengths, seq, n_heads, n_kv, head_dim, dtype)
    launches = t_decode.int8_decode_attention.launches
    got = t_decode.int8_decode_attention(*args)
    torch.cuda.synchronize()
    assert t_decode.int8_decode_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.isfinite(got).all()
    ref = t_decode.int8_decode_attention_reference(*args)
    # bf16: a bf16 output and sums in another order; f32: the order only.
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert all(float(got[i].abs().max()) == 0.0 for i in zero)


# (dtype, n_heads, n_kv, head_dim) the dense kernel is not built for.
@pytest.mark.parametrize("dtype, n_heads, n_kv, head_dim", [
    (torch.bfloat16, 64, 8, 128), (torch.bfloat16, 16, 4, 64),
    (torch.float32, 32, 8, 128)])
def test_cuda_dense_decode_kernel_refuses_other_configs(cuda, dtype, n_heads,
                                                        n_kv, head_dim):
    args = _dense_inputs(cuda, [3, 40], 64, n_heads, n_kv, head_dim, dtype)
    launches = t_decode.int8_decode_attention.launches
    with pytest.raises(ValueError, match="dense kernel is built for"):
        t_decode.int8_decode_attention(*args)
    assert t_decode.int8_decode_attention.launches == launches


def _decode_calls(cuda, dtype):
    """The three decode wrappers, each with inputs whose long slot the
    kernels split over several blocks."""
    lengths = [3000, 1, 17, 600]
    group = t_decode.KERNEL_GROUPS[dtype]
    paged = _inputs(cuda, 3, lengths, 16, 200, 8 * group, 8, 128, dtype)
    q, kq, ks, vq, vs, tables, lens = paged
    dense = _dense_inputs(cuda, lengths, 3000, 8 * group, 8, 128, dtype)
    return {
        "window": (t_decode.paged_int8_window_attention, paged),
        "one_token": (t_decode.paged_int8_decode_attention,
                      (q[:, 0].contiguous(), kq, ks, vq, vs, tables, lens)),
        "dense": (t_decode.int8_decode_attention, dense),
    }


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("call", ["window", "one_token", "dense"])
def test_cuda_decode_kernels_are_deterministic_and_graph_safe(cuda, call,
                                                              dtype):
    """Two calls give the same bits (splits merge in split order), and a
    CUDA graph of a call, replayed twice, gives the eager bits (the last
    split of each slot and kv head resets its ticket)."""
    fn, args = _decode_calls(cuda, dtype)[call]
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn(*args)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)


@pytest.mark.parametrize("call", ["window", "one_token", "dense"])
def test_cuda_decode_wrappers_make_one_launch(cuda, call):
    """Each wrapper call runs one CUDA kernel on the device, the decode
    kernel: no memset, no combine launch."""
    fn, args = _decode_calls(cuda, torch.bfloat16)[call]
    fn(*args)
    torch.cuda.synchronize()
    ran = _device_kernels(lambda: fn(*args))
    assert len(ran) == 1 and "decode_kernel" in next(iter(ran)), ran
    assert next(iter(ran.values())) == 1, ran


def test_cuda_decode_tickets_survive_growth_and_other_streams(cuda):
    """A CUDA graph captured before a larger call grew the ticket buffer
    still replays to the eager bits (the old buffer is kept), and calls
    that alternate between two streams give the bits of the default
    stream's call (each waits for the other's last launch)."""
    fn, args = _decode_calls(cuda, torch.bfloat16)["window"]
    first = fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn(*args)
    big = t_decode._ticket_buffer(cuda, 0).numel() // 8 + 1
    _, kq, ks, vq, vs, _, _ = args
    q_big = torch.randn(big, 1, 32, 128, device=cuda).to(torch.bfloat16)
    # Every slot reads block 1 twenty times over: two splits to merge.
    tables = torch.ones(big, 20, dtype=torch.int32, device=cuda)
    lens = torch.full((big,), 300, dtype=torch.int32, device=cuda)
    grown = fn(q_big, kq, ks, vq, vs, tables, lens)
    assert t_decode._ticket_buffer(cuda, 0).numel() >= big * 8
    torch.testing.assert_close(
        grown.float(),
        t_decode.paged_int8_window_attention_reference(
            q_big, kq, ks, vq, vs, tables, lens).float(),
        atol=2e-2, rtol=2e-2)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for i in range(6):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(fn(*args))
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, first)


@pytest.mark.parametrize("rows, dtype", [(8, torch.bfloat16),
                                         (2048, torch.bfloat16),
                                         (3, torch.float32)])
def test_cuda_rmsnorm_dx_kernel_matches_plain(cuda, rows, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows + 1)
    x = (torch.randn(rows, 4096, device=cuda, generator=gen) * 3).to(dtype)
    g = torch.randn(rows, 4096, device=cuda, generator=gen).to(dtype)
    scale = torch.rand(4096, device=cuda, generator=gen) + 0.5
    launches = t_rmsnorm.rmsnorm_bwd_dx.launches
    got = t_rmsnorm.rmsnorm_bwd_dx(x, g, scale)
    torch.cuda.synchronize()
    assert t_rmsnorm.rmsnorm_bwd_dx.launches == launches + 1
    assert got.dtype == dtype
    ref = t_rmsnorm.rmsnorm_bwd_dx_reference(x, g, scale)
    # bf16: one ulp of the output, plus cancellation between the two
    # terms (atol against the largest entry); f32: sums in another order.
    rtol = 1 / 128 if dtype == torch.bfloat16 else 1e-5
    atol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


def test_cuda_rmsnorm_autograd_launches_both_kernels(cuda):
    x = torch.randn(16, 4096, device=cuda, requires_grad=True)
    scale = torch.ones(4096, device=cuda, requires_grad=True)
    before = (t_rmsnorm.rmsnorm.launches, t_rmsnorm.rmsnorm_bwd_dx.launches)
    t_rmsnorm.rmsnorm(x, scale).pow(2).sum().backward()
    torch.cuda.synchronize()
    assert (t_rmsnorm.rmsnorm.launches, t_rmsnorm.rmsnorm_bwd_dx.launches) == (
        before[0] + 1, before[1] + 1)
    assert x.grad is not None and scale.grad.shape == (4096,)


@pytest.mark.parametrize("fused_norms", [True, False])
def test_cuda_model_norms_always_launch_the_kernel(cuda, fused_norms):
    from tf_yarn_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig.tiny(fused_norms=fused_norms)
    model = tt.make_model(cfg, seed=0, device=cuda)
    before = t_rmsnorm.rmsnorm.launches
    with torch.no_grad():
        logits = model(torch.zeros(1, 8, dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    # One norm before attention and one before the MLP in each layer,
    # and the final norm.
    assert t_rmsnorm.rmsnorm.launches == before + 2 * cfg.n_layers + 1
    assert torch.isfinite(logits).all()


# (batch, s_q, s_kv, n_heads, n_kv, head_dim, causal): GQA groups 1, 4
# and 8; tails that are not a multiple of the kernels' tiles (128 q rows
# of the forward and of dq, 64 kv rows of a dq step, 64 q rows of a dk/dv
# step); Skv > S (kv tiles with no live q row) and Skv < S; non-causal;
# head_dim 64 and 128.
FLASH_CASES = {
    "g1_d128": (1, 256, 256, 8, 8, 128, True),
    "g4_d64_tail": (2, 96, 96, 8, 2, 64, True),
    "g8_skv_gt_s": (1, 128, 192, 8, 1, 128, True),
    "g4_noncausal_tail": (1, 160, 160, 4, 1, 64, False),
    "g2_skv_lt_s": (1, 64, 32, 4, 2, 128, True),
    # Across the forward's 128-row tiles: a tail inside the second tile,
    # Skv > S over several kv tiles, and two batches without the mask.
    "g4_d128_tail_tile2": (1, 320, 320, 8, 2, 128, True),
    "g2_d64_skv_gt_s_tiles": (1, 384, 512, 4, 2, 64, True),
    "g4_b2_noncausal_tiles": (2, 256, 256, 8, 2, 128, False),
    # dk/dv's 128-row kv tiles, each split over two blocks: a kv tail
    # inside the second kv tile; Skv > S and not a multiple of 128; group
    # 1, whose halves are cut between q tiles, with an even and an odd
    # number of 64-row q tiles; two batches without the mask, Skv != S.
    "dkv_g4_d128_kv_tail_tile2": (1, 200, 200, 8, 2, 128, True),
    "dkv_g2_d64_skv_gt_s_ragged": (1, 160, 224, 4, 2, 64, True),
    "dkv_g1_d128_even_q_tiles": (1, 384, 384, 4, 4, 128, True),
    "dkv_g1_d64_odd_q_tiles": (1, 320, 320, 2, 2, 64, True),
    "dkv_g4_d64_b2_noncausal": (2, 192, 256, 8, 2, 64, False),
    # dq's 128-row q tiles over 64-row kv steps: a q tail one row past the
    # first tile (its second tile's upper warpgroup holds no row), and a
    # tail inside the third tile with Skv < S, not a multiple of 64.
    "dq_g1_d64_q_tail_row": (1, 130, 250, 2, 2, 64, True),
    "dq_g4_d128_tail_tile3_skv_lt_s": (1, 300, 260, 8, 2, 128, True),
}


def _flash_inputs(device, batch, s_q, s_kv, n_heads, n_kv, head_dim, dtype):
    gen = torch.Generator(device=device).manual_seed(s_q * 7 + s_kv)
    mk = lambda *shape: torch.randn(*shape, device=device, generator=gen).to(dtype)
    return (mk(batch, s_q, n_heads, head_dim), mk(batch, s_kv, n_kv, head_dim),
            mk(batch, s_kv, n_kv, head_dim), mk(batch, s_q, n_heads, head_dim))


def _assert_rel(got, ref, tol, name):
    """||got - ref|| / ||ref|| within tol over every 64-row block of the
    sequence axis (axis 1) of every batch, so no one large row sets the
    scale; a block whose reference is zero must come out exactly zero."""
    diff = (got.float() - ref.float()).transpose(0, 1)
    ref = ref.float().transpose(0, 1)
    for start in range(0, ref.shape[0], 64):
        for b in range(ref.shape[1]):
            err = float(diff[start:start + 64, b].norm())
            norm = float(ref[start:start + 64, b].norm())
            assert err <= tol * norm, (
                f"{name}: rows {start}.. of batch {b}: error norm {err} > "
                f"{tol} x reference norm {norm}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_kernels_match_plain(cuda, case, dtype):
    batch, s_q, s_kv, n_heads, n_kv, head_dim, causal = FLASH_CASES[case]
    q, k, v, dout = _flash_inputs(cuda, batch, s_q, s_kv, n_heads, n_kv,
                                  head_dim, dtype)
    counts = (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
              t_flash.flash_dkv.launches)
    out, lse = t_flash.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = t_flash.flash_fwd_reference(q, k, v, causal)
    delta = t_flash.flash_delta(ref_out, dout)
    dq = t_flash.flash_dq(q, k, v, dout, ref_lse, delta, causal)
    dk, dv = t_flash.flash_dkv(q, k, v, dout, ref_lse, delta, causal)
    torch.cuda.synchronize()
    assert (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
            t_flash.flash_dkv.launches) == tuple(c + 1 for c in counts)
    ref_dq = t_flash.flash_dq_reference(q, k, v, dout, ref_lse, delta, causal)
    ref_dk, ref_dv = t_flash.flash_dkv_reference(q, k, v, dout, ref_lse,
                                                 delta, causal)
    # bf16: outputs rounded to bf16 (relative 2^-9) and p/ds rounded to
    # bf16 at running maxima that differ between the 64-row kernel tiles
    # and the plain whole-row softmax; f32: sums in another order only.
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _assert_rel(out, ref_out, tol, "o")
    # The LSE is f32 from exact bf16 products: 1e-4 absolute.
    lse_err = float((lse - ref_lse).abs().max())
    assert lse_err <= 1e-4, f"lse: max abs err {lse_err}"
    _assert_rel(dq, ref_dq, tol, "dq")
    _assert_rel(dk, ref_dk, tol, "dk")
    _assert_rel(dv, ref_dv, tol, "dv")
    for name, t in (("o", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert torch.isfinite(t).all(), name
    if causal and s_kv > s_q:
        # kv rows past the last query have no live q row: exact zeros.
        assert torch.equal(dk[:, s_q:], torch.zeros_like(dk[:, s_q:]))
        assert torch.equal(dv[:, s_q:], torch.zeros_like(dv[:, s_q:]))


@pytest.mark.parametrize("head_dim", [64, 128])
def test_cuda_flash_dkv_is_bitwise_deterministic(cuda, head_dim):
    # Each kv tile's two blocks meet through f32 partials in whichever
    # order they finish; two addends commute, so dk and dv may not vary.
    q, k, v, dout = _flash_inputs(cuda, 1, 512, 512, 8, 2, head_dim,
                                  torch.bfloat16)
    ref_out, ref_lse = t_flash.flash_fwd_reference(q, k, v, True)
    delta = t_flash.flash_delta(ref_out, dout)
    first = t_flash.flash_dkv(q, k, v, dout, ref_lse, delta, True)
    for _ in range(3):
        again = t_flash.flash_dkv(q, k, v, dout, ref_lse, delta, True)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("head_dim", [64, 128])
def test_cuda_flash_dq_is_bitwise_deterministic(cuda, head_dim):
    # A q tile's dq is summed by one block over its own kv steps, with no
    # atomics and no partials: repeated calls may not vary.
    q, k, v, dout = _flash_inputs(cuda, 1, 512, 512, 8, 2, head_dim,
                                  torch.bfloat16)
    ref_out, ref_lse = t_flash.flash_fwd_reference(q, k, v, True)
    delta = t_flash.flash_delta(ref_out, dout)
    first = t_flash.flash_dq(q, k, v, dout, ref_lse, delta, True)
    for _ in range(3):
        again = t_flash.flash_dq(q, k, v, dout, ref_lse, delta, True)
        assert torch.equal(first, again)


def test_cuda_flash_autograd_launches_every_kernel(cuda):
    q, k, v, dout = _flash_inputs(cuda, 1, 128, 128, 8, 2, 128, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
              t_flash.flash_dkv.launches)
    out = t_flash.flash_attention(q, k, v, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
            t_flash.flash_dkv.launches) == tuple(c + 1 for c in counts)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert v.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype, head_dim", [(torch.float16, 128),
                                             (torch.bfloat16, 96),
                                             (torch.float32, 256)])
def test_cuda_flash_refuses_other_configs(cuda, dtype, head_dim):
    q = torch.zeros(1, 64, 4, head_dim, device=cuda, dtype=dtype)
    k = torch.zeros(1, 64, 2, head_dim, device=cuda, dtype=dtype)
    counts = t_flash.flash_fwd.launches
    with pytest.raises(ValueError):
        t_flash.flash_fwd(q, k, k)
    assert t_flash.flash_fwd.launches == counts


def test_cuda_flash_refuses_mixed_dtypes(cuda):
    q = torch.zeros(1, 64, 4, 128, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        t_flash.flash_fwd(q, k, k)


def test_cuda_dense_decode_paths_match_cpu(cuda):
    """A small f32 decoder (head_dim 128, GQA group 2: the f32
    instantiation) through the dense decode on the card and on the CPU
    from the same weights: a batch-3 prefill, three single-token steps
    (the kernel) and a window of 3 (the plain attention), then one
    gather-mode tick over a block pool. f32 sums in another order: 1e-3
    on the logits; tokens equal."""
    from tf_yarn_tpu_torch.models import decode_engine as t_engine
    from tf_yarn_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=256, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=512,
                               max_seq_len=64, dtype=torch.float32,
                               kv_cache_dtype="int8")
    cpu = tt.make_model(cfg, seed=1, device="cpu")
    card = tt.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, 256, (3, 11), generator=torch.Generator()
                           .manual_seed(2))
    windows = [prompt[:, :1], prompt[:, 1:2], prompt[:, 2:3], prompt[:, 3:6]]
    launches = t_decode.int8_decode_attention.launches
    outs = []
    for model in (card, cpu):
        logits, rows = model.prefill(prompt.to(model.device))
        cache = model.make_cache(3)
        cache.insert(rows)
        seen = [logits.cpu()]
        for window in windows:
            seen.append(model.decode(window.to(model.device), cache).cpu())
        engine = t_engine.DecodeEngine(model)
        pool = engine.make_paged_pool(9, 16)
        row, _ = engine.prefill(prompt[:1, :8])
        engine.pack_prefill(pool, [1], row, 8, 16)
        tables = np.zeros((2, 4), np.int32)
        tables[0, 0] = 1
        _, emitted, _ = engine.paged_step(
            pool, tables, [8, 0], [int(prompt[0, 8]), 0], [None, None],
            [True, False], block_size=16)
        outs.append((seen, emitted.tolist()))
    assert t_decode.int8_decode_attention.launches == launches + 3 * 2 + 2
    for got, ref in zip(*(o[0] for o in outs)):
        torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "bf16"])
def test_cuda_block_moves_match_cpu_bitwise(cuda, kv_cache_dtype):
    """`extract_blocks`/`inject_blocks` (the host swap tier, the block
    wire) on a pool on the card and on the CPU holding the same bits:
    the payloads are equal, the pools after an inject IN PLACE (the same
    pool object back, from a host payload and from a device one) are
    equal, and an empty id list moves nothing."""
    from tf_yarn_tpu_torch.models import decode_engine as t_engine
    from tf_yarn_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=64, d_model=256, n_layers=3,
                               n_heads=2, n_kv_heads=1, d_ff=128,
                               max_seq_len=64, dtype=torch.bfloat16,
                               kv_cache_dtype=kv_cache_dtype)
    gen = torch.Generator().manual_seed(3)
    pools = {}
    for device in ("cpu", cuda):
        engine = t_engine.DecodeEngine(tt.Transformer(cfg, device=device))
        pools[str(device)] = (engine, engine.make_paged_pool(9, 16))
    for name in tt.KV_NAMES:
        leaf = getattr(pools["cpu"][1], name)
        if leaf is None:
            continue
        values = (torch.randint(-127, 128, leaf.shape, generator=gen)
                  if leaf.dtype == torch.int8
                  else torch.randn(leaf.shape, generator=gen))
        for _engine, pool in pools.values():
            getattr(pool, name).copy_(values.to(leaf.dtype))
    moved = {}
    for device, (engine, pool) in pools.items():
        payload = engine.extract_blocks(pool, [3, 1, 7], 16)
        host = t_engine.PagedKVPool(**{
            name: None if leaf is None else leaf.cpu()
            for name, leaf in vars(payload).items()})
        assert engine.inject_blocks(pool, [2, 5, 8], host, 16) is pool
        assert engine.inject_blocks(pool, [4], engine.extract_blocks(
            pool, [6], 16), 16) is pool
        empty = engine.extract_blocks(pool, [], 16)
        assert empty.key.shape[1] == 0
        assert engine.inject_blocks(pool, [], empty, 16) is pool
        torch.cuda.synchronize()
        moved[device] = (host, pool)
    (cpu_payload, cpu_pool), (card_payload, card_pool) = moved.values()
    for name in tt.KV_NAMES:
        want = getattr(cpu_pool, name)
        if want is None:
            assert getattr(card_pool, name) is None
            continue
        assert torch.equal(getattr(card_payload, name),
                           getattr(cpu_payload, name))
        assert torch.equal(getattr(card_pool, name).cpu(), want)
        assert torch.equal(want[:, [2, 5, 8]], getattr(cpu_payload, name))
        assert torch.equal(want[:, 4], want[:, 6])


def _norm_tolerances(dtype, ref_dx):
    """bf16: one ulp of the output (rtol 1/128) and, for dx, cancellation
    between its terms (atol 1e-2 of the largest entry); f32: sums in
    another order (rtol 1e-5 for y, 1e-4 and 1e-4 of the largest entry
    for dx, whose group means run over up to 25,088 elements)."""
    big = float(ref_dx.float().abs().max())
    if dtype == torch.bfloat16:
        return dict(rtol=1 / 128, atol=1e-5), dict(rtol=1 / 128, atol=1e-2 * big)
    return dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-4 * big)


# rows x d: one row, row counts that are no multiple of the dx kernel's
# rows a block (333, 4097), widths the register kernel holds (768, 1024:
# 3 and 4 vectors a lane in bf16, 6 and 8 in f32), one too wide for it
# (4096: the loop kernel's 16-byte loads) and one that is not a multiple
# of any vector width (771: scalar loads).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("rows, d", [(1, 768), (333, 768), (333, 771),
                                     (4097, 768), (333, 1024), (7, 4096)])
def test_cuda_layernorm_kernels_match_plain(cuda, rows, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, device=cuda, generator=gen) * 3 + 1).to(dtype)
    g = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    scale = torch.rand(d, device=cuda, generator=gen) + 0.5
    bias = torch.randn(d, device=cuda, generator=gen)
    before = (t_layernorm.layernorm.launches,
              t_layernorm.layernorm_bwd_dx.launches)
    y = t_layernorm._forward(x, scale, bias, 1e-12)
    dx = t_layernorm.layernorm_bwd_dx(x, g, scale, 1e-12)
    torch.cuda.synchronize()
    assert (t_layernorm.layernorm.launches,
            t_layernorm.layernorm_bwd_dx.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert y.dtype == dtype and dx.dtype == dtype
    ref_dx = t_layernorm.layernorm_bwd_dx_reference(x, g, scale, 1e-12)
    tol_y, tol_dx = _norm_tolerances(dtype, ref_dx)
    torch.testing.assert_close(
        y.float(), t_layernorm.layernorm_reference(x, scale, bias, 1e-12).float(),
        **tol_y)
    torch.testing.assert_close(dx.float(), ref_dx.float(), **tol_dx)


# The LayerNorm forward's layouts: the row kernel where d is 1-8 16-byte
# vectors a lane (bf16 d 256, 768, 1024 and 2048: 1, 3, 4 and 8 vectors;
# f32 d 768 and 1024: 6 and 8), over one row, a partial block of rows,
# BERT-base's 4096 and ViT-B/16's 25216; the three-pass kernel at d 64
# (the tiny configs) and 771 (no vector divides it).
LN_FWD_ROWS = [1, 7, 4096, 25216]
LN_FWD_CASES = ([(torch.bfloat16, d, rows) for d in (256, 768, 1024, 2048)
                 for rows in LN_FWD_ROWS]
                + [(torch.float32, d, rows) for d in (768, 1024)
                   for rows in LN_FWD_ROWS]
                + [(dtype, d, rows) for dtype in (torch.bfloat16, torch.float32)
                   for d in (64, 771) for rows in (7, 4096)])


def _ln_forward_check(got, x, scale, bias, eps):
    """y within one bf16 ulp of the plain version (f32 sums in another
    order), or 1e-5 in f32."""
    ref = t_layernorm.layernorm_reference(x, scale, bias, eps)
    assert got.dtype == x.dtype and got.shape == x.shape
    rtol = 1 / 128 if x.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize(
    "dtype, d, rows", LN_FWD_CASES,
    ids=[f"{'bf16' if t == torch.bfloat16 else 'f32'}-{d}-{r}"
         for t, d, r in LN_FWD_CASES])
def test_cuda_layernorm_forward_layouts_match_plain(cuda, dtype, d, rows):
    """Each layout against the plain version, bitwise equal over two
    calls, one CUDA launch a call of the kernel its shape picks."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, device=cuda, generator=gen) * 3 + 1).to(dtype)
    scale = torch.rand(d, device=cuda, generator=gen) + 0.5
    bias = torch.randn(d, device=cuda, generator=gen)
    eps = 1e-12 if rows % 2 else 1e-6
    launches = t_layernorm.layernorm.launches
    got = t_layernorm._forward(x, scale, bias, eps)
    again = t_layernorm._forward(x, scale, bias, eps)
    torch.cuda.synchronize()
    assert t_layernorm.layernorm.launches == launches + 2
    assert torch.equal(got, again)
    _ln_forward_check(got, x, scale, bias, eps)
    _one_kernel(lambda: t_layernorm._forward(x, scale, bias, eps),
                "layernorm_kernel<" if d in (64, 771)
                else "layernorm_row_kernel<")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_layernorm_forward_unaligned_takes_the_general_kernel(cuda,
                                                                   dtype):
    """A contiguous view one element into its storage, or a scale off
    16-byte alignment, is taken by the three-pass kernel."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    flat = (torch.randn(33 * 768 + 1, device=cuda, generator=gen) * 3).to(dtype)
    x = flat[1:].view(33, 768)
    assert x.is_contiguous() and x.data_ptr() % 16
    scale = torch.rand(769, device=cuda, generator=gen) + 0.5
    bias = torch.randn(768, device=cuda, generator=gen)
    for xs, s in ((x, scale[:768]), (flat[:-1].view(33, 768), scale[1:])):
        got = t_layernorm._forward(xs, s, bias, 1e-6)
        torch.cuda.synchronize()
        _ln_forward_check(got, xs, s, bias, 1e-6)
        _one_kernel(lambda: t_layernorm._forward(xs, s, bias, 1e-6),
                    "layernorm_kernel<")


def test_cuda_layernorm_forward_refuses_bad_inputs(cuda):
    """A dtype the kernels do not take, or a scale or bias of the wrong
    shape, raises instead of launching."""
    x = torch.randn(4, 768, device=cuda, dtype=torch.bfloat16)
    scale, bias = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    launches = t_layernorm.layernorm.launches
    with pytest.raises(ValueError, match="dtype"):
        t_layernorm._forward(x.half(), scale, bias, 1e-12)
    with pytest.raises(ValueError, match="shape"):
        t_layernorm._forward(x, scale[:767], bias, 1e-12)
    with pytest.raises(ValueError, match="shape"):
        t_layernorm._forward(x, scale, torch.zeros(2, 768, device=cuda), 1e-12)
    assert t_layernorm.layernorm.launches == launches


# (shape, groups), with the forward's plan: the ResNet-50 stem's
# 112x112x64 slab (802,816 elements an image; one pass, a cluster of 8
# blocks of 256 threads), the last stage's 7x7x2048 (one pass, one block
# of 128 threads a cluster), a grid of several waves of clusters, a slab
# too large for a cluster (two launches), one channel a group, one group
# (a cluster of several blocks), a [B, L, C] input, and a channel count
# that is no power of two (no 32-byte span: two launches).
GROUPNORM_CASES = {
    "stem": ((2, 112, 112, 64), 32),
    "stage4": ((3, 7, 7, 2048), 32),
    "waves": ((512, 7, 7, 512), 32),
    "huge": ((1, 256, 256, 64), 32),
    "groups_eq_c": ((2, 8, 8, 64), 64),
    "one_group": ((2, 14, 14, 256), 1),
    "seq": ((3, 50, 96), 3),
    "c6": ((2, 5, 5, 6), 3),
}


def _gn_inputs(cuda, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, device=cuda, generator=gen) * 2 + 0.5).to(dtype)
    g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    scale = torch.rand(c, device=cuda, generator=gen) + 0.5
    bias = torch.randn(c, device=cuda, generator=gen)
    return x, g, scale, bias


def _check_gn_backward(got, x, g, scale, stats, groups, dtype):
    """(dx, dscale, dbias) against the plain backward from the same
    statistics. dx as `_norm_tolerances`; dscale and dbias are f32 sums
    over B x HW positions whose longest chain of additions is under 64
    in either version: rtol 1e-5 and atol 1e-5 of the sum of the terms'
    magnitudes (a sum near 0 of large terms)."""
    ref = t_groupnorm.groupnorm_bwd_reference(x, g, scale, stats, groups)
    _, tol_dx = _norm_tolerances(dtype, ref[0])
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol_dx)
    c = x.shape[-1]
    g32 = g.float().reshape(-1, c).abs()
    norm = t_groupnorm._normalize(x, stats, groups).reshape(-1, c).abs()
    for name, out, want, terms in (("dscale", got[1], ref[1], g32 * norm),
                                   ("dbias", got[2], ref[2], g32)):
        assert out.dtype == torch.float32, name
        torch.testing.assert_close(
            out, want, rtol=1e-5, atol=1e-5 * float(terms.sum(0).max()),
            msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(GROUPNORM_CASES))
def test_cuda_groupnorm_kernels_match_plain(cuda, case, dtype):
    shape, groups = GROUPNORM_CASES[case]
    x, g, scale, bias = _gn_inputs(cuda, shape, dtype, len(case))
    before = (t_groupnorm.groupnorm.launches,
              t_groupnorm.groupnorm_backward.launches)
    y, stats = t_groupnorm.groupnorm_forward(x, scale, bias, groups, 1e-6)
    got = t_groupnorm.groupnorm_backward(x, g, scale, stats, groups)
    torch.cuda.synchronize()
    assert (t_groupnorm.groupnorm.launches,
            t_groupnorm.groupnorm_backward.launches) == (before[0] + 1,
                                                         before[1] + 1)
    ref_stats = t_groupnorm.groupnorm_stats_reference(x, groups, 1e-6)
    # The kernel's statistics (one pass: two-pass sums from the tile on
    # chip; two launches: shifted one-pass sums) against the plain ones.
    torch.testing.assert_close(stats, ref_stats, rtol=1e-5, atol=1e-5)
    ref_y = t_groupnorm.groupnorm_reference(x, scale, bias, groups, 1e-6)
    tol_y, _ = _norm_tolerances(dtype, ref_y)
    torch.testing.assert_close(y.float(), ref_y.float(), **tol_y)
    _check_gn_backward(got, x, g, scale, ref_stats, groups, dtype)


# ResNet-50's 12 GroupNorm slabs as (side, C), at batch 2: every plan the
# forward makes for them (clusters of 1-8 blocks, 128 and 256 threads).
RESNET50_SLABS = [(112, 64), (56, 64), (56, 256), (56, 128), (28, 128),
                  (28, 512), (28, 256), (14, 256), (14, 1024), (14, 512),
                  (7, 512), (7, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("side, c", RESNET50_SLABS)
def test_cuda_groupnorm_forward_matches_plain_at_resnet50_slabs(cuda, side, c,
                                                                dtype):
    gen = torch.Generator(device=cuda).manual_seed(side + c)
    x = (torch.randn(2, side, side, c, device=cuda, generator=gen) * 2
         + 0.5).to(dtype)
    scale = torch.rand(c, device=cuda, generator=gen) + 0.5
    bias = torch.randn(c, device=cuda, generator=gen)
    assert t_groupnorm.groupnorm_plan(2, side * side, c, 32,
                                      x.element_size()).one_pass
    y, stats = t_groupnorm.groupnorm_forward(x, scale, bias, 32, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        stats, t_groupnorm.groupnorm_stats_reference(x, 32, 1e-6),
        rtol=1e-5, atol=1e-5)
    tol_y = (dict(rtol=1 / 128, atol=1e-5) if dtype == torch.bfloat16
             else dict(rtol=1e-5, atol=1e-5))
    torch.testing.assert_close(
        y.float(),
        t_groupnorm.groupnorm_reference(x, scale, bias, 32, 1e-6).float(),
        **tol_y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("side, c", RESNET50_SLABS)
def test_cuda_groupnorm_backward_matches_plain_at_resnet50_slabs(cuda, side, c,
                                                                 dtype):
    """dx, dscale and dbias at every ResNet-50 slab (batch 2), each from
    its one-pass plan and the parameter sums, from the plain statistics."""
    x, g, scale, _ = _gn_inputs(cuda, (2, side, side, c), dtype, side + c)
    assert t_groupnorm.groupnorm_plan(2, side * side, c, 32, x.element_size(),
                                      backward=True).one_pass
    stats = t_groupnorm.groupnorm_stats_reference(x, 32, 1e-6)
    got = t_groupnorm.groupnorm_backward(x, g, scale, stats, 32)
    torch.cuda.synchronize()
    _check_gn_backward(got, x, g, scale, stats, 32, dtype)


def _device_kernels(run):
    """Device kernels `run()` launched, by name, under torch.profiler. A
    session can lose the first launches after it starts: three spin
    kernels (`torch.cuda._sleep`, left out of the counts) go first, and a
    session that saw no kernel of `run` at all is run again, up to three
    times (as `chip_smoke.kernel_launch_counts` does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and not getattr(e, "is_user_annotation", False)
               and "spin_kernel" not in e.key}
        if ran:
            return ran
    return ran


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["stem", "stage4", "huge", "c6"])
def test_cuda_groupnorm_backward_launches_the_plan(cuda, case, dtype):
    """One backward call runs the plan's launches on the device and no
    other kernel (no plain reduction); one that wants neither dscale nor
    dbias skips the parameter sums."""
    shape, groups = GROUPNORM_CASES[case]
    x, g, scale, _ = _gn_inputs(cuda, shape, dtype, 12)
    stats = t_groupnorm.groupnorm_stats_reference(x, groups, 1e-6)
    b, c = shape[0], shape[-1]
    plan = t_groupnorm.groupnorm_plan(b, x.numel() // (b * c), c, groups,
                                      x.element_size(), backward=True)
    torch.cuda.synchronize()
    ran = _device_kernels(
        lambda: t_groupnorm.groupnorm_backward(x, g, scale, stats, groups))
    assert all("groupnorm" in k for k in ran), ran
    assert sum(ran.values()) == plan.launches
    ran = _device_kernels(lambda: t_groupnorm.groupnorm_backward(
        x, g, scale, stats, groups, dscale=False, dbias=False))
    assert sum(ran.values()) == plan.launches - 1, ran


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["stem", "stage4", "waves", "huge", "c6"])
def test_cuda_groupnorm_backward_is_bitwise_deterministic(cuda, case, dtype):
    """Two backward calls give the same bits for dx, dscale and dbias, on
    both plans: sums in rank, chunk and image order, no atomics."""
    shape, groups = GROUPNORM_CASES[case]
    x, g, scale, _ = _gn_inputs(cuda, shape, dtype, 13)
    stats = t_groupnorm.groupnorm_stats_reference(x, groups, 1e-6)
    first = t_groupnorm.groupnorm_backward(x, g, scale, stats, groups)
    second = t_groupnorm.groupnorm_backward(x, g, scale, stats, groups)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The leaves (x, scale, bias) each case freezes.
FROZEN = {"scale": (1,), "bias": (2,), "both": (1, 2), "x": (0,)}


@pytest.mark.parametrize("case", ["stem", "huge"])
@pytest.mark.parametrize("frozen", sorted(FROZEN))
def test_cuda_groupnorm_frozen_inputs_get_no_gradient(cuda, frozen, case):
    """A frozen scale or bias (or x) gets None for its gradient through
    autograd, and the other gradients keep their bits."""
    shape, groups = GROUPNORM_CASES[case]
    x, g, scale, bias = _gn_inputs(cuda, shape, torch.bfloat16, 14)
    grads = []
    for freeze in ((), FROZEN[frozen]):
        leaves = [t.clone().requires_grad_(i not in freeze)
                  for i, t in enumerate((x, scale, bias))]
        t_groupnorm.groupnorm(*leaves, groups, 1e-6).backward(g)
        grads.append([leaf.grad for leaf in leaves])
    torch.cuda.synchronize()
    full, part = grads
    for i, (got, want) in enumerate(zip(part, full)):
        if i in FROZEN[frozen]:
            assert got is None, i
        else:
            assert torch.equal(got, want), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["stem", "stage4", "waves", "huge", "c6"])
def test_cuda_groupnorm_forward_is_bitwise_deterministic(cuda, case, dtype):
    """Two forward calls on the same input give the same bits, on both
    plans: the cluster's partials are added in rank order, the two
    launches' in chunk order, and no atomics."""
    shape, groups = GROUPNORM_CASES[case]
    c = shape[-1]
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(shape, device=cuda, generator=gen) * 2 + 0.5).to(dtype)
    scale = torch.rand(c, device=cuda, generator=gen) + 0.5
    bias = torch.randn(c, device=cuda, generator=gen)
    y1, stats1 = t_groupnorm.groupnorm_forward(x, scale, bias, groups, 1e-6)
    y2, stats2 = t_groupnorm.groupnorm_forward(x, scale, bias, groups, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(stats1, stats2)


def test_cuda_groupnorm_near_constant_input_is_finite(cuda):
    """A large mean with a tiny spread (tests/test_ops.py's case): the
    one-pass kernel's two-pass sums lose nothing to cancellation."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = 1000.0 + 1e-3 * torch.randn(1, 8, 8, 32, device=cuda, generator=gen)
    ones, zeros = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    y, stats = t_groupnorm.groupnorm_forward(x, ones, zeros, 4, 1e-6)
    ref_stats = t_groupnorm.groupnorm_stats_reference(x, 4, 1e-6)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(stats, ref_stats, rtol=1e-3, atol=1e-3)


def test_cuda_norm_layouts_refused_or_taken_as_documented(cuda):
    """The kernels read contiguous rows: a channels-last NCHW tensor seen
    as NHWC is taken as it is; a contiguous NCHW tensor seen that way,
    or a transposed LayerNorm input, raises instead of reading garbage."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    nchw = torch.randn(2, 64, 9, 9, device=cuda, generator=gen)
    scale, bias = torch.rand(64, device=cuda) + 0.5, torch.randn(64, device=cuda)
    launches = t_groupnorm.groupnorm.launches
    with pytest.raises(ValueError, match="contiguous"):
        t_groupnorm.groupnorm(nchw.permute(0, 2, 3, 1), scale, bias, 8)
    with pytest.raises(ValueError, match="contiguous"):
        t_layernorm.layernorm(nchw[0].transpose(0, 1), scale[:9], bias[:9])
    assert t_groupnorm.groupnorm.launches == launches
    channels_last = nchw.contiguous(memory_format=torch.channels_last)
    got = t_groupnorm.groupnorm(channels_last.permute(0, 2, 3, 1), scale, bias, 8)
    ref = t_groupnorm.groupnorm_reference(nchw.permute(0, 2, 3, 1), scale, bias, 8)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["layernorm", "groupnorm"])
def test_cuda_norm_autograd_launches_both_kernels(cuda, norm):
    """Forward and backward through the kernels; dx, dscale and dbias
    against autograd through the plain version (f32)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(4, 6, 6, 32, device=cuda, generator=gen)
    w = torch.randn(x.shape, device=cuda, generator=gen)
    scale = torch.rand(32, device=cuda, generator=gen) + 0.5
    bias = torch.randn(32, device=cuda, generator=gen)
    mod = t_layernorm if norm == "layernorm" else t_groupnorm
    fn = (lambda *a: t_layernorm.layernorm(*a, 1e-6)) if norm == "layernorm" \
        else (lambda *a: t_groupnorm.groupnorm(*a, 4, 1e-6))
    ref_fn = (lambda *a: t_layernorm.layernorm_reference(*a, 1e-6)) \
        if norm == "layernorm" \
        else (lambda *a: t_groupnorm.groupnorm_reference(*a, 4, 1e-6))
    fwd, bwd = getattr(mod, norm), (t_layernorm.layernorm_backward
                                    if norm == "layernorm"
                                    else t_groupnorm.groupnorm_backward)
    before = (fwd.launches, bwd.launches)
    grads = []
    for f in (fn, ref_fn):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        (f(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _ln_inputs(cuda, rows, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(rows, d, device=cuda, generator=gen) * 3 + 1).to(dtype)
    g = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    scale = torch.rand(d, device=cuda, generator=gen) + 0.5
    bias = torch.randn(d, device=cuda, generator=gen)
    return x, g, scale, bias


def _ln_param_terms(x, g, eps):
    """The magnitudes of the terms behind dscale and dbias, [rows, d]:
    g·x·r and g·mean·r, whose difference is g·norm (the two packages'
    row means differ by f32 rounding, so an x near its row's mean leaves
    a norm with a large relative error), and g."""
    d = x.shape[-1]
    x32, g32 = x.float().reshape(-1, d), g.float().reshape(-1, d)
    mean = x32.mean(-1, keepdim=True)
    centered = x32 - mean
    r = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + eps)
    return g32.abs() * (x32.abs() + mean.abs()) * r, g32.abs()


def _check_ln_backward(got, x, g, scale, eps, dtype):
    """dx at `_norm_tolerances`; dscale and dbias (f32 sums over the rows
    in another order than torch.sum's) at rtol 1e-5 and, column by
    column, atol 1e-5 of the sum of the terms' magnitudes
    (`_ln_param_terms`)."""
    ref = t_layernorm.layernorm_bwd_reference(x, g, scale, eps)
    _, tol_dx = _norm_tolerances(dtype, ref[0])
    assert got[0].dtype == dtype
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol_dx)
    d = x.shape[-1]
    for name, out, want, terms in zip(("dscale", "dbias"), got[1:], ref[1:],
                                      _ln_param_terms(x, g, eps)):
        assert out.dtype == torch.float32 and out.shape == (d,), name
        bound = 1e-5 * want.abs() + 1e-5 * terms.abs().sum(0)
        assert bool(((out - want).abs() <= bound).all()), (
            name, float((out - want).abs().max()))


# d: BERT's and ViT's 768 (the column sums in registers), 1024 (in
# registers in bf16, in shared memory in f32), 2048 (shared memory in
# bf16; the loop kernel's 16-byte loads in f32) and 771 (no 16-byte
# vector divides it: the loop kernel's scalar loads); rows: one, fewer
# than the grid's warps, and BERT-base's 4096.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [768, 1024, 771, 2048])
@pytest.mark.parametrize("rows", [1, 37, 4096])
def test_cuda_layernorm_backward_matches_plain(cuda, rows, d, dtype):
    x, g, scale, _ = _ln_inputs(cuda, rows, d, dtype, rows + d)
    launches = t_layernorm.layernorm_backward.launches
    got = t_layernorm.layernorm_backward(x, g, scale, 1e-12)
    torch.cuda.synchronize()
    assert t_layernorm.layernorm_backward.launches == launches + 1
    _check_ln_backward(got, x, g, scale, 1e-12, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [768, 771])
def test_cuda_layernorm_backward_launches_its_kernels(cuda, d, dtype):
    """One backward call runs two LayerNorm kernels on the device (the
    column sums with dx, then the parameter sums) and nothing else; with
    the parameters frozen, the dx kernel alone."""
    x, g, scale, _ = _ln_inputs(cuda, 333, d, dtype, 21)
    torch.cuda.synchronize()
    for need_params, planned in ((True, 2), (False, 1)):
        ran = _device_kernels(lambda: t_layernorm.layernorm_backward(
            x, g, scale, 1e-12, need_params=need_params))
        assert all("layernorm" in k for k in ran), ran
        assert sum(ran.values()) == planned, ran


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [768, 771, 2048])
def test_cuda_layernorm_backward_is_bitwise_deterministic(cuda, d, dtype):
    """Two backward calls give the same bits for dx, dscale and dbias:
    the blocks' partials are added in a fixed order, no atomics."""
    x, g, scale, _ = _ln_inputs(cuda, 4096, d, dtype, 22)
    first = t_layernorm.layernorm_backward(x, g, scale, 1e-12)
    second = t_layernorm.layernorm_backward(x, g, scale, 1e-12)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [768, 771])
@pytest.mark.parametrize("frozen", sorted(FROZEN))
def test_cuda_layernorm_frozen_inputs_get_no_gradient(cuda, frozen, d):
    """A frozen scale or bias (or x) gets None for its gradient through
    autograd, and the other gradients keep their bits: the kernels
    without dx sum the same columns in the same order."""
    x, g, scale, bias = _ln_inputs(cuda, 333, d, torch.bfloat16, 23)
    grads = []
    for freeze in ((), FROZEN[frozen]):
        leaves = [t.clone().requires_grad_(i not in freeze)
                  for i, t in enumerate((x, scale, bias))]
        t_layernorm.layernorm(*leaves, 1e-12).backward(g)
        grads.append([leaf.grad for leaf in leaves])
    torch.cuda.synchronize()
    full, part = grads
    for i, (got, want) in enumerate(zip(part, full)):
        if i in FROZEN[frozen]:
            assert got is None, i
        else:
            assert torch.equal(got, want), i


def test_cuda_out_of_vocabulary_prompt_keeps_the_replica_serving(cuda):
    """A prompt with ids V and -V-3 on the fused paged grid beside two
    clean ones, then a clean request on the same replica: every stream
    served to length and equal to the CPU's (the embedding reads rows
    V-1 and 0 as the JAX package does; an index outside the table would
    be a device-side assert that fails every later request)."""
    from tf_yarn_tpu_torch.models import decode_engine as t_engine
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.serving.request import SamplingParams
    from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

    # head_dim 128 at GQA group 2: the f32 instantiation of the kernel.
    cfg = tt.TransformerConfig(vocab_size=128, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=256,
                               max_seq_len=64, dtype=torch.float32,
                               kv_cache_dtype="int8")
    cpu_model = tt.make_model(cfg, seed=5, device="cpu")
    card_model = tt.Transformer(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(range(3, 10)), [1, 128, -131, 2], [1, 2]]
    runs = []
    for model in (card_model, cpu_model):
        scheduler = SlotScheduler(t_engine.DecodeEngine(model), max_slots=3,
                                  block_size=16, kv_layout="paged",
                                  decode_attention="fused")
        sampling = SamplingParams(max_new_tokens=6)
        try:
            responses = [scheduler.submit(p, sampling) for p in prompts]
            responses.append(None)
            for _ in range(100):
                if responses[-1] is None and all(
                        r.done for r in responses[:-1]):
                    responses[-1] = scheduler.submit([5, 6, 7], sampling)
                if responses[-1] is not None and responses[-1].done:
                    break
                scheduler.tick()
        finally:
            scheduler.close()
        torch.cuda.synchronize()
        runs.append([(r.result(timeout=1), r.finish_reason)
                     for r in responses])
    assert runs[0] == runs[1]
    assert [reason for _, reason in runs[0]] == ["length"] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dlrm_scores_match_cpu(cuda, dtype):
    """The ranker on the card against its f32 forward on the CPU, ids
    negative and past their tables included: f32 at 1e-5 (TF32 off),
    bf16 within 2e-2 (bf16 products against f32 ones)."""
    from tf_yarn_tpu_torch.models import dlrm

    cfg = dlrm.DLRMConfig.tiny(table_sizes=(64, 100, 7, 300), dtype=dtype)
    cpu_model = dlrm.DLRM(dlrm.DLRMConfig.tiny(table_sizes=cfg.table_sizes,
                                               dtype=torch.float32),
                          device="cpu")
    cpu_model.load_state_dict(dlrm.make_model(cfg, seed=2,
                                              device="cpu").state_dict())
    card_model = dlrm.DLRM(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(4)
    cat = torch.randint(-1000, 1000, (33, 4), generator=gen,
                        dtype=torch.int32)
    dense = torch.randn(33, cfg.n_dense, generator=gen)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = card_model(cat.to(cuda), dense.to(cuda)).cpu()
            ref = cpu_model(cat, dense)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert got.dtype == torch.float32 and got.shape == (33, 1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


def test_cuda_launched_worker_runs_the_layernorm_kernels(
        cuda, tmp_path, monkeypatch):
    """chip_smoke.py phase 9 at the tiny f32 BERT: the worker that
    `run_on_gpu` launches launches the LayerNorm forward and backward
    kernels as often as the same experiment does in this process, loads
    the kernel library this process built, and gives the same losses
    (f32 on one card: 1e-5). The worker gets no TPU_YARN_PLATFORM (the
    conftest sets it to cpu for the JAX package), so it runs on the card
    as a user's would."""
    import json
    import os

    import chip_smoke
    from tf_yarn_tpu_torch import client, experiment, training
    from tf_yarn_tpu_torch.topologies import NodeLabel, TaskSpec

    for fn in (t_layernorm.layernorm, t_layernorm.layernorm_backward):
        fn.launches = 0
    local, launched = tmp_path / "local", tmp_path / "launched"
    training.train_and_evaluate(experiment.as_core_experiment(
        chip_smoke.launcher_bert_experiment(str(local), tiny=True)),
        device=cuda)
    ref = json.loads((local / chip_smoke.LAUNCHER_COUNTS).read_text())
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    client.run_on_gpu(
        client.get_safe_experiment_fn("chip_smoke.launcher_bert_experiment",
                                      str(launched), True),
        {"worker": TaskSpec(instances=1, chips_per_host=1,
                            label=NodeLabel.GPU)},
        env={"PYTHONPATH": repo}, poll_every_secs=0.2, dead_task_secs=120)
    got = json.loads((launched / chip_smoke.LAUNCHER_COUNTS).read_text())
    assert got["device"].startswith("cuda")
    assert got["launches"] == ref["launches"]
    assert min(got["launches"].values()) > 0
    assert not got["built_kernels_here"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)


@pytest.fixture(scope="module")
def card_fleet():
    """chip_smoke.py phase 10 at the small f32 decoder on the card: the
    mixed fleet that `run_on_gpu` launches (no TPU_YARN_PLATFORM: the
    conftest sets it to cpu for the JAX package, so it is taken out for
    the launch), and the same checkpoint's streams served on the CPU."""
    import os

    import chip_smoke
    from tf_yarn_tpu_torch import checkpoint, client, topologies
    from tf_yarn_tpu_torch.models import decode_engine, dlrm
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.serving import scheduler, server

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    platform = os.environ.pop("TPU_YARN_PLATFORM", None)
    try:
        result = chip_smoke.fleet_slice(
            torch, tt, decode_engine, scheduler, server, checkpoint, client,
            topologies, dlrm, cuda, tiny=True)
    finally:
        if platform is not None:
            os.environ["TPU_YARN_PLATFORM"] = platform
    # The weights phase 10 (a) draws on the card (seed 0), served on the
    # CPU (the plain versions).
    cfg = chip_smoke.fleet_config(torch, tt, True)
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict({
        name: value.cpu() for name, value in
        tt.make_model(cfg, seed=chip_smoke.SEED, device=cuda)
        .state_dict().items()})
    grid = scheduler.SlotScheduler(decode_engine.DecodeEngine(model),
                                   **chip_smoke.FLEET_GRID)
    frontend = server.ServingServer(grid, "127.0.0.1", 0)
    grid.start()
    frontend.start()
    try:
        cpu = chip_smoke.serve_one_at_a_time(
            frontend.port, chip_smoke.fleet_prompts(torch, cfg),
            chip_smoke.FLEET_NEW)
    finally:
        frontend.stop()
        grid.close()
    return result, [body["tokens"] for body in cpu]


def test_cuda_launched_decode_and_prefill_replicas_serve_the_cpu_streams(
        cuda, card_fleet):
    """Phase 10 (b) at the small f32 decoder: the first decode replica
    serves the prompts of 17, 64 and 300 tokens one at a time, the two
    long ones shipped, with the streams of the same checkpoint served on
    the CPU; `fleet_slice` also holds them to the card's in-process grid,
    the launches of rmsnorm, quantize and the paged kernel in both decode
    tasks and of rmsnorm and quantize alone in the prefill task."""
    result, cpu = card_fleet
    launched = result["b_launched"]
    assert launched["prefill_offload"]["ships"] == 2
    for task in ("decode_task", "serving_1_task"):
        assert min(launched[task]["launches"].values()) > 0
    assert launched["prefill_task"]["launches"][
        "paged_int8_window_attention"] == 0
    assert launched["streams"] == cpu


def test_cuda_routed_fleet_streams_equal_the_cpu_streams(cuda, card_fleet):
    """Phase 10 (d) and (e) at the small f32 decoder: the streams through
    the router, on both decode replicas and after one is drained, equal
    the CPU's (`fleet_slice` holds each routed stream to (a)'s, which
    equal the CPU's here), and the router never initialised CUDA."""
    result, cpu = card_fleet
    assert result["a_in_process"]["streams"] == cpu
    assert result["d_routed"]["streams_equal_in_process"]
    assert result["e_failover"]["streams_equal_in_process"]
    router = result["d_routed"]["router_task"]
    assert not router["cuda_initialized"] and not router["kernel_library_loaded"]
