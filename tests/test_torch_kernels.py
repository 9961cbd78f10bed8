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
# past its table (positions are capped there); another block size.
CASES = {
    "window3": (torch.bfloat16, 3, [1, 17, 60, 100], 16, 8, 32, 8, 128),
    "splits": (torch.bfloat16, 1, [0, 254, 255, 256, 511, 1000], 16, 64,
               32, 8, 128),
    "full_table": (torch.bfloat16, 3, [16 * 64 - 1, 300], 16, 64, 32, 8, 128),
    "block8": (torch.bfloat16, 2, [5, 130, 700], 8, 96, 32, 8, 128),
    "f32_splits": (torch.float32, 2, [5, 255, 256, 700], 16, 48, 8, 4, 128),
    "f32_block8": (torch.float32, 1, [0, 130], 8, 32, 4, 2, 128),
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
