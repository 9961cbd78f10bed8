"""The port's flash attention and attention dispatch held against the JAX
package on the CPU.

The same seeded numpy inputs go through the JAX `flash_attention`
(Pallas in interpret mode, as tests/test_attention.py runs it) and its
`jax.vjp`, and through the port's plain versions (CPU tensors take them;
the CUDA kernels are held against the same plain versions by
tests/test_torch_kernels.py on the card). f32 throughout: the tolerance
covers sums taken in another order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.ops import attention as t_attention
from tf_yarn_tpu_torch.ops import flash_attention as t_flash

# (s_q, s_kv, n_heads, n_kv, causal, block_q, block_k): causal and not,
# GQA group 1, 2 and 4, and cross lengths (Skv > S: kv blocks past the
# last query row, whose dk/dv are zero; Skv < S).
CASES = {
    "causal": (32, 32, 4, 4, True, 16, 16),
    "noncausal": (32, 32, 4, 4, False, 16, 16),
    "gqa2": (64, 64, 4, 2, True, 32, 32),
    "gqa4": (64, 64, 8, 2, True, 32, 32),
    "cross_causal": (32, 64, 4, 2, True, 16, 32),
    "cross_noncausal": (32, 64, 4, 2, False, 16, 32),
    "short_kv": (64, 32, 4, 1, True, 32, 16),
}


def _inputs(s_q, s_kv, n_heads, n_kv, seed=0, head_dim=16):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.5).astype(np.float32)
    return (mk(2, s_q, n_heads, head_dim), mk(2, s_kv, n_kv, head_dim),
            mk(2, s_kv, n_kv, head_dim), mk(2, s_q, n_heads, head_dim))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_forward_and_vjp(case):
    from tf_yarn_tpu.ops.flash_attention import flash_attention

    s_q, s_kv, n_heads, n_kv, causal, block_q, block_k = CASES[case]
    q, k, v, g = _inputs(s_q, s_kv, n_heads, n_kv)
    out, vjp = jax.vjp(
        lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                        block_q=block_q, block_k=block_k),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = t_flash.flash_attention(tq, tk, tv, causal=causal, block_q=block_q,
                                  block_k=block_k)
    got.backward(torch.tensor(g))
    # f32 on both sides: sums in another order only.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=2e-6, rtol=1e-5)
    for name, t, ref in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5, err_msg=f"d{name}")
    if causal and s_kv > s_q:
        assert not tk.grad[:, s_q:].any() and not tv.grad[:, s_q:].any()


def test_plain_bf16_flash_vjp_matches_jax():
    """bf16 on both sides: the JAX vjp rounds p and ds to the operands'
    dtype where the port's plain versions do (ds to K's before ds.K for
    dq, to q's for dk; p to dO's for dv), which the card tests' bf16
    tolerance relies on."""
    from tf_yarn_tpu.ops.flash_attention import flash_attention

    q, k, v, g = _inputs(128, 128, 4, 2, seed=3, head_dim=64)
    q, k, v, g = (a[:1] for a in (q, k, v, g))
    _, vjp = jax.vjp(
        lambda q, k, v: flash_attention(q, k, v, causal=True, block_q=64,
                                        block_k=64),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    grads = vjp(jnp.asarray(g, jnp.bfloat16))

    bf = lambda a: torch.tensor(a).to(torch.bfloat16)
    tq, tk, tv = (bf(a).requires_grad_() for a in (q, k, v))
    t_flash.flash_attention(tq, tk, tv, causal=True, block_q=64,
                            block_k=64).backward(bf(g))
    # Both sides round at the same points from the same bf16 inputs; what
    # is left is f32 sums in another order and the ulps of bf16 roundings
    # those move: 1e-2 of the reference's norm.
    for name, t, ref in zip("qkv", (tq, tk, tv), grads):
        got = t.grad.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= 1e-2, f"d{name}: relative error norm {err}"


def test_plain_lse_matches_jax_residual():
    """The LSE the forward saves is the JAX residual's first lane (the TPU
    kernel replicates it over 128 lanes; the port keeps [B·H, S])."""
    from tf_yarn_tpu.ops.flash_attention import _flash_forward

    q, k, v, _ = _inputs(32, 32, 4, 2, seed=1)
    _, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, 0.25, 16, 16, True, save_residuals=True)
    _, got = t_flash.flash_fwd(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), True, 0.25)
    assert got.shape == (2 * 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[..., 0],
                               atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("s_q, s_kv, block_q, block_k", [
    (768, 768, 512, 512), (1024, 384, 512, 512), (96, 96, 32, 32),
    (2048, 2048, 512, 512)])
def test_block_folding_matches_jax(s_q, s_kv, block_q, block_k):
    from tf_yarn_tpu.ops.flash_attention import _check_blocks

    assert t_flash._check_blocks(s_q, s_kv, block_q, block_k) == \
        _check_blocks(s_q, s_kv, block_q, block_k)


def test_indivisible_lengths_rejected():
    q, k, v, _ = _inputs(60, 60, 4, 4)
    with pytest.raises(ValueError, match="divisible"):
        t_flash.flash_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), block_q=32, block_k=32)


def test_empty_inputs_give_zeros():
    q = torch.randn(2, 0, 4, 16)
    k = torch.randn(2, 8, 4, 16)
    assert t_flash.flash_attention(q, k, k).shape == (2, 0, 4, 16)
    q = torch.randn(2, 8, 4, 16)
    out = t_flash.flash_attention(q, torch.randn(2, 0, 4, 16),
                                  torch.randn(2, 0, 4, 16))
    assert out.shape == q.shape and not out.any()


def test_cpu_tensors_take_the_plain_flash_versions():
    before = (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
              t_flash.flash_dkv.launches)
    q, k, v, _ = _inputs(16, 16, 4, 2)
    tq = torch.tensor(q, requires_grad=True)
    t_flash.flash_attention(tq, torch.tensor(k), torch.tensor(v)).sum().backward()
    assert tq.grad is not None
    assert (t_flash.flash_fwd.launches, t_flash.flash_dq.launches,
            t_flash.flash_dkv.launches) == before


def test_attention_dispatch():
    q, k, v, _ = _inputs(16, 16, 4, 2, seed=2)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    flash = t_attention.attention(tq, tk, tv, impl="flash")
    xla = t_attention.attention(tq, tk, tv, impl="xla")
    # Two algorithms for one function, f32.
    torch.testing.assert_close(flash, xla, atol=1e-5, rtol=1e-5)
    # Without a mesh (one rank) the sequence-parallel impls are xla's
    # attention, as in the JAX package: nothing to cut.
    for impl in ("ring", "ulysses", "ulysses_flash"):
        torch.testing.assert_close(t_attention.attention(tq, tk, tv, impl=impl),
                                   xla, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_attention.attention(tq, tk, tv, impl="nope")
    with pytest.raises(NotImplementedError, match="key_padding_mask"):
        t_attention.attention(tq, tk, tv, impl="flash",
                              key_padding_mask=torch.ones(2, 16))


def test_xla_attention_key_padding_mask_matches_jax():
    from tf_yarn_tpu.ops.attention import xla_attention

    q, k, v, _ = _inputs(8, 8, 4, 2, seed=3)
    mask = np.ones((2, 8), np.int32)
    mask[0, 5:] = 0
    mask[1, :] = 0  # a fully padded row gets zeros
    expected = np.asarray(xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        key_padding_mask=jnp.asarray(mask)))
    got = t_attention.xla_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), causal=False,
                                    key_padding_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6)
    assert not got[1].any()
