"""The port's LayerNorm and GroupNorm held against the JAX package on the
CPU, forward and backward (dx, dscale, dbias), on seeded numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (the forward
kernel, and the dx kernel through `jax.vjp`); the port's wrappers take
their plain versions for CPU tensors. f32 throughout: each tolerance
covers sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.ops import groupnorm as t_groupnorm
from tf_yarn_tpu_torch.ops import layernorm as t_layernorm


def _inputs(shape, seed, offset=0.0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32) * 2 + offset,
            rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32) * 0.1,
            rng.randn(*shape).astype(np.float32))


def _jax_value_and_grads(fn, x, scale, bias, w):
    """fn's output and the grads of sum(fn · w) in x, scale and bias."""
    args = tuple(map(jnp.asarray, (x, scale, bias)))
    y, vjp = jax.vjp(fn, *args)
    return [np.asarray(t) for t in (y, *vjp(jnp.asarray(w)))]


def _port_value_and_grads(fn, x, scale, bias, w):
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, scale, bias)]
    y = fn(*leaves)
    (y * torch.tensor(w)).sum().backward()
    return [t.detach().numpy() for t in (y, *(leaf.grad for leaf in leaves))]


# (3, 7, 48): 21 rows; (300, 40): 300 rows, not a multiple of the JAX
# kernel's block_rows (256), which then falls back to blocks of 4. The
# port has one backward; it is held against both of the JAX package's.
@pytest.mark.parametrize("kernel_bwd", [True, False], ids=["dx_kernel",
                                                         "reference_vjp"])
@pytest.mark.parametrize("shape", [(4, 32), (3, 7, 48), (300, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("eps", [1e-12, 1e-6])
def test_layernorm_forward_and_grads_match_jax(eps, shape, kernel_bwd):
    from tf_yarn_tpu.ops import layernorm as j_layernorm

    x, scale, bias, w = _inputs(shape, seed=len(shape) + shape[-1], offset=1.0)
    want = _jax_value_and_grads(
        lambda x, s, b: j_layernorm.layernorm(x, s, b, eps=eps,
                                              kernel_bwd=kernel_bwd),
        x, scale, bias, w)
    got = _port_value_and_grads(
        lambda x, s, b: t_layernorm.layernorm(x, s, b, eps),
        x, scale, bias, w)
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), got, want):
        # f32, sums in another order (dscale/dbias sum up to 300 rows).
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


# BERT-base's and ViT-B/16's width, the row kernel's on the card, in
# both of its dtypes and at both models' eps, over a few rows.
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("eps", [1e-12, 1e-6])
def test_layernorm_reference_at_d768_matches_the_jax_kernel(eps, dtype):
    from tf_yarn_tpu.ops import layernorm as j_layernorm

    x, scale, bias, _ = _inputs((5, 768), seed=768, offset=1.0)
    want = j_layernorm.layernorm(jnp.asarray(x, getattr(jnp, dtype)),
                                 jnp.asarray(scale), jnp.asarray(bias),
                                 eps=eps)
    got = t_layernorm.layernorm_reference(
        torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(scale),
        torch.tensor(bias), eps)
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    # bf16: one ulp of y (f32 sums in another order); f32: 1e-5.
    rtol = 1 / 128 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-5)


def test_layernorm_dx_reference_matches_the_jax_dx_kernel():
    """The plain dx alone against the JAX dx kernel, both at eps 1e-12."""
    from tf_yarn_tpu.ops import layernorm as j_layernorm

    x, scale, _, g = _inputs((5, 33), seed=2, offset=-3.0)
    want = j_layernorm._layernorm_bwd(1e-12, 256, True, True,
                                      tuple(map(jnp.asarray, (x, scale, scale))),
                                      jnp.asarray(g))[0]
    got = t_layernorm.layernorm_bwd_dx(torch.tensor(x), torch.tensor(g),
                                       torch.tensor(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_layernorm_bf16_matches_jax():
    """bf16 in and out, f32 inside, on both sides; the tolerance is one
    bf16 ulp (2⁻⁷) relative plus 2⁻⁷ absolute, for two roundings to bf16
    of values that differ only in f32 summation order."""
    from tf_yarn_tpu.ops import layernorm as j_layernorm

    x, scale, bias, w = _inputs((6, 40), seed=5, offset=1.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    y, vjp = jax.vjp(lambda x: j_layernorm.layernorm(x, scale, bias),
                     xb)
    want = [np.asarray(t.astype(jnp.float32)) for t in (y, vjp(wb)[0])]
    xt = torch.tensor(x).bfloat16().requires_grad_()
    yt = t_layernorm.layernorm(xt, torch.tensor(scale), torch.tensor(bias))
    yt.backward(torch.tensor(w).bfloat16())
    assert yt.dtype == xt.grad.dtype == torch.bfloat16
    for name, a, b in zip(("y", "dx"), (yt.float(), xt.grad.float()), want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=2 ** -7,
                                   atol=2 ** -7, err_msg=name)


# (37, 771): a width no 16-byte vector divides (the card's loop kernel).
@pytest.mark.parametrize("shape", [(4, 32), (3, 7, 48), (300, 40), (37, 771)],
                         ids=lambda s: "x".join(map(str, s)))
def test_layernorm_bwd_reference_matches_the_jax_backward(shape):
    """The plain backward (dx, dscale, dbias) against the JAX custom_vjp's
    backward: its dx kernel in interpret mode, its XLA dscale and dbias;
    f32, sums in another order (dscale and dbias over up to 300 rows)."""
    from tf_yarn_tpu.ops import layernorm as j_layernorm

    x, scale, bias, g = _inputs(shape, seed=shape[0] + shape[-1], offset=1.0)
    want = j_layernorm._layernorm_bwd(
        1e-12, 256, True, True, tuple(map(jnp.asarray, (x, scale, bias))),
        jnp.asarray(g))
    got = t_layernorm.layernorm_bwd_reference(
        torch.tensor(x), torch.tensor(g), torch.tensor(scale), 1e-12)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    xt, gt, st = (torch.tensor(t) for t in (x, g, scale))
    assert t_layernorm.layernorm_backward(xt, gt, st, 1e-12,
                                          need_dx=False)[0] is None
    assert t_layernorm.layernorm_backward(
        xt, gt, st, 1e-12, need_params=False)[1:] == (None, None)


@pytest.mark.parametrize("frozen", ["scale", "bias", "both"])
def test_layernorm_frozen_parameters_get_no_gradient(frozen):
    """A frozen scale or bias gets no gradient and leaves dx and the other
    gradient as they are (the backward honours needs_input_grad)."""
    x, scale, bias, w = _inputs((3, 5, 48), seed=8, offset=1.0)
    grads = []
    for freeze in (None, frozen):
        leaves = [torch.tensor(t, requires_grad=True) for t in (x, scale, bias)]
        if freeze in ("scale", "both"):
            leaves[1].requires_grad_(False)
        if freeze in ("bias", "both"):
            leaves[2].requires_grad_(False)
        (t_layernorm.layernorm(*leaves, 1e-6) * torch.tensor(w)).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    full, part = grads
    assert torch.equal(part[0], full[0])
    assert (part[1] is None) == (frozen in ("scale", "both"))
    assert (part[2] is None) == (frozen in ("bias", "both"))
    for got, want in zip(part[1:], full[1:]):
        if got is not None:
            assert torch.equal(got, want)


# [B, H, W, C] and [B, L, C] slabs; one group, one channel a group.
GROUPNORM_CASES = [((2, 4, 4, 16), 4), ((2, 6, 6, 32), 1),
                   ((2, 4, 4, 8), 8), ((3, 10, 12), 3)]


@pytest.mark.parametrize("shape, groups", GROUPNORM_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else f"g{v}")
def test_groupnorm_forward_and_grads_match_jax(shape, groups):
    from tf_yarn_tpu.ops import groupnorm as j_groupnorm

    x, scale, bias, w = _inputs(shape, seed=shape[-1] + groups, offset=0.5)
    want = _jax_value_and_grads(
        lambda x, s, b: j_groupnorm.groupnorm(x, s, b, groups, eps=1e-6),
        x, scale, bias, w)
    got = _port_value_and_grads(
        lambda x, s, b: t_groupnorm.groupnorm(x, s, b, groups, 1e-6),
        x, scale, bias, w)
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), got, want):
        # f32, sums in another order: the JAX kernel's one-pass
        # statistics against the port's two-pass ones.
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_groupnorm_reference_and_stats_match_jax():
    from tf_yarn_tpu.ops import groupnorm as j_groupnorm

    x, scale, bias, _ = _inputs((2, 5, 5, 12), seed=4, offset=2.0)
    want = j_groupnorm.groupnorm_reference(*map(jnp.asarray, (x, scale, bias)),
                                           6, eps=1e-5)
    got = t_groupnorm.groupnorm_reference(*map(torch.tensor, (x, scale, bias)),
                                          6, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    norm = np.asarray(j_groupnorm._norm32(jnp.asarray(x), 6, 1e-5))
    stats = t_groupnorm.groupnorm_stats_reference(torch.tensor(x), 6, 1e-5)
    np.testing.assert_allclose(
        t_groupnorm._normalize(torch.tensor(x), stats, 6).numpy(), norm,
        rtol=1e-5, atol=1e-5)


def test_groupnorm_no_nan_on_near_constant_input():
    """tests/test_ops.py's case: a large mean with a tiny spread."""
    rng = np.random.RandomState(3)
    x = torch.tensor(1000.0 + 1e-3 * rng.randn(1, 8, 8, 32).astype(np.float32),
                     requires_grad=True)
    y = t_groupnorm.groupnorm(x, torch.ones(32), torch.zeros(32), 4, 1e-6)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(x.grad).all()


def test_groupnorm_edges_match_the_jax_function():
    from tf_yarn_tpu.ops import groupnorm as j_groupnorm

    x = np.random.RandomState(2).randn(2, 4, 4, 6).astype(np.float32)
    ones, zeros = np.ones(6, np.float32), np.zeros(6, np.float32)
    # 6 channels into 4 groups: both packages refuse.
    for fn in (t_groupnorm.groupnorm, t_groupnorm.groupnorm_reference):
        with pytest.raises(ValueError, match="divide"):
            fn(torch.tensor(x), torch.tensor(ones), torch.tensor(zeros), 4)
    with pytest.raises(ValueError, match="divide"):
        j_groupnorm.groupnorm(jnp.asarray(x), ones, zeros, 4)
    # An empty batch comes back as it went in.
    empty = torch.zeros(0, 4, 4, 6)
    assert t_groupnorm.groupnorm(empty, torch.tensor(ones), torch.tensor(zeros),
                                 3) is empty
    assert j_groupnorm.groupnorm(jnp.zeros((0, 4, 4, 6)), ones, zeros,
                                 3).shape == (0, 4, 4, 6)


def test_groupnorm_bf16_backward_matches_jax():
    """The port's plain backward (dx, dscale, dbias) in bf16 against the
    JAX `groupnorm` vjp, whose dx is its Pallas kernel in interpret mode;
    f32 inside on both sides, from the same numpy inputs. y and dx are
    bf16: one bf16 ulp (2⁻⁷) relative plus 2⁻⁷ absolute, for two
    roundings of values that differ only in f32 summation order. dscale
    and dbias are f32 sums over the slab's 2 x 64 positions of products
    of the same bf16 cotangent with norms that agree to f32 rounding: the
    order of 128 f32 additions moves a sum by under 128 · 2⁻²⁴ of its
    magnitude, inside rtol 1e-5."""
    from tf_yarn_tpu.ops import groupnorm as j_groupnorm

    x, scale, bias, w = _inputs((2, 8, 8, 32), seed=32, offset=0.5)
    y, vjp = jax.vjp(
        lambda x, s, b: j_groupnorm.groupnorm(x, s, b, 8, eps=1e-6,
                                              interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(t.astype(jnp.float32))
            for t in (y, *vjp(jnp.asarray(w, jnp.bfloat16)))]
    xt = torch.tensor(x).bfloat16().requires_grad_()
    st, bt = (torch.tensor(v, requires_grad=True) for v in (scale, bias))
    yt = t_groupnorm.groupnorm(xt, st, bt, 8, 1e-6)
    yt.backward(torch.tensor(w).bfloat16())
    assert yt.dtype == xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == bt.grad.dtype == torch.float32
    got = [t.detach().float().numpy() for t in (yt, xt.grad, st.grad, bt.grad)]
    for name, a, b in zip(("y", "dx"), got, want):
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=2 ** -7,
                                   err_msg=name)
    for name, a, b in zip(("dscale", "dbias"), got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("frozen", ["scale", "bias", "both"])
def test_groupnorm_frozen_parameters_get_no_gradient(frozen):
    """A frozen scale or bias gets no gradient and leaves dx and the other
    gradient as they are (the backward honours needs_input_grad)."""
    x, scale, bias, w = _inputs((2, 4, 4, 16), seed=7, offset=0.5)
    grads = []
    for freeze in (None, frozen):
        leaves = [torch.tensor(t, requires_grad=True) for t in (x, scale, bias)]
        if freeze in ("scale", "both"):
            leaves[1].requires_grad_(False)
        if freeze in ("bias", "both"):
            leaves[2].requires_grad_(False)
        (t_groupnorm.groupnorm(*leaves, 4, 1e-6) * torch.tensor(w)).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    full, part = grads
    assert torch.equal(part[0], full[0])
    assert (part[1] is None) == (frozen in ("scale", "both"))
    assert (part[2] is None) == (frozen in ("bias", "both"))
    for got, want in zip(part[1:], full[1:]):
        if got is not None:
            assert torch.equal(got, want)


def test_groupnorm_bwd_reference_matches_the_jax_backward():
    """The plain backward alone against the JAX custom_vjp's backward
    (its dx kernel in interpret mode, its XLA dscale and dbias), f32."""
    from tf_yarn_tpu.ops import groupnorm as j_groupnorm

    x, scale, bias, g = _inputs((3, 6, 5, 24), seed=9, offset=-1.0)
    want = j_groupnorm._groupnorm_bwd(
        6, 1e-6, True, True, tuple(map(jnp.asarray, (x, scale, bias))),
        jnp.asarray(g))
    xt = torch.tensor(x)
    stats = t_groupnorm.groupnorm_stats_reference(xt, 6, 1e-6)
    got = t_groupnorm.groupnorm_bwd_reference(xt, torch.tensor(g),
                                              torch.tensor(scale), stats, 6)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        # f32, sums in another order (dscale/dbias over 90 positions).
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert t_groupnorm.groupnorm_backward(
        xt, torch.tensor(g), torch.tensor(scale), stats, 6, dx=False,
        dbias=False)[::2] == (None, None)
