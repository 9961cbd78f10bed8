"""Fused LayerNorm, forward and backward — counterpart of
tf_yarn_tpu/ops/layernorm.py (the norm of BERT and ViT).

`layernorm` is differentiable through a `torch.autograd.Function`: the
forward is the hand-written kernel of csrc/layernorm.cu (replacing the
TPU kernel `_layernorm_kernel`), dx comes from the dx kernel of the same
file (replacing `_layernorm_bwd_dx_kernel`), and dscale = Σ g·norm and
dbias = Σ g stay plain torch reductions outside the kernel, as the JAX
package leaves them to XLA. Each wrapper dispatches on the tensor's
device: CUDA tensors launch the kernel (counted in
``layernorm.launches`` and ``layernorm_bwd_dx.launches``), CPU tensors
take the plain versions the tests hold against the JAX package.
"""

from __future__ import annotations

import torch

from tf_yarn_tpu_torch.ops import _build


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(x − mean)·rsqrt(var + eps)·scale + bias over the last dim, the
    variance two-pass, in f32, returned in x's dtype (layernorm.py:26-33)."""
    x32 = x.float()
    centered = x32 - x32.mean(-1, keepdim=True)
    var = (centered * centered).mean(-1, keepdim=True)
    norm = centered * torch.rsqrt(var + eps)
    return (norm * scale.float() + bias.float()).to(x.dtype)


def layernorm_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor,
                               scale: torch.Tensor,
                               eps: float = 1e-12) -> torch.Tensor:
    """dx = r·(gs − mean(gs) − norm·mean(gs·norm)), gs = g·scale, in f32,
    returned in x's dtype (layernorm.py:61-73)."""
    x32 = x.float()
    gs = g.float() * scale.float()
    centered = x32 - x32.mean(-1, keepdim=True)
    r = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + eps)
    norm = centered * r
    dx = r * (gs - gs.mean(-1, keepdim=True)
              - norm * (gs * norm).mean(-1, keepdim=True))
    return dx.to(x.dtype)


def _check_vector(name: str, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    if v.shape != (d,):
        raise ValueError(f"{name} must have shape ({d},), got {tuple(v.shape)}")
    v = v.detach().float().contiguous()
    _build.require_cuda(name, v, (torch.float32,))
    return v


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return layernorm_reference(x, scale, bias, eps)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    scale = _check_vector("scale", x, scale)
    bias = _check_vector("bias", x, bias)
    d = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = _build.load_library()
    status = lib.tyt_layernorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        float(eps), _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "layernorm")
    layernorm.launches += 1
    return y


def layernorm_bwd_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """dx of `layernorm` for the cotangent g (x's shape, cast to x's
    dtype). CUDA tensors launch the dx kernel, CPU tensors take
    `layernorm_bwd_dx_reference`."""
    g = g.to(x.dtype)
    if not x.is_cuda:
        return layernorm_bwd_dx_reference(x, g, scale, eps)
    g = g.contiguous()
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    _build.require_cuda("g", g, _build.DTYPE_CODES)
    if g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    scale = _check_vector("scale", x, scale)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx
    lib = _build.load_library()
    status = lib.tyt_layernorm_bwd_dx(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(), rows, d,
        float(eps), _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "layernorm_bwd_dx")
    layernorm_bwd_dx.launches += 1
    return dx


class _LayerNorm(torch.autograd.Function):
    """The JAX `_layernorm` custom_vjp with ``kernel_bwd=True``
    (layernorm.py:80-114)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dx = layernorm_bwd_dx(x, g, scale, ctx.eps)
        g32 = g.float().reshape(-1, x.shape[-1])
        if ctx.needs_input_grad[1]:
            x32 = x.float().reshape(-1, x.shape[-1])
            centered = x32 - x32.mean(-1, keepdim=True)
            norm = centered * torch.rsqrt(
                (centered * centered).mean(-1, keepdim=True) + ctx.eps)
            dscale = (g32 * norm).sum(0).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g32.sum(0).to(bias.dtype)
        return dx, dscale, dbias, None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last dim of x [..., d] with [d] scale and bias
    (read as f32); output in x's dtype; differentiable in x, scale and
    bias."""
    return _LayerNorm.apply(x, scale, bias, eps)


layernorm.launches = 0
layernorm_bwd_dx.launches = 0
