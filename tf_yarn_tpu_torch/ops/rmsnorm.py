"""Fused RMSNorm, forward and backward — counterpart of
tf_yarn_tpu/ops/rmsnorm.py.

`rmsnorm` is differentiable through a `torch.autograd.Function`: the
forward is the hand-written kernel of csrc/rmsnorm.cu (replacing the TPU
kernel `_rmsnorm_kernel`), dx comes from the dx kernel of the same file
(replacing `_rmsnorm_bwd_dx_kernel`), and dscale = Σ_rows g·x·r stays a
plain torch reduction outside the kernel, as the JAX package leaves it
to XLA. Each wrapper dispatches on the tensor's device: CUDA tensors
launch the kernel (counted in ``rmsnorm.launches`` and
``rmsnorm_bwd_dx.launches``), CPU tensors take the plain versions the
tests hold against the JAX package.
"""

from __future__ import annotations

import torch

from tf_yarn_tpu_torch.ops import _build


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """y = x · rsqrt(mean(x²) + eps) · scale over the last dim, in f32,
    returned in x's dtype."""
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (norm * scale.float()).to(x.dtype)


def rmsnorm_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor,
                             scale: torch.Tensor,
                             eps: float = 1e-5) -> torch.Tensor:
    """dx = r·(g·s) − x·r³·mean(g·s·x), r = rsqrt(mean(x²) + eps), in f32,
    returned in x's dtype (rmsnorm.py:55-61)."""
    x32 = x.float()
    gs = g.float() * scale.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    proj = torch.mean(gs * x32, dim=-1, keepdim=True)
    return (r * gs - x32 * (r * r * r) * proj).to(x.dtype)


def _check_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    scale = scale.detach().float().contiguous()
    _build.require_cuda("scale", scale, (torch.float32,))
    return scale


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return rmsnorm_reference(x, scale, eps)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    scale = _check_scale(x, scale)
    d = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = _build.load_library()
    status = lib.tyt_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "rmsnorm")
    rmsnorm.launches += 1
    return y


def rmsnorm_bwd_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """dx of `rmsnorm` for the cotangent g (x's shape, cast to x's
    dtype). CUDA tensors launch the dx kernel, CPU tensors take
    `rmsnorm_bwd_dx_reference`."""
    g = g.to(x.dtype)
    if not x.is_cuda:
        return rmsnorm_bwd_dx_reference(x, g, scale, eps)
    g = g.contiguous()
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    _build.require_cuda("g", g, _build.DTYPE_CODES)
    if g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    scale = _check_scale(x, scale)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx
    lib = _build.load_library()
    status = lib.tyt_rmsnorm_bwd_dx(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(), rows, d,
        float(eps), _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "rmsnorm_bwd_dx")
    rmsnorm_bwd_dx.launches += 1
    return dx


class _RMSNorm(torch.autograd.Function):
    """The JAX `_rmsnorm` custom_vjp with ``kernel_bwd=True``
    (rmsnorm.py:68-96)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = rmsnorm_bwd_dx(x, g, scale, ctx.eps)
        if ctx.needs_input_grad[1]:
            x32 = x.float()
            r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + ctx.eps)
            dscale = (g.float() * x32 * r).reshape(-1, x.shape[-1]).sum(0)
            dscale = dscale.to(scale.dtype)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., d] with a [d] scale (read as
    f32); output in x's dtype; differentiable in x and scale."""
    return _RMSNorm.apply(x, scale, eps)


rmsnorm.launches = 0
rmsnorm_bwd_dx.launches = 0
