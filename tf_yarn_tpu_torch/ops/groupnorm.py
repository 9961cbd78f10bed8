"""Fused GroupNorm over NHWC slabs, forward and backward — counterpart of
tf_yarn_tpu/ops/groupnorm.py (the norm of ResNet).

x is ``[B, ..., C]`` with the channels last (``[B, H, W, C]`` or
``[B, L, C]``); each (image, group) is normalised over its spatial
positions and its ``C / groups`` channels, as flax's ``nn.GroupNorm``.
`groupnorm` is differentiable through a `torch.autograd.Function`: the
forward is the hand-written kernel of csrc/groupnorm.cu (replacing the
TPU kernel `_groupnorm_kernel`), which also returns each group's (mean,
inv) so the backward does not recompute them; dx comes from the dx kernel
of the same file (replacing `_groupnorm_bwd_dx_kernel`); dscale = Σ g·norm
and dbias = Σ g stay plain torch reductions, as the JAX package leaves
them to XLA. CUDA tensors launch the kernels (counted in
``groupnorm.launches`` and ``groupnorm_bwd_dx.launches``; each counted
call is two CUDA launches, a reduction and an apply pass), CPU tensors
take the plain versions the tests hold against the JAX package.

Layout: the kernels read x as contiguous ``[B, HW, C]``. A channels-last
NCHW tensor seen as NHWC (``x.permute(0, 2, 3, 1)``) is contiguous and is
taken as it is; a contiguous NCHW tensor seen that way is not, and the
wrapper raises rather than read it as garbage. The JAX package falls
back to its XLA reference for a slab over 8 MiB (its VMEM budget); the
card kernels serve every slab size, and both compute the same function
to f32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tf_yarn_tpu_torch.ops import _build

# Per-group sums live in the reduction kernel's shared memory (2·G f32).
MAX_GROUPS = 4096
# Elements of a slab each block covers: ~64 K, so the ResNet-50 slabs
# (100 K – 800 K elements an image) split into 2–13 chunks an image.
_CHUNK_ELEMENTS = 65536


def _check_groups(x: torch.Tensor, groups: int) -> None:
    if x.shape[-1] % groups:
        raise ValueError(
            f"channels ({x.shape[-1]}) must divide into groups ({groups})")


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x as f32 [B, HW, G, C/G]."""
    b, c = x.shape[0], x.shape[-1]
    return x.float().reshape(b, -1, groups, c // groups)


def groupnorm_stats_reference(x: torch.Tensor, groups: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """Each (image, group)'s (mean, rsqrt(var + eps)), the variance
    two-pass, as f32 [B, G, 2] (groupnorm.py:38-48)."""
    _check_groups(x, groups)
    xg = _grouped(x, groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    b = x.shape[0]
    return torch.stack([mean.reshape(b, groups),
                        torch.rsqrt(var + eps).reshape(b, groups)], -1)


def _normalize(x: torch.Tensor, stats: torch.Tensor, groups: int) -> torch.Tensor:
    """(x − mean)·inv in f32, x's shape."""
    b = x.shape[0]
    mean = stats[..., 0].reshape(b, 1, groups, 1)
    inv = stats[..., 1].reshape(b, 1, groups, 1)
    return ((_grouped(x, groups) - mean) * inv).reshape(x.shape)


def _affine(x, stats, scale, bias, groups: int) -> torch.Tensor:
    norm = _normalize(x, stats, groups)
    return (norm * scale.float() + bias.float()).to(x.dtype)


def groupnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """flax nn.GroupNorm over [B, ..., C] in f32, returned in x's dtype
    (groupnorm.py:51-60); raises ValueError when C % groups."""
    return _affine(x, groupnorm_stats_reference(x, groups, eps), scale, bias,
                   groups)


def groupnorm_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor,
                               scale: torch.Tensor, stats: torch.Tensor,
                               groups: int) -> torch.Tensor:
    """dx = inv·(gs − mean_g(gs) − norm·mean_g(gs·norm)), gs = g·scale,
    per (image, group) from the forward's `stats` [B, G, 2], in f32,
    returned in x's dtype (groupnorm.py:150-164)."""
    b = x.shape[0]
    norm = _grouped(_normalize(x, stats, groups), groups)
    gs = _grouped(g.float() * scale.float(), groups)
    m1 = gs.mean(dim=(1, 3), keepdim=True)
    m2 = (gs * norm).mean(dim=(1, 3), keepdim=True)
    inv = stats[..., 1].reshape(b, 1, groups, 1)
    return (inv * (gs - m1 - norm * m2)).reshape(x.shape).to(x.dtype)


def _slab(x: torch.Tensor) -> Tuple[int, int, int]:
    b, c = x.shape[0], x.shape[-1]
    return b, (x.numel() // (b * c) if b * c else 0), c


def _check_cuda(x: torch.Tensor, groups: int, **vectors: torch.Tensor):
    """The kernel's preconditions; returns (B, HW, C, rows per chunk,
    chunks) and the [C] vectors as contiguous f32."""
    _check_groups(x, groups)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    if x.dim() < 2:
        raise ValueError(f"x must be [B, ..., C], got shape {tuple(x.shape)}")
    b, hw, c = _slab(x)
    if not 0 < groups <= MAX_GROUPS:
        raise ValueError(f"groups must be in 1..{MAX_GROUPS}, got {groups}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 images")
    out = []
    for name, v in vectors.items():
        if v.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},), got {tuple(v.shape)}")
        v = v.detach().float().contiguous()
        _build.require_cuda(name, v, (torch.float32,))
        out.append(v)
    rows_per_chunk = max(1, min(hw, _CHUNK_ELEMENTS // c))
    chunks = -(-hw // rows_per_chunk)
    return (b, hw, c, rows_per_chunk, chunks), out


def groupnorm_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      groups: int, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): the normalised x in x's dtype and each (image, group)'s
    (mean, inv) as f32 [B, G, 2]. CUDA tensors launch the kernel, CPU
    tensors take `groupnorm_reference`'s arithmetic."""
    if not x.is_cuda:
        stats = groupnorm_stats_reference(x, groups, eps)
        return _affine(x, stats, scale, bias, groups), stats
    (b, hw, c, rows_per_chunk, chunks), (scale, bias) = _check_cuda(
        x, groups, scale=scale, bias=bias)
    y = torch.empty_like(x)
    stats = torch.empty(b, groups, 2, dtype=torch.float32, device=x.device)
    if hw == 0:
        return y, stats.zero_()
    partials = torch.empty(b, chunks, groups, 2, dtype=torch.float32,
                           device=x.device)
    lib = _build.load_library()
    status = lib.tyt_groupnorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), partials.data_ptr(), b, hw, c, groups,
        rows_per_chunk, chunks, float(eps), _build.DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device),
    )
    _build.check(status, "groupnorm")
    groupnorm.launches += 1
    return y, stats


def groupnorm_bwd_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                     stats: torch.Tensor, groups: int) -> torch.Tensor:
    """dx of `groupnorm` for the cotangent g (x's shape, cast to x's
    dtype), from the forward's `stats`. CUDA tensors launch the dx
    kernel, CPU tensors take `groupnorm_bwd_dx_reference`."""
    g = g.to(x.dtype)
    if not x.is_cuda:
        return groupnorm_bwd_dx_reference(x, g, scale, stats, groups)
    g = g.contiguous()
    (b, hw, c, rows_per_chunk, chunks), (scale,) = _check_cuda(x, groups,
                                                          scale=scale)
    _build.require_cuda("g", g, _build.DTYPE_CODES)
    if g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    _build.require_cuda("stats", stats, (torch.float32,))
    if stats.shape != (b, groups, 2):
        raise ValueError(f"stats must have shape {(b, groups, 2)}, "
                         f"got {tuple(stats.shape)}")
    dx = torch.empty_like(x)
    if hw == 0:
        return dx
    partials = torch.empty(b, chunks, groups, 2, dtype=torch.float32,
                           device=x.device)
    lib = _build.load_library()
    status = lib.tyt_groupnorm_bwd_dx(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), stats.data_ptr(),
        dx.data_ptr(), partials.data_ptr(), b, hw, c, groups, rows_per_chunk,
        chunks, _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "groupnorm_bwd_dx")
    groupnorm_bwd_dx.launches += 1
    return dx


class _GroupNorm(torch.autograd.Function):
    """The JAX `_groupnorm` custom_vjp (groupnorm.py:206-235), with the
    forward's statistics saved for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        y, stats = groupnorm_forward(x, scale, bias, groups, eps)
        ctx.save_for_backward(x, scale, stats)
        ctx.groups, ctx.bias_dtype = groups, bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dx = groupnorm_bwd_dx(x, g, scale, stats, ctx.groups)
        c = x.shape[-1]
        g32 = g.float().reshape(-1, c)
        if ctx.needs_input_grad[1]:
            norm = _normalize(x, stats, ctx.groups).reshape(-1, c)
            dscale = (g32 * norm).sum(0).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g32.sum(0).to(ctx.bias_dtype)
        return dx, dscale, dbias, None, None


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over x [B, ..., C] (channels last) with [C] scale and
    bias (read as f32); output in x's dtype; differentiable in x, scale
    and bias. An empty batch returns x; C % groups raises ValueError."""
    if x.shape[0] == 0:
        return x
    _check_groups(x, groups)
    return _GroupNorm.apply(x, scale, bias, groups, eps)


groupnorm.launches = 0
groupnorm_bwd_dx.launches = 0
