"""Fused LayerNorm, forward and backward — counterpart of
tf_yarn_tpu/ops/layernorm.py (the norm of BERT and ViT).

`layernorm` is differentiable through a `torch.autograd.Function`: the
forward is the hand-written kernel of csrc/layernorm.cu (replacing the
TPU kernel `_layernorm_kernel`), and the backward (`layernorm_backward`)
the same file's kernels: dx (replacing `_layernorm_bwd_dx_kernel`) and,
from the same read of x and g, the column sums dscale = Σ g·norm and
dbias = Σ g that the JAX package leaves to XLA, added over the blocks by
a second small launch. Each wrapper dispatches on the tensor's device:
CUDA tensors launch the kernels (counted in ``layernorm.launches``,
``layernorm_backward.launches`` and, for the dx kernel called alone,
``layernorm_bwd_dx.launches``), CPU tensors take the plain versions the
tests hold against the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def layernorm_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                            scale: torch.Tensor, eps: float = 1e-12
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) in f32: dx = r·(gs − mean(gs) −
    norm·mean(gs·norm)), gs = g·scale (layernorm.py:61-73), returned in
    x's dtype; dscale = Σ_rows g·norm and dbias = Σ_rows g
    (layernorm.py:102-111), f32 [d]."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    g32 = g.float().reshape(-1, d)
    gs = g32 * scale.float()
    centered = x32 - x32.mean(-1, keepdim=True)
    r = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + eps)
    norm = centered * r
    dx = r * (gs - gs.mean(-1, keepdim=True)
              - norm * (gs * norm).mean(-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), (g32 * norm).sum(0), g32.sum(0)


def layernorm_bwd_dx_reference(x: torch.Tensor, g: torch.Tensor,
                               scale: torch.Tensor,
                               eps: float = 1e-12) -> torch.Tensor:
    """dx of `layernorm_bwd_reference`, in x's dtype."""
    return layernorm_bwd_reference(x, g, scale, eps)[0]


# The backward's grid: blocks of BWD_WARPS warps (csrc/layernorm.cu
# kBwdWarps), each warp given BWD_ROWS_PER_WARP rows or more, at most
# BWD_BLOCKS_PER_SM blocks for each streaming multiprocessor, each block
# writing one [d, 2] row of f32 partials. The loop kernel keeps the
# [2, d] column sums in shared memory: d up to MAX_PARAMS_WIDTH.
BWD_WARPS = 8
BWD_ROWS_PER_WARP = 4
BWD_BLOCKS_PER_SM = 2
MAX_PARAMS_WIDTH = (232448 // 4 - 2 * BWD_WARPS) // 2


def layernorm_bwd_blocks(rows: int, sms: int) -> int:
    """Blocks of the backward that sums dscale and dbias: one for every
    BWD_WARPS x BWD_ROWS_PER_WARP rows, at most BWD_BLOCKS_PER_SM x `sms`
    (a function of the shape and the card alone, so the sums' order is
    too). Fewer, longer-lived warps cost each block's column sums and
    partials less at BERT-base's 4096 rows; ViT-B/16's 25216 fill the
    card."""
    per_block = BWD_WARPS * BWD_ROWS_PER_WARP
    return max(1, min(-(-rows // per_block), BWD_BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def layernorm_backward(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-12, need_dx: bool = True,
                       need_params: bool = True
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, dscale, dbias) of `layernorm` for the cotangent g (x's shape,
    cast to x's dtype): dx in x's dtype unless `need_dx` is False, dscale
    and dbias f32 [d] unless `need_params` is False (each then None).
    CUDA tensors launch the backward's kernels: without the parameters
    the dx kernel alone (`layernorm_bwd_dx`), else the column-sum kernel
    and the parameter sums (2 launches). CPU tensors take
    `layernorm_bwd_reference`."""
    if not (need_dx or need_params):
        raise ValueError("layernorm_backward needs dx or the parameters")
    g = g.to(x.dtype)
    if not x.is_cuda:
        dx, dscale, dbias = layernorm_bwd_reference(x, g, scale, eps)
        return (dx if need_dx else None, dscale if need_params else None,
                dbias if need_params else None)
    if not need_params:
        dx = layernorm_bwd_dx(x, g, scale, eps)
        layernorm_backward.launches += 1
        return dx, None, None
    g = g.contiguous()
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    _build.require_cuda("g", g, _build.DTYPE_CODES)
    if g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    scale = _check_vector("scale", x, scale)
    d = x.shape[-1]
    if d > MAX_PARAMS_WIDTH:
        raise ValueError(f"dscale and dbias are summed for d up to "
                         f"{MAX_PARAMS_WIDTH}, got {d}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    dscale, dbias = torch.empty(d, **f32), torch.empty(d, **f32)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dscale.zero_(), dbias.zero_()
    blocks = layernorm_bwd_blocks(rows, _sm_count(x.device))
    partials = torch.empty(blocks, d, 2, **f32)
    lib = _build.load_library()
    status = lib.tyt_layernorm_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(),
        None if dx is None else dx.data_ptr(), partials.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), rows, d, blocks, float(eps),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "layernorm_backward")
    layernorm_backward.launches += 1
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """The JAX `_layernorm` custom_vjp with ``kernel_bwd=True``
    (layernorm.py:80-114); a frozen x, scale or bias gets no gradient,
    and the kernels compute only what is wanted."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        need_dx, need_scale, need_bias = ctx.needs_input_grad[:3]
        dx, dscale, dbias = layernorm_backward(
            x, g, scale, ctx.eps, need_dx, need_scale or need_bias)
        return (dx, dscale.to(scale.dtype) if need_scale else None,
                dbias.to(bias.dtype) if need_bias else None, None)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last dim of x [..., d] with [d] scale and bias
    (read as f32); output in x's dtype; differentiable in x, scale and
    bias."""
    return _LayerNorm.apply(x, scale, bias, eps)


layernorm.launches = 0
layernorm_bwd_dx.launches = 0
layernorm_backward.launches = 0
