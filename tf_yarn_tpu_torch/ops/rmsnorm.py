"""Fused RMSNorm forward — counterpart of tf_yarn_tpu/ops/rmsnorm.py.

`rmsnorm` dispatches on the tensor's device: a CUDA tensor goes to the
hand-written kernel (csrc/rmsnorm.cu, which replaces the TPU kernel
`_rmsnorm_kernel`), a CPU tensor to `rmsnorm_reference`, the plain
version the tests hold against the JAX package. Forward only: serving
has no backward (the dx kernel is still to port, ROADMAP.md Queue 2).
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., d] with a [d] scale (read as
    f32); output in x's dtype. CUDA tensors launch the kernel (counted
    in `rmsnorm.launches`), CPU tensors take the plain version."""
    if not x.is_cuda:
        return rmsnorm_reference(x, scale, eps)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    scale = scale.float().contiguous()
    _build.require_cuda("scale", scale, (torch.float32,))
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


rmsnorm.launches = 0
