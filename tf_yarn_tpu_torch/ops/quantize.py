"""Per-row symmetric int8 quantization — counterpart of
tf_yarn_tpu/ops/quantize.py.

`quantize_int8` dispatches on the tensor's device: a CUDA tensor goes to
the hand-written kernel (csrc/quantize.cu, which replaces the TPU kernel
`_quantize_kernel`), a CPU tensor to `quantize_int8_reference`. Both
read x in f32 or bf16 and work on its exact f32 value, as the TPU kernel
does (``x_ref[...].astype(jnp.float32)``), and compute ``scale =
max(absmax, 1e-8) * float32(1/127)`` — XLA folds the JAX package's
division by the constant 127 into that multiply — and
``clip(round_half_even(x / scale), -127, 127)`` with a true division,
so on identical input they agree with the JAX package bit for bit.

`quantize_int8_grouped` (the paged pool's per-block scales) is a
reshape around `quantize_int8`, as in the JAX package: a group of
`group_rows` rows of width d is one row of width ``group_rows * d``,
which the kernel takes through its general path (its one-load-a-lane
path is for d 128 only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch.ops import _build

# The f32 reciprocal of 127 (equal to 1.0f / 127.0f in the kernel).
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_int8_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] -> (int8 values [..., d], f32 scales [..., 1])."""
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) * INV_127
    values = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return values, scale


def quantize_int8(x: torch.Tensor, *, stochastic: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] f32 or bf16 -> (int8 values [..., d], f32 scales
    [..., 1]). CUDA tensors launch the kernel (counted in
    `quantize_int8.launches`), CPU tensors take the plain version.
    Stochastic rounding needs the TPU's in-kernel PRNG and raises here,
    as the JAX package does off the TPU."""
    if stochastic:
        raise ValueError(
            "stochastic rounding needs the TPU PRNG; the port rounds to "
            "nearest even only"
        )
    if not x.is_cuda:
        return quantize_int8_reference(x)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    d = x.shape[-1]
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                         device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return values, scales
    lib = _build.load_library()
    status = lib.tyt_quantize_int8(
        x.data_ptr(), values.data_ptr(), scales.data_ptr(), rows, d,
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device),
    )
    _build.check(status, "quantize_int8")
    quantize_int8.launches += 1
    return values, scales


quantize_int8.launches = 0


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (values.float() * scales).to(dtype)


def quantize_int8_grouped(x: torch.Tensor, group_rows: int, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric int8 (quantize.py:93-118): x [..., R, d] ->
    (int8 values [..., R, d], f32 scales [..., R/group_rows, 1]), one
    abs-max scale shared by every `group_rows` consecutive rows. With
    ``group_rows`` the KV block size this is the paged pool's per-block
    scale layout. A CUDA tensor launches the kernel once, at row width
    ``group_rows * d``; a CPU tensor takes the plain version."""
    if group_rows < 1:
        raise ValueError(f"group_rows must be >= 1, got {group_rows}")
    *lead, rows, d = x.shape
    if rows % group_rows:
        raise ValueError(
            f"rows ({rows}) must divide by group_rows ({group_rows})"
        )
    grouped = x.reshape(*lead, rows // group_rows, group_rows * d)
    values, scales = quantize_int8(grouped, **kwargs)
    return values.reshape(x.shape), scales


def dequantize_int8_grouped(values: torch.Tensor, scales: torch.Tensor,
                            group_rows: int,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Inverse of `quantize_int8_grouped`: values [..., R, d] + scales
    [..., R/group_rows, 1] -> [..., R, d]."""
    *lead, rows, d = values.shape
    grouped = values.reshape(*lead, rows // group_rows, group_rows * d)
    return dequantize_int8(grouped, scales, dtype).reshape(values.shape)
