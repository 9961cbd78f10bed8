"""ResNet-50 with GroupNorm — counterpart of tf_yarn_tpu/models/resnet.py
(BASELINE.json config 4).

Images arrive NHWC ``[B, H, W, C]`` as in the JAX package. Inside, an
activation is an NCHW tensor in ``torch.channels_last`` memory, whose
storage is NHWC: the convolutions take cuDNN's channels-last path, and
the same tensor permuted to NHWC is contiguous, which is what the
GroupNorm kernels read (`ops.groupnorm`). Every norm runs through
`ops.groupnorm` (the kernels for CUDA tensors, the plain f32 version for
CPU ones), so ``fused_norms`` is accepted for the JAX configs' sake and
changes no number.

Flax's ``SAME`` padding puts the odd pixel at the end (low = total // 2):
the 7×7/2 stem on 224 pads (2, 3), a 3×3/2 conv or the 3×3/2 max-pool on
an even size pads (0, 1), the space-to-depth stem's 2×2 conv (0, 1).
PyTorch's symmetric ``padding=`` would shift such outputs by a pixel, so
`Conv` and the pool pad explicitly with ``F.pad`` when the two sides
differ (the pool with −inf). Conv kernels are stored ``[out, in, kh, kw]``
(torch's layout); the flax ones are HWIO (`models/weights.
resnet_from_flax` transposes them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models import common
from tf_yarn_tpu_torch.models.transformer import _param
from tf_yarn_tpu_torch.ops.groupnorm import groupnorm


# RGB: flax infers a conv's input channels at init, the port at
# construction; the zoo's images (make_experiment's synthetic input)
# have 3.
IMAGE_CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "conv": 7x7/2 conv + 3x3/2 max-pool; "space_to_depth": 4x4 pixel
    # blocks into 48 channels, then a 2x2 conv (H, W divisible by 4).
    stem: str = "conv"
    # Accepted so JAX configs carry over, and ignored: every norm runs
    # through ops.groupnorm.
    fused_norms: bool = False

    def __post_init__(self):
        if self.stem not in ("conv", "space_to_depth"):
            raise ValueError(
                f"stem must be 'conv' or 'space_to_depth', got {self.stem!r}")

    @classmethod
    def resnet50(cls, **overrides) -> "ResNetConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "ResNetConfig":
        defaults = dict(stage_sizes=(1, 1), num_classes=10, width=8,
                        num_groups=4)
        defaults.update(overrides)
        return cls(**defaults)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """x [B, C, H, W] padded for a SAME window: (x, symmetric pads) when
    both sides agree (left to the op), else (padded x, (0, 0))."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], kernel, stride),
                          same_pads(x.shape[3], kernel, stride))
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: kernel ``[out, in, k, k]``, optional
    bias, ``SAME`` or ``VALID`` padding, computed in the compute dtype
    (input, kernel and bias cast to it)."""

    def __init__(self, features_in: int, features_out: int, kernel: int,
                 config, device, stride: int = 1, padding: str = "SAME",
                 use_bias: bool = False):
        super().__init__()
        self.config, self.stride, self.padding = config, stride, padding
        self.kernel = _param((features_out, features_in, kernel, kernel),
                             True, config, device)
        self.bias = (_param((features_out,), True, config, device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        kernel = self.kernel.to(dtype=dtype, memory_format=torch.channels_last)
        pads = (0, 0)
        if self.padding == "SAME":
            x, pads = _pad_same(x, kernel.shape[-1], self.stride)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), kernel, bias, stride=self.stride,
                        padding=pads)


class GroupNormOp(nn.Module):
    """GroupNorm with flax nn.GroupNorm's parameters (resnet.py:63-81),
    eps 1e-6, over an NCHW channels-last x; output in the compute dtype."""

    def __init__(self, channels: int, num_groups: int, config, device):
        super().__init__()
        self.config, self.num_groups = config, num_groups
        self.scale = _param((channels,), True, config, device)
        self.bias = _param((channels,), True, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The NHWC view of a channels-last tensor is contiguous (no copy);
        # any other layout makes the kernel's wrapper raise.
        nhwc = x.permute(0, 2, 3, 1)
        y = groupnorm(nhwc, self.scale, self.bias, self.num_groups, eps=1e-6)
        return y.to(self.config.dtype).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (the stride) → 1x1 (x4), GroupNorm after each, with a
    projected shortcut where the shape changes (resnet.py:84-109)."""

    def __init__(self, features_in: int, filters: int, stride: int, config,
                 device):
        super().__init__()
        out = filters * 4
        norm = lambda c: GroupNormOp(c, min(config.num_groups, c), config,
                                     device)
        self.conv1 = Conv(features_in, filters, 1, config, device)
        self.norm1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, config, device, stride=stride)
        self.norm2 = norm(filters)
        self.conv3 = Conv(filters, out, 1, config, device)
        self.norm3 = norm(out)
        # The JAX block projects when the residual's shape differs from
        # the output's: a channel change or a stride.
        self.proj = self.proj_norm = None
        if features_in != out or stride != 1:
            self.proj = Conv(features_in, out, 1, config, device, stride=stride)
            self.proj_norm = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return F.relu(residual + y)


class _Head(nn.Module):
    """flax ``nn.Dense(dtype=float32)``: f32 x @ kernel + bias."""

    def __init__(self, features_in: int, features_out: int, config, device):
        super().__init__()
        self.kernel = _param((features_in, features_out), True, config, device)
        self.bias = _param((features_out,), True, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel.float() + self.bias.float()


class ResNet(nn.Module):
    """images [B, H, W, C] -> f32 logits [B, num_classes]. Built on CUDA
    unless ``device="cpu"`` is passed; weights uninitialised until
    `common.init_weights` or a state dict fills them."""

    def __init__(self, config: ResNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        stem_norm_groups = min(cfg.num_groups, cfg.width)
        if cfg.stem == "space_to_depth":
            self.stem = Conv(16 * IMAGE_CHANNELS, cfg.width, 2, cfg, device)
        else:
            self.stem = Conv(IMAGE_CHANNELS, cfg.width, 7, cfg, device,
                             stride=2)
        self.stem_norm = GroupNormOp(cfg.width, stem_norm_groups, cfg, device)
        features = cfg.width
        self.block_names = []
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                filters = cfg.width * 2 ** stage
                name = f"stage{stage}_block{block}"
                self.add_module(name, Bottleneck(features, filters, stride,
                                                 cfg, device))
                self.block_names.append(name)
                features = filters * 4
        self.head = _Head(features, cfg.num_classes, cfg, device)

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        # `deterministic` keeps the loss contract uniform (no dropout).
        cfg = self.config
        x = x.to(cfg.dtype)
        if cfg.stem == "space_to_depth":
            b, h, w, c = x.shape
            if h % 4 or w % 4:
                raise ValueError(
                    f"space_to_depth stem needs H, W divisible by 4, got "
                    f"{h}x{w}; pad/crop the input or use stem='conv'")
            x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // 4, w // 4, 16 * c)
            x = F.relu(self.stem_norm(self.stem(x.permute(0, 3, 1, 2))))
        else:
            x = F.relu(self.stem_norm(self.stem(x.permute(0, 3, 1, 2))))
            x, pads = _pad_same(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, stride=2, padding=pads)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))


def make_model(config: ResNetConfig, seed: int = 0, device=None) -> ResNet:
    """A `ResNet` on `device` (CUDA by default) with random weights from a
    generator seeded with `seed`."""
    model = ResNet(config, device=device)
    return common.init_weights(
        model, torch.Generator(device=model.device).manual_seed(int(seed)))


def make_experiment(config: Optional[ResNetConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 100,
                    batch_size: int = 128, image_size: int = 224,
                    learning_rate: float = 0.1, mesh_spec=None,
                    input_fn=None, **train_param_overrides):
    """Image classification (resnet.py:157-198): synthetic N(0, 1) images
    and uniform labels unless `input_fn` is given;
    ``optax.sgd(learning_rate, momentum=0.9)``. The model is built by
    `train_and_evaluate` on its device, with random weights from
    ``train_params.seed``."""
    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams

    config = config or ResNetConfig.resnet50()

    def synthetic():
        rng = np.random.RandomState(0)
        while True:
            yield {
                "x": rng.randn(batch_size, image_size, image_size, 3).astype(
                    np.float32),
                "y": rng.randint(0, config.num_classes,
                                 batch_size).astype(np.int32),
            }

    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=common.sgd(learning_rate, momentum=0.9),
        loss_fn=common.classification_loss,
        train_input_fn=input_fn or synthetic,
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: make_model(config, seed, device),
        mesh_spec=mesh_spec,
    )
