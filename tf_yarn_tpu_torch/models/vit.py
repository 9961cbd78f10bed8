"""Vision Transformer — counterpart of tf_yarn_tpu/models/vit.py.

Patchify with one ``VALID`` convolution whose stride is the patch
(`resnet.Conv`, cuDNN), a CLS token and learned position embeddings,
then BERT's `EncoderBlock` (every norm through `ops.layernorm`, eps
1e-6) and a final norm; the head reads the CLS position and its logits
are f32. Images arrive NHWC ``[B, H, W, C]`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models import common
from tf_yarn_tpu_torch.models.bert import (BertNorm, EncoderBlock, _dense,
                                           check_encoder_config)
from tf_yarn_tpu_torch.models.resnet import IMAGE_CHANNELS, Conv
from tf_yarn_tpu_torch.models.transformer import _param
from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel.sharding import EMBED


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dropout_rate: float = 0.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"  # xla | flash | ring | ulysses | ulysses_flash
    lora_rank: int = 0  # LoRA adapters on the encoder are not ported
    lora_alpha: float = 16.0
    # Accepted so JAX configs carry over, and ignored: every norm runs
    # through ops.layernorm.
    fused_norms: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def base16(cls, **overrides) -> "ViTConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "ViTConfig":
        defaults = dict(image_size=32, patch_size=8, num_classes=10,
                        d_model=32, n_layers=2, n_heads=2, d_ff=64)
        defaults.update(overrides)
        return cls(**defaults)


class ViT(nn.Module):
    """images [B, H, W, C] -> f32 logits [B, num_classes]. Built on CUDA
    unless ``device="cpu"`` is passed; weights uninitialised until
    `common.init_weights` or a state dict fills them."""

    def __init__(self, config: ViTConfig, device=None):
        super().__init__()
        check_encoder_config(config)
        device = resolve_device(device)
        cfg = self.config = config
        p = cfg.patch_size
        self.patchify = Conv(IMAGE_CHANNELS, cfg.d_model, p, cfg, device,
                             stride=p, padding="VALID", use_bias=True)
        self.cls_token = _param((1, 1, cfg.d_model), True, cfg, device)
        self.position_embedding = _param((cfg.n_patches + 1, cfg.d_model),
                                         True, cfg, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, device))
        self.final_norm = BertNorm(cfg, device)
        self.head = _dense(cfg.d_model, cfg.num_classes, cfg, device,
                           (EMBED, None))
        sharding.annotate(self, position_embedding=(None, EMBED))
        self.generator = torch.Generator(device=device)

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        if x.shape[1] != cfg.image_size or x.shape[2] != cfg.image_size:
            raise ValueError(
                f"expected {cfg.image_size}x{cfg.image_size} images, "
                f"got {x.shape[1]}x{x.shape[2]}")
        patches = self.patchify(x.to(cfg.dtype).permute(0, 3, 1, 2))
        b = patches.shape[0]
        # [B, d, h, w] -> [B, h·w, d]: patches in row-major order, as the
        # JAX reshape of the NHWC output.
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.d_model)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(cfg.dtype)[None]
        x = common.dropout(x, cfg.dropout_rate, deterministic, self.generator)
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, self.generator, deterministic)
        x = self.final_norm(x)
        return self.head(x[:, 0]).float()


def make_model(config: ViTConfig, seed: int = 0, device=None) -> ViT:
    """A `ViT` on `device` (CUDA by default) with random weights from a
    generator seeded with `seed`; its dropout generator is seeded with
    `seed` too."""
    model = ViT(config, device=device)
    model.generator.manual_seed(int(seed))
    return common.init_weights(
        model, torch.Generator(device=model.device).manual_seed(int(seed)))


def make_experiment(config: Optional[ViTConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 100,
                    batch_size: int = 128, learning_rate: float = 3e-4,
                    mesh_spec=None, input_fn=None, **train_param_overrides):
    """Image classification (vit.py:112-151): synthetic N(0, 1) images and
    uniform labels unless `input_fn` is given; ``optax.adamw(
    learning_rate, weight_decay=0.05)`` on every parameter. The model is
    built by `train_and_evaluate` on its device, with random weights from
    ``train_params.seed``."""
    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams

    config = config or ViTConfig.base16()
    check_encoder_config(config)

    def synthetic():
        rng = np.random.RandomState(0)
        size = config.image_size
        while True:
            yield {
                "x": rng.randn(batch_size, size, size, 3).astype(np.float32),
                "y": rng.randint(0, config.num_classes,
                                 batch_size).astype(np.int32),
            }

    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=common.adamw(learning_rate, weight_decay=0.05),
        loss_fn=common.classification_loss,
        train_input_fn=input_fn or synthetic,
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: make_model(config, seed, device),
        mesh_spec=mesh_spec,
    )
