"""BERT-family encoder — counterpart of tf_yarn_tpu/models/bert.py
(BASELINE.json config 3, the BERT-base fine-tune).

Post-LN encoder blocks (attention, then the tanh-GELU MLP, each added to
the residual and normalised), token and position embeddings (the
segment embedding exists and is used only when segments are passed, as
in the JAX package), a [CLS] pooler with tanh and a classification head
whose logits are f32. Attention is non-causal through `ops.attention`
with the key-padding mask; every norm runs through `ops.layernorm` (the
hand-written kernels for CUDA tensors, the plain f32 version for CPU
ones), so ``fused_norms`` is accepted for the JAX configs' sake and
changes no number. Parameters are f32 masters cast to the compute dtype
at every use, named as the flax tree with ``/`` read as ``.``
(`models/weights.bert_from_flax`). Dropout masks come from the model's
own ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models import common
from tf_yarn_tpu_torch.models.transformer import LoraDense, _param, vocab_index
from tf_yarn_tpu_torch.ops.attention import attention
from tf_yarn_tpu_torch.ops.layernorm import layernorm
from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.sharding import EMBED, HEADS, KV, MLP, VOCAB


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    n_segments: int = 2
    num_classes: int = 2
    dropout_rate: float = 0.1
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"  # xla | flash | ring | ulysses | ulysses_flash
    # Accepted so JAX configs carry over, and ignored: every norm runs
    # through ops.layernorm.
    fused_norms: bool = False
    # LoRA adapters on the encoder are not ported (rank 0 only).
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def base(cls, **overrides) -> "BertConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "BertConfig":
        defaults = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                        d_ff=64, max_seq_len=64, dropout_rate=0.0)
        defaults.update(overrides)
        return cls(**defaults)


def check_encoder_config(config) -> None:
    """What the encoder families refuse: LoRA adapters. Every attention
    backend runs (ring and Ulysses cut the sequence over the run's ``sp``
    dim, as the JAX encoders' do); a padded batch's mask needs ``"xla"``,
    which `ops.attention.attention` enforces as the JAX package does."""
    if config.lora_rank > 0:
        raise NotImplementedError(
            "LoRA adapters on the encoder families are not ported yet "
            "(ROADMAP.md Queue 1 item 8); use lora_rank=0")


class BertNorm(nn.Module):
    """LayerNorm with flax nn.LayerNorm's parameters (``scale`` ones,
    ``bias`` zeros, f32), output cast to the compute dtype."""

    def __init__(self, config, device):
        super().__init__()
        self.config = config
        self.scale = _param((config.d_model,), True, config, device)
        self.bias = _param((config.d_model,), True, config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return layernorm(x, self.scale, self.bias, cfg.norm_eps).to(cfg.dtype)


def _dense(features_in: int, features_out: int, config, device,
           axes) -> LoraDense:
    """The JAX `_Dense`: a trained LoraDense with a bias, its kernel
    annotated with the logical `axes`."""
    return LoraDense(features_in, features_out, config, device,
                     trainable=True, use_bias=True, axes=axes)


class EncoderBlock(nn.Module):
    """Post-LN block shared by BERT and ViT (bert.py:94-119)."""

    def __init__(self, config, device):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.wq = _dense(d, d, cfg, device, (EMBED, HEADS))
        self.wk = _dense(d, d, cfg, device, (EMBED, KV))
        self.wv = _dense(d, d, cfg, device, (EMBED, KV))
        self.wo = _dense(d, d, cfg, device, (HEADS, EMBED))
        self.attn_norm = BertNorm(cfg, device)
        self.ffn_in = _dense(d, cfg.d_ff, cfg, device, (EMBED, MLP))
        self.ffn_out = _dense(cfg.d_ff, d, cfg, device, (MLP, EMBED))
        self.ffn_norm = BertNorm(cfg, device)
        # Under tp: the rank's heads and hidden features (the dense
        # layers' annotations), its input entering through copy_in.
        self.tp = None

    def forward(self, x: torch.Tensor, generator: torch.Generator,
                deterministic: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        enter = ((lambda t: t) if self.tp is None
                 else (lambda t: tp_lib.copy_in(t, self.tp)))
        x_in = enter(x)
        split = lambda t: t.reshape(b, s, -1, cfg.head_dim)
        out = attention(split(self.wq(x_in)), split(self.wk(x_in)),
                        split(self.wv(x_in)), impl=cfg.attention_impl,
                        causal=False, key_padding_mask=attention_mask)
        out = self.wo(out.reshape(b, s, -1))
        out = common.dropout(out, cfg.dropout_rate, deterministic, generator)
        x = self.attn_norm(x + out)
        # flax nn.gelu is the tanh approximation.
        h = self.ffn_out(F.gelu(self.ffn_in(enter(x)), approximate="tanh"))
        h = common.dropout(h, cfg.dropout_rate, deterministic, generator)
        return self.ffn_norm(x + h)


class BertEncoder(nn.Module):
    """tokens [B, S] (+ optional segments [B, S], attention_mask [B, S]
    with 1 = real token) -> pooled [B, d_model] (bert.py:122-164)."""

    def __init__(self, config: BertConfig, device):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = _param((cfg.vocab_size, cfg.d_model), True,
                                      cfg, device)
        self.position_embedding = _param((cfg.max_seq_len, cfg.d_model), True,
                                         cfg, device)
        self.segment_embedding = _param((cfg.n_segments, cfg.d_model), True,
                                        cfg, device)
        self.embed_norm = BertNorm(cfg, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, device))
        self.pooler = _dense(cfg.d_model, cfg.d_model, cfg, device,
                             (EMBED, None))
        sharding.annotate(self, token_embedding=(VOCAB, EMBED),
                          position_embedding=(None, EMBED))
        self.tp = None

    def forward(self, tokens: torch.Tensor, generator: torch.Generator,
                segments: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        s = tokens.shape[1]
        ids = vocab_index(tokens, cfg.vocab_size)
        x = (self.token_embedding[ids].to(cfg.dtype) if self.tp is None
             else tp_lib.vocab_embed(self.token_embedding, ids,
                                     cfg.vocab_size, self.tp, cfg.dtype))
        x = x + self.position_embedding[:s].to(cfg.dtype)[None]
        if segments is not None:
            x = x + self.segment_embedding[
                vocab_index(segments, cfg.n_segments)].to(cfg.dtype)
        x = self.embed_norm(x)
        x = common.dropout(x, cfg.dropout_rate, deterministic, generator)
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, generator, deterministic,
                                            attention_mask)
        return torch.tanh(self.pooler(x[:, 0]))


class BertClassifier(nn.Module):
    """tokens [B, S] -> f32 logits [B, num_classes]. Built on CUDA unless
    ``device="cpu"`` is passed; weights uninitialised until
    `common.init_weights` or a state dict fills them."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        check_encoder_config(config)
        device = resolve_device(device)
        self.config = config
        self.encoder = BertEncoder(config, device)
        self.classifier = _dense(config.d_model, config.num_classes, config,
                                 device, (EMBED, None))
        self.generator = torch.Generator(device=device)

    @property
    def device(self) -> torch.device:
        return self.classifier.kernel.device

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pooled = self.encoder(tokens, self.generator,
                              deterministic=deterministic,
                              attention_mask=attention_mask)
        return self.classifier(pooled).float()


def make_model(config: BertConfig, seed: int = 0, device=None) -> BertClassifier:
    """A `BertClassifier` on `device` (CUDA by default) with random
    weights from a generator seeded with `seed`; its dropout generator
    is seeded with `seed` too."""
    model = BertClassifier(config, device=device)
    model.generator.manual_seed(int(seed))
    return common.init_weights(
        model, torch.Generator(device=model.device).manual_seed(int(seed)))


def loss_fn(model, batch, train: bool = True):
    """Cross-entropy and accuracy over {"x": tokens, "y": labels} with an
    optional "mask" [B, S] for padded batches (bert.py:210-218)."""
    mask = batch.get("mask")
    logits = model(batch["x"], deterministic=not train, attention_mask=mask)
    labels = batch["y"].long()
    loss = F.cross_entropy(logits, labels)
    return loss, {"accuracy": (logits.argmax(-1) == labels).float().mean()}


def make_experiment(config: Optional[BertConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 100,
                    batch_size: int = 32, seq_len: int = 128,
                    learning_rate: float = 2e-5, mesh_spec=None,
                    input_fn=None, **train_param_overrides):
    """Sequence-classification fine-tune (bert.py:181-231): synthetic
    tokens unless `input_fn` yields {"x": tokens, "y": labels} (plus
    "mask" for padded batches); ``optax.adamw(learning_rate)``, weight
    decay 1e-4 on every parameter. The model is built by
    `train_and_evaluate` on its device, with random weights from
    ``train_params.seed``."""
    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams

    config = config or BertConfig.base()
    check_encoder_config(config)

    def synthetic():
        rng = np.random.RandomState(0)
        while True:
            tokens = rng.randint(0, config.vocab_size, (batch_size, seq_len))
            labels = (tokens[:, 0] % config.num_classes).astype(np.int32)
            yield {"x": tokens.astype(np.int32), "y": labels}

    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=common.adamw(learning_rate),
        loss_fn=loss_fn,
        train_input_fn=input_fn or synthetic,
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: make_model(config, seed, device),
        mesh_spec=mesh_spec,
    )
