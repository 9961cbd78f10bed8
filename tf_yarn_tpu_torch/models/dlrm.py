"""DLRM, the click-through ranker — counterpart of
tf_yarn_tpu/models/dlrm.py.

Categorical ids gather from ONE stacked table ``[sum(table_sizes),
embed_dim]`` (each id folded into its own table with ``cat % sizes +
offsets`` first, so an id out of range reads a row of its own table and
never a neighbour's); a bottom MLP over the dense features; the pairwise
dots of every feature vector with every other in one batched product,
of which the strict upper triangle is kept; a top MLP and an f32 head.
The JAX package computes all of it outside any Pallas kernel, so the
port is an embedding gather, matmuls and `torch.bmm` too.

A ranking replica over a tp group (`models.rank_engine.RankEngine(
mesh=)`) cuts the stacked table's rows over the ranks under
`parallel.sharding.RANKING_RULES` (`parallel.tensor_parallel.shard`
sets ``tp``); its lookup is the vocab-parallel one
(`tensor_parallel.vocab_embed`: each id's row from the one rank that
holds it, the others' zeros, summed), so every rank computes the rest
of the forward on the same exact rows. Every other parameter stays
whole.

Numbers as flax computes them: every Dense casts its input, kernel and
bias to its dtype before the product and the bias add (bf16 in the
Criteo config), the head's dtype is f32, and the parameters are f32
masters. Parameters are named as the flax tree with ``/`` read as ``.``
(``embedding``, ``bottom0.kernel``, ``top0.bias``, ``head.kernel``),
kernels ``[in, out]``, so `models/weights.dlrm_from_flax` carries a JAX
model's variables over by name.
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
from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.sharding import EMBED


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    # Criteo clicks: 26 categorical + 13 numeric features.
    table_sizes: Tuple[int, ...] = (2**17,) * 26
    embed_dim: int = 64
    n_dense: int = 13
    bottom_mlp: Tuple[int, ...] = (512, 256)
    top_mlp: Tuple[int, ...] = (512, 256)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def total_buckets(self) -> int:
        return sum(self.table_sizes)

    @classmethod
    def criteo(cls, **overrides) -> "DLRMConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "DLRMConfig":
        defaults = dict(
            table_sizes=(64,) * 4, embed_dim=8, n_dense=4,
            bottom_mlp=(16,), top_mlp=(16,),
        )
        defaults.update(overrides)
        return cls(**defaults)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]`` and bias ``[out]`` in
    `param_dtype`; input, kernel and bias cast to `dtype`, then the
    product, then the bias add."""

    def __init__(self, features_in: int, features_out: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            features_in, features_out, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            features_out, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y + self.bias.to(self.dtype)


class DLRM(nn.Module):
    """``(cat [B, F] ids, dense [B, n_dense]) -> logit [B, 1]`` f32
    (dense is None when ``n_dense`` is 0). Built on CUDA unless
    ``device="cpu"`` is passed; weights uninitialised until
    `init_weights` or a state dict fills them."""

    def __init__(self, config: DLRMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        n_tables = len(cfg.table_sizes)
        self.embedding = nn.Parameter(torch.empty(
            cfg.total_buckets, cfg.embed_dim, dtype=cfg.param_dtype,
            device=device))
        sharding.annotate(self, embedding=(EMBED, None))
        # The rank's tp group once the table is cut over it (module
        # docstring); None on one device.
        self.tp = None
        width = cfg.n_dense
        self.bottom = []
        if cfg.n_dense:
            for index, out in enumerate(cfg.bottom_mlp + (cfg.embed_dim,)):
                layer = Dense(width, out, cfg.dtype, cfg.param_dtype, device)
                self.add_module(f"bottom{index}", layer)
                self.bottom.append(layer)
                width = out
        n_feats = n_tables + (1 if cfg.n_dense else 0)
        width = (cfg.embed_dim if cfg.n_dense else 0) \
            + n_feats * (n_feats - 1) // 2
        self.top = []
        for index, out in enumerate(cfg.top_mlp):
            layer = Dense(width, out, cfg.dtype, cfg.param_dtype, device)
            self.add_module(f"top{index}", layer)
            self.top.append(layer)
            width = out
        self.head = Dense(width, 1, torch.float32, cfg.param_dtype, device)
        # Constants built once on the model's device: each table's size
        # and first row in the stacked table, and the flat index of the
        # strict upper triangle of the [n, n] dot matrix, row-major as
        # np.triu_indices lists it.
        sizes = np.asarray(cfg.table_sizes, np.int64)
        offsets = np.concatenate(([0], np.cumsum(sizes[:-1])))
        iu, ju = np.triu_indices(n_feats, k=1)
        for name, value in (("sizes", sizes), ("offsets", offsets),
                            ("pairs", iu * n_feats + ju)):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=torch.int64, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DLRM":
        """Random weights from `generator` (on the model's device): the
        table N(0, 1/embed_dim), kernels N(0, 1/fan_in) (the lecun
        scale), biases zeros."""
        for name, param in self.named_parameters():
            if name == "embedding":
                param.normal_(0.0, self.config.embed_dim ** -0.5,
                              generator=generator)
            elif name.endswith("bias"):
                param.zero_()
            else:
                param.normal_(0.0, param.shape[0] ** -0.5,
                              generator=generator)
        return self

    def forward(self, cat: torch.Tensor, dense: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        # `deterministic` is the loss contract's (no dropout in DLRM).
        cfg = self.config
        n_tables = len(cfg.table_sizes)
        if cat.shape[-1] != n_tables:
            raise ValueError(
                f"cat has {cat.shape[-1]} features, config has {n_tables} tables"
            )
        if cfg.n_dense and dense is None:
            # The JAX model's top MLP refuses the narrower input too.
            raise ValueError(
                f"this model takes {cfg.n_dense} dense features; got none")
        # A floor mod (torch.remainder), as jnp's %: a negative id lands in
        # the same row of its table in both packages.
        ids = cat % self.sizes + self.offsets
        if self.tp is None:
            emb = F.embedding(ids, self.embedding).to(cfg.dtype)  # [B, F, D]
        else:
            emb = tp_lib.vocab_embed(self.embedding, ids, cfg.total_buckets,
                                     self.tp, cfg.dtype, "table rows")
        feats, bottom = emb, None
        if cfg.n_dense:
            x = dense.to(cfg.dtype)
            for layer in self.bottom:
                x = torch.relu(layer(x))
            bottom = x
            feats = torch.cat([x[:, None, :], emb], dim=1)  # [B, F+1, D]
        inter = torch.bmm(feats, feats.transpose(1, 2))
        pairs = inter.reshape(inter.shape[0], -1)[:, self.pairs]
        top = torch.cat([bottom, pairs], -1) if bottom is not None else pairs
        for layer in self.top:
            top = torch.relu(layer(top))
        return self.head(top)


def make_model(config: DLRMConfig, seed: int = 0, device=None) -> DLRM:
    """A `DLRM` on `device` (CUDA by default) with random weights from a
    generator seeded with `seed`."""
    model = DLRM(config, device=device)
    return model.init_weights(
        torch.Generator(device=model.device).manual_seed(int(seed)))


def dlrm_loss(model, batch, train: bool = True):
    """Sigmoid cross-entropy over {"cat", "dense", "y"} batches
    (dlrm.py:136-149): the mean of optax's
    ``sigmoid_binary_cross_entropy``, and the accuracy of the logit's
    sign."""
    logits = model(batch["cat"], batch.get("dense"),
                   deterministic=not train).squeeze(-1)
    labels = batch["y"].float()
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    accuracy = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"accuracy": accuracy}


def make_experiment(config: Optional[DLRMConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 200,
                    batch_size: int = 1024, learning_rate: float = 1e-3,
                    mesh_spec=None, input_fn=None, **train_param_overrides):
    """CTR training (dlrm.py:152-199): the JAX package's synthetic
    batches unless `input_fn` yields {"cat", "dense", "y"};
    ``optax.adagrad(learning_rate)`` (`common.adagrad`). The model is
    built by `train_and_evaluate` on its device (CUDA unless
    ``device="cpu"``), with random weights from ``train_params.seed``."""
    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams

    config = config or DLRMConfig.criteo()

    def synthetic():
        # Balanced, learnable labels: each bucket of table 0 carries a
        # fixed ±1 vote (memorisable in its embedding row), so a working
        # model separates the classes and a broken one sits at ~50%.
        rng = np.random.RandomState(0)
        n_tables = len(config.table_sizes)
        sizes = np.asarray(config.table_sizes)
        while True:
            cat = rng.randint(0, sizes, (batch_size, n_tables)).astype(np.int32)
            dense = rng.lognormal(0.0, 1.0, (batch_size, config.n_dense))
            y = cat[:, 0] % 2
            yield {
                "cat": cat,
                "dense": np.log1p(dense).astype(np.float32),
                "y": y.astype(np.int32),
            }

    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=common.adagrad(learning_rate),
        loss_fn=dlrm_loss,
        train_input_fn=input_fn or synthetic,
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: make_model(config, seed, device),
        mesh_spec=mesh_spec,
    )
