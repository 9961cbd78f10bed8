"""Hashed linear classifier — counterpart of tf_yarn_tpu/models/linear.py,
BASELINE.json config 2 (the reference's ``tf.estimator.LinearClassifier``
on Criteo clicks).

Sparse logistic regression: categorical features arrive as hashed bucket
ids ``[B, n_features]`` (`hash_features`, crc32 on the host), and the
logit is the sum of their rows of a zero-initialised ``weights
[n_buckets, 1]`` f32 table, plus a ``bias [1]`` (plus ``dense @
dense_weights`` for ``n_dense`` numeric features). An id outside the
table reads what the JAX package's gather reads: a negative id counts
once from the end, then the id is clamped (`models.transformer.
vocab_index`). The JAX package computes it outside any Pallas kernel, so
the port is an embedding gather and a sum. It trains with adagrad
(`models.common.adagrad`) and the binary logistic loss, as JAX's
`make_experiment` does, on the same synthetic stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel.sharding import EMBED


@dataclasses.dataclass(frozen=True)
class LinearConfig:
    n_buckets: int = 2**20
    n_features: int = 39  # criteo clicks: 13 numeric + 26 categorical
    n_dense: int = 0


class HashedLinearClassifier(nn.Module):
    """``x`` int ``[B, F]`` bucket ids (and optional ``dense [B, n_dense]``)
    -> logit ``[B, 1]`` f32. Built on CUDA unless ``device="cpu"``, its
    parameters zeros (flax's zeros init), named as the flax tree."""

    def __init__(self, config: LinearConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        zeros = lambda *shape: nn.Parameter(torch.zeros(
            *shape, dtype=torch.float32, device=device))
        self.weights = zeros(config.n_buckets, 1)
        self.bias = zeros(1)
        self.dense_weights = zeros(config.n_dense, 1) if config.n_dense \
            else None
        sharding.annotate(self, weights=(EMBED, None))

    def forward(self, x: torch.Tensor, dense: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        from tf_yarn_tpu_torch.models.transformer import vocab_index

        rows = self.weights[vocab_index(x, self.config.n_buckets)]
        logit = rows.squeeze(-1).sum(-1, keepdim=True) + self.bias
        if dense is not None and self.dense_weights is not None:
            logit = logit + dense.float() @ self.dense_weights
        return logit


def hash_features(raw, n_buckets: int) -> np.ndarray:
    """Host-side feature hashing (linear.py:52-64): crc32 of each value's
    UTF-8 text, mod `n_buckets`, int32 ``[rows, features]`` — stable
    across processes and runs, unlike Python's salted ``hash``."""
    import zlib

    def bucket(value) -> int:
        return zlib.crc32(str(value).encode("utf-8")) % n_buckets

    return np.asarray([[bucket(v) for v in row] for row in raw],
                      dtype=np.int32)


def synthetic_stream(config: LinearConfig, batch_size: int):
    """The JAX experiment's endless batches (linear.py:82-88): a
    ``RandomState(0)`` hot set of 64 buckets, ids uniform over the table,
    the label whether a row holds a hot bucket."""
    rng = np.random.RandomState(0)
    hot = rng.randint(0, config.n_buckets, 64)
    while True:
        x = rng.randint(0, config.n_buckets, (batch_size, config.n_features))
        y = np.isin(x, hot).sum(axis=1) > 0
        yield {"x": x.astype(np.int32), "y": y.astype(np.int32)}


def make_experiment(config: Optional[LinearConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 200,
                    batch_size: int = 512, learning_rate: float = 0.05,
                    mesh_spec=None, input_fn=None, **train_param_overrides):
    """The linear classifier's experiment (linear.py:67-106): adagrad at
    `learning_rate`, the binary logistic loss, `synthetic_stream` unless
    `input_fn` is given. The model is built by `train_and_evaluate` on
    its device (``init_fn``)."""
    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
    from tf_yarn_tpu_torch.models import common

    config = config or LinearConfig()
    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=common.adagrad(learning_rate),
        loss_fn=common.binary_logistic_loss,
        train_input_fn=input_fn or (lambda: synthetic_stream(config,
                                                             batch_size)),
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: HashedLinearClassifier(config, device),
        mesh_spec=mesh_spec,
    )
