"""MNIST-style dense classifier — counterpart of
tf_yarn_tpu/models/mnist.py.

`DenseClassifier` is the JAX package's plain MLP (``x`` flattened, then
``Dense -> relu`` per hidden size, dropout after each when its rate is
set, and a last ``Dense`` to the classes). Its layers are named as the
flax tree (``Dense_0``, ``Dense_1``, ...) with ``kernel [in, out]`` and
``bias``, so `models.weights.mnist_from_flax` maps the JAX variables by
name. flax infers the input width at init; a torch module needs it at
construction (``in_features``). The weights start as flax's do in law
(LeCun normal kernels, zero biases), from a seeded generator.

`make_experiment` is the JAX one's (Adam, `common.classification_loss`,
`common.synthetic_classification_iter` by default): the model the JAX
package's multi-host tests train (tests/test_multihost.py), which the
port's multi-rank tests train too.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
from tf_yarn_tpu_torch.models import common

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated law has variance 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


class Dense(nn.Module):
    """``x @ kernel + bias``, kernel ``[in, out]`` as flax lays it out."""

    def __init__(self, features_in: int, features_out: int, device) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features_out,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class DenseClassifier(nn.Module):
    def __init__(self, in_features: int = 784,
                 hidden_sizes: Sequence[int] = (512, 256),
                 num_classes: int = 10, dropout_rate: float = 0.0,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.dropout_rate = dropout_rate
        widths = [in_features, *hidden_sizes, num_classes]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                                device))

    def forward(self, x: torch.Tensor,
                deterministic: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_dense - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            if self.dropout_rate:
                x = nn.functional.dropout(x, self.dropout_rate,
                                          training=not deterministic)
        return getattr(self, f"Dense_{self.n_dense - 1}")(x)

    def init_weights(self, generator: torch.Generator) -> "DenseClassifier":
        with torch.no_grad():
            for i in range(self.n_dense):
                dense = getattr(self, f"Dense_{i}")
                std = math.sqrt(1.0 / dense.kernel.shape[0]) / _TRUNCATED_STD
                nn.init.trunc_normal_(dense.kernel, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                dense.bias.zero_()
        return self


def make_model(in_features: int = 784, hidden_sizes: Sequence[int] = (512, 256),
               num_classes: int = 10, seed: int = 0, device=None,
               dropout_rate: float = 0.0) -> DenseClassifier:
    """A `DenseClassifier` on `device` (CUDA by default) with weights from
    a generator seeded with `seed`."""
    model = DenseClassifier(in_features, hidden_sizes, num_classes,
                            dropout_rate, device=device)
    device = model.Dense_0.kernel.device
    return model.init_weights(
        torch.Generator(device=device).manual_seed(int(seed)))


def adam(learning_rate: float):
    """``optax.adam(learning_rate)``: torch's Adam (betas 0.9, 0.999, eps
    1e-8 in both) over the parameters that require grad."""

    def make(model: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad],
            lr=learning_rate)

    return make


def make_experiment(
    model_dir: Optional[str] = None,
    train_steps: int = 200,
    batch_size: int = 128,
    feature_dim: int = 784,
    num_classes: int = 10,
    learning_rate: float = 1e-3,
    mesh_spec=None,
    input_fn=None,
    eval_input_fn=None,
    hidden_sizes: Sequence[int] = (512, 256),
    **train_param_overrides,
) -> TorchExperiment:
    """mnist.py:37-66: the model is built by the train loop on its device
    (``init_fn``) with weights from ``train_params.seed``."""
    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        init_fn=lambda device, seed: make_model(
            feature_dim, hidden_sizes, num_classes, seed, device),
        optimizer=adam(learning_rate),
        loss_fn=common.classification_loss,
        train_input_fn=input_fn or (
            lambda: common.synthetic_classification_iter(
                batch_size, feature_dim, num_classes)),
        eval_input_fn=eval_input_fn,
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        mesh_spec=mesh_spec,
    )
