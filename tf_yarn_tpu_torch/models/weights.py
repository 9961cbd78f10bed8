"""Bridge from the JAX package's flax variables to the port's state dict.

`from_flax(variables, config)` takes the variables of
`tf_yarn_tpu.models.transformer.Transformer` — ``{"params": ...}`` or
the inner params tree, leaves as numpy arrays (``np.asarray`` of jax
arrays) — and returns a state dict for
`tf_yarn_tpu_torch.models.transformer.Transformer`. It reads both layer
layouts the JAX package writes (transformer.py:467-477, 519-522):

* ``layers/block/...`` — `scan_layers=True`: every leaf carries a
  leading layer axis, unstacked here;
* ``layer_{i}/block/...`` — the unrolled loop.

Dense kernels keep the JAX ``[in, out]`` layout (``"...d,df"``), which is
the port's `LoraDense.kernel` layout too: nothing is transposed. With
``config.lora_rank > 0`` every dense also maps its ``lora_a`` ``[in,
rank]`` and ``lora_b`` ``[rank, out]`` leaves. With ``config.moe_experts >
0`` a block's ``moe/{router,w_gate,w_up,w_down}`` (the Switch MLP, in
the JAX layouts ``[d, E]``, ``[E, d, d_ff]`` and ``[E, d_ff, d]``) take
the place of its ``mlp`` denses. Leaves come back as f32
tensors (the JAX params are f32); `load_state_dict` casts each to its
parameter's dtype, so f32 masters stay f32. Every leaf must be consumed
and every port parameter filled, or it raises. The port imports no JAX:
this module only walks nested mappings.

`bert_from_flax`, `vit_from_flax`, `resnet_from_flax`,
`dlrm_from_flax`, `mnist_from_flax` and `linear_from_flax` bridge the
encoder and vision families, the DLRM ranker, the MNIST classifier and
the hashed linear classifier. Their port modules are named as the flax
tree (``encoder/layer_0/wq/kernel`` is ``encoder.layer_0.wq.kernel``),
so each leaf maps by reading ``/`` as ``.``; conv kernels go from flax's
HWIO to torch's ``[out, in, kh, kw]``. The same rule holds: every leaf
consumed, every parameter filled, every shape equal, or it raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from tf_yarn_tpu_torch.models.transformer import TransformerConfig

# flax path under a block -> port name under `layers.{i}.`
_BLOCK_LEAVES = {
    "attn_norm/scale": "attn_norm.scale",
    "attn/wq/kernel": "attn.wq.kernel",
    "attn/wk/kernel": "attn.wk.kernel",
    "attn/wv/kernel": "attn.wv.kernel",
    "attn/wo/kernel": "attn.wo.kernel",
    "mlp_norm/scale": "mlp_norm.scale",
    "mlp/w_gate/kernel": "mlp.w_gate.kernel",
    "mlp/w_up/kernel": "mlp.w_up.kernel",
    "mlp/w_down/kernel": "mlp.w_down.kernel",
}
_DENSES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
           "mlp/w_gate", "mlp/w_up", "mlp/w_down")
_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")
_TOP_LEAVES = {
    "embedding": "embedding",
    "lm_head": "lm_head",
    "final_norm/scale": "final_norm.scale",
}


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(getattr(value, "value", value))
    return out


def from_flax(variables, config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict (f32 CPU tensors; `load_state_dict` casts
    them to each parameter's dtype and device)."""
    params = variables.get("params", variables)
    flat = _flatten(params)
    state: Dict[str, torch.Tensor] = {}

    def take(path: str) -> np.ndarray:
        try:
            return flat.pop(path)
        except KeyError:
            raise KeyError(f"flax variables have no leaf {path!r}") from None

    for path, name in _TOP_LEAVES.items():
        state[name] = torch.from_numpy(np.array(take(path), np.float32))
    scanned = any(path.startswith("layers/block/") for path in flat)
    block_leaves = dict(_BLOCK_LEAVES)
    denses = _DENSES
    if config.moe_experts > 0:
        block_leaves = {path: name for path, name in block_leaves.items()
                        if not path.startswith("mlp/")}
        block_leaves.update({f"moe/{leaf}": f"moe.{leaf}"
                             for leaf in _MOE_LEAVES})
        denses = tuple(d for d in _DENSES if not d.startswith("mlp/"))
    if config.lora_rank > 0:
        for dense in denses:
            for factor in ("lora_a", "lora_b"):
                block_leaves[f"{dense}/{factor}"] = (
                    f"{dense.replace('/', '.')}.{factor}")
    for path, name in block_leaves.items():
        if scanned:
            stacked = take(f"layers/block/{path}")
            if stacked.shape[0] != config.n_layers:
                raise ValueError(
                    f"layers/block/{path} stacks {stacked.shape[0]} layers, "
                    f"config has {config.n_layers}"
                )
            layers = list(stacked)
        else:
            layers = [take(f"layer_{i}/block/{path}")
                      for i in range(config.n_layers)]
        for i, leaf in enumerate(layers):
            state[f"layers.{i}.{name}"] = torch.from_numpy(
                np.array(leaf, np.float32))
    if flat:
        raise ValueError(
            f"flax leaves the port has no parameter for: {sorted(flat)}"
        )
    return state


def _bridge_by_name(variables, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Flax leaves onto `model`'s parameters by name (``/`` -> ``.``),
    conv kernels HWIO -> OIHW, shapes checked."""
    flat = _flatten(variables.get("params", variables))
    expected = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    unknown = []
    for path, leaf in flat.items():
        name = path.replace("/", ".")
        if name not in expected:
            unknown.append(path)
            continue
        value = np.array(leaf, np.float32)
        if value.ndim == 4:  # conv kernel [kh, kw, in, out]
            value = value.transpose(3, 2, 0, 1)
        if value.shape != expected[name]:
            raise ValueError(f"{path}: shape {value.shape} (as the port lays "
                             f"it out), the port expects {expected[name]}")
        state[name] = torch.from_numpy(np.ascontiguousarray(value))
    if unknown:
        raise ValueError(
            f"flax leaves the port has no parameter for: {sorted(unknown)}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"flax variables have no leaf for: {missing}")
    return state


def bert_from_flax(variables, config) -> Dict[str, torch.Tensor]:
    """State dict of `models.bert.BertClassifier` from the variables of
    the JAX `BertClassifier` (f32 CPU tensors)."""
    from tf_yarn_tpu_torch.models.bert import BertClassifier

    return _bridge_by_name(variables, BertClassifier(config, device="cpu"))


def dlrm_from_flax(variables, config) -> Dict[str, torch.Tensor]:
    """State dict of `models.dlrm.DLRM` from the variables of the JAX
    `DLRM` (f32 CPU tensors)."""
    from tf_yarn_tpu_torch.models.dlrm import DLRM

    return _bridge_by_name(variables, DLRM(config, device="cpu"))


def vit_from_flax(variables, config) -> Dict[str, torch.Tensor]:
    """State dict of `models.vit.ViT` from the variables of the JAX `ViT`
    (f32 CPU tensors)."""
    from tf_yarn_tpu_torch.models.vit import ViT

    return _bridge_by_name(variables, ViT(config, device="cpu"))


def resnet_from_flax(variables, config) -> Dict[str, torch.Tensor]:
    """State dict of `models.resnet.ResNet` from the variables of the JAX
    `ResNet` (f32 CPU tensors)."""
    from tf_yarn_tpu_torch.models.resnet import ResNet

    return _bridge_by_name(variables, ResNet(config, device="cpu"))


def linear_from_flax(variables, config) -> Dict[str, torch.Tensor]:
    """State dict of `models.linear.HashedLinearClassifier` from the
    variables of the JAX one (f32 CPU tensors)."""
    from tf_yarn_tpu_torch.models.linear import HashedLinearClassifier

    return _bridge_by_name(variables, HashedLinearClassifier(config,
                                                             device="cpu"))


def mnist_from_flax(variables, hidden_sizes=(512, 256), num_classes: int = 10,
                    device=None):
    """`models.mnist.DenseClassifier` on `device` holding the variables of
    the JAX `DenseClassifier` (its input width is the first kernel's)."""
    from tf_yarn_tpu_torch._device import resolve_device
    from tf_yarn_tpu_torch.models.mnist import DenseClassifier

    flat = _flatten(variables.get("params", variables))
    model = DenseClassifier(int(np.shape(flat["Dense_0/kernel"])[0]),
                            hidden_sizes, num_classes, device="cpu")
    model.load_state_dict(_bridge_by_name(variables, model))
    return model.to(resolve_device(device))
