"""Torch model checkpoints with epoch discovery — counterpart of
tf_yarn_tpu/utils/model_ckpt.py (reference: pytorch/model_ckpt.py:15-77).

``model_<epoch>.pt`` files holding ``{"model", "optimizer", "epoch",
**extra}``, the newest epoch found by name, and the DDP wrapper's
``module`` unwrapped on save, as in the JAX package. ``model_dir`` may
be any `fs` URI (a path, ``file://``, ``gs://``, ``hdfs://``, a
registered scheme).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional

import torch

from tf_yarn_tpu_torch import fs as fs_lib

_logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^model_(\d+)\.pt$")


def _unwrap(model):
    return model.module if hasattr(model, "module") else model


def find_latest_ckpt(model_dir: str) -> Optional[str]:
    """Newest model_<epoch>.pt in model_dir (reference: model_ckpt.py:15-28)."""
    epochs = [int(match.group(1)) for match in (
        _CKPT_RE.match(entry) for entry, _is_dir in fs_lib.listdir(model_dir))
        if match]
    return (fs_lib.join(model_dir, f"model_{max(epochs)}.pt") if epochs
            else None)


def load_latest_ckpt(model_dir: str, device: str = "cpu"
                     ) -> Optional[Dict[str, Any]]:
    """reference: model_ckpt.py:31-52."""
    path = find_latest_ckpt(model_dir)
    if path is None:
        _logger.info("no checkpoint found in %s", model_dir)
        return None
    with fs_lib.open_input_file(path) as fh:
        return torch.load(fh, map_location=device, weights_only=False)


def save_ckpt(model_dir: str, model, optimizer, epoch: int,
              **kwargs: Any) -> str:
    """reference: model_ckpt.py:55-73 (rank-0 callers only, like the
    reference's usage)."""
    state = {
        "model": _unwrap(model).state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": epoch,
        **kwargs,
    }
    path = fs_lib.join(model_dir, f"model_{epoch}.pt")
    with fs_lib.open_output(path) as fh:
        torch.save(state, fh)
    _logger.info("saved checkpoint %s", path)
    return path
