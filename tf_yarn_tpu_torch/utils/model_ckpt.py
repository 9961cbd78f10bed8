"""Torch model checkpoints with epoch discovery — counterpart of
tf_yarn_tpu/utils/model_ckpt.py (reference: pytorch/model_ckpt.py:15-77).

``model_<epoch>.pt`` files holding ``{"model", "optimizer", "epoch",
**extra}``, the newest epoch found by name, and the DDP wrapper's
``module`` unwrapped on save, as in the JAX package. ``model_dir`` is a
local path: a remote filesystem's URI raises (ROADMAP.md Queue 1 item
5.4, `fs.py`).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional

import torch

_logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^model_(\d+)\.pt$")


def _local(model_dir: str) -> str:
    from tf_yarn_tpu_torch.pytorch import refuse_remote

    refuse_remote(model_dir, "model_dir")
    return model_dir[len("file://"):] if model_dir.startswith("file://") \
        else model_dir


def _unwrap(model):
    return model.module if hasattr(model, "module") else model


def find_latest_ckpt(model_dir: str) -> Optional[str]:
    """Newest model_<epoch>.pt in model_dir (reference: model_ckpt.py:15-28)."""
    model_dir = _local(model_dir)
    if not os.path.isdir(model_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_CKPT_RE.match,
                                            os.listdir(model_dir)) if m]
    return (os.path.join(model_dir, f"model_{max(epochs)}.pt") if epochs
            else None)


def load_latest_ckpt(model_dir: str, device: str = "cpu"
                     ) -> Optional[Dict[str, Any]]:
    """reference: model_ckpt.py:31-52."""
    path = find_latest_ckpt(model_dir)
    if path is None:
        _logger.info("no checkpoint found in %s", model_dir)
        return None
    return torch.load(path, map_location=device, weights_only=False)


def save_ckpt(model_dir: str, model, optimizer, epoch: int,
              **kwargs: Any) -> str:
    """reference: model_ckpt.py:55-73 (rank-0 callers only, like the
    reference's usage)."""
    model_dir = _local(model_dir)
    state = {
        "model": _unwrap(model).state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": epoch,
        **kwargs,
    }
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"model_{epoch}.pt")
    torch.save(state, path)
    _logger.info("saved checkpoint %s", path)
    return path
