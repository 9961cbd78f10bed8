"""Device resolution for the port's entry points.

The card is the default: an entry point given no device runs on CUDA,
and raises when there is none. The CPU is used only when the caller
asks for it (the CPU tests pass ``device="cpu"``), so a missing card
never turns into a quiet, slow CPU run. A launched task reads the same
choice from ``TPU_YARN_PLATFORM`` (`task_device`), as the JAX package's
task programs do. The ``router`` task's device is ``meta``: the router
reads its experiment's knobs and never runs the model, so the experiment
fn it shares with the replicas builds shapes only — no weights, no CUDA
context.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from tf_yarn_tpu_torch import constants

ENV_PLATFORM = "TPU_YARN_PLATFORM"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); an explicit
    device is returned as a ``torch.device`` after the same check for
    CUDA requests. ``meta`` (the router task's) is returned as it is."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    if resolved.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    return resolved


def task_device() -> torch.device:
    """The device of a launched task (and of an experiment fn running in
    one): ``meta`` in a ``router:*`` task (its ``TPU_YARN_TASK``), which
    never runs the model; elsewhere ``TPU_YARN_PLATFORM`` unset, ``cuda``
    or ``gpu`` -> the card (raises without one, never falls back);
    ``cpu`` -> the CPU, the setting the CPU tests launch with."""
    if os.environ.get(constants.ENV_TASK_KEY, "").startswith("router:"):
        return torch.device("meta")
    platform = os.environ.get(ENV_PLATFORM, "").strip().lower()
    if platform in ("", "cuda", "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(
        f"{ENV_PLATFORM}={platform!r}: the port runs on 'cuda' (the default) "
        "or 'cpu'"
    )
