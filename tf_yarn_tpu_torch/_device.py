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

Each rank of a process group computes on its own card: the primary at
index i among its host's primaries takes ``cuda:i`` when the host has a
card for each of them, and the group talks NCCL. Where the primaries
outnumber the cards they share them round robin and the group talks
gloo, since NCCL refuses two ranks on one device: every rank still
computes on a card; only the wire differs (`rank_card`,
`assign_rank_device`). With `LocalBackend`, the port's one backend,
every primary of a run is on this host. A tensor-parallel serving
replica's ranks (`serving.tp_replica`, the task and the followers it
spawns) are placed the same way, by their rank in the replica.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple, Union

import torch

from tf_yarn_tpu_torch import constants

_logger = logging.getLogger(__name__)

ENV_PLATFORM = "TPU_YARN_PLATFORM"

# The card `assign_rank_device` gave this process, if it gave one.
_RANK_CARD: Optional[int] = None


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
        device = resolve_device(None)
        return device if _RANK_CARD is None else torch.device("cuda", _RANK_CARD)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(
        f"{ENV_PLATFORM}={platform!r}: the port runs on 'cuda' (the default) "
        "or 'cpu'"
    )


def rank_card(index_on_host: int, primaries_on_host: int,
              cards: int) -> Tuple[int, str]:
    """(card index, collective backend) of the primary at `index_on_host`
    among `primaries_on_host` on a host with `cards` cards: its own card
    and NCCL when there is a card for each primary; else the cards
    shared round robin and gloo (NCCL refuses two ranks on one device)."""
    if cards < 1:
        raise ValueError(f"a host with {cards} cards has no card to assign")
    if primaries_on_host <= cards:
        return index_on_host, "nccl"
    return index_on_host % cards, "gloo"


def assign_rank_device(index_on_host: int, primaries_on_host: int
                       ) -> Tuple[torch.device, str]:
    """Place this rank (`rank_card`): on the card, ``torch.cuda.set_device``
    to it (so `task_device` names it from now on) and its backend; on the
    CPU (``TPU_YARN_PLATFORM=cpu``), the CPU and gloo. A shared card is
    logged at WARNING with the reason for gloo."""
    global _RANK_CARD
    device = task_device()
    if device.type != "cuda":
        return device, "gloo"
    cards = torch.cuda.device_count()
    card, backend = rank_card(index_on_host, primaries_on_host, cards)
    torch.cuda.set_device(card)
    _RANK_CARD = card
    if backend == "gloo":
        _logger.warning(
            "%d primaries share this host's %d card(s): rank %d computes on "
            "cuda:%d and the process group is gloo, as NCCL refuses two ranks "
            "on one device", primaries_on_host, cards, index_on_host, card)
    else:
        _logger.info("rank %d computes on cuda:%d; the process group is NCCL",
                     index_on_host, card)
    return torch.device("cuda", card), backend
