"""Checkpoints with a MANIFEST — the synchronous subset of
tf_yarn_tpu/checkpoint.py.

A checkpoint is the directory ``<model_dir>/ckpt-<step>`` holding
`torch.save` files of the train state's parts — ``params.pt`` (the
model's state dict), ``optimizer.pt`` (the optimizer's) and
``step.json`` — plus ``MANIFEST.json`` with every file's size and
sha256, the same contract as the JAX package (checkpoint.py:174-221):
discovery counts only manifested trees, restore verifies first and
quarantines a tree that disagrees to ``ckpt-<step>.corrupt``. The tree
is written under ``.staging-ckpt-<step>`` and renamed into place, so
nothing half written is ever visible. ``model_dir`` is a local path;
the remote filesystems, the staged and peer uploads and the async
writer (checkpoint.py:310-815) are still to port (ROADMAP.md Queue 1
item 4). `TPU_YARN_CKPT_VERIFY` is not read: verification always
re-hashes.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from tf_yarn_tpu_torch import telemetry

_logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
MANIFEST_NAME = "MANIFEST.json"
_PARTS = ("params", "optimizer")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint tree disagrees with its MANIFEST.json (or has none)."""


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt-{step}")


def list_checkpoint_steps(model_dir: str,
                          require_manifest: bool = True) -> List[int]:
    """Completed checkpoint steps, ascending; only manifested trees count
    unless ``require_manifest=False``."""
    if not os.path.isdir(model_dir):
        return []
    steps = []
    for name in os.listdir(model_dir):
        match = _CKPT_RE.match(name)
        path = os.path.join(model_dir, name)
        if not (match and os.path.isdir(path)):
            continue
        if require_manifest and not os.path.exists(
                os.path.join(path, MANIFEST_NAME)):
            continue
        steps.append(int(match.group(1)))
    return sorted(steps)


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
    steps = list_checkpoint_steps(model_dir)
    return steps[-1] if steps else None


def _walk_files(ckpt_dir: str) -> List[Tuple[str, int]]:
    """Sorted [(relpath, size)] of every file under the tree, manifest
    excluded."""
    out = []
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, ckpt_dir)
            if rel != MANIFEST_NAME:
                out.append((rel, os.path.getsize(path)))
    return sorted(out)


def _file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as stream:
        for chunk in iter(lambda: stream.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def write_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """Walk the tree and write MANIFEST.json (sizes + sha256)."""
    files = {rel: {"size": size,
                   "sha256": _file_sha256(os.path.join(ckpt_dir, rel))}
             for rel, size in _walk_files(ckpt_dir)}
    payload = {"format": 1, "step": step, "files": files}
    with open(os.path.join(ckpt_dir, MANIFEST_NAME), "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
    return payload


def verify_checkpoint(ckpt_dir: str) -> None:
    """Check the tree against its manifest; raises CheckpointCorrupt on
    any disagreement."""
    with telemetry.span("checkpoint/verify", path=ckpt_dir):
        _verify_checkpoint(ckpt_dir)


def _verify_checkpoint(ckpt_dir: str) -> None:
    manifest_path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise CheckpointCorrupt(f"{ckpt_dir}: no {MANIFEST_NAME}")
    try:
        with open(manifest_path) as fh:
            expected = json.load(fh)["files"]
    except (ValueError, KeyError, TypeError) as exc:
        raise CheckpointCorrupt(
            f"{ckpt_dir}: unparseable {MANIFEST_NAME}: {exc}") from None
    actual = dict(_walk_files(ckpt_dir))
    for rel, meta in expected.items():
        if rel not in actual:
            raise CheckpointCorrupt(f"{ckpt_dir}: missing file {rel!r}")
        if int(meta.get("size", -1)) != actual[rel]:
            raise CheckpointCorrupt(
                f"{ckpt_dir}: size mismatch for {rel!r} "
                f"(manifest {meta.get('size')}, on disk {actual[rel]})")
        if meta.get("sha256") and _file_sha256(
                os.path.join(ckpt_dir, rel)) != meta["sha256"]:
            raise CheckpointCorrupt(f"{ckpt_dir}: checksum mismatch for {rel!r}")


def quarantine_checkpoint(model_dir: str, step: int) -> str:
    """Move a corrupt ckpt-<step> aside to ckpt-<step>.corrupt."""
    src = checkpoint_path(model_dir, step)
    dst = f"{src}.corrupt"
    shutil.rmtree(dst, ignore_errors=True)
    os.replace(src, dst)
    _logger.error("quarantined corrupt checkpoint %s -> %s", src, dst)
    return dst


def latest_verified_step(model_dir: str) -> Optional[int]:
    """Newest step whose tree passes verification; corrupt trees are
    quarantined on the way down."""
    while True:
        step = latest_checkpoint_step(model_dir)
        if step is None:
            return None
        try:
            verify_checkpoint(checkpoint_path(model_dir, step))
        except CheckpointCorrupt as exc:
            _logger.error("checkpoint verification failed (%s); falling "
                          "back to the previous step", exc)
            quarantine_checkpoint(model_dir, step)
            telemetry.get_registry().counter(
                "checkpoint/quarantined_total").inc()
            continue
        return step


def save_checkpoint(model_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` — ``{"params": state dict, "optimizer": state dict,
    "step": int}`` — as ckpt-<step>, synchronously: files and manifest
    into a staging directory, then one rename."""
    path = checkpoint_path(model_dir, step)
    staging = os.path.join(model_dir, f".staging-ckpt-{step}")
    with telemetry.span("checkpoint/save", step=step) as sp:
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        for part in _PARTS:
            torch.save(state[part], os.path.join(staging, f"{part}.pt"))
        with open(os.path.join(staging, "step.json"), "w") as fh:
            json.dump({"step": int(state["step"])}, fh)
        write_manifest(staging, step=step)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(staging, path)
    telemetry.get_registry().histogram(
        "checkpoint/seconds", op="save").observe(sp.duration)
    _logger.info("saved checkpoint %s", path)
    return path


def restore_checkpoint(model_dir: str, step: int, map_location=None,
                       parts: Tuple[str, ...] = _PARTS,
                       mmap: bool = False) -> Dict[str, Any]:
    """The state saved as ckpt-<step>, tensors on `map_location`: the
    `parts` asked for and the step. ``mmap=True`` maps the files instead
    of reading them (with ``map_location="cpu"``), so a caller that copies
    the tensors into a model's own parameters holds one copy of them.
    No verification here (callers verify first)."""
    path = checkpoint_path(model_dir, step)
    with telemetry.span("checkpoint/restore", step=step) as sp:
        state = {part: torch.load(os.path.join(path, f"{part}.pt"),
                                  map_location=map_location, mmap=mmap,
                                  weights_only=True)
                 for part in parts}
        with open(os.path.join(path, "step.json")) as fh:
            state["step"] = int(json.load(fh)["step"])
    telemetry.get_registry().histogram(
        "checkpoint/seconds", op="restore").observe(sp.duration)
    return state


def restore_latest(model_dir: str, map_location=None):
    """(state, step) of the newest verified checkpoint, or (None, None)."""
    step = latest_verified_step(model_dir)
    if step is None:
        return None, None
    return restore_checkpoint(model_dir, step, map_location), step


def prune_checkpoints(model_dir: str, keep_last_n: Optional[int]) -> None:
    """Delete completed checkpoints beyond the newest `keep_last_n`
    (called before each save, as the JAX writer's retention does)."""
    if not keep_last_n:
        return
    for step in list_checkpoint_steps(model_dir)[:-keep_last_n]:
        path = checkpoint_path(model_dir, step)
        _logger.info("retention(%d): deleting %s", keep_last_n, path)
        shutil.rmtree(path)
