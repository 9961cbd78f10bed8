"""Checkpoints with a MANIFEST — the local-path part of
tf_yarn_tpu/checkpoint.py.

A checkpoint is the directory ``<model_dir>/ckpt-<step>`` holding
`torch.save` files of the train state's parts — ``params.pt`` (the
model's state dict), ``optimizer.pt`` (the optimizer's) and
``step.json`` — plus ``MANIFEST.json`` with every file's size and
sha256, the same contract as the JAX package (checkpoint.py:174-221):
discovery counts only manifested trees, restore verifies first and
quarantines a tree that disagrees to ``ckpt-<step>.corrupt``. The tree
is written under ``.staging-ckpt-<step>`` and renamed into place, so
nothing half written is ever visible.

`CheckpointWriter` (checkpoint.py:585-815) is the train loop's: `save`
blocks only while the state is copied into a host snapshot; the files
and the manifest are written on one background thread, so the next
steps overlap the write. ``model_dir`` is a local path: the remote
filesystems and the staged and peer uploads (checkpoint.py:279-548) wait
for ``fs.py`` (ROADMAP.md Queue 1 item 5.4). `TPU_YARN_CKPT_VERIFY` is
not read: verification always re-hashes.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.resilience import chaos as _chaos

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


def _observe_op(op: str, seconds: float) -> None:
    telemetry.get_registry().histogram(
        "checkpoint/seconds", op=op).observe(seconds)


def _write_tree(model_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Files, then the manifest (the completion marker), into a staging
    directory; then one rename to ckpt-<step>."""
    path = checkpoint_path(model_dir, step)
    staging = os.path.join(model_dir, f".staging-ckpt-{step}")
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    for part in _PARTS:
        torch.save(state[part], os.path.join(staging, f"{part}.pt"))
    with open(os.path.join(staging, "step.json"), "w") as fh:
        json.dump({"step": int(state["step"])}, fh)
    write_manifest(staging, step=step)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(staging, path)
    # The commit boundary of both save paths (the synchronous one and the
    # async writer's thread): TPU_YARN_FAULT truncate_ckpt=latest.
    _chaos.on_checkpoint_commit(path)
    return path


def save_checkpoint(model_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` — ``{"params": state dict, "optimizer": state dict,
    "step": int}`` — as ckpt-<step>, synchronously. The train loop uses
    `CheckpointWriter`; this stays the one-shot API for tools and tests."""
    with telemetry.span("checkpoint/save", step=step) as sp:
        path = _write_tree(model_dir, step, state)
    _observe_op("save", sp.duration)
    _logger.info("saved checkpoint %s", path)
    return path


def _host_snapshot(tree: Any) -> Any:
    """`tree` with every tensor copied to host memory (a copy even for a
    CPU tensor: the train step updates its parameters in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {key: _host_snapshot(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_snapshot(value) for value in tree)
    return tree


class CheckpointWriter:
    """Async checkpoint writer with keep-last-N retention
    (checkpoint.py:585-815).

    `save()` blocks only until every tensor of the state is copied into
    a host snapshot, so the caller may update the model at once; the
    ``torch.save`` files and the MANIFEST.json completion marker are
    then written on one background thread, into a staging directory
    renamed into place, so a polling side-car evaluator only ever sees
    completed, manifested checkpoints. One write is in flight at a time:
    a save first waits for the previous write to land (it holds a
    host copy of the state), which also makes a second save of the same
    step wait for the first.

    Retention: before each save, completed ``ckpt-*`` trees beyond the
    newest `keep_last_n` are deleted (only manifested ones are listed,
    so an in-flight save is never collected). A background failure is
    raised once, from the next `save`, `wait` or `close`."""

    def __init__(self, keep_last_n: Optional[int] = None):
        self.keep_last_n = keep_last_n
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # Guards _futures: appended by the train thread, drained by
        # wait()/close(), which may run on another thread.
        self._lock = threading.Lock()
        self._futures: List[concurrent.futures.Future] = []

    def save(self, model_dir: str, step: int, state: Dict[str, Any]) -> str:
        """Snapshot `state` (save_checkpoint's dict) to host memory and
        write it as ckpt-<step> in the background."""
        # save_submit prices only the blocking part: the wait for the
        # previous write and the host snapshot.
        with telemetry.span("checkpoint/save_submit", step=step) as sp:
            self._raise_errors()
            self._gc(model_dir)
            snapshot = _host_snapshot(state)
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-write")
            future = self._executor.submit(_write_tree, model_dir, step,
                                           snapshot)
            del snapshot
            with self._lock:
                self._futures.append(future)
        _observe_op("save_submit", sp.duration)
        path = checkpoint_path(model_dir, step)
        _logger.info("checkpoint %s save started (async)", path)
        return path

    def _raise_errors(self) -> None:
        """Wait for every submitted write; raise the first failure.
        Settled futures leave the queue even when failing, so one failure
        is raised once."""
        with self._lock:
            futures, self._futures = self._futures, []
        errors = [exc for exc in (f.exception() for f in futures)
                  if exc is not None]
        if errors:
            raise errors[0]

    def _gc(self, model_dir: str) -> None:
        """Best-effort retention: a failure defers the deletion to the
        next save."""
        if not self.keep_last_n:
            return
        try:
            prune_checkpoints(model_dir, self.keep_last_n)
        except Exception:
            _logger.warning("retention GC failed for %s; will retry on the "
                            "next save", model_dir, exc_info=True)

    def wait(self) -> None:
        """Block until every started save has landed."""
        with telemetry.span("checkpoint/wait") as sp:
            self._raise_errors()
        _observe_op("wait", sp.duration)

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._raise_errors()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
    _observe_op("restore", sp.duration)
    return state


def restore_checkpoint_host(model_dir: str, step: int) -> Dict[str, Any]:
    """ckpt-<step>'s parameters (``"params"``) and step, mapped into host
    memory whatever device saved them: the side-car evaluator loads them
    into its own model (checkpoint.py:837). No verification here."""
    path = checkpoint_path(model_dir, step)
    with telemetry.span("checkpoint/restore_host", step=step) as sp:
        state = {"params": torch.load(os.path.join(path, "params.pt"),
                                      map_location="cpu", mmap=True,
                                      weights_only=True)}
        with open(os.path.join(path, "step.json")) as fh:
            state["step"] = int(json.load(fh)["step"])
    _observe_op("restore_host", sp.duration)
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
