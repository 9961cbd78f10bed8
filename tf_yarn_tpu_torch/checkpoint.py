"""Checkpoints with a MANIFEST — counterpart of tf_yarn_tpu/checkpoint.py.

A checkpoint is the directory ``<model_dir>/ckpt-<step>`` holding
`torch.save` files of the train state's parts — ``params.pt`` (the
model's state dict), ``optimizer.pt`` (the optimizer's) and
``step.json`` — plus ``MANIFEST.json`` with every file's size and
sha256, the same contract as the JAX package (checkpoint.py:174-221):
discovery counts only manifested trees, restore verifies first and
quarantines a tree that disagrees to ``ckpt-<step>.corrupt``.

``model_dir`` may be any URI `fs` resolves; discovery, verification,
quarantine, restore, retention and the manifest all go through `fs`.

* A local path (or ``file://``) is written in place: the tree under
  ``.staging-ckpt-<step>``, then one rename to ``ckpt-<step>``.
* Every other scheme is **staged** (JAX checkpoint.py:259-548): the tree
  is written to local temp storage, uploaded to ``.staging-ckpt-<step>``
  (a name discovery never matches) and renamed into place, with a
  same-step predecessor moved aside to ``.replaced-ckpt-<step>`` first
  and restored if a crash left only the backup (`_commit_staged`). The
  JAX package writes ``gs://`` directly through orbax
  (``_ORBAX_NATIVE_SCHEMES``); `torch.save` has no remote writer, so in
  the port every non-local scheme is staged. Restore fetches the files
  it reads to local temp storage first.

`CheckpointWriter` (checkpoint.py:585-815) is the train loop's: `save`
blocks only while the state is copied into a host snapshot; the files
and the manifest are written (and, staged, uploaded) on one background
thread, so the next steps overlap the write. A background failure is
raised once, from the next `save`, `wait` or `close`.

Peers. Under DDP every rank holds the whole state, and under FSDP2, tp,
ep and pp the state dict is gathered to rank 0 before the save, so rank
0 alone writes. A staged save across ranks agrees first (the JAX
package's three agreed bits of `_snapshot_for_staging`, here one small
all-reduce over the train loop's process group, before any rank starts
writing): each rank's local error, rank 0's RAM gate (`_host_available_
ram`: the host snapshot must fit) and a failed background upload on rank
0. Every rank then raises together — rank 0 the real error, the others
`PeerStagedFailure` — and none is left waiting in a collective.
`TPU_YARN_CKPT_VERIFY` is not read: verification always re-hashes.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from tf_yarn_tpu_torch import fs as fs_lib
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.resilience import chaos as _chaos

_logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
MANIFEST_NAME = "MANIFEST.json"
_PARTS = ("params", "optimizer")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint tree disagrees with its MANIFEST.json (or has none)."""


class PeerStagedFailure(RuntimeError):
    """Raised on the ranks that did NOT own a failure of a staged save
    (rank 0's background upload, or another rank's local error), so every
    rank leaves the save together."""


def checkpoint_path(model_dir: str, step: int) -> str:
    return fs_lib.join(model_dir, f"ckpt-{step}")


def is_staged(model_dir: str) -> bool:
    """Whether saves to `model_dir` stage through local temp storage:
    every scheme but a local path and ``file://``."""
    return not fs_lib.is_local(model_dir)


def list_checkpoint_steps(model_dir: str,
                          require_manifest: bool = True) -> List[int]:
    """Completed checkpoint steps, ascending; only manifested trees count
    unless ``require_manifest=False``."""
    steps = []
    for name, is_dir in fs_lib.listdir(model_dir):
        match = _CKPT_RE.match(name)
        if not (match and is_dir):
            continue
        if require_manifest and not fs_lib.exists(
                fs_lib.join(model_dir, name, MANIFEST_NAME)):
            continue
        steps.append(int(match.group(1)))
    return sorted(steps)


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
    steps = list_checkpoint_steps(model_dir)
    return steps[-1] if steps else None


def _walk_files(ckpt_uri: str) -> List[Tuple[str, int]]:
    """Sorted [(relpath, size)] of every file under the tree, manifest
    excluded."""
    return sorted((rel, size) for rel, kind, size in fs_lib.tree(ckpt_uri)
                  if kind == fs_lib.FileType.File and rel != MANIFEST_NAME)


def _file_sha256(ckpt_uri: str, rel: str) -> str:
    digest = hashlib.sha256()
    with fs_lib.open_input(fs_lib.join(ckpt_uri, rel)) as stream:
        for chunk in iter(lambda: stream.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def write_manifest(ckpt_uri: str, step: Optional[int] = None) -> Dict:
    """Walk the tree and write MANIFEST.json (sizes + sha256)."""
    files = {rel: {"size": size, "sha256": _file_sha256(ckpt_uri, rel)}
             for rel, size in _walk_files(ckpt_uri)}
    payload = {"format": 1, "step": step, "files": files}
    fs_lib.write_text(fs_lib.join(ckpt_uri, MANIFEST_NAME),
                      json.dumps(payload, indent=1, sort_keys=True))
    return payload


def verify_checkpoint(ckpt_uri: str) -> None:
    """Check the tree against its manifest; raises CheckpointCorrupt on
    any disagreement."""
    with telemetry.span("checkpoint/verify", path=ckpt_uri):
        _verify_checkpoint(ckpt_uri)


def _verify_checkpoint(ckpt_uri: str) -> None:
    manifest_uri = fs_lib.join(ckpt_uri, MANIFEST_NAME)
    if not fs_lib.exists(manifest_uri):
        raise CheckpointCorrupt(f"{ckpt_uri}: no {MANIFEST_NAME}")
    try:
        expected = json.loads(fs_lib.read_text(manifest_uri))["files"]
    except (ValueError, KeyError, TypeError) as exc:
        raise CheckpointCorrupt(
            f"{ckpt_uri}: unparseable {MANIFEST_NAME}: {exc}") from None
    actual = dict(_walk_files(ckpt_uri))
    for rel, meta in expected.items():
        if rel not in actual:
            raise CheckpointCorrupt(f"{ckpt_uri}: missing file {rel!r}")
        if int(meta.get("size", -1)) != actual[rel]:
            raise CheckpointCorrupt(
                f"{ckpt_uri}: size mismatch for {rel!r} "
                f"(manifest {meta.get('size')}, on disk {actual[rel]})")
        if meta.get("sha256") and _file_sha256(ckpt_uri, rel) \
                != meta["sha256"]:
            raise CheckpointCorrupt(f"{ckpt_uri}: checksum mismatch for {rel!r}")


def quarantine_checkpoint(model_dir: str, step: int) -> str:
    """Move a corrupt ckpt-<step> aside to ckpt-<step>.corrupt."""
    src = checkpoint_path(model_dir, step)
    dst = f"{src}.corrupt"
    fs_lib.rmtree(dst)  # a re-quarantine of the same step replaces
    fs_lib.move(src, dst)
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


def _write_files(directory: str, state: Dict[str, Any], step: int) -> None:
    """The tree's files, then its manifest, into a fresh local dir."""
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    for part in _PARTS:
        torch.save(state[part], os.path.join(directory, f"{part}.pt"))
    with open(os.path.join(directory, "step.json"), "w") as fh:
        json.dump({"step": int(state["step"])}, fh)
    write_manifest(directory, step=step)


def _commit_staged(local_ckpt: str, model_dir: str, step: int) -> int:
    """Upload a locally written tree and rename it into place; returns
    the bytes uploaded. The staging name never matches the ckpt-<step>
    pattern, so a polling evaluator never sees a half-uploaded tree."""
    staging = fs_lib.join(model_dir, f".staging-ckpt-{step}")
    final = checkpoint_path(model_dir, step)
    backup = fs_lib.join(model_dir, f".replaced-ckpt-{step}")
    fs_lib.rmtree(staging)
    if fs_lib.exists(backup):
        if fs_lib.exists(final):
            # The crash came AFTER the replacement committed: the backup
            # is debris.
            fs_lib.rmtree(backup)
        else:
            # The crash came BETWEEN move-aside and commit: the backup is
            # the only surviving copy of this step — restore it before
            # attempting the new upload (which may itself fail).
            fs_lib.move(backup, final)
    fs_lib.mkdirs(model_dir)
    fs_lib.upload_dir(local_ckpt, staging)
    # Replace a same-step predecessor without a window where neither copy
    # survives: the old tree is moved aside first.
    if fs_lib.exists(final):
        fs_lib.move(final, backup)
    fs_lib.move(staging, final)
    fs_lib.rmtree(backup)
    return sum(size for _rel, size in _walk_files(local_ckpt)) + \
        os.path.getsize(os.path.join(local_ckpt, MANIFEST_NAME))


def _write_staged(model_dir: str, step: int, snapshot_holder: list) -> None:
    """Serialize a host snapshot locally and commit it remotely (on rank 0;
    for the async writer, on its thread). `snapshot_holder` is a
    one-element list, emptied once the state is on local disk, so the
    host copy is released before the slow upload."""
    with telemetry.span("checkpoint/staged_write", step=step) as sp:
        with tempfile.TemporaryDirectory(prefix="tpu-yarn-ckpt-stage-") as tmp:
            local = os.path.join(tmp, f"ckpt-{step}")
            _write_files(local, snapshot_holder[0], step)
            snapshot_holder.clear()
            # The manifest rides inside the staged tree: the rename-commit
            # publishes payload and completion marker at once.
            uploaded = _commit_staged(local, model_dir, step)
            sp.args["bytes"] = uploaded
        telemetry.get_registry().counter(
            "checkpoint/staged_bytes_total").inc(uploaded)
        _chaos.on_checkpoint_commit(checkpoint_path(model_dir, step))
    _observe_op("staged_write", sp.duration)


def _write_tree(model_dir: str, step: int, snapshot_holder: list) -> str:
    """Write the state in the one-element `snapshot_holder` as
    ckpt-<step>: in place for a local model_dir (a staging directory
    renamed into place), staged for a remote one. The holder is emptied
    once the files are written, so an async writer's host copy goes
    before a slow upload (its work item would pin a bare argument)."""
    path = checkpoint_path(model_dir, step)
    if is_staged(model_dir):
        _write_staged(model_dir, step, snapshot_holder)
        return path
    local_dir = fs_lib.local_path(model_dir)
    final = fs_lib.local_path(path)
    staging = os.path.join(local_dir, f".staging-ckpt-{step}")
    _write_files(staging, snapshot_holder[0], step)
    snapshot_holder.clear()
    shutil.rmtree(final, ignore_errors=True)
    os.replace(staging, final)
    # The commit boundary of both save paths (the synchronous one and the
    # async writer's thread): TPU_YARN_FAULT truncate_ckpt=latest.
    _chaos.on_checkpoint_commit(path)
    return path


def save_checkpoint(model_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` — ``{"params": state dict, "optimizer": state dict,
    "step": int}`` — as ckpt-<step>, synchronously. The train loop uses
    `CheckpointWriter`; this stays the one-shot API for tools and tests."""
    with telemetry.span("checkpoint/save", step=step) as sp:
        path = _write_tree(model_dir, step, [state])
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


def _tree_nbytes(tree: Any) -> int:
    """Bytes of the tensors in a state tree (what its host snapshot
    takes)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_nbytes(value) for value in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(value) for value in tree)
    return 0


def _host_available_ram() -> int:
    """Bytes of host memory a staged snapshot may reasonably claim.
    0 = unknown (gate disabled)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 0


# Per-collective byte budget for streaming gathered leaves to rank 0
# (`_plan_gather_batches`): a state with thousands of small leaves pays
# one collective a batch, not one a leaf, while a rank's transient RAM
# stays bounded by one batch.
_GATHER_BATCH_BYTES = 256 << 20


def _plan_gather_batches(sized_indices: Iterable[Tuple[int, int]],
                         budget: int) -> List[List[int]]:
    """Group (leaf index, nbytes) pairs into batches of <= budget bytes
    each (a single over-budget leaf still forms its own batch: it must
    gather whole). Pure, so every rank computes the same boundaries (JAX
    checkpoint.py:343-362)."""
    batches: list = []
    current: list = []
    current_bytes = 0
    for index, nbytes in sized_indices:
        if current and current_bytes + nbytes > budget:
            batches.append(current)
            current, current_bytes = [], 0
        current.append(index)
        current_bytes += nbytes
    if current:
        batches.append(current)
    return batches


def _all_reduce_max(flags: List[int], device) -> List[int]:
    """Elementwise max of `flags` over the default process group."""
    import torch.distributed as dist

    tensor = torch.tensor(flags, dtype=torch.int64, device=device)
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX)
    return [int(v) for v in tensor.tolist()]


class CheckpointWriter:
    """Async checkpoint writer with keep-last-N retention
    (checkpoint.py:585-815).

    `save()` blocks only until every tensor of the state is copied into
    a host snapshot, so the caller may update the model at once; the
    ``torch.save`` files and the MANIFEST.json completion marker are
    then written on one background thread (staged and uploaded for a
    remote model_dir), so a polling side-car evaluator only ever sees
    completed, manifested checkpoints. One write is in flight at a time:
    a save first waits for the previous write to land (it holds a host
    copy of the state), which also makes a second save of the same step
    wait for the first.

    Retention: before each save, completed ``ckpt-*`` trees beyond the
    newest `keep_last_n` are deleted (only manifested ones are listed,
    so an in-flight save is never collected). A background failure is
    raised once, from the next `save`, `wait` or `close`.

    Across ranks (`world` > 1, every rank holding a writer, `rank` 0 the
    one that writes): `save` and `wait` agree over the default process
    group before any rank writes or returns (module docstring), on
    `device` (the CPU under gloo, the rank's card under NCCL). A writer
    of rank > 0 writes nothing."""

    def __init__(self, keep_last_n: Optional[int] = None, *, rank: int = 0,
                 world: int = 1, device=None):
        self.keep_last_n = keep_last_n
        self._owner = rank == 0
        self._world = world
        self._device = device if device is not None else torch.device("cpu")
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # Guards _futures: appended by the train thread, drained by
        # wait()/close(), which may run on another thread.
        self._lock = threading.Lock()
        self._futures: List[concurrent.futures.Future] = []

    def save(self, model_dir: str, step: int, state: Dict[str, Any]) -> str:
        """Snapshot `state` (save_checkpoint's dict) to host memory and
        write it as ckpt-<step> in the background. On a rank > 0 only the
        agreement runs (`state` is not read)."""
        path = checkpoint_path(model_dir, step)
        # save_submit prices only the blocking part: the wait for the
        # previous write, the agreement and the host snapshot.
        with telemetry.span("checkpoint/save_submit" if self._owner
                            else "checkpoint/agree", step=step) as sp:
            pending = self._collect_errors()
            if self._world > 1:
                self._agree(pending, state)
            elif pending is not None:
                raise pending
            if not self._owner:
                return path
            self._gc(model_dir)
            holder = [_host_snapshot(state)]
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-write")
            future = self._executor.submit(_write_tree, model_dir, step,
                                           holder)
            del holder
            with self._lock:
                self._futures.append(future)
        _observe_op("save_submit", sp.duration)
        _logger.info("checkpoint %s save started (async)", path)
        return path

    def _agree(self, pending: Optional[BaseException], state) -> None:
        """The agreed bits, one all-reduce: any rank's local error (its
        state lacks a part; rank 0's size count failed), rank 0's RAM
        gate, rank 0's failed upload. Raises on every rank together when
        any is set."""
        local_error, need = None, 0
        fits = True
        try:
            missing = [key for key in ("params", "optimizer", "step")
                       if key not in state]
            if missing:
                raise KeyError(f"checkpoint state lacks {missing}")
            if self._owner:
                need = _tree_nbytes(state)
                avail = _host_available_ram()
                fits = not (avail and need > avail // 2)
        except Exception as exc:  # agreed below, then raised
            local_error = exc
        error, unfit, failed = _all_reduce_max(
            [int(local_error is not None), int(not fits),
             int(pending is not None)], self._device)
        if failed:
            if pending is not None:
                raise pending
            raise PeerStagedFailure(
                "rank 0 reported a failed background checkpoint write; "
                "aborting this save on every rank")
        if error:
            if local_error is not None:
                raise local_error
            raise PeerStagedFailure(
                "a peer rank failed to prepare this checkpoint save; "
                "aborting it on every rank")
        if unfit:
            raise ValueError(
                "a staged checkpoint copies the full state to rank 0's "
                f"host RAM ({need / 1e9:.2f} GB on rank 0), which does not "
                "fit half of what is available there")

    def _collect_errors(self) -> Optional[BaseException]:
        """Wait for every submitted write; the first failure, or None.
        Settled futures leave the queue even when failing, so one failure
        is reported once."""
        with self._lock:
            futures, self._futures = self._futures, []
        errors = [exc for exc in (f.exception() for f in futures)
                  if exc is not None]
        return errors[0] if errors else None

    def _raise_errors(self) -> None:
        pending = self._collect_errors()
        if pending is not None:
            raise pending

    def _gc(self, model_dir: str) -> None:
        """Best-effort retention: a failure defers the deletion to the
        next save (a raise here would part rank 0 from its peers)."""
        if not self.keep_last_n:
            return
        try:
            prune_checkpoints(model_dir, self.keep_last_n)
        except Exception:
            _logger.warning("retention GC failed for %s; will retry on the "
                            "next save", model_dir, exc_info=True)

    def wait(self) -> None:
        """Block until every started save has landed (on every rank,
        across ranks)."""
        with telemetry.span("checkpoint/wait") as sp:
            pending = self._collect_errors()
            if self._world > 1 and _all_reduce_max(
                    [int(pending is not None)], self._device)[0] \
                    and pending is None:
                raise PeerStagedFailure(
                    "rank 0 reported a failed background checkpoint write")
            if pending is not None:
                raise pending
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


@contextlib.contextmanager
def _readable_files(model_dir: str, step: int, names: Iterable[str]):
    """{name: local path} of ckpt-<step>'s files `names`: in place for a
    local model_dir, fetched to a temp dir first for a remote one. A file
    mapped with ``torch.load(mmap=True)`` stays readable after the temp
    dir goes."""
    path = checkpoint_path(model_dir, step)
    if not is_staged(model_dir):
        yield {name: os.path.join(fs_lib.local_path(path), name)
               for name in names}
        return
    with tempfile.TemporaryDirectory(prefix="tpu-yarn-ckpt-fetch-") as tmp:
        local = {}
        for name in names:
            local[name] = os.path.join(tmp, name)
            with fs_lib.open_input(fs_lib.join(path, name)) as src, \
                    open(local[name], "wb") as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
        yield local


def _load_state(model_dir: str, step: int, parts: Tuple[str, ...],
                map_location, mmap: bool) -> Dict[str, Any]:
    names = [f"{part}.pt" for part in parts] + ["step.json"]
    with _readable_files(model_dir, step, names) as files:
        state = {part: torch.load(files[f"{part}.pt"],
                                  map_location=map_location, mmap=mmap,
                                  weights_only=True)
                 for part in parts}
        with open(files["step.json"]) as fh:
            state["step"] = int(json.load(fh)["step"])
    return state


def restore_checkpoint(model_dir: str, step: int, map_location=None,
                       parts: Tuple[str, ...] = _PARTS,
                       mmap: bool = False) -> Dict[str, Any]:
    """The state saved as ckpt-<step>, tensors on `map_location`: the
    `parts` asked for and the step. ``mmap=True`` maps the files instead
    of reading them (with ``map_location="cpu"``), so a caller that copies
    the tensors into a model's own parameters holds one copy of them.
    No verification here (callers verify first)."""
    with telemetry.span("checkpoint/restore", step=step) as sp:
        state = _load_state(model_dir, step, parts, map_location, mmap)
    _observe_op("restore", sp.duration)
    return state


def restore_checkpoint_host(model_dir: str, step: int) -> Dict[str, Any]:
    """ckpt-<step>'s parameters (``"params"``) and step, mapped into host
    memory whatever device saved them: the side-car evaluator loads them
    into its own model (checkpoint.py:837). No verification here."""
    with telemetry.span("checkpoint/restore_host", step=step) as sp:
        state = _load_state(model_dir, step, ("params",), "cpu", True)
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
        fs_lib.rmtree(path)
