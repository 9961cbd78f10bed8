"""The port's URI filesystem layer held against the JAX package's
(tests/test_fs.py): the fs primitives, staged checkpoints, eval markers,
the pytorch checkpoints and a trained-and-resumed decoder on a fake
remote scheme — a registered pyarrow filesystem over a temp dir, which
both packages resolve the same way.

No test here resolves an unregistered remote scheme through pyarrow (that
would reach for the network): the pyarrow-less import runs in a
subprocess that hides pyarrow, where the scheme fails before any I/O.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tf_yarn_tpu import checkpoint as j_ckpt
from tf_yarn_tpu import evaluation as j_evaluation
from tf_yarn_tpu import fs as j_fs
from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import evaluation as t_evaluation
from tf_yarn_tpu_torch import fs as t_fs
from tf_yarn_tpu_torch import telemetry

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def mockfs(tmp_path):
    """mockfs:// registered in both packages over one local dir: the
    port's through a SubTreeFileSystem, the JAX one's as tests/test_fs.py
    registers it. Yields (the scheme root, the local dir)."""
    from pyarrow import fs as pafs

    base = tmp_path / "remote-root"
    base.mkdir()
    local = pafs.LocalFileSystem()
    t_fs.register_scheme("mockfs", lambda uri: (
        pafs.SubTreeFileSystem(str(base), local),
        uri[len("mockfs://"):].lstrip("/")))
    j_fs.register_scheme("mockfs", lambda uri: (
        local, str(base / uri[len("mockfs://"):].lstrip("/"))))
    yield "mockfs://bucket", base / "bucket"
    t_fs.unregister_scheme("mockfs")
    j_fs.unregister_scheme("mockfs")


def _state(value):
    return {"params": {"w": torch.full((4, 4), float(value)),
                       "b": torch.arange(8.0) * value},
            "optimizer": {"state": {0: {"exp_avg": torch.ones(4) * value}}},
            "step": value}


URIS = ["gs://b/p", "/tmp/x", "file:///tmp/x", "hdfs://nn:8020/a/b",
        "viewfs://c/d/", "relative/dir", "mockfs://bucket/model",
        "s3+x.y-z://w", "", "C:/not-a-scheme"]


@pytest.mark.parametrize("uri", URIS)
def test_scheme_parsing_join_and_is_local_equal_jax(uri):
    assert t_fs.parse_scheme(uri) == j_fs.parse_scheme(uri)
    assert t_fs.is_local(uri) == j_fs.is_local(uri)
    assert t_fs.join(uri, "ckpt-1", "MANIFEST.json") == \
        j_fs.join(uri, "ckpt-1", "MANIFEST.json")
    if j_fs.is_local(uri):
        assert t_fs.local_path(uri) == j_fs.local_path(uri)
    else:
        with pytest.raises(ValueError):
            t_fs.local_path(uri)
        assert t_fs._split_root(uri) == j_fs._split_root(uri)


def test_fs_primitives_equal_jax(mockfs):
    root, base = mockfs
    for fs_lib, name in ((t_fs, "port"), (j_fs, "jax")):
        uri = fs_lib.join(root, name, "dir", "hello.txt")
        fs_lib.write_text(uri, "hi there")
        fs_lib.write_text(fs_lib.join(root, name, "dir", "sub", "x"), "x")
        fs_lib.mkdirs(fs_lib.join(root, name, "empty"))
    for fs_lib in (t_fs, j_fs):
        for name in ("port", "jax"):
            top = fs_lib.join(root, name)
            assert fs_lib.read_text(fs_lib.join(top, "dir", "hello.txt")) \
                == "hi there"
            assert sorted(fs_lib.listdir(top)) == [("dir", True),
                                                  ("empty", True)]
            assert sorted(fs_lib.listdir(fs_lib.join(top, "dir"))) == [
                ("hello.txt", False), ("sub", True)]
            assert fs_lib.listdir(fs_lib.join(top, "missing")) == []
            assert fs_lib.exists(fs_lib.join(top, "dir", "hello.txt"))
            assert not fs_lib.exists(fs_lib.join(top, "nope"))
            assert fs_lib.isdir(fs_lib.join(top, "dir"))
            assert not fs_lib.isdir(fs_lib.join(top, "dir", "hello.txt"))
    t_fs.move(t_fs.join(root, "port", "empty"), t_fs.join(root, "port", "moved"))
    assert sorted(os.listdir(base / "port")) == ["dir", "moved"]
    for fs_lib, name in ((t_fs, "port"), (j_fs, "jax")):
        fs_lib.rmtree(fs_lib.join(root, name, "dir"))
        assert not fs_lib.exists(fs_lib.join(root, name, "dir", "hello.txt"))
        fs_lib.rmtree(fs_lib.join(root, name, "dir"))  # idempotent


def test_upload_download_dir_equal_jax(mockfs, tmp_path):
    root, base = mockfs
    src = tmp_path / "src"
    (src / "sub" / "deeper").mkdir(parents=True)
    (src / "a.txt").write_text("a")
    (src / "sub" / "b.txt").write_text("b")
    (src / "sub" / "deeper" / "c.bin").write_bytes(bytes(range(256)) * 5000)
    for fs_lib, name in ((t_fs, "port"), (j_fs, "jax")):
        remote = fs_lib.join(root, name)
        assert fs_lib.upload_dir(str(src), remote) == 3
    for fs_lib in (t_fs, j_fs):
        for name in ("port", "jax"):
            dst = tmp_path / f"dst-{fs_lib.__name__}-{name}"
            assert fs_lib.download_dir(fs_lib.join(root, name), str(dst)) == 3
            assert (dst / "a.txt").read_text() == "a"
            assert (dst / "sub" / "b.txt").read_text() == "b"
            assert (dst / "sub" / "deeper" / "c.bin").read_bytes() == \
                (src / "sub" / "deeper" / "c.bin").read_bytes()


def test_local_filesystem_answers_as_pyarrow_does(tmp_path):
    """The port's os-backed LocalFileSystem against pyarrow's on one tree:
    each path's type and size, and both listings."""
    from pyarrow import fs as pafs

    (tmp_path / "d" / "e").mkdir(parents=True)
    (tmp_path / "d" / "f.txt").write_text("12345")
    (tmp_path / "g").write_bytes(b"")
    ours, theirs = t_fs.LocalFileSystem(), pafs.LocalFileSystem()
    for rel in ("d", "d/e", "d/f.txt", "g", "missing"):
        path = str(tmp_path / rel)
        a, b = ours.get_file_info(path), theirs.get_file_info(path)
        assert int(a.type) == int(b.type), rel
        if b.type == pafs.FileType.File:
            assert a.size == b.size
    for recursive in (False, True):
        a = ours.get_file_info(t_fs.FileSelector(str(tmp_path),
                                                 recursive=recursive))
        b = theirs.get_file_info(pafs.FileSelector(str(tmp_path),
                                                   recursive=recursive))
        assert sorted((i.path, int(i.type)) for i in a) == \
            sorted((i.path, int(i.type)) for i in b)
    assert [int(t) for t in t_fs.FileType] == [int(t) for t in pafs.FileType]


def test_staged_checkpoint_roundtrip(mockfs):
    root, base = mockfs
    model_dir = t_fs.join(root, "model")
    state = _state(7)
    t_ckpt.save_checkpoint(model_dir, 7, state)
    assert t_ckpt.list_checkpoint_steps(model_dir) == [7]
    assert sorted(os.listdir(base / "model")) == ["ckpt-7"]
    assert sorted(os.listdir(base / "model" / "ckpt-7")) == [
        "MANIFEST.json", "optimizer.pt", "params.pt", "step.json"]
    t_ckpt.verify_checkpoint(t_ckpt.checkpoint_path(model_dir, 7))
    restored = t_ckpt.restore_checkpoint_host(model_dir, 7)
    assert restored["step"] == 7
    for key, value in state["params"].items():
        assert torch.equal(restored["params"][key], value)
    again, step = t_ckpt.restore_latest(model_dir)
    assert step == 7 and torch.equal(
        again["optimizer"]["state"][0]["exp_avg"], torch.ones(4) * 7)
    mapped = t_ckpt.restore_checkpoint(model_dir, 7, map_location="cpu",
                                       parts=("params",), mmap=True)
    assert sorted(mapped) == ["params", "step"]
    assert torch.equal(mapped["params"]["w"], state["params"]["w"])
    assert telemetry.get_registry().counter(
        "checkpoint/staged_bytes_total").value > 0


def test_staged_writer_async_and_retention(mockfs):
    root, base = mockfs
    model_dir = t_fs.join(root, "model2")
    with t_ckpt.CheckpointWriter(keep_last_n=2) as writer:
        for step in (1, 2, 3):
            writer.save(model_dir, step, _state(step))
            writer.wait()
        # GC runs before each save: with [1, 2, 3] on disk and
        # keep_last_n=2, step 1 is collected before 4 is written.
        writer.save(model_dir, 4, _state(4))
        writer.wait()
    assert t_ckpt.list_checkpoint_steps(model_dir) == [2, 3, 4]
    assert sorted(os.listdir(base / "model2")) == ["ckpt-2", "ckpt-3",
                                                   "ckpt-4"]
    restored = t_ckpt.restore_checkpoint_host(model_dir, 4)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 4.0))


def test_staged_upload_failure_surfaces_on_next_save(mockfs, monkeypatch):
    """An error of a background staged upload raises from the next
    save(), once, and the last good checkpoint survives (JAX
    tests/test_fs.py:102)."""
    root, _ = mockfs
    model_dir = t_fs.join(root, "failmodel")
    writer = t_ckpt.CheckpointWriter()
    writer.save(model_dir, 1, _state(1))
    writer.wait()
    real_upload = t_fs.upload_dir

    def flaky_upload(local_dir, uri, *args, **kwargs):
        if ".staging-ckpt-2" in uri:
            raise OSError("link down")
        return real_upload(local_dir, uri, *args, **kwargs)

    monkeypatch.setattr(t_fs, "upload_dir", flaky_upload)
    writer.save(model_dir, 2, _state(2))  # fails on the worker thread
    with pytest.raises(OSError, match="link down"):
        writer.save(model_dir, 3, _state(3))
    # Reported once: the writer is usable again afterwards.
    writer.save(model_dir, 4, _state(4))
    writer.wait()
    writer.close()
    assert t_ckpt.list_checkpoint_steps(model_dir) == [1, 4]
    restored = t_ckpt.restore_checkpoint_host(model_dir, 1)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))


def test_staged_writer_releases_the_snapshot_before_the_upload(
        mockfs, monkeypatch):
    """The host snapshot is dropped once the files are on local disk, so
    the slow upload pins no copy of the state (JAX `_write_staged`'s
    holder): a weak reference to it is dead when the upload starts."""
    import gc
    import weakref

    root, _ = mockfs
    refs, dead_at_upload = [], []
    real_snapshot, real_upload = t_ckpt._host_snapshot, t_fs.upload_dir

    def snapshot(tree):
        out = real_snapshot(tree)
        if isinstance(tree, dict) and "params" in tree:  # the whole state
            refs.append(weakref.ref(out["params"]["w"]))
        return out

    def upload(local_dir, uri, *args, **kwargs):
        gc.collect()
        dead_at_upload.append(refs[-1]() is None)
        return real_upload(local_dir, uri, *args, **kwargs)

    monkeypatch.setattr(t_ckpt, "_host_snapshot", snapshot)
    monkeypatch.setattr(t_fs, "upload_dir", upload)
    with t_ckpt.CheckpointWriter() as writer:
        writer.save(t_fs.join(root, "released"), 1, _state(1))
        writer.wait()
    assert dead_at_upload == [True]


def test_staged_same_step_overwrite_keeps_no_debris(mockfs):
    root, _ = mockfs
    model_dir = t_fs.join(root, "overwrite")
    t_ckpt.save_checkpoint(model_dir, 5, _state(1))
    t_ckpt.save_checkpoint(model_dir, 5, _state(9))
    restored = t_ckpt.restore_checkpoint_host(model_dir, 5)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 9.0))
    assert [name for name, _ in t_fs.listdir(model_dir)] == ["ckpt-5"]


def test_staged_commit_recovers_a_crash_between_move_aside_and_commit(
        mockfs, tmp_path):
    """A crash that left only `.replaced-ckpt-<step>` (the old tree moved
    aside, the new one not yet renamed in): the next commit restores the
    backup before uploading, as the JAX `_commit_staged` does; a failed
    upload then leaves the old tree in place."""
    root, base = mockfs
    model_dir = t_fs.join(root, "crash")
    t_ckpt.save_checkpoint(model_dir, 3, _state(3))
    os.rename(base / "crash" / "ckpt-3", base / "crash" / ".replaced-ckpt-3")
    empty = tmp_path / "empty"
    empty.mkdir()

    def broken(*args, **kwargs):
        raise OSError("upload failed")

    real = t_fs.upload_dir
    t_fs.upload_dir = broken
    try:
        with pytest.raises(OSError, match="upload failed"):
            t_ckpt._commit_staged(str(empty), model_dir, 3)
    finally:
        t_fs.upload_dir = real
    assert sorted(os.listdir(base / "crash")) == ["ckpt-3"]
    assert t_ckpt.latest_verified_step(model_dir) == 3
    # A backup left AFTER the commit landed is debris.
    t_ckpt.save_checkpoint(model_dir, 3, _state(4))
    (base / "crash" / ".replaced-ckpt-3").mkdir()
    t_ckpt.save_checkpoint(model_dir, 3, _state(5))
    assert sorted(os.listdir(base / "crash")) == ["ckpt-3"]
    assert torch.equal(t_ckpt.restore_checkpoint_host(model_dir, 3)[
        "params"]["w"], torch.full((4, 4), 5.0))


def test_remote_verify_quarantines_a_torn_tree(mockfs):
    root, base = mockfs
    model_dir = t_fs.join(root, "torn")
    t_ckpt.save_checkpoint(model_dir, 1, _state(1))
    t_ckpt.save_checkpoint(model_dir, 2, _state(2))
    params = base / "torn" / "ckpt-2" / "params.pt"
    params.write_bytes(params.read_bytes()[:-7])
    assert t_ckpt.latest_verified_step(model_dir) == 1
    assert sorted(os.listdir(base / "torn")) == ["ckpt-1", "ckpt-2.corrupt"]


def test_eval_markers_on_remote_fs_equal_jax(mockfs):
    root, base = mockfs
    for package, mark, steps in (
            ("port", t_evaluation._mark_evaluated,
             t_evaluation.evaluated_steps),
            ("jax", j_evaluation._mark_evaluated,
             j_evaluation._evaluated_steps)):
        model_dir = t_fs.join(root, package)
        assert steps(model_dir) == set()
        mark(model_dir, 5, {"loss": 1.0})
        mark(model_dir, 10, {"loss": 0.5})
        assert steps(model_dir) == {5, 10}
    for package in ("port", "jax"):
        assert sorted(os.listdir(base / package / "eval-done")) == [
            "eval-done-10.json", "eval-done-5.json"]
    assert (base / "port" / "eval-done" / "eval-done-5.json").read_text() \
        == (base / "jax" / "eval-done" / "eval-done-5.json").read_text()


def test_file_uri_checkpoint(tmp_path):
    model_dir = f"file://{tmp_path}/model"
    t_ckpt.save_checkpoint(model_dir, 1, _state(1))
    assert t_ckpt.list_checkpoint_steps(model_dir) == [1]
    # The tree landed where a plain-path caller would expect it.
    assert (tmp_path / "model" / "ckpt-1" / "MANIFEST.json").is_file()
    assert t_ckpt.latest_verified_step(str(tmp_path / "model")) == 1
    restored = t_ckpt.restore_checkpoint_host(model_dir, 1)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))


def test_placement_check_equals_jax(monkeypatch, tmp_path):
    def outcome(fs_lib, uri):
        try:
            fs_lib.check_model_dir_placement(uri)
            return "ok"
        except ValueError as exc:
            return str(exc)

    cases = [str(tmp_path), f"file://{tmp_path}", "gs://bucket/model",
             "mockfs://x", ""]
    for env in ({}, {"TPU_YARN_REMOTE_BACKEND": "1"},
                {"TPU_YARN_REMOTE_BACKEND": "1",
                 "TPU_YARN_ALLOW_LOCAL_MODEL_DIR": "1"}):
        for var in ("TPU_YARN_REMOTE_BACKEND",
                    "TPU_YARN_ALLOW_LOCAL_MODEL_DIR"):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        got = [outcome(t_fs, uri) for uri in cases]
        assert got == [outcome(j_fs, uri) for uri in cases]
        refused = env == {"TPU_YARN_REMOTE_BACKEND": "1"}
        assert ["host-local" in g for g in got] == [
            refused, refused, False, False, False]


def test_uploading_tb_writer_delegates_and_uploads(mockfs):
    """User hooks holding the writer call any SummaryWriter method against
    a remote model_dir, and `upload()` pushes events before close (JAX
    tests/test_fs.py:202)."""
    pytest.importorskip("torch.utils.tensorboard")
    from tf_yarn_tpu_torch import training as t_training

    root, base = mockfs
    model_dir = t_fs.join(root, "tbmodel")
    writer = t_training._make_tb_writer(model_dir)
    assert isinstance(writer, t_training._UploadingTbWriter)
    writer.add_scalar("train/loss", 1.0, 0)
    writer.add_histogram("weights", np.arange(8.0), 0)
    writer.add_text("note", "hello", 0)
    writer.upload()
    events = [n for n, _ in t_fs.listdir(t_fs.join(model_dir, "tb"))]
    assert any("tfevents" in n for n in events), events
    before = sum(p.stat().st_size for p in (base / "tbmodel" / "tb").iterdir())
    writer.add_scalar("train/loss", 0.5, 1)
    writer.close()
    writer.close()  # idempotent
    after = sum(p.stat().st_size for p in (base / "tbmodel" / "tb").iterdir())
    assert after > before
    local = t_training._make_tb_writer(str(base / "local"))
    assert not isinstance(local, t_training._UploadingTbWriter)
    local.close()


def test_torch_ckpt_on_remote_fs_equals_jax(mockfs):
    from tf_yarn_tpu.utils import model_ckpt as j_model_ckpt
    from tf_yarn_tpu_torch.utils import model_ckpt as t_model_ckpt

    root, _ = mockfs
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for package, mod in (("port", t_model_ckpt), ("jax", j_model_ckpt)):
        model_dir = t_fs.join(root, package)
        assert mod.find_latest_ckpt(model_dir) is None
        for epoch in (3, 12, 7):
            mod.save_ckpt(model_dir, model, opt, epoch=epoch)
        assert mod.find_latest_ckpt(model_dir) == t_fs.join(model_dir,
                                                             "model_12.pt")
    port = t_model_ckpt.load_latest_ckpt(t_fs.join(root, "port"))
    ref = j_model_ckpt.load_latest_ckpt(t_fs.join(root, "jax"))
    assert port["epoch"] == ref["epoch"] == 12
    for name in port["model"]:
        assert torch.equal(port["model"][name], ref["model"][name])


def test_restore_params_into_a_model_from_remote(mockfs):
    """The serving and inference restore (`inference._restore_params`:
    verify, map, copy once) from a remote model_dir."""
    from tf_yarn_tpu_torch import inference as t_inference

    root, _ = mockfs
    torch.manual_seed(1)
    source = torch.nn.Linear(6, 3)
    model_dir = t_fs.join(root, "serve")
    t_ckpt.save_checkpoint(model_dir, 9, {"params": source.state_dict(),
                                          "optimizer": {}, "step": 9})
    target = torch.nn.Linear(6, 3)
    assert t_inference._restore_params(target, model_dir, None) == 9
    assert t_inference._restore_params(target, model_dir, 9) == 9
    for name, value in source.state_dict().items():
        assert torch.equal(target.state_dict()[name], value)


def test_train_and_resume_on_remote_fs_matches_jax(mockfs):
    """A tiny LoRA decoder trained 2 steps, then resumed to 4, with its
    model_dir on the mockfs, against the JAX package's run of 4 steps on
    the mockfs from the same weights and batches (xla attention, plain
    norms): the losses agree within
    tests/test_torch_training.py's loss tolerance, and the remote trees
    hold the same checkpoint names (ckpt-4 with its manifest last) and no
    staging or backup trees."""
    from tests import _parallel_jobs as pj

    root, base = mockfs
    job = dict(model="decoder", mesh=None, impl="xla", lora=pj.LORA,
               name="remote", model_dir=t_fs.join(root, "port"),
               jax_dir=t_fs.join(root, "jax"))
    boxed, state = pj.jax_variables(job)
    init = base.parent / "init.pt"
    torch.save(state, init)
    job["init"] = str(init)
    port = []
    for steps in (2, 4):
        losses, _ = pj.world_one(dict(job, steps=steps, checkpoint=2))
        port += [losses[s] for s in sorted(losses)]
    # The JAX side straight to step 4 (a resumed port run equals a
    # straight one bitwise, tests/test_torch_resume.py).
    ref_run = pj.jax_run(dict(job, steps=4, checkpoint=2), boxed)
    ref = [ref_run["losses"][s] for s in sorted(ref_run["losses"])]
    assert len(port) == len(ref) == 4
    np.testing.assert_allclose(port, ref, rtol=2e-5)
    trees = {}
    for package in ("port", "jax"):
        trees[package] = sorted(os.listdir(base / package))
        assert not [n for n in trees[package] if n.startswith(".")], trees
    ckpts = [n for n in trees["port"] if n.startswith("ckpt-")]
    assert ckpts == [n for n in trees["jax"] if n.startswith("ckpt-")]
    assert ckpts[-1] == "ckpt-4" and set(ckpts) <= {"ckpt-2", "ckpt-4"}
    assert t_ckpt.latest_verified_step(t_fs.join(root, "port")) == 4
    assert j_ckpt.latest_checkpoint_step(t_fs.join(root, "jax")) == 4
    manifest = json.loads((base / "port" / "ckpt-4" / "MANIFEST.json")
                          .read_text())
    assert manifest["step"] == 4 and "params.pt" in manifest["files"]


_NO_PYARROW = r"""
import os, sys
sys.modules["pyarrow"] = None
sys.modules["pyarrow.fs"] = None
from tf_yarn_tpu_torch import checkpoint, fs
root = sys.argv[1]
checkpoint.save_checkpoint(os.path.join(root, "local"), 1,
                           {"params": {}, "optimizer": {}, "step": 1})
assert checkpoint.latest_verified_step(os.path.join(root, "local")) == 1


class Plain(fs.LocalFileSystem):
    pass


fs.register_scheme("plainfs", lambda uri: (
    Plain(), os.path.join(root, "remote", uri[len("plainfs://"):])))
checkpoint.save_checkpoint("plainfs://m", 2,
                           {"params": {}, "optimizer": {}, "step": 2})
assert checkpoint.latest_verified_step("plainfs://m") == 2
assert sorted(os.listdir(os.path.join(root, "remote", "m"))) == ["ckpt-2"]
try:
    fs.exists("nofs://host/path")
except ModuleNotFoundError as exc:
    print("refused:", exc)
assert "pyarrow" not in {k for k, v in sys.modules.items() if v is not None}
print("ok")
"""


def test_fs_imports_and_works_without_pyarrow(tmp_path):
    """With pyarrow hidden, the port's fs and checkpoints work on local
    paths and on a registered scheme, and an unregistered remote scheme
    fails naming pyarrow and register_scheme."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_PYARROW, str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "pyarrow is not installed" in out.stdout
    assert "register_scheme" in out.stdout
