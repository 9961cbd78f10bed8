"""URI filesystem layer — counterpart of tf_yarn_tpu/fs.py: the one seam
for every `model_dir`-like path.

Every subsystem that touches a user-supplied directory (checkpoint
discovery, verification, retention and staged uploads, eval-done
markers, inference output, TensorBoard uploads, packaging) resolves it
through this module, so a `model_dir` may be a plain path, ``file://``,
``gs://``, ``hdfs://``, or any scheme registered with
:func:`register_scheme`.

* Plain paths and ``file://`` go through `os` and `shutil`
  (:class:`LocalFileSystem`).
* A registered scheme's factory returns ``(filesystem, path)``, where
  `filesystem` has the methods of ``pyarrow.fs.FileSystem`` this module
  calls (`get_file_info` on a path or a selector, `create_dir`,
  `delete_dir`, `move`, `open_output_stream`, `open_input_stream`,
  `open_input_file`). A ``pyarrow.fs.SubTreeFileSystem`` works unchanged,
  and so does a small class of its own that answers with
  :class:`FileInfo` and reads :class:`FileSelector` (the vendor seam; also
  how tests mount a fake remote filesystem).
* Any other scheme goes to ``pyarrow.fs.FileSystem.from_uri``, imported
  only then: without pyarrow that raises an error naming the package and
  the `register_scheme` alternative. Nothing here imports pyarrow for a
  local path or a registered scheme.
"""

from __future__ import annotations

import enum
import functools
import logging
import os
import re
import shutil
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

_logger = logging.getLogger(__name__)

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

# scheme -> factory(uri) -> (filesystem, path-within-fs)
_REGISTRY: Dict[str, Callable[[str], Tuple[object, str]]] = {}


class FileType(enum.IntEnum):
    """A path's kind, with ``pyarrow.fs.FileType``'s names and values, so
    either kind of filesystem's answers compare through `int`."""

    NotFound = 0
    Unknown = 1
    File = 2
    Directory = 3


@dataclass
class FileInfo:
    """What `get_file_info` answers for one path (pyarrow's fields)."""

    path: str
    type: FileType
    size: int = 0


@dataclass
class FileSelector:
    """A directory listing request (pyarrow's fields)."""

    base_dir: str
    recursive: bool = False
    allow_not_found: bool = False


class LocalFileSystem:
    """This host's filesystem through `os` and `shutil`, with the methods
    of ``pyarrow.fs.LocalFileSystem`` that this module calls."""

    @staticmethod
    def _info(path: str) -> FileInfo:
        if os.path.isdir(path):
            return FileInfo(path, FileType.Directory)
        if os.path.exists(path):
            return FileInfo(path, FileType.File, os.path.getsize(path))
        return FileInfo(path, FileType.NotFound)

    def get_file_info(self, target):
        if not isinstance(target, FileSelector):
            return self._info(target)
        base = target.base_dir.rstrip("/") or "/"
        if not os.path.isdir(base):
            if target.allow_not_found:
                return []
            raise FileNotFoundError(base)
        if not target.recursive:
            return [self._info(os.path.join(base, name))
                    for name in sorted(os.listdir(base))]
        infos = []
        for root, dirs, files in os.walk(base):
            dirs.sort()
            infos.extend(self._info(os.path.join(root, name))
                         for name in dirs + sorted(files))
        return infos

    def create_dir(self, path: str, recursive: bool = True) -> None:
        if recursive:
            os.makedirs(path, exist_ok=True)
        else:
            os.mkdir(path)

    def delete_dir(self, path: str) -> None:
        shutil.rmtree(path)

    def move(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def open_output_stream(self, path: str):
        return open(path, "wb")

    def open_input_stream(self, path: str):
        return open(path, "rb")

    def open_input_file(self, path: str):
        return open(path, "rb")


def register_scheme(scheme: str, factory: Callable[[str], Tuple[object, str]]) -> None:
    """Route `scheme://...` URIs through `factory(uri) -> (fs, path)`.

    Overrides pyarrow's own resolution for that scheme — the seam for
    vendor filesystems and for tests that need a fake remote fs (e.g. a
    SubTreeFileSystem over a temp dir)."""
    _REGISTRY[scheme] = factory
    _fs_for_root.cache_clear()


def unregister_scheme(scheme: str) -> None:
    _REGISTRY.pop(scheme, None)
    _fs_for_root.cache_clear()


def parse_scheme(uri: str) -> str:
    """"gs://b/p" -> "gs"; plain paths -> ""."""
    match = _SCHEME_RE.match(uri)
    return match.group(1) if match else ""


def is_local(uri: str) -> bool:
    """True when `uri` lives on this host's filesystem (no scheme or
    file://) — the "needs shared storage" test for multi-host runs."""
    return parse_scheme(uri) in ("", "file")


def local_path(uri: str) -> str:
    """The plain local path of a local uri (strips file://)."""
    scheme = parse_scheme(uri)
    if scheme == "file":
        return uri[len("file://"):]
    if scheme == "":
        return uri
    raise ValueError(f"{uri!r} is not a local path")


def _split_root(uri: str) -> Tuple[str, str]:
    """"hdfs://host:port/a/b" -> ("hdfs://host:port/", "a/b"): the root
    names the filesystem client (scheme + authority), so one client
    serves every ``.../ckpt-<step>`` URI of a long run."""
    scheme = parse_scheme(uri)
    rest = uri[len(scheme) + 3:]
    authority, _, path = rest.partition("/")
    return f"{scheme}://{authority}/", path


@functools.lru_cache(maxsize=64)
def _fs_for_root(root_uri: str):
    """One pyarrow filesystem client per (scheme, authority)."""
    try:
        from pyarrow import fs as pafs
    except ImportError as exc:
        raise ModuleNotFoundError(
            f"{root_uri}: the {parse_scheme(root_uri)}:// scheme resolves "
            "through pyarrow.fs, and pyarrow is not installed; install "
            "pyarrow or register a filesystem for the scheme with "
            "tf_yarn_tpu_torch.fs.register_scheme", name="pyarrow") from exc
    return pafs.FileSystem.from_uri(root_uri)


def resolve(uri: str):
    """uri -> (filesystem, path-within-fs)."""
    scheme = parse_scheme(uri)
    if scheme in _REGISTRY:
        # Registered factories may derive the path from the full URI
        # arbitrarily, so they are consulted per call.
        return _REGISTRY[scheme](uri)
    if scheme in ("", "file"):
        return LocalFileSystem(), os.path.abspath(local_path(uri))
    root, path = _split_root(uri)
    filesystem, base = _fs_for_root(root)
    if path:
        return filesystem, base.rstrip("/") + "/" + path
    return filesystem, base


def _type(info) -> FileType:
    return FileType(int(info.type))


def _selector(filesystem, path: str, recursive: bool):
    """A listing request in the filesystem's own type: pyarrow's
    filesystems take only pyarrow's selector (and pyarrow is imported
    already when one of them exists)."""
    if type(filesystem).__module__.startswith("pyarrow"):
        from pyarrow import fs as pafs

        return pafs.FileSelector(path, recursive=recursive)
    return FileSelector(path, recursive=recursive)


def tree(uri: str, recursive: bool = True) -> List[Tuple[str, FileType, int]]:
    """[(path relative to `uri`, type, size)] of what lies under the
    directory `uri`; [] when it is not a directory."""
    filesystem, root = resolve(uri)
    if _type(filesystem.get_file_info(root)) != FileType.Directory:
        return []
    root = root.rstrip("/")
    return [(info.path[len(root):].lstrip("/"), _type(info),
             int(info.size or 0))
            for info in filesystem.get_file_info(
                _selector(filesystem, root, recursive))]


def join(uri: str, *parts: str) -> str:
    """Path join that preserves the uri scheme."""
    if parse_scheme(uri) == "":
        return os.path.join(uri, *parts)
    return "/".join([uri.rstrip("/"), *parts])


def exists(uri: str) -> bool:
    filesystem, path = resolve(uri)
    return _type(filesystem.get_file_info(path)) != FileType.NotFound


def isdir(uri: str) -> bool:
    filesystem, path = resolve(uri)
    return _type(filesystem.get_file_info(path)) == FileType.Directory


def listdir(uri: str) -> List[Tuple[str, bool]]:
    """[(base_name, is_dir)] of the directory's children; [] when the
    directory doesn't exist (discovery loops poll before training has
    created model_dir)."""
    return [(os.path.basename(rel), kind == FileType.Directory)
            for rel, kind, _size in tree(uri, recursive=False)]


def mkdirs(uri: str) -> None:
    filesystem, path = resolve(uri)
    filesystem.create_dir(path, recursive=True)


def rmtree(uri: str) -> None:
    """Delete a directory tree; missing targets are a no-op (retention GC
    races with concurrent deleters)."""
    filesystem, path = resolve(uri)
    try:
        filesystem.delete_dir(path)
    except Exception as exc:
        if _type(filesystem.get_file_info(path)) != FileType.NotFound:
            raise
        _logger.debug("rmtree(%s): already gone (%s)", uri, exc)


def move(src_uri: str, dst_uri: str) -> None:
    """Rename within one filesystem (the commit step of staged uploads)."""
    src_fs, src_path = resolve(src_uri)
    _dst_fs, dst_path = resolve(dst_uri)
    src_fs.move(src_path, dst_path)


def open_output(uri: str):
    """Binary writable stream; parent directories are created."""
    filesystem, path = resolve(uri)
    parent = os.path.dirname(path.rstrip("/"))
    if parent:
        filesystem.create_dir(parent, recursive=True)
    return filesystem.open_output_stream(path)


def open_input(uri: str):
    filesystem, path = resolve(uri)
    return filesystem.open_input_stream(path)


def open_input_file(uri: str):
    """Seekable (random-access) reader — torch.load needs seek(), which
    plain input streams don't provide."""
    filesystem, path = resolve(uri)
    return filesystem.open_input_file(path)


def write_text(uri: str, text: str) -> None:
    with open_output(uri) as stream:
        stream.write(text.encode("utf-8"))


def read_text(uri: str) -> str:
    with open_input(uri) as stream:
        return stream.read().decode("utf-8")


def upload_dir(local_dir: str, uri: str, filesystem=None) -> int:
    """Recursively copy a local tree to `uri`; returns files copied.

    The single walk-and-copy implementation — `packaging.upload_dir`
    delegates here. An explicit `filesystem` skips URI resolution and
    treats `uri` as a path within it."""
    if filesystem is None:
        filesystem, target = resolve(uri)
    else:
        target = uri.rstrip("/")
    copied = 0
    for root, _dirs, files in os.walk(local_dir):
        rel_root = os.path.relpath(root, local_dir)
        remote_root = target if rel_root == "." else f"{target}/{rel_root}"
        filesystem.create_dir(remote_root, recursive=True)
        for name in files:
            with open(os.path.join(root, name), "rb") as src, \
                    filesystem.open_output_stream(f"{remote_root}/{name}") as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
            copied += 1
    return copied


def download_dir(uri: str, local_dir: str) -> int:
    """Recursively copy `uri`'s tree to a local directory."""
    filesystem, root = resolve(uri)
    os.makedirs(local_dir, exist_ok=True)
    copied = 0
    for rel, kind, _size in tree(uri):
        dst = os.path.join(local_dir, rel)
        if kind == FileType.Directory:
            os.makedirs(dst, exist_ok=True)
        else:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with filesystem.open_input_stream(f"{root.rstrip('/')}/{rel}") \
                    as src, open(dst, "wb") as out:
                shutil.copyfileobj(src, out, 1 << 20)
            copied += 1
    return copied


def check_model_dir_placement(model_dir: str) -> None:
    """Fail fast when a remote-backend run points model_dir at host-local
    storage: each host would write `ckpt-*` trees to its own disk and a
    restore or side-car eval from another host silently sees nothing. A
    shared mount (NFS) at a local path is legitimate: declare it with
    TPU_YARN_ALLOW_LOCAL_MODEL_DIR=1."""
    if not model_dir or not is_local(model_dir):
        return
    if not os.environ.get("TPU_YARN_REMOTE_BACKEND"):
        return
    if os.environ.get("TPU_YARN_ALLOW_LOCAL_MODEL_DIR"):
        return
    raise ValueError(
        f"model_dir {model_dir!r} is host-local but this task was launched "
        "by a remote (multi-machine) backend: checkpoints and eval markers "
        "would land on each host's own disk. Use a shared filesystem URI "
        "(gs://, hdfs://, ...) — or set TPU_YARN_ALLOW_LOCAL_MODEL_DIR=1 "
        "if this path is a shared mount."
    )
