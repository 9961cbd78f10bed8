"""Environment & code packaging for multi-host placement — counterpart
of tf_yarn_tpu/packaging.py.

A bare GPU host needs the project code (and the user's pinned
third-party deps) before it can run a task: `ship_env` zips
``tf_yarn_tpu_torch/`` (plus any pip-editable projects), stages the
archives on a filesystem every worker can read (`fs`: a path, NFS,
``gs://``, ``hdfs://``) and returns the `pre_script_hook` that fetches and
unpacks them on the worker; `ship_files` sends the same over the
backend's own file channel instead (`SshBackend` streams it over ssh).
`requirements`/`wheels_dir` add a wheelhouse that the worker installs
with ``pip install --no-index``.

The package zip carries the CUDA sources (``ops/csrc/*.cu`` and
``*.cuh``): a shipped worker builds its kernel library from them at first
use, into ``build/`` beside its unpacked copy. Build products (``build/``,
``*.so``) and caches never travel.

The shell strings (`unpack_cmd`, `_fetch_cmd`, `_pip_install_cmd`) are
the JAX package's byte for byte, and `zip_path` names a directory's
archive as the JAX one does.
"""

from __future__ import annotations

import hashlib
import logging
import os
import site
import sys
import tempfile
import zipfile
from typing import Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)

_EXCLUDE_DIRS = {".git", "__pycache__", ".pytest_cache", ".claude", "node_modules",
                 "build"}


def zip_path(py_dir: str, include_base_name: bool = True) -> str:
    """Zip a directory of Python code (reference: packaging.py:23-36).

    Returns the path of a content-addressed zip in the temp dir (same
    content → same name → cacheable on the far side).
    """
    py_dir = os.path.abspath(py_dir)
    base = os.path.basename(py_dir)
    entries: List[Tuple[str, str]] = []
    for root, dirs, files in os.walk(py_dir):
        # Sorted traversal: the content digest must not depend on inode order.
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for name in sorted(files):
            if name.endswith((".pyc", ".so", ".so.tmp")):
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, py_dir)
            if include_base_name:
                rel = os.path.join(base, rel)
            entries.append((full, rel))

    digest = hashlib.sha256()
    for full, rel in entries:
        digest.update(rel.encode())
        with open(full, "rb") as fh:
            digest.update(fh.read())
    out_path = os.path.join(
        tempfile.gettempdir(), f"{base}-{digest.hexdigest()[:12]}.zip"
    )
    if not os.path.exists(out_path):
        with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for full, rel in entries:
                zf.write(full, rel)
        _logger.info("packed %s (%d files) -> %s", py_dir, len(entries), out_path)
    return out_path


def _resolve_fs(target_dir: str, filesystem):
    if filesystem is None:
        from tf_yarn_tpu_torch import fs as fs_lib

        # Shares fs.register_scheme's vendor/test seam with every other
        # URI consumer (checkpoints, markers, inference output).
        filesystem, target_dir = fs_lib.resolve(target_dir)
    return filesystem, target_dir.rstrip("/")


def _copy_file_to_fs(local_path: str, filesystem, remote_path: str) -> None:
    with open(local_path, "rb") as src, filesystem.open_output_stream(
        remote_path
    ) as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)


def upload_env(
    package_path: str, target_dir: str, filesystem=None
) -> str:
    """Copy a packed archive to `target_dir` on any `fs` filesystem
    (local path, gs://, hdfs:// — the upload_env_to_hdfs role,
    reference: packaging.py:39-56). Returns where the workers fetch it
    from: the URI for a URI `target_dir` (the JAX package returns the
    path within the filesystem, which drops the scheme), an absolute
    path for a local one, the path within `filesystem` when one is
    given."""
    from tf_yarn_tpu_torch import fs as fs_lib

    name = os.path.basename(package_path)
    given = filesystem is not None
    uri = target_dir
    filesystem, target_dir = _resolve_fs(target_dir, filesystem)
    filesystem.create_dir(target_dir, recursive=True)
    remote = f"{target_dir}/{name}"
    _copy_file_to_fs(package_path, filesystem, remote)
    _logger.info("uploaded %s -> %s", package_path, remote)
    if given or fs_lib.parse_scheme(uri) == "":
        return remote
    return fs_lib.join(uri, name)


def upload_dir(local_dir: str, target_dir: str, filesystem=None) -> int:
    """Recursively copy a local directory tree onto a pyarrow filesystem
    (reference uploads TB logs this way, pytorch/tasks/worker.py:145-152).
    Returns the number of files copied. Delegates to `fs.upload_dir` —
    one walk-and-copy implementation for the whole repo."""
    from tf_yarn_tpu_torch import fs as fs_lib

    if not os.path.isdir(local_dir):
        raise ValueError(f"upload_dir: {local_dir!r} is not a directory")
    copied = fs_lib.upload_dir(local_dir, target_dir, filesystem=filesystem)
    _logger.info("uploaded %d files %s -> %s", copied, local_dir, target_dir)
    return copied


def get_editable_requirements() -> Dict[str, str]:
    """pip-editable projects in this env: name -> source dir (reference:
    cluster_pack's editable-requirements detection, client.py:498-505).

    Best-effort: covers path-style `__editable__.<name>-<ver>.pth` files.
    PEP-660 finder-style editables (a pth containing an `import ..._finder`
    line, no path) carry no directory to ship and are skipped.
    """
    editable: Dict[str, str] = {}
    for directory in site.getsitepackages() + [site.getusersitepackages()]:
        if not os.path.isdir(directory):
            continue
        for entry in os.listdir(directory):
            if entry.startswith("__editable__") and entry.endswith(".pth"):
                # "__editable__.mypkg-1.0.0.pth" -> "mypkg"
                stem = entry[len("__editable__."):-len(".pth")]
                name = stem.split("-", 1)[0]
                try:
                    with open(os.path.join(directory, entry)) as fh:
                        lines = [
                            line.strip()
                            for line in fh.read().splitlines()
                            if line.strip() and not line.startswith("import ")
                        ]
                    if lines and os.path.isdir(lines[-1]):
                        editable[name] = lines[-1]
                except OSError:
                    continue
    return editable


def detect_packed_repo() -> Optional[str]:
    """Directory holding the running tf_yarn_tpu_torch package."""
    import tf_yarn_tpu_torch

    return os.path.dirname(
        os.path.dirname(os.path.abspath(tf_yarn_tpu_torch.__file__)))


_SHELL_SAFE_RE = None


def _require_shell_safe(value: str, what: str) -> str:
    """unpack_cmd interpolates paths into a worker-side shell line AND a
    single-quoted python literal; rather than attempt dual-context
    quoting (where `~` expansion and `$HOME` must still work), reject
    anything outside the conservative safe set with a clear error."""
    global _SHELL_SAFE_RE
    if _SHELL_SAFE_RE is None:
        import re

        _SHELL_SAFE_RE = re.compile(r"^[A-Za-z0-9_./:~=@%+-]+$")
    if not _SHELL_SAFE_RE.match(value):
        raise ValueError(
            f"{what} {value!r} contains shell-unsafe characters "
            "(spaces/quotes/metacharacters); use a path matching "
            "[A-Za-z0-9_./:~=@%+-]"
        )
    return value


def _fetch_cmd(remote_zip: str, local_zip: str) -> Optional[str]:
    """Shell command fetching `remote_zip` to a worker-local path, or None
    when the zip is directly readable (plain path / file:// — a shared
    mount). Only stdlib + the scheme's own CLI are assumed on the worker:
    env shipping exists precisely because tf_yarn_tpu_torch is NOT importable
    there yet."""
    from tf_yarn_tpu_torch import fs as fs_lib

    scheme = fs_lib.parse_scheme(remote_zip)
    if scheme in ("", "file"):
        return None
    if scheme == "gs":
        return f"gsutil -q cp {remote_zip} {local_zip}"
    if scheme in ("hdfs", "viewfs"):
        return f"hdfs dfs -get -f {remote_zip} {local_zip}"
    raise ValueError(
        f"no worker-side fetch command for scheme {scheme!r} "
        f"({remote_zip}); stage the env on a path, file://, gs://, or "
        "hdfs:// filesystem — or ship over the backend channel instead "
        "(run_on_gpu without env_staging_dir)"
    )


def unpack_cmd(
    remote_zip: str,
    dest: str = "~/.tpu_yarn_code",
    export_pythonpath: bool = True,
) -> str:
    """Shell one-liner for SshBackend.pre_script_hook: fetch + unzip +
    prepend to PYTHONPATH on the worker. Assumes only a bare python3
    (zipfile is stdlib); `~` is expanded on the worker, not the driver."""
    from tf_yarn_tpu_torch import fs as fs_lib

    if fs_lib.parse_scheme(remote_zip) == "file":
        remote_zip = remote_zip[len("file://"):]
    _require_shell_safe(remote_zip, "remote_zip")
    _require_shell_safe(dest, "dest")
    fetch = _fetch_cmd(remote_zip, f"{dest}/_fetched.zip")
    src = f"{dest}/_fetched.zip" if fetch else remote_zip
    parts = [f"mkdir -p {dest}"]
    if fetch:
        parts.append(fetch)
    # expanduser runs worker-side so `~` paths work from inside python
    # (the shell only expands `~` at a word start, not mid-argument).
    parts.append(
        "python3 -c \"import os,zipfile;"
        f"zipfile.ZipFile(os.path.expanduser('{src}'))"
        f".extractall(os.path.expanduser('{dest}'))\""
    )
    if export_pythonpath:
        parts.append(f"export PYTHONPATH={dest}:$PYTHONPATH")
    return " && ".join(parts)


WHEELHOUSE_MANIFEST = "_requirements.txt"

_DIST_SUFFIXES = (".whl", ".tar.gz", ".zip")

# build_wheelhouse is memoized per driver process: a retry loop or an
# iterative notebook must not re-run pip download (or leak a temp copy)
# per run_on_gpu call. Not cached on disk across processes — a fresh
# driver re-resolves, so a PyPI-side change can't be masked forever.
_WHEELHOUSE_CACHE: Dict[tuple, str] = {}


def _dist_name(filename: str) -> str:
    """'mylib-1.0-py3-none-any.whl' / 'python-dateutil-2.9.0.tar.gz' ->
    'mylib' / 'python-dateutil'. Split before the first -<digit> segment:
    wheel names escape hyphens to underscores, but pre-PEP-625 sdists
    keep them in the project name."""
    import re

    match = re.match(r"^(.+?)-\d", filename)
    return match.group(1) if match else filename.split("-", 1)[0]


def _wheelhouse_cache_key(requirements, wheels_dir, platform,
                          python_version) -> tuple:
    specs = (
        ("file", os.path.abspath(requirements),
         os.path.getmtime(requirements))
        if isinstance(requirements, str)
        else tuple(requirements) if requirements is not None else None
    )
    listing = None
    if wheels_dir is not None:
        listing = tuple(
            (name, os.path.getsize(os.path.join(wheels_dir, name)),
             os.path.getmtime(os.path.join(wheels_dir, name)))
            for name in sorted(os.listdir(wheels_dir))
            if name.endswith(_DIST_SUFFIXES)
        )
    return (specs, wheels_dir and os.path.abspath(wheels_dir), listing,
            platform, python_version)


def build_wheelhouse(
    requirements=None,
    wheels_dir: Optional[str] = None,
    platform: Optional[str] = None,
    python_version: Optional[str] = None,
) -> str:
    """Driver-side wheelhouse: a directory of wheels satisfying
    `requirements` plus a `_requirements.txt` manifest naming what the
    worker must install from it.

    The reference ships the entire interpreter env as a pex on every run
    (reference: client.py:421-424, packaging.py:39-56); GPU host images
    already carry python+torch, so only the *delta* — the user's
    third-party deps — needs to travel. `requirements` is a list of pip
    requirement specs or a path to a requirements.txt; wheels resolve
    via `pip download` (needs egress on the DRIVER only). `wheels_dir`
    supplies pre-downloaded wheels instead — the air-gapped / CI seam.

    `pip download` resolves for THIS interpreter and platform unless
    `platform`/`python_version` pin the worker's (e.g.
    platform="manylinux2014_x86_64", python_version="3.12" — adds
    `--only-binary :all:`, which pip requires with those pins). A
    driver whose OS/CPython differs from the worker image must pin, or
    the shipped wheels won't match the worker's compatibility tags.
    """
    import shutil
    import subprocess

    if requirements is None and wheels_dir is None:
        raise ValueError("need requirements specs and/or a wheels_dir")
    if isinstance(requirements, str) and not os.path.exists(requirements):
        # A lone spec string ("numpy==1.26") is the natural mis-call of
        # the list-vs-path contract; getmtime's FileNotFoundError names
        # neither the contract nor the fix.
        raise ValueError(
            f"requirements={requirements!r}: a string is the PATH to a "
            "requirements.txt, and no such file exists. Pass pip specs "
            f"as a list (requirements=[{requirements!r}]) or point to "
            "an existing requirements file."
        )
    key = _wheelhouse_cache_key(
        requirements, wheels_dir, platform, python_version)
    cached = _WHEELHOUSE_CACHE.get(key)
    if cached is not None and os.path.isdir(cached):
        return cached
    # Stable basename: zip_path embeds it in the archive name, which must
    # depend only on CONTENT for the staging cache + unpack-root digest.
    house = os.path.join(
        tempfile.mkdtemp(prefix="tpu-yarn-deps-"), "wheelhouse")
    os.makedirs(house)
    if wheels_dir is not None:
        for name in sorted(os.listdir(wheels_dir)):
            if name.endswith(_DIST_SUFFIXES):
                shutil.copy2(os.path.join(wheels_dir, name),
                             os.path.join(house, name))
    if requirements is not None and wheels_dir is None:
        spec_args = (
            ["-r", requirements] if isinstance(requirements, str)
            else list(requirements)
        )
        pin_args: List[str] = []
        if platform or python_version:
            pin_args = ["--only-binary", ":all:"]
            if platform:
                pin_args += ["--platform", platform]
            if python_version:
                pin_args += ["--python-version", python_version]
        subprocess.run(
            [sys.executable, "-m", "pip", "download", "-q",
             "-d", house] + pin_args + spec_args,
            check=True,
        )
    with open(os.path.join(house, WHEELHOUSE_MANIFEST), "w") as fh:
        if isinstance(requirements, str):
            with open(requirements) as src:
                fh.write(src.read())
        elif requirements is not None:
            fh.write("\n".join(requirements) + "\n")
        else:
            # No explicit specs: install every shipped distribution by
            # name — sdists included (pip builds them offline on the
            # worker; it fails loudly there if a build backend is
            # missing, instead of silently never installing them).
            for name in sorted(os.listdir(house)):
                if name.endswith(_DIST_SUFFIXES):
                    fh.write(_dist_name(name) + "\n")
    _WHEELHOUSE_CACHE[key] = house
    return house


def _pip_install_cmd(house: str, target: str, python: str = "python3") -> str:
    """Worker-side shell fragment installing a fetched wheelhouse into
    `target` (no root, no venv mutation: --target + PYTHONPATH), run
    under the WORKER's interpreter (`python` — the backend's configured
    one, so compatibility tags match the process that will import the
    deps). The content-addressed unpack root makes the .done marker
    safe: changed deps get a fresh root, so a marker never vouches for
    stale installs."""
    _require_shell_safe(house, "wheelhouse dir")
    _require_shell_safe(target, "pydeps target")
    _require_shell_safe(python, "python interpreter")
    install = (
        f"{python} -m pip install -q --no-index --find-links {house} "
        f"--target {target} -r {house}/{WHEELHOUSE_MANIFEST}"
    )
    return (
        f"[ -f {target}/.tpu_yarn_done ] || "
        f"{{ {install} && touch {target}/.tpu_yarn_done; }}"
    )


def package_dir() -> str:
    """The importable tf_yarn_tpu_torch package directory (what a worker
    needs on its PYTHONPATH)."""
    import tf_yarn_tpu_torch

    return os.path.dirname(os.path.abspath(tf_yarn_tpu_torch.__file__))


def ship_env(
    staging_dir: str,
    dest: str = "~/.tpu_yarn_code",
    include_editable: bool = True,
    requirements=None,
    wheels_dir: Optional[str] = None,
    python: str = "python3",
) -> str:
    """Zip + upload this environment's project code (and, with
    `requirements`/`wheels_dir`, its third-party deps as a wheelhouse)
    and return the pre_script_hook that bootstraps it on a
    bare-interpreter worker.

    The reference ships the full interpreter env on every run
    (reference: client.py:421-424 auto `cluster_pack.upload_env`,
    packaging.py:39-56). GPU hosts are provisioned from images that
    already carry python+torch, so what must travel is the *project* code
    — tf_yarn_tpu_torch itself plus any pip-editable working copies — and any
    user deps absent from the image: `requirements` (pip specs or a
    requirements.txt path) resolves driver-side into a wheelhouse that
    workers `pip install --no-index --target` into the unpack root.
    Archives are content-addressed (`zip_path`), so re-runs re-upload
    only on change.
    """
    # tf_yarn_tpu_torch itself is zipped with its base name so `dest`
    # becomes the sys.path root containing the package; each editable pth entry
    # is already a sys.path root, so its contents extract flat.
    archives = [zip_path(package_dir(), include_base_name=True)]
    if include_editable:
        for _name, src_dir in sorted(get_editable_requirements().items()):
            archives.append(zip_path(src_dir, include_base_name=False))
    wheel_zip = None
    if requirements is not None or wheels_dir is not None:
        wheel_zip = zip_path(
            build_wheelhouse(requirements, wheels_dir),
            include_base_name=False,
        )
    # Content-addressed unpack dir: same code re-extracts into the same
    # place, changed code gets a fresh one — a deleted module can't
    # linger from a previous run's extraction. The wheelhouse digest
    # rides along so changed deps also get a fresh root (and a fresh
    # pip --target install).
    digest = hashlib.sha256(
        "|".join(os.path.basename(a)
                 for a in archives + ([wheel_zip] if wheel_zip else [])
                 ).encode()
    ).hexdigest()[:12]
    unpack_root = f"{dest.rstrip('/')}/{digest}"
    hooks = [
        unpack_cmd(upload_env(a, staging_dir), unpack_root,
                   export_pythonpath=False)
        for a in archives
    ]
    python_path = f"{unpack_root}:$PYTHONPATH"
    if wheel_zip:
        house = f"{unpack_root}/_wheels"
        pydeps = f"{unpack_root}/_pydeps"
        hooks.append(
            unpack_cmd(upload_env(wheel_zip, staging_dir), house,
                       export_pythonpath=False)
        )
        hooks.append(_pip_install_cmd(house, pydeps, python=python))
        python_path = f"{pydeps}:{python_path}"
    hooks.append(f"export PYTHONPATH={python_path}")
    return " && ".join(hooks)


def ship_files(
    requirements=None, wheels_dir: Optional[str] = None
) -> Dict[str, str]:
    """Project code as `files=` entries for the backend channel (SshBackend
    streams these over ssh into each task's workdir, which lands on
    PYTHONPATH) — env shipping with no shared filesystem at all. The
    zero-config default for remote backends; `ship_env` is the
    shared-staging alternative.

    With `requirements`/`wheels_dir`, a `_shipped_wheels/` dir rides the
    same channel; the worker pip-installs it --no-index before
    unpickling the experiment (_task_commons._install_shipped_wheels).
    """
    entries: Dict[str, str] = {"tf_yarn_tpu_torch": package_dir()}
    for name, src_dir in sorted(get_editable_requirements().items()):
        # A pth entry is a sys.path root: ship each child so the workdir
        # itself is the import root — minus VCS/cache trees (a flat-layout
        # checkout has .git/ and friends as children; streaming gigabytes
        # of history to every host on every run is the bug, zip_path
        # prunes the same set).
        for child in sorted(os.listdir(src_dir)):
            if child in _EXCLUDE_DIRS:
                continue
            path = os.path.join(src_dir, child)
            taken = entries.setdefault(child, path)
            if taken != path:
                # Two editable roots with a same-named child (or one
                # shadowing tf_yarn_tpu_torch itself): the first wins, and
                # the loser is named.
                _logger.warning(
                    "ship_files: %r from editable project %r collides "
                    "with already-shipped %r; shipping the first, NOT %r",
                    child, name, taken, path,
                )
    if requirements is not None or wheels_dir is not None:
        house = build_wheelhouse(requirements, wheels_dir)
        for name in sorted(os.listdir(house)):
            entries[f"_shipped_wheels/{name}"] = os.path.join(house, name)
    return entries


def python_env_description() -> Dict[str, str]:
    """Env summary recorded with a run (version drift debugging)."""
    return {
        "python": sys.version.split()[0],
        "executable": sys.executable,
        "platform": sys.platform,
    }
