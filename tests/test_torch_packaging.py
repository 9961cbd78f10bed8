"""The port's packaging held against the JAX package's
(tests/test_packaging.py): the worker-side shell strings byte for byte,
the content-addressed zip names, the shipped package's contents (the
CUDA sources, no build products), the fake gsutil and hdfs fetches, the
wheelhouse; and the kernel build's lock across processes racing its link
step, with nvcc and the library loader stubbed."""

import os
import shutil
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import pytest

from tests._wheels import make_wheel
from tf_yarn_tpu import packaging as j_packaging
from tf_yarn_tpu_torch import fs as t_fs
from tf_yarn_tpu_torch import packaging as t_packaging

REPO = Path(__file__).resolve().parents[1]

UNPACK_CASES = [
    ("/shared/code.zip", {}),
    ("/shared/code.zip", {"dest": "~/.code"}),
    ("/shared/code.zip", {"dest": "~/.code/abc", "export_pythonpath": False}),
    ("file:///shared/code.zip", {}),
    ("gs://bucket/x/code.zip", {"dest": "~/c"}),
    ("hdfs://nn:8020/code.zip", {}),
    ("viewfs://cluster/a/code.zip", {"dest": "~/v"}),
]


@pytest.mark.parametrize("remote, kwargs", UNPACK_CASES,
                         ids=[f"case{i}" for i in range(len(UNPACK_CASES))])
def test_unpack_and_fetch_cmds_equal_jax(remote, kwargs):
    assert t_packaging.unpack_cmd(remote, **kwargs) == \
        j_packaging.unpack_cmd(remote, **kwargs)
    local = f"{kwargs.get('dest', '~/.tpu_yarn_code')}/_fetched.zip"
    assert t_packaging._fetch_cmd(remote, local) == \
        j_packaging._fetch_cmd(remote, local)


@pytest.mark.parametrize("remote", ["s3weird://x/code.zip",
                                    "/has space/code.zip",
                                    "/quote'd/code.zip"])
def test_unpack_cmd_refusals_equal_jax(remote):
    with pytest.raises(ValueError) as port:
        t_packaging.unpack_cmd(remote)
    with pytest.raises(ValueError) as ref:
        j_packaging.unpack_cmd(remote)
    assert str(port.value) == str(ref.value).replace("run_on_tpu",
                                                     "run_on_gpu")


@pytest.mark.parametrize("house, target, python", [
    ("~/code/_wheels", "~/code/_pydeps", "python3"),
    ("/abs/w", "/abs/p", "/opt/py/bin/python"),
    ("/home/u/x/_wheels", "/home/u/x/_pydeps", sys.executable),
])
def test_pip_install_cmd_equals_jax(house, target, python):
    assert t_packaging._pip_install_cmd(house, target, python=python) == \
        j_packaging._pip_install_cmd(house, target, python=python)
    with pytest.raises(ValueError, match="shell-unsafe"):
        t_packaging._pip_install_cmd(house, target, python="py; rm -rf /")


def _project(tmp_path):
    src = tmp_path / "proj"
    (src / "pkg").mkdir(parents=True)
    (src / "a.py").write_text("print('a')")
    (src / "pkg" / "__init__.py").write_text("")
    (src / "pkg" / "data.bin").write_bytes(bytes(range(200)))
    (src / "__pycache__").mkdir()
    (src / "__pycache__" / "junk.pyc").write_text("x")
    return src


def test_zip_path_names_equal_jax(tmp_path):
    src = _project(tmp_path)
    for base in (True, False):
        port = t_packaging.zip_path(str(src), include_base_name=base)
        ref = j_packaging.zip_path(str(src), include_base_name=base)
        assert os.path.basename(port) == os.path.basename(ref)
        with zipfile.ZipFile(port) as a, zipfile.ZipFile(ref) as b:
            assert sorted(a.namelist()) == sorted(b.namelist())
    first = t_packaging.zip_path(str(src))
    (src / "a.py").write_text("print('changed')")
    assert t_packaging.zip_path(str(src)) != first


def test_package_zip_carries_the_cuda_sources_and_no_build(tmp_path):
    """The worker builds its kernels from the shipped ops/csrc: the zip of
    package_dir() holds every .cu and .cuh, and never build/, caches or a
    shared library (a copy of the package with those planted)."""
    package = Path(t_packaging.package_dir())
    assert package.name == "tf_yarn_tpu_torch"
    copy = tmp_path / "tf_yarn_tpu_torch"
    shutil.copytree(package, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (copy / "build" / "tf_yarn_tpu_torch").mkdir(parents=True)
    (copy / "build" / "tf_yarn_tpu_torch" / "lib.so").write_bytes(b"x")
    (copy / "ops" / "libtyt_kernels_0.so").write_bytes(b"x")
    (copy / "ops" / "__pycache__").mkdir()
    (copy / "ops" / "__pycache__" / "m.cpython-312.pyc").write_bytes(b"x")
    for root in (package, copy):
        with zipfile.ZipFile(t_packaging.zip_path(str(root))) as zf:
            names = zf.namelist()
        sources = sorted(p.name for p in (package / "ops" / "csrc").iterdir()
                         if p.suffix in (".cu", ".cuh"))
        assert sources and sorted(
            n.rsplit("/", 1)[1] for n in names
            if n.startswith("tf_yarn_tpu_torch/ops/csrc/")) == sources
        assert "tf_yarn_tpu_torch/client.py" in names
        assert not [n for n in names if "/build/" in n or "__pycache__" in n
                    or n.endswith((".so", ".pyc"))]
    # The file channel packs the same way (SshBackend._pack_files).
    from tf_yarn_tpu_torch.backends import SshBackend
    import tarfile

    tar = SshBackend._pack_files({"tf_yarn_tpu_torch": str(copy)})
    try:
        with tarfile.open(tar) as tf:
            members = tf.getnames()
    finally:
        os.unlink(tar)
    assert "tf_yarn_tpu_torch/ops/csrc/layernorm.cu" in members
    assert not [n for n in members if "build" in n.split("/")
                or n.endswith((".so", ".pyc"))]


def _fake_fetch(tmp_path, tool, script, remote, marker):
    """Stage a project zip in a local mirror, shim `tool` onto PATH, and run
    the port's unpack_cmd for `remote` under a bare shell; returns the
    marker module's printed VALUE."""
    src = tmp_path / "proj"
    src.mkdir()
    (src / f"{marker}.py").write_text("VALUE = 41 + 1")
    archive = t_packaging.zip_path(str(src), include_base_name=False)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    shutil.copyfile(archive, mirror / "code.zip")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / tool
    fake.write_text("#!/bin/sh\n" + script.format(mirror=mirror))
    fake.chmod(0o755)
    cmd = t_packaging.unpack_cmd(remote, dest=str(tmp_path / "code"))
    probe = (f"{cmd} && {sys.executable} -c "
             f"'import {marker}; print({marker}.VALUE)'")
    result = subprocess.run(
        ["/bin/sh", "-c", probe], capture_output=True, text=True, timeout=60,
        env={"PATH": f"{bindir}:{os.path.dirname(sys.executable)}"
                     ":/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert result.returncode == 0, result.stderr
    return result.stdout.strip()


def test_unpack_cmd_gs_fetch_executes_with_fake_gsutil(tmp_path):
    assert _fake_fetch(
        tmp_path, "gsutil",
        'src="$3"; dst="$4"\ncp "{mirror}/$(basename "$src")" "$dst"\n',
        "gs://bucket/code.zip", "gs_marker") == "42"


def test_unpack_cmd_hdfs_fetch_executes_with_fake_hdfs(tmp_path):
    assert _fake_fetch(
        tmp_path, "hdfs",
        '[ "$1" = dfs ] || exit 2\n[ "$2" = -get ] || exit 2\n'
        'src="$4"; dst="$5"\ncp "{mirror}/$(basename "$src")" "$dst"\n',
        "hdfs://nn:8020/code.zip", "hdfs_marker") == "42"


def test_build_wheelhouse_from_wheels_dir_equals_jax(tmp_path):
    dl = tmp_path / "dl"
    make_wheel(str(dl))
    make_wheel(str(dl), name="otherpkg", version="2.0")
    (dl / "srconly-0.1.tar.gz").write_bytes(b"not a real sdist")
    for requirements in (["deppkg"], None):
        port = t_packaging.build_wheelhouse(requirements=requirements,
                                            wheels_dir=str(dl))
        ref = j_packaging.build_wheelhouse(requirements=requirements,
                                           wheels_dir=str(dl))
        assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
        manifest = t_packaging.WHEELHOUSE_MANIFEST
        assert Path(port, manifest).read_text() == \
            Path(ref, manifest).read_text()
        # Memoized: the same inputs give the same house.
        assert t_packaging.build_wheelhouse(
            requirements=requirements, wheels_dir=str(dl)) == port
    assert Path(port, manifest).read_text().split() == [
        "deppkg", "otherpkg", "srconly"]
    with pytest.raises(ValueError, match="list"):
        t_packaging.build_wheelhouse(requirements="numpy==1.26")
    with pytest.raises(ValueError, match="wheels_dir"):
        t_packaging.build_wheelhouse()


def test_ship_files_and_ship_env(tmp_path):
    dl = tmp_path / "dl"
    make_wheel(str(dl))
    entries = t_packaging.ship_files(requirements=["deppkg"],
                                     wheels_dir=str(dl))
    assert entries["tf_yarn_tpu_torch"] == t_packaging.package_dir()
    assert "_shipped_wheels/deppkg-1.0-py3-none-any.whl" in entries
    assert f"_shipped_wheels/{t_packaging.WHEELHOUSE_MANIFEST}" in entries
    staging = tmp_path / "staging"
    hook = t_packaging.ship_env(str(staging), requirements=["deppkg"],
                                wheels_dir=str(dl), python=sys.executable)
    zips = sorted(p.name for p in staging.iterdir())
    assert len(zips) == 2 and any(z.startswith("tf_yarn_tpu_torch-")
                                  for z in zips)
    parts = hook.split(" && ")
    assert parts[-1].startswith("export PYTHONPATH=") and \
        "/_pydeps:" in parts[-1]
    assert f"{sys.executable} -m pip install -q --no-index" in hook
    # Re-shipping the same code reuses the same archive names.
    assert t_packaging.ship_env(str(staging), requirements=["deppkg"],
                                wheels_dir=str(dl),
                                python=sys.executable) == hook
    assert sorted(p.name for p in staging.iterdir()) == zips


def test_upload_env_returns_a_uri_the_worker_can_fetch(tmp_path):
    """On a URI staging dir the port returns the archive's URI, which
    unpack_cmd turns into the scheme's fetch (the JAX package returns the
    path within the filesystem)."""
    from pyarrow import fs as pafs

    archive = t_packaging.zip_path(str(_project(tmp_path)))
    bucket = tmp_path / "bucket"
    bucket.mkdir()
    t_fs.register_scheme("gs", lambda uri: (
        pafs.SubTreeFileSystem(str(bucket), pafs.LocalFileSystem()),
        uri[len("gs://"):]))
    try:
        remote = t_packaging.upload_env(archive, "gs://b/stage")
    finally:
        t_fs.unregister_scheme("gs")
    name = os.path.basename(archive)
    assert remote == f"gs://b/stage/{name}"
    assert (bucket / "b" / "stage" / name).is_file()
    assert "gsutil -q cp gs://b/stage/" in t_packaging.unpack_cmd(remote)
    local = t_packaging.upload_env(archive, str(tmp_path / "nfs"))
    assert local == str(tmp_path / "nfs" / name) and os.path.isfile(local)
    assert t_packaging.upload_dir(str(tmp_path / "nfs"),
                                  str(tmp_path / "copy")) == 1


_RACER = textwrap.dedent(r"""
    import ctypes, json, os, sys
    from pathlib import Path
    from tf_yarn_tpu_torch.ops import _build

    stub, build_dir, go = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    _build.BUILD_DIR = build_dir
    _build._nvcc = lambda: stub
    loaded = []

    class FakeLibrary:
        def __init__(self, path):
            data = Path(path).read_bytes()
            loaded.append((path, len(data), data.endswith(b"END")))

        def __getattr__(self, name):
            return type("Fn", (), {})()

    ctypes.CDLL = FakeLibrary
    while not go.exists():
        pass
    _build.load_library()
    print(json.dumps({"loaded": loaded, "built": _build.build_seconds
                      is not None}))
""")

_STUB_NVCC = textwrap.dedent(r"""
    #!/bin/sh
    # Stands for nvcc: "-c src -o obj" writes an object; "-shared -o lib
    # objs" writes the library slowly, so a racing reader would see it
    # half written, and logs each link.
    out=""; shared=0; prev=""
    for arg in "$@"; do
        [ "$prev" = "-o" ] && out="$arg"
        [ "$arg" = "-shared" ] && shared=1
        prev="$arg"
    done
    if [ "$shared" = 1 ]; then
        echo link >> "$LINK_LOG"
        printf 'HALF' > "$out"; sleep 0.5; printf -- '-END' >> "$out"
    else
        echo obj > "$out"
    fi
""").lstrip()


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes that share a build directory race `load_library`
    (nvcc stubbed): one builds and links, the other waits on the lock and
    loads the finished library — both load it whole, there is one link,
    and no object or temporary is left."""
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB_NVCC)
    stub.chmod(0o755)
    build_dir, go, log = tmp_path / "build", tmp_path / "go", tmp_path / "links"
    env = dict(os.environ, PYTHONPATH=str(REPO), LINK_LOG=str(log))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACER, str(stub), str(build_dir), str(go)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    import json
    import time

    time.sleep(3)  # both processes imported and spinning on `go`
    go.write_text("")
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert log.read_text().split() == ["link"]
    assert sorted(r["built"] for r in results) == [False, True]
    paths = {r["loaded"][0][0] for r in results}
    assert len(paths) == 1
    assert all(r["loaded"][0][1:] == [len("HALF-END"), True]
               for r in results)
    left = sorted(p.name for p in build_dir.iterdir())
    assert [n for n in left if n.endswith((".o", ".tmp"))] == []
    assert Path(paths.pop()).name in left
