"""Build and load the port's CUDA kernels (route: nvcc + ctypes).

At first use, `load_library` compiles every `csrc/*.cu` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`, `-O3`, no `--use_fast_math`:
the int8 quantize kernel's bit parity needs IEEE division) into one
shared library with a plain C interface, and loads it with ctypes. The
sources compile in parallel, one nvcc process each, then link. The
library lands in ``build/tf_yarn_tpu_torch/`` beside the package
(listed in .gitignore), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads straight away. A worker
that runs shipped code builds into ``build/`` beside its unpacked copy.

Processes that share a build directory (two ranks of one host, or two
tasks over one unpacked copy) build one at a time: the builder holds an
exclusive `flock` on ``<library>.lock`` (released by the kernel if the
process dies), objects and the linked library carry the builder's pid,
and the library is renamed into place whole, so a waiting process finds
it complete and loads it without building again.

Every C entry point launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()`; `check` raises when it is not
0. Nothing here runs at import: the CPU tests import every module of
the package on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tf_yarn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# torch dtype -> the `tyt::DType` code the kernels switch on (common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tyt_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    "tyt_rmsnorm_bwd_dx": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tyt_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tyt_layernorm_bwd_dx": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tyt_layernorm_bwd": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    "tyt_groupnorm": [_P] * 6 + [_I] * 10 + [_F, _I, _P],
    "tyt_groupnorm_bwd": [_P] * 8 + [_I] * 11 + [_P],
    "tyt_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "tyt_flash_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "tyt_flash_dkv": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
    "tyt_quantize_int8": [_P, _P, _P, _I, _I, _I, _P],
    "tyt_paged_window_attention": [_P] * 11 + [_I] * 10 + [_F, _I, _P],
    "tyt_dense_decode_attention": [_P] * 10 + [_I] * 6 + [_F, _I, _P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
# nvcc's output of the last build (ptxas register / spill report) and
# its wall time, for chip_smoke.py to print.
build_log: str = ""
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use "
        "on the machine with the card"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libtyt_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(commands: List[List[str]]) -> str:
    """Run the commands in parallel; raise with nvcc's output if any
    fails. Returns their combined output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in commands
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}"
            )
    return "".join(outputs)


def build() -> Path:
    """Compile the kernels into the shared library unless a build of the
    same sources and flags exists. Returns the library path."""
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib_path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _build_locked(lib_path)
    return lib_path


def _build_locked(lib_path: Path) -> None:
    """Compile and link the library to `lib_path`, under the build lock."""
    global build_log, build_seconds
    nvcc = _nvcc()
    started = time.perf_counter()
    objects = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in _sources()]
    log = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(_sources(), objects)
    ])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *map(str, objects)]])
    os.replace(tmp, lib_path)
    for obj in objects:
        obj.unlink()
    build_log = log
    build_seconds = time.perf_counter() - started


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def check(status: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {status}")


def stream_handle(device: torch.device) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, tensor: torch.Tensor, dtypes) -> None:
    """The wrapper-side checks every kernel argument passes: on CUDA, of
    an accepted dtype, contiguous."""
    if not tensor.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if tensor.dtype not in dtypes:
        raise ValueError(
            f"{name} must have dtype in {sorted(map(str, dtypes))}, "
            f"got {tensor.dtype}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
