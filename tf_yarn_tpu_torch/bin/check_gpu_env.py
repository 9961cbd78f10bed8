"""`check_gpu_env` — the port's environment diagnostic, the counterpart
of tf_yarn_tpu/bin/check_tpu_env.py.

    python -m tf_yarn_tpu_torch.bin.check_gpu_env [--skip-run]

Checks, each printing one ``OK`` or ``FAIL`` line: torch and the card
(on the card it builds or finds the kernel library and launches the
fused RMSNorm kernel against its plain version; ``TPU_YARN_PLATFORM=cpu``
asks for the CPU instead), the coordination service's round trip, the
shipping of the port's code and of a wheel to a bare interpreter, and a
one-task local run through `client.run_on_gpu`. Exits 0 when every
check passed, else 1.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile

_logger = logging.getLogger(__name__)

# The fused RMSNorm launch of the device check: Llama-3-8B's width.
PROBE_ROWS, PROBE_D = 64, 4096
PROBE_TOL = 2e-2  # bf16 output, one rounding of a value of order 4


def check_torch() -> bool:
    """torch's and CUDA's versions and the devices. ``TPU_YARN_PLATFORM``
    ``cpu`` makes it a check of the CPU; otherwise the card must be there
    (no fallback), the kernel library builds or loads, and one RMSNorm
    kernel launch matches its plain version."""
    try:
        import torch

        from tf_yarn_tpu_torch import _device

        platform = os.environ.get(_device.ENV_PLATFORM, "").strip().lower()
        versions = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
        if platform == "cpu":
            print(f"OK   {versions}, device=cpu ({_device.ENV_PLATFORM}=cpu)")
            return True
        device = _device.task_device()
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        from tf_yarn_tpu_torch.ops import _build, rmsnorm

        started = time.perf_counter()
        library = _build.build()  # builds unless these sources are built
        _build.load_library()
        load_s = time.perf_counter() - started
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(PROBE_ROWS, PROBE_D, device=device, generator=gen,
                        dtype=torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(PROBE_D, device=device, generator=gen)
        before = rmsnorm.rmsnorm.launches
        got = rmsnorm.rmsnorm(x, scale)
        launched = rmsnorm.rmsnorm.launches - before
        want = rmsnorm.rmsnorm_reference(x, scale)
        err = float((got.float() - want.float()).abs().max())
        if launched != 1 or not err <= PROBE_TOL:
            raise RuntimeError(f"rmsnorm kernel: {launched} launches, max abs "
                               f"err {err} against its plain version")
        built = "built" if _build.build_seconds is not None else "found"
        print(f"OK   {versions}, devices={names}; kernel library "
              f"{library.name} {built} and loaded in "
              f"{load_s:.1f} s; rmsnorm kernel launched {launched}x on "
              f"[{PROBE_ROWS}, {PROBE_D}] bf16, max abs err {err:.3g}")
        return True
    except Exception as exc:
        print(f"FAIL torch devices unavailable: {exc}")
        return False


def check_coordination() -> bool:
    from tf_yarn_tpu_torch.coordination import KVClient
    from tf_yarn_tpu_torch.coordination.server_factory import start_best_server

    try:
        server = start_best_server()
        try:
            client = KVClient(server.endpoint)
            client.put("probe", b"ok")
            if client.wait("probe", timeout=5.0) != b"ok":
                raise RuntimeError("the probe key read back wrong")
            print(f"OK   coordination service round-trip ({client.ping()} "
                  f"server at {server.endpoint})")
            return True
        finally:
            server.stop()
    except Exception as exc:
        print(f"FAIL coordination service: {exc}")
        return False


def check_env_shipping() -> bool:
    """Zip the installed port, stage it, and run the unpack hook in a bare
    shell with no PYTHONPATH and a temporary cwd: the import must come
    from the unpacked copy."""
    from tf_yarn_tpu_torch import packaging

    try:
        with tempfile.TemporaryDirectory(prefix="check-env-ship-") as tmp:
            staging = os.path.join(tmp, "staging")
            hook = packaging.ship_env(staging, dest=os.path.join(tmp, "code"))
            probe = (
                f"{hook} && {sys.executable} -c "
                "'import tf_yarn_tpu_torch; print(tf_yarn_tpu_torch.__file__)'"
            )
            result = subprocess.run(
                ["/bin/sh", "-c", probe],
                capture_output=True, text=True, timeout=120,
                env={k: v for k, v in os.environ.items()
                     if k != "PYTHONPATH"},
                cwd=tmp,
            )
            imported = result.stdout.strip()
            if result.returncode != 0:
                raise RuntimeError(result.stderr.strip()[-300:])
            if not imported.startswith(tmp):
                raise RuntimeError(f"imported {imported}, not the shipped copy")
        print("OK   env shipping (zip -> stage -> unpack_cmd -> import "
              "from shipped copy)")
        return True
    except Exception as exc:
        print(f"FAIL env shipping: {exc}")
        return False


def check_wheel_shipping() -> bool:
    """Hand-build a wheel, resolve it through `build_wheelhouse` (the
    ``wheels_dir`` path: no network) and ``pip install --no-index
    --target`` it as a worker does; the import must come from there."""
    from tf_yarn_tpu_torch import packaging

    try:
        with tempfile.TemporaryDirectory(prefix="check-wheel-ship-") as tmp:
            name, version = "gpuyarnprobe", "0.0"
            info = f"{name}-{version}.dist-info"
            dl = os.path.join(tmp, "dl")
            os.makedirs(dl)
            with zipfile.ZipFile(
                os.path.join(dl, f"{name}-{version}-py3-none-any.whl"), "w"
            ) as zf:
                zf.writestr(f"{name}.py", "PROBE = 'ok'\n")
                zf.writestr(f"{info}/METADATA",
                            f"Metadata-Version: 2.1\nName: {name}\n"
                            f"Version: {version}\n")
                zf.writestr(f"{info}/WHEEL",
                            "Wheel-Version: 1.0\nGenerator: doctor\n"
                            "Root-Is-Purelib: true\nTag: py3-none-any\n")
                zf.writestr(f"{info}/RECORD", "")
            house = packaging.build_wheelhouse(
                requirements=[name], wheels_dir=dl)
            try:
                target = os.path.join(tmp, "pydeps")
                install = subprocess.run(
                    [sys.executable, "-m", "pip", "install", "-q",
                     "--no-index", "--find-links", house, "--target", target,
                     "-r", os.path.join(house, packaging.WHEELHOUSE_MANIFEST)],
                    capture_output=True, text=True, timeout=120,
                )
                if install.returncode != 0:
                    raise RuntimeError(
                        f"pip install failed: {install.stderr.strip()[-300:]}")
                result = subprocess.run(
                    [sys.executable, "-c",
                     f"import {name}; print({name}.PROBE)"],
                    capture_output=True, text=True, timeout=60,
                    env={**os.environ, "PYTHONPATH": target},
                )
                if result.returncode != 0 or result.stdout.strip() != "ok":
                    raise RuntimeError(
                        f"import: {result.stdout!r} {result.stderr[-300:]}")
            finally:
                # build_wheelhouse memoizes its house for drivers; a
                # short-lived check must not leave it behind.
                shutil.rmtree(os.path.dirname(house), ignore_errors=True)
        print("OK   wheel shipping (wheelhouse -> pip install --no-index "
              "-> import)")
        return True
    except Exception as exc:
        print(f"FAIL wheel shipping: {exc}")
        return False


def _write_rank(probe_path: str):
    """The local run's fn of `TaskParameters`, sent by name."""
    def run(params):
        with open(probe_path, "w") as fh:
            fh.write(f"rank={params.rank}")

    return run


def check_local_run() -> bool:
    """One task through the whole driver path: `run_on_gpu`, the
    coordination service, the task program, back."""
    from tf_yarn_tpu_torch.client import get_safe_experiment_fn, run_on_gpu
    from tf_yarn_tpu_torch.topologies import TaskSpec

    fd, probe_path = tempfile.mkstemp(prefix="check-gpu-env-")
    os.close(fd)
    try:
        run_on_gpu(
            get_safe_experiment_fn(
                "tf_yarn_tpu_torch.bin.check_gpu_env._write_rank", probe_path),
            {"worker": TaskSpec(instances=1)},
            custom_task_module="tf_yarn_tpu_torch.tasks.distributed",
            name="check_gpu_env",
            poll_every_secs=0.2,
        )
        with open(probe_path) as fh:
            written = fh.read()
        if written != "rank=0":
            raise RuntimeError(f"the task wrote {written!r}")
        print("OK   end-to-end local run (driver -> coordination -> task)")
        return True
    except Exception as exc:
        print(f"FAIL end-to-end local run: {exc}")
        return False
    finally:
        try:
            os.unlink(probe_path)
        except OSError:
            pass


CHECKS = (check_torch, check_coordination, check_env_shipping,
          check_wheel_shipping)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--skip-run", action="store_true", help="skip the end-to-end launch probe"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    checks = CHECKS + (() if args.skip_run else (check_local_run,))
    ok = True
    for check in checks:
        started = time.perf_counter()
        ok &= check()
        print(f"     {check.__name__}: {time.perf_counter() - started:.2f} s")
    print("all checks passed" if ok else "some checks FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
