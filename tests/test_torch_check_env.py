"""The port's `check_gpu_env` diagnoses: the counterparts of
tests/test_check_env.py's four checks, the wheel check, the device check
failing with a FAIL line when there is no card and no CPU override, and
the console script's exit codes. The port has no native coordination
server, so nothing here sets ``TPU_YARN_COORDD``."""

import os
import subprocess
import sys
from pathlib import Path

from tf_yarn_tpu_torch.bin import check_gpu_env

REPO = Path(__file__).resolve().parents[1]


def test_check_torch_honors_platform_override(monkeypatch, capsys):
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert check_gpu_env.check_torch()
    out = capsys.readouterr().out
    assert out.startswith("OK   torch ") and "device=cpu" in out


def test_check_torch_fails_without_a_card_or_override(monkeypatch, capsys):
    import torch

    monkeypatch.delenv("TPU_YARN_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not check_gpu_env.check_torch()
    out = capsys.readouterr().out
    assert out.startswith("FAIL torch devices unavailable")
    assert "no CUDA device is available" in out


def test_check_coordination_round_trip(capsys):
    assert check_gpu_env.check_coordination()
    assert capsys.readouterr().out.startswith("OK   coordination")


def test_check_env_shipping_round_trip(capsys):
    assert check_gpu_env.check_env_shipping()
    assert "import from shipped copy" in capsys.readouterr().out


def test_check_wheel_shipping_round_trip(capsys):
    assert check_gpu_env.check_wheel_shipping()
    assert capsys.readouterr().out.startswith("OK   wheel shipping")


def test_check_local_run_end_to_end(monkeypatch, capsys):
    monkeypatch.setenv("TPU_YARN_PLATFORM", "cpu")
    assert check_gpu_env.check_local_run()
    assert capsys.readouterr().out.startswith("OK   end-to-end local run")


def _script(*args, platform=None):
    env = {k: v for k, v in os.environ.items() if k != "TPU_YARN_PLATFORM"}
    env["PYTHONPATH"] = str(REPO)
    if platform:
        env["TPU_YARN_PLATFORM"] = platform
    return subprocess.run(
        [sys.executable, "-m", "tf_yarn_tpu_torch.bin.check_gpu_env", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_console_script_exit_codes():
    """With the CPU asked for every check passes (exit 0); with no card
    and no override the device check fails (exit 1) and the others still
    run. This machine has no card."""
    ok = _script("--skip-run", platform="cpu")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    lines = [line for line in ok.stdout.splitlines()
             if line.startswith(("OK", "FAIL"))]
    assert len(lines) == 4 and all(line.startswith("OK") for line in lines)
    assert ok.stdout.rstrip().endswith("all checks passed")
    assert "check_torch:" in ok.stdout  # each check's seconds
    bad = _script("--skip-run")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "FAIL torch devices unavailable" in bad.stdout
    assert bad.stdout.count("OK   ") == 3
    assert bad.stdout.rstrip().endswith("some checks FAILED")
