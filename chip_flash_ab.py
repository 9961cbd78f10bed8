"""Time a bf16 flash-attention kernel of several copies of the port, in
turns, on one card.

    python3 chip_flash_ab.py [--pass fwd|dkv] ROOT [ROOT ...]

Each ROOT is a directory holding a `tf_yarn_tpu_torch` package (the
checkout itself, or an older commit unpacked with `git archive` into a
directory that .gitignore lists). The roots are timed in the order
given, each in a process of its own that builds that copy's kernels:
pass parent, change, change, parent to compare two versions on one
card. `--pass` picks the kernel: `fwd` (the default) the forward
`flash_fwd`, `dkv` the backward's `flash_dkv`. The shape is the training
slice's (B 1, S 2048, H 32, Hkv 8, D 128, causal, bf16, the seed of
`chip_smoke.check_flash`); the timing is `chip_smoke.time_ms` over
CUDA-graph replays, cold (inputs cycling through copies that exceed
twice the L2) and warm. One JSON line per root: its label, both times in
microseconds, the outputs' errors against the plain versions (for dkv
also whether two calls gave bitwise-equal dk and dv) and the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py of this checkout, whatever the root being timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def time_one(root: Path, kernel: str) -> dict:
    import torch

    smoke = _smoke()
    sys.path.insert(0, str(root))
    from tf_yarn_tpu_torch.ops import _build
    from tf_yarn_tpu_torch.ops import flash_attention as flash

    if not Path(flash.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {flash.__file__}, not from {root}")
    _build.load_library()
    b, s, h, hkv, d = (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, smoke.TRAIN_HEADS,
                       smoke.TRAIN_KV_HEADS, smoke.TRAIN_HEAD_DIM)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 9)
    mk = lambda *shape: torch.randn(*shape, device="cuda",
                                    generator=gen).to(torch.bfloat16)
    q, k, v, dout = mk(b, s, h, d), mk(b, s, hkv, d), mk(b, s, hkv, d), mk(b, s, h, d)
    qb, kvb, stat = q.numel() * 2, k.numel() * 2, b * h * s * 4
    ref_out, ref_lse = flash.flash_fwd_reference(q, k, v)
    if kernel == "fwd":
        out, lse = flash.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        fn = lambda q, k, v: flash.flash_fwd(q, k, v)
        args = (q, k, v)
        touched = 2 * qb + 2 * kvb
        found = {"o_rel_err": _rel(out, ref_out),
                 "lse_max_abs_err": float((lse - ref_lse).abs().max())}
    else:
        delta = flash.flash_delta(ref_out, dout)
        args = (q, k, v, dout, ref_lse, delta)
        dk, dv = flash.flash_dkv(*args)
        dk2, dv2 = flash.flash_dkv(*args)
        ref_dk, ref_dv = flash.flash_dkv_reference(*args)
        torch.cuda.synchronize()
        fn = flash.flash_dkv
        touched = 2 * qb + 4 * kvb + 2 * stat
        found = {"dk_rel_err": _rel(dk, ref_dk), "dv_rel_err": _rel(dv, ref_dv),
                 "bitwise_equal": bool(torch.equal(dk, dk2)
                                       and torch.equal(dv, dv2))}
    cold = smoke.cold_copies(args, touched)
    return {
        "pass": kernel,
        "cold_us": smoke.time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
        "warm_us": smoke.time_ms(fn, torch, arg_sets=(args,)) * 1e3,
        **found,
        "card": smoke.nvidia_smi(),
    }


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        import torch

        if not torch.cuda.is_available():
            print("chip_flash_ab: no CUDA device available", file=sys.stderr)
            return 2
        print(json.dumps(time_one(Path(argv[2]).resolve(), argv[1])), flush=True)
        return 0
    kernel = "fwd"
    if argv[:1] == ["--pass"]:
        kernel, argv = (argv[1] if len(argv) > 1 else ""), argv[2:]
    if kernel not in ("fwd", "dkv") or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    status = 0
    for label in argv:
        done = subprocess.run([sys.executable, __file__, "--one", kernel, label],
                              capture_output=True, text=True, cwd=os.getcwd())
        lines = done.stdout.strip().splitlines()
        if done.returncode or not lines:
            print(done.stderr[-2000:], file=sys.stderr)
            status = done.returncode or 1
            continue
        print(json.dumps({"root": label, **json.loads(lines[-1])}), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
