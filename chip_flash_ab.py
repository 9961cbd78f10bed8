"""Time one kernel of several copies of the port, in turns, on one card.

    python3 chip_flash_ab.py [--pass PASS] ROOT [ROOT ...]

Each ROOT is a directory holding a `tf_yarn_tpu_torch` package (the
checkout itself, or an older commit unpacked with `git archive` into a
directory that .gitignore lists). The roots are timed in the order
given, each in a process of its own that builds that copy's kernels:
pass parent, change, change, parent to compare two versions on one
card. `--pass` picks the kernel:
- `fwd` (the default): the bf16 flash forward `flash_fwd`, `dq` and
  `dkv` the backward's `flash_dq` and `flash_dkv`, at the training
  slice's shape (B 1, S 2048, H 32, Hkv 8, D 128, causal, bf16, the seed
  of `chip_smoke.check_flash`);
- `gn_fwd`: the GroupNorm forward `groupnorm_forward` at ResNet-50's 12
  slab shapes (`chip_smoke.RESNET50_GN`: batch 128, 32 groups, bf16),
  each shape's time and the launch-weighted sum of its 53 calls a step;
- `gn_bwd`: the GroupNorm backward as autograd runs it
  (`_GroupNorm.backward`: dx, dscale and dbias, all three wanted) at the
  same 12 shapes, from the forward's statistics, so that a package whose
  backward is a dx kernel beside plain dscale/dbias sums and one whose
  kernels give all three are timed alike;
- `ln_fwd`: the LayerNorm forward (`layernorm`'s kernel, one launch a
  call) at BERT-base's and ViT-B/16's rows (`chip_smoke.LN_SHAPES`,
  bf16), beside `F.layer_norm` and the floor of one launch under graph
  replay (a one-element fill), with each call's CUDA launches by name;
- `ln_dx`: the LayerNorm dx `layernorm_bwd_dx` at the same rows;
- `ln_bwd`: the LayerNorm backward as autograd runs it
  (`_LayerNorm.backward`: dx, dscale and dbias, all three wanted) at the
  same rows, so that a package whose backward is a dx kernel beside
  plain dscale/dbias sums and one whose kernels give all three are
  timed alike; beside it `F.layer_norm`'s autograd backward for x,
  weight and bias;
- `decode`: the int8 decode attention, paged
  (`paged_int8_window_attention`) and dense (`int8_decode_attention`),
  at the smoke's phase-3 shape (8 slots, lengths 1-4096 from the seed)
  and at the serving slice's (`chip_smoke.SERVING_LENGTHS`), with each
  CUDA kernel's device time a call from the profiler;
- `rmsnorm`: the RMSNorm forward `rmsnorm` at its main-path rows of d
  4096 (`chip_smoke.RMSNORM_ROWS`: a decode tick's, phase 3's and the
  training slice's, bf16);
- `quantize`: the int8 quantize at its main-path rows of 128
  (`chip_smoke.QUANTIZE_ROWS`: a decode tick's and phase 3's), from f32
  and from bf16 as that root's serving path runs it (a cast to f32
  first where its `quantize_int8` takes f32 only), beside the floor of
  one launch under graph replay (a one-element fill).
Both also give each call's CUDA launches by name.
The timing is `chip_smoke.time_ms` over CUDA-graph replays, cold (inputs
cycling through copies that exceed twice the L2) and warm. One JSON line
per root: its label, the times in microseconds, the outputs' errors
against the plain versions (for dq, dkv, gn_fwd, gn_bwd, ln_fwd,
ln_bwd, decode, rmsnorm and quantize also whether two calls gave
bitwise-equal outputs) and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

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


def _time_flash(torch, smoke, kernel: str) -> dict:
    from tf_yarn_tpu_torch.ops import flash_attention as flash

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
    elif kernel == "dq":
        delta = flash.flash_delta(ref_out, dout)
        args = (q, k, v, dout, ref_lse, delta)
        dq, dq2 = flash.flash_dq(*args), flash.flash_dq(*args)
        ref_dq = flash.flash_dq_reference(*args)
        torch.cuda.synchronize()
        fn = flash.flash_dq
        touched = 3 * qb + 2 * kvb + 2 * stat
        found = {"dq_rel_err": _rel(dq, ref_dq),
                 "bitwise_equal": bool(torch.equal(dq, dq2))}
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
        "cold_us": smoke.time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
        "warm_us": smoke.time_ms(fn, torch, arg_sets=(args,)) * 1e3,
        **found,
    }


def _time_gn_fwd(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import groupnorm as gn

    groups, shapes, bitwise = smoke.GN_GROUPS, {}, True
    step = {"cold_us": 0.0, "warm_us": 0.0, "bound_us": 0.0}
    for (side, c), calls in smoke.RESNET50_GN.items():
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + c + side)
        x = (torch.randn(smoke.GN_BATCH, side, side, c, device="cuda",
                         generator=gen) * 2 + 0.5).to(torch.bfloat16)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        y, stats = gn.groupnorm_forward(x, scale, bias, groups, 1e-6)
        y2, stats2 = gn.groupnorm_forward(x, scale, bias, groups, 1e-6)
        ref_y = gn.groupnorm_reference(x, scale, bias, groups, 1e-6)
        ref_stats = gn.groupnorm_stats_reference(x, groups, 1e-6)
        torch.cuda.synchronize()
        bitwise &= bool(torch.equal(y, y2) and torch.equal(stats, stats2))
        args = (x, scale, bias)
        fn = lambda x, s, b: gn.groupnorm_forward(x, s, b, groups, 1e-6)
        touched = 2 * x.numel() * 2
        cold = smoke.cold_copies(args, touched)
        row = {
            "calls": calls,
            "cold_us": smoke.time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
            "warm_us": smoke.time_ms(fn, torch, arg_sets=(args,)) * 1e3,
            "bound_us": smoke.bound_ms(touched + 2 * c * 4
                                       + smoke.GN_BATCH * groups * 8,
                                       8 * x.numel())[0] * 1e3,
            "y_max_abs_err": float((y.float() - ref_y.float()).abs().max()),
            "stats_max_abs_err": float((stats - ref_stats).abs().max()),
        }
        shapes[f"{side}x{side}x{c}"] = row
        for key in step:
            step[key] += calls * row[key]
        del x, y, y2, ref_y, cold
    return {"shapes": shapes, "resnet50_step": step, "bitwise_equal": bitwise}


def _plain_gn_bwd(torch, x, g, scale, stats, groups):
    """dx, dscale and dbias in f32 from the forward's statistics, written
    out here so that every root is held against the same arithmetic."""
    b, c = x.shape[0], x.shape[-1]
    grouped = lambda t: t.float().reshape(b, -1, groups, c // groups)
    mean = stats[..., 0].reshape(b, 1, groups, 1)
    inv = stats[..., 1].reshape(b, 1, groups, 1)
    norm = (grouped(x) - mean) * inv
    gs = grouped(g) * grouped(scale.expand_as(g))
    dx = inv * (gs - gs.mean(dim=(1, 3), keepdim=True)
                - norm * (gs * norm).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape), (grouped(g) * norm).reshape(-1, c).sum(0),
            g.float().reshape(-1, c).sum(0))


def _time_gn_bwd(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import groupnorm as gn

    groups, shapes, bitwise = smoke.GN_GROUPS, {}, True
    step = {"cold_us": 0.0, "warm_us": 0.0, "bound_us": 0.0}

    def backward(x, g, scale, stats):
        ctx = SimpleNamespace(saved_tensors=(x, scale, stats), groups=groups,
                              bias_dtype=torch.float32,
                              needs_input_grad=(True, True, True, False,
                                                False))
        return gn._GroupNorm.backward(ctx, g)[:3]

    for (side, c), calls in smoke.RESNET50_GN.items():
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + c + side)
        x = (torch.randn(smoke.GN_BATCH, side, side, c, device="cuda",
                         generator=gen) * 2 + 0.5).to(torch.bfloat16)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        g = torch.randn(x.shape, device="cuda", generator=gen).to(torch.bfloat16)
        _, stats = gn.groupnorm_forward(x, scale, bias, groups, 1e-6)
        args = (x, g, scale, stats)
        first, second = backward(*args), backward(*args)
        ref = _plain_gn_bwd(torch, *args, groups)
        torch.cuda.synchronize()
        bitwise &= all(bool(torch.equal(a, b)) for a, b in zip(first, second))
        touched = 3 * x.numel() * 2
        cold = smoke.cold_copies(args, touched)
        row = {
            "calls": calls,
            "cold_us": smoke.time_ms(backward, torch, inner=2,
                                     arg_sets=cold) * 1e3,
            "warm_us": smoke.time_ms(backward, torch, arg_sets=(args,)) * 1e3,
            "bound_us": smoke.bound_ms(touched + 3 * c * 4
                                       + smoke.GN_BATCH * groups * 8,
                                       18 * x.numel())[0] * 1e3,
            **{f"{name}_max_abs_err": float((a.float() - b).abs().max())
               for name, a, b in zip(("dx", "dscale", "dbias"), first, ref)},
        }
        shapes[f"{side}x{side}x{c}"] = row
        for key in step:
            step[key] += calls * row[key]
        del x, g, first, second, ref, cold
    return {"shapes": shapes, "resnet50_step": step, "bitwise_equal": bitwise}


def _time_ln_dx(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import layernorm as ln

    shapes = {}
    for key, (rows, d, eps) in smoke.LN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + rows)
        x = (torch.randn(rows, d, device="cuda", generator=gen) * 3 + 1).to(
            torch.bfloat16)
        g = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
        scale = torch.rand(d, device="cuda", generator=gen) + 0.5
        dx = ln.layernorm_bwd_dx(x, g, scale, eps)
        ref_dx = ln.layernorm_bwd_dx_reference(x, g, scale, eps)
        torch.cuda.synchronize()
        args = (x, g, scale)
        fn = lambda x, g, s, eps=eps: ln.layernorm_bwd_dx(x, g, s, eps)
        touched = 3 * x.numel() * 2 + d * 4
        cold = smoke.cold_copies(args, touched)
        shapes[key] = {
            "cold_us": smoke.time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
            "warm_us": smoke.time_ms(fn, torch, arg_sets=(args,)) * 1e3,
            "bound_us": smoke.bound_ms(touched, 14 * x.numel())[0] * 1e3,
            "dx_max_abs_err": float((dx.float() - ref_dx.float()).abs().max()),
        }
    return {"shapes": shapes}


def _time_ln_fwd(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import layernorm as ln

    shapes, bitwise = {}, True
    for key, (rows, d, eps) in smoke.LN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + rows)
        x = (torch.randn(rows, d, device="cuda", generator=gen) * 3 + 1).to(
            torch.bfloat16)
        scale = torch.rand(d, device="cuda", generator=gen) + 0.5
        bias = torch.randn(d, device="cuda", generator=gen)
        fn = lambda x, s, b, eps=eps: ln._forward(x, s, b, eps)
        args = (x, scale, bias)
        first, second = fn(*args), fn(*args)
        ref = ln.layernorm_reference(x, scale, bias, eps)
        torch.cuda.synchronize()
        bitwise &= bool(torch.equal(first, second))
        weight, wbias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        library = lambda x, s, b, d=d, eps=eps: torch.nn.functional.layer_norm(
            x, (d,), weight, wbias, eps)
        # x read and y written, scale and bias read once.
        touched = 2 * x.numel() * 2 + 2 * d * 4
        cold = smoke.cold_copies(args, touched)
        shapes[key] = {
            **smoke.shape_times(torch, fn, args, touched, 8 * x.numel()),
            "library_us": smoke.time_ms(library, torch, inner=2,
                                        arg_sets=cold) * 1e3,
            "launches_per_call": smoke.kernel_launch_counts(
                torch, lambda: fn(*args)),
            "max_abs_err": float((first.float() - ref.float()).abs().max()),
        }
        del cold
    one = torch.zeros(1, device="cuda")
    floor = smoke.time_ms(lambda t: t.fill_(1.0), torch, arg_sets=((one,),))
    return {"shapes": shapes, "bitwise_equal": bitwise,
            "one_launch_floor_us": floor * 1e3}


def _plain_ln_bwd(torch, x, g, scale, eps):
    """dx, dscale and dbias in f32, written out here so that every root is
    held against the same arithmetic."""
    x32, g32 = x.float(), g.float()
    centered = x32 - x32.mean(-1, keepdim=True)
    r = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + eps)
    norm, gs = centered * r, g32 * scale
    dx = r * (gs - gs.mean(-1, keepdim=True)
              - norm * (gs * norm).mean(-1, keepdim=True))
    return dx, (g32 * norm).sum(0), g32.sum(0)


def _time_ln_bwd(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import layernorm as ln

    shapes, bitwise = {}, True
    for key, (rows, d, eps) in smoke.LN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + rows)
        x = (torch.randn(rows, d, device="cuda", generator=gen) * 3 + 1).to(
            torch.bfloat16)
        g = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
        scale = torch.rand(d, device="cuda", generator=gen) + 0.5
        bias = torch.randn(d, device="cuda", generator=gen)

        def backward(x, g, scale, bias, eps=eps):
            ctx = SimpleNamespace(saved_tensors=(x, scale, bias), eps=eps,
                                  needs_input_grad=(True, True, True, False))
            return ln._LayerNorm.backward(ctx, g)[:3]

        def library(x, g, weight=scale.to(torch.bfloat16).requires_grad_(),
                    wbias=bias.to(torch.bfloat16).requires_grad_(), d=d,
                    eps=eps):
            y = torch.nn.functional.layer_norm(x, (d,), weight, wbias, eps)
            return y, (x, weight, wbias), g

        args = (x, g, scale, bias)
        first, second = backward(*args), backward(*args)
        ref = _plain_ln_bwd(torch, x, g, scale, eps)
        torch.cuda.synchronize()
        bitwise &= all(bool(torch.equal(a, b)) for a, b in zip(first, second))
        # x and g read, dx written; scale read, dscale and dbias written.
        touched = 3 * x.numel() * 2 + 3 * d * 4
        cold = smoke.cold_copies(args, touched)
        sets = [smoke._leaves(torch, (x, g)) for _ in range(len(cold))]
        shapes[key] = {
            "cold_us": smoke.time_ms(backward, torch, inner=2,
                                     arg_sets=cold) * 1e3,
            "warm_us": smoke.time_ms(backward, torch, arg_sets=(args,)) * 1e3,
            "bound_us": smoke.bound_ms(touched, 18 * x.numel())[0] * 1e3,
            "library_us": smoke.backward_ms(library, torch, sets)[0] * 1e3,
            "kernel_us_per_call": smoke.device_kernels_us(torch, backward, args,
                                                          touched),
            **{f"{name}_max_abs_err": float((a.float() - b).abs().max())
               for name, a, b in zip(("dx", "dscale", "dbias"), first, ref)},
        }
        del cold, sets
    return {"shapes": shapes, "bitwise_equal": bitwise}


def _time_decode(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import decode_attention, quantize

    ops = SimpleNamespace(decode_attention=decode_attention, quantize=quantize)
    paged = decode_attention.paged_int8_window_attention
    dense = decode_attention.int8_decode_attention
    found, bitwise = {}, True
    phase3, _, _ = smoke.paged_inputs(torch, ops, "cuda")
    lengths = phase3[-1].tolist()
    del phase3
    cases = {
        "paged_phase3": (paged, lambda: smoke.paged_inputs(torch, ops, "cuda")),
        "paged_serving": (paged, lambda: smoke.paged_inputs(
            torch, ops, "cuda", smoke.SERVING_LENGTHS, max_blocks=32)),
        "dense_phase3": (dense, lambda: smoke.dense_inputs(
            torch, ops, "cuda", [n + 1 for n in lengths])),
        "dense_serving": (dense, lambda: smoke.dense_inputs(
            torch, ops, "cuda", [n + 1 for n in smoke.SERVING_LENGTHS],
            seq=512)),
    }
    plain = {paged: decode_attention.paged_int8_window_attention_reference,
             dense: decode_attention.int8_decode_attention_reference}
    for key, (fn, make) in cases.items():
        args, n_bytes, n_flops = make()
        first, second = fn(*args), fn(*args)
        ref = plain[fn](*args)
        torch.cuda.synchronize()
        bitwise &= bool(torch.equal(first, second))
        cold = smoke.cold_copies(args, n_bytes)
        found[key] = {
            "cold_us": smoke.time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
            "warm_us": smoke.time_ms(fn, torch, arg_sets=(args,)) * 1e3,
            "bound_us": smoke.bound_ms(n_bytes, n_flops)[0] * 1e3,
            "kernel_us_per_call": smoke.device_kernels_us(torch, fn, args,
                                                          n_bytes),
            "max_abs_err": float((first.float() - ref.float()).abs().max()),
        }
        del args, first, second, ref, cold
    return {"shapes": found, "bitwise_equal": bitwise}


def _time_rmsnorm(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import rmsnorm as rn

    fn = lambda x, scale: rn.rmsnorm(x, scale, 1e-5)
    shapes, bitwise = {}, True
    for key, rows in smoke.RMSNORM_ROWS.items():
        args = smoke.rmsnorm_inputs(torch, rows, torch.bfloat16)
        first, second = fn(*args), fn(*args)
        ref = rn.rmsnorm_reference(*args, 1e-5)
        torch.cuda.synchronize()
        bitwise &= bool(torch.equal(first, second))
        n = rows * smoke.RMSNORM_D
        shapes[key] = {
            **smoke.shape_times(torch, fn, args, 2 * n * 2 + smoke.RMSNORM_D * 4,
                                4 * n),
            "launches_per_call": smoke.kernel_launch_counts(
                torch, lambda: fn(*args)),
            "max_abs_err": float((first.float() - ref.float()).abs().max()),
        }
    return {"shapes": shapes, "bitwise_equal": bitwise}


def _takes_bf16(torch, quantize) -> bool:
    """Whether this root's `quantize_int8` takes bf16 on the card (before
    it did, the serving path cast K and V to f32 first)."""
    try:
        quantize.quantize_int8(torch.zeros(1, 128, device="cuda",
                                           dtype=torch.bfloat16))
    except ValueError:
        return False
    return True


def _time_quantize(torch, smoke) -> dict:
    from tf_yarn_tpu_torch.ops import quantize

    takes_bf16 = _takes_bf16(torch, quantize)

    def main_path(x):
        """As this root's serving path quantizes K and V."""
        if x.dtype != torch.float32 and not takes_bf16:
            x = x.float()
        return quantize.quantize_int8(x)

    shapes, bitwise = {}, True
    for key, rows in smoke.QUANTIZE_ROWS.items():
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = smoke.quantize_inputs(torch, rows, dtype)
            (values, scales), again = main_path(x), main_path(x)
            ref_v, ref_s = quantize.quantize_int8_reference(x)
            torch.cuda.synchronize()
            bitwise &= bool(torch.equal(values, again[0])
                            and torch.equal(scales, again[1]))
            n = rows * smoke.QUANTIZE_D
            shapes[f"{key}_{name}"] = {
                **smoke.shape_times(torch, main_path, (x,),
                                    n * x.element_size() + n + rows * 4, 4 * n),
                "launches_per_call": smoke.kernel_launch_counts(
                    torch, lambda: main_path(x)),
                "scales_bit_equal": bool(torch.equal(scales, ref_s)),
                "codes_differing": int((values != ref_v).sum()),
            }
    # The floor under CUDA-graph replay: a one-element fill, one launch.
    one = torch.zeros(1, device="cuda")
    floor = smoke.time_ms(lambda t: t.fill_(1.0), torch, arg_sets=((one,),))
    return {"shapes": shapes, "bitwise_equal": bitwise,
            "takes_bf16": takes_bf16, "one_launch_floor_us": floor * 1e3}


PASSES = ("fwd", "dq", "dkv", "gn_fwd", "gn_bwd", "ln_fwd", "ln_dx", "ln_bwd",
          "decode", "rmsnorm", "quantize")


def time_one(root: Path, kernel: str) -> dict:
    import torch

    smoke = _smoke()
    sys.path.insert(0, str(root))
    from tf_yarn_tpu_torch.ops import _build

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    _build.load_library()
    if kernel == "gn_fwd":
        found = _time_gn_fwd(torch, smoke)
    elif kernel == "gn_bwd":
        found = _time_gn_bwd(torch, smoke)
    elif kernel == "ln_fwd":
        found = _time_ln_fwd(torch, smoke)
    elif kernel == "ln_dx":
        found = _time_ln_dx(torch, smoke)
    elif kernel == "ln_bwd":
        found = _time_ln_bwd(torch, smoke)
    elif kernel == "decode":
        found = _time_decode(torch, smoke)
    elif kernel == "rmsnorm":
        found = _time_rmsnorm(torch, smoke)
    elif kernel == "quantize":
        found = _time_quantize(torch, smoke)
    else:
        found = _time_flash(torch, smoke, kernel)
    return {"pass": kernel, **found, "card": smoke.nvidia_smi()}


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
    if kernel not in PASSES or not argv:
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
