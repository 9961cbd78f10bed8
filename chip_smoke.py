#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tf_yarn_tpu_torch) on one
NVIDIA H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: the three CUDA kernels from ops/csrc/ (sm_90a), timed;
3. kernels: each kernel against its plain torch version on the card at
   the serving path's shapes, with the stated tolerance, timed with CUDA
   events over CUDA-graph replays beside the plain version, the library
   call where one exists, and its bound on this card. The times are
   cold: the calls cycle over copies of the inputs that together exceed
   twice the L2 cache, as the serving path finds each layer's inputs
   out of L2; the warm time (the same inputs again and again) is kept
   beside them;
4. reference: a small f32 model served on the card (kernels) and on the
   CPU (plain versions) from the same weights — greedy streams equal,
   prefill logits close;
5. slice: the Llama-3-8B-width decoder (random bf16 weights from seed 0)
   behind SlotScheduler (paged, fused, int8) and ServingServer on
   127.0.0.1, answering 4 concurrent greedy /v1/generate requests; every
   kernel's launch count must be > 0 after them. A second burst of fresh
   prompts then runs under torch.profiler: the device's busy share and
   the kernels that took most device time.

The line before last is the card's `nvidia-smi` name and power limit
and the one before it the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without a result when
no CUDA device is available or the port's package is not beside this
file.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
H100_L2_BYTES = 50 * 2 ** 20
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_flops: float):
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_flops / H100_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, torch, inner: int = 20, outer: int = 10, arg_sets=((),)
            ) -> float:
    """Device time per call of `fn(*args)`: `inner` rounds over
    `arg_sets` captured in one CUDA graph, replayed `outer` times between
    CUDA events (no host launch cost in the measurement). One argument
    set gives the warm time; `cold_copies` gives sets whose calls find
    their inputs out of L2."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            for args in arg_sets:
                fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(outer):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (inner * outer * len(arg_sets))


def cold_copies(args, touched_bytes: int):
    """Copies of `args` (tensors cloned) such that between two calls on
    one copy the others move at least twice the L2 cache's bytes."""
    n = 2 + -(-2 * H100_L2_BYTES // touched_bytes)
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def timings(fn, plain, library, args, touched_bytes, torch, plain_inner=20):
    """The kernel's cold and warm times, the plain version's and the
    library call's (None where there is none) cold times, in ms."""
    cold = cold_copies(args, touched_bytes)
    return {
        "ms": time_ms(fn, torch, inner=2, arg_sets=cold),
        "warm_ms": time_ms(fn, torch, arg_sets=(args,)),
        "plain_ms": time_ms(plain, torch, inner=1, outer=max(1, plain_inner // 4),
                            arg_sets=cold),
        "library_ms": library and time_ms(library, torch, inner=2,
                                          arg_sets=cold),
    }


def check_rmsnorm(torch, ops, dev):
    rows_list = (8, 512)
    worst = 0.0
    for rows in rows_list:
        gen = torch.Generator(device=dev).manual_seed(SEED + rows)
        x = torch.randn(rows, 4096, device=dev, generator=gen).to(torch.bfloat16)
        scale = torch.rand(4096, device=dev, generator=gen) + 0.5
        got = ops.rmsnorm.rmsnorm(x, scale, 1e-5)
        ref = ops.rmsnorm.rmsnorm_reference(x, scale, 1e-5)
        torch.cuda.synchronize()
        # rtol 1/128: one bf16 ulp of the output (f32 sums in another order).
        torch.testing.assert_close(got.float(), ref.float(), rtol=1 / 128, atol=0)
        worst = max(worst, float((got.float() - ref.float()).abs().max()))
    weight = scale.to(torch.bfloat16)
    row = {
        "name": "rmsnorm", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "tf_yarn_tpu/ops/rmsnorm.py:34",
        "shape": [rows, 4096], "max_abs_err": worst,
    }
    n = rows * 4096
    row.update(timings(
        lambda x, scale, weight: ops.rmsnorm.rmsnorm(x, scale, 1e-5),
        lambda x, scale, weight: ops.rmsnorm.rmsnorm_reference(x, scale, 1e-5),
        lambda x, scale, weight: torch.nn.functional.rms_norm(
            x, (4096,), weight=weight, eps=1e-5),
        (x, scale, weight), 2 * n * 2, torch))
    row["bound_ms"], row["bound_by"] = bound_ms(2 * n * 2 + 4096 * 4, 4 * n)
    return row


def check_quantize(torch, ops, dev):
    worst = 0
    for rows in (8 * 8, 512 * 8):
        gen = torch.Generator(device=dev).manual_seed(SEED + rows)
        x = torch.randn(rows, 128, device=dev, generator=gen) * 3
        values, scales = ops.quantize.quantize_int8(x)
        ref_v, ref_s = ops.quantize.quantize_int8_reference(x)
        torch.cuda.synchronize()
        if not torch.equal(scales, ref_s):
            raise AssertionError("quantize_int8: scales are not bit-equal")
        # Codes equal, except at most one where x / scale lies within
        # 1e-6 of a half (rounding at the boundary).
        diff = values != ref_v
        if int(diff.sum()) > 1:
            raise AssertionError(f"quantize_int8: {int(diff.sum())} codes differ")
        if int(diff.sum()) == 1:
            ratio = (x / ref_s)[diff]
            if float((ratio.abs().frac() - 0.5).abs().max()) > 1e-6:
                raise AssertionError("quantize_int8: a code differs off the half")
        worst = max(worst, int((values.int() - ref_v.int()).abs().max()))
    row = {
        "name": "quantize_int8", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/quantize.cu",
        "replaces": "tf_yarn_tpu/ops/quantize.py:20",
        "shape": [rows, 128], "max_abs_err": float(worst),
    }
    n = rows * 128
    row.update(timings(ops.quantize.quantize_int8,
                       ops.quantize.quantize_int8_reference, None, (x,),
                       n * 4 + n + rows * 4, torch))
    row["bound_ms"], row["bound_by"] = bound_ms(n * 4 + n + rows * 4, 4 * n)
    return row


def check_attention(torch, ops, dev):
    slots, width, n_heads, n_kv, head_dim, bs, max_blocks = 8, 1, 32, 8, 128, 16, 512
    gen = torch.Generator(device=dev).manual_seed(SEED)
    num_blocks = slots * max_blocks + 1
    x = torch.randn(num_blocks, bs, n_kv, head_dim, device=dev, generator=gen)
    kq, ks = ops.quantize.quantize_int8_reference(x * 2)
    vq, vs = ops.quantize.quantize_int8_reference(
        torch.randn(x.shape, device=dev, generator=gen))
    del x
    ks[0] = float("nan")  # trash-block garbage must never leak
    vs[0] = float("nan")
    lengths = torch.randint(1, 4097, (slots,), device=dev, generator=gen,
                            dtype=torch.int32)
    perm = torch.randperm(num_blocks - 1, device=dev, generator=gen) + 1
    tables = perm[:slots * max_blocks].reshape(slots, max_blocks).to(torch.int32)
    live = (lengths.long() + width + bs - 1) // bs
    cols = torch.arange(max_blocks, device=dev)[None, :]
    tables = torch.where(cols < live[:, None], tables, torch.zeros_like(tables))
    q = torch.randn(slots, width, n_heads, head_dim, device=dev,
                    generator=gen).to(torch.bfloat16)
    args = (q, kq, ks, vq, vs, tables, lengths)
    got = ops.decode_attention.paged_int8_window_attention(*args)
    ref = ops.decode_attention.paged_int8_window_attention_reference(*args)
    torch.cuda.synchronize()
    # atol = rtol = 2e-2: a bf16 output, sums in another order.
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    row = {
        "name": "paged_int8_window_attention", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "tf_yarn_tpu/ops/decode_attention.py:199",
        "shape": {"slots": slots, "width": width, "lengths": lengths.tolist(),
                  "block_size": bs, "max_blocks": max_blocks},
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
    }
    # Each slot's live positions are read once (its window included):
    # K and V int8 rows plus their f32 scales, the live table entries,
    # q and the output once; 4 flops per position, head and column.
    positions = int((lengths.long() + width).sum())
    n_bytes = (positions * n_kv * (2 * head_dim + 2 * 4)
               + int(live.sum()) * 4 + slots * 4
               + 2 * q.numel() * q.element_size())
    row.update(timings(ops.decode_attention.paged_int8_window_attention,
                       ops.decode_attention.paged_int8_window_attention_reference,
                       None, args, n_bytes, torch, plain_inner=8))
    # Device time per call of each CUDA kernel behind the wrapper (the
    # split and combine kernels), cold, from the profiler.
    cold = cold_copies(args, n_bytes)
    calls = 4 * len(cold)
    profiled = device_profile(torch, lambda: [
        ops.decode_attention.paged_int8_window_attention(*a)
        for _ in range(4) for a in cold])
    row["kernel_us_per_call"] = {
        re.search(r"\w+_kernel", k["name"]).group(0): k["ms"] * 1e3 / calls
        for k in profiled["top_kernels"] if "_kernel" in k["name"]}
    del cold
    n_flops = sum(int(lengths[s]) * width + width * (width + 1) // 2
                  for s in range(slots)) * n_heads * head_dim * 4
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops)
    return row


def serve_tiny_reference(torch, tt, engine_mod, sched_mod, dev):
    """The same small f32 model served through the kernels on the card
    and through the plain versions on the CPU: greedy streams must be
    equal and the prefill logits close."""
    cfg = tt.TransformerConfig(vocab_size=512, d_model=512, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=1024,
                               max_seq_len=256, dtype=torch.float32)
    cpu_model = tt.make_model(cfg, seed=SEED, device="cpu")
    gpu_model = tt.Transformer(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = [[(7 * i + 3) % 512 for i in range(n)] for n in (5, 40)]
    streams = []
    logits = []
    for model in (gpu_model, cpu_model):
        engine = engine_mod.DecodeEngine(model)
        logits.append(engine.prefill([prompts[1][:32]])[1].cpu())
        scheduler = sched_mod.SlotScheduler(engine, max_slots=2, block_size=16)
        try:
            responses = [scheduler.submit(
                p, sched_mod.SamplingParams(max_new_tokens=8)) for p in prompts]
            for _ in range(200):
                scheduler.tick()
                if all(r.done for r in responses):
                    break
            streams.append([r.result(timeout=1) for r in responses])
        finally:
            scheduler.close()
    err = float((logits[0] - logits[1]).abs().max())
    if not torch.isfinite(logits[0]).all() or err > 1e-3:
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    if streams[0] != streams[1]:
        raise AssertionError(f"card {streams[0]} != CPU {streams[1]}")
    return {"prefill_logits_max_abs_err": err, "streams": streams[0]}


def post(port: int, body: dict) -> tuple:
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=600) as reply:
        return reply.status, json.loads(reply.read())


def get(port: int, path: str) -> tuple:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as reply:
        return reply.status, json.loads(reply.read())


def burst(port: int, prompts, new_tokens: int):
    """POST every prompt at once (one thread each); returns the replies
    in prompt order and the wall time until the last one."""
    results = [None] * len(prompts)

    def call(i):
        results[i] = post(port, {"prompt": prompts[i],
                                 "max_new_tokens": new_tokens})

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    started = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    wall = time.perf_counter() - started
    if any(thread.is_alive() for thread in threads) or None in results:
        raise AssertionError("a request did not finish")
    return results, wall


def device_profile(torch, run):
    """`run()` under torch.profiler: the device's busy share of the wall
    time and the kernels that took most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    rows = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total",
                            getattr(event, "self_cuda_time_total", 0))
        if device_us > 0:
            rows.append((device_us, event.count, event.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _count, _key in rows) / 1e6
    if busy_s <= 0:
        raise AssertionError("the profiler saw no device time")
    return {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / wall,
        "top_kernels": [{"name": key[:80], "ms": us / 1e3, "calls": count}
                        for us, count, key in rows[:8]],
    }


def serve_slice(torch, tt, engine_mod, sched_mod, server_mod, counted, dev):
    cfg = tt.TransformerConfig.llama3_8b(dtype=torch.bfloat16)
    started = time.perf_counter()
    model = tt.make_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"model: llama3_8b widths, {cfg.n_layers} layers, bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}e9 params, "
        f"built in {time.perf_counter() - started:.1f} s")
    engine = engine_mod.DecodeEngine(model)
    _cache, logits = engine.prefill([[1, 2, 3, 4, 5, 6, 7, 8]])
    if tuple(logits.shape) != (1, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    scheduler = sched_mod.SlotScheduler(engine, max_slots=4, block_size=16,
                                        kv_layout="paged",
                                        decode_attention="fused")
    server = server_mod.ServingServer(scheduler, "127.0.0.1", 0)
    scheduler.start()
    server.start()
    try:
        gen = torch.Generator().manual_seed(SEED)
        lengths = (17, 64, 150, 300)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
                   for n in lengths]
        for fn in counted:
            fn.launches = 0
        results, wall = burst(server.port, prompts, 16)
        launches = {fn.__name__: fn.launches for fn in counted}
        for status, body in results:
            if status != 200 or len(body["tokens"]) != 16:
                raise AssertionError(f"bad reply {status}: {body}")
            if not all(0 <= t < cfg.vocab_size for t in body["tokens"]):
                raise AssertionError(f"token out of range: {body['tokens']}")
        status, health = get(server.port, "/healthz")
        if status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {status} {health}")
        status, stats = get(server.port, "/stats")
        if status != 200 or "decode_engine" not in stats:
            raise AssertionError(f"/stats: {status}")
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{name} never launched on the main path")
        ticks = stats["ticks"]
        # The same burst again with fresh prompts (no prefix-cache hits),
        # under the profiler: where the device time goes, and how idle
        # the device is.
        fresh = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
                 for n in lengths]
        profiled = device_profile(torch, lambda: burst(server.port, fresh, 16))
        return {
            "requests": len(prompts),
            "prompt_tokens": list(lengths),
            "new_tokens": 16,
            "wall_s": wall,
            "tokens_per_s": 16 * len(prompts) / wall,
            "ttft_s": sorted(body["ttft_s"] for _status, body in results),
            "ticks": ticks,
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profiled_burst": profiled,
        }
    finally:
        server.stop()
        scheduler.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "tf_yarn_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tf_yarn_tpu_torch.models import decode_engine as engine_mod
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.ops import _build
    from tf_yarn_tpu_torch.ops import decode_attention, quantize, rmsnorm
    from tf_yarn_tpu_torch.serving import scheduler as sched_mod
    from tf_yarn_tpu_torch.serving import server as server_mod

    class ops:  # one namespace for the three kernel modules
        pass

    ops.rmsnorm, ops.quantize, ops.decode_attention = (
        rmsnorm, quantize, decode_attention)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; {nvcc[-1]}")
    log(f"card: {card}")

    started = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - started:.1f} s "
        f"(nvcc {_build.build_seconds and round(_build.build_seconds, 1)} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    rows = [check_rmsnorm(torch, ops, dev), check_quantize(torch, ops, dev),
            check_attention(torch, ops, dev)]
    for row in rows:
        log(f"kernel {row['name']}: max_abs_err {row['max_abs_err']:.3g}, "
            f"{row['ms'] * 1e3:.2f} us cold, {row['warm_ms'] * 1e3:.2f} us warm "
            f"(plain {row['plain_ms'] * 1e3:.2f} us, "
            f"bound {row['bound_ms'] * 1e3:.2f} us by {row['bound_by']})"
            + (f" {row['kernel_us_per_call']}" if "kernel_us_per_call" in row
               else ""))

    reference = serve_tiny_reference(torch, tt, engine_mod, sched_mod, dev)
    log(f"reference: card vs CPU prefill logits max err "
        f"{reference['prefill_logits_max_abs_err']:.3g}, greedy streams equal")

    counted = (rmsnorm.rmsnorm, quantize.quantize_int8,
               decode_attention.paged_int8_window_attention)
    torch.cuda.reset_peak_memory_stats()
    slice_result = serve_slice(torch, tt, engine_mod, sched_mod, server_mod,
                               counted, dev)
    log(f"slice: {json.dumps(slice_result)} on {card}")

    for row in rows:
        row["launches"] = slice_result["launches"][row["name"]]
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
