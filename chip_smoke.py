#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (tf_yarn_tpu_torch) on one
NVIDIA H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: every CUDA kernel from ops/csrc/ (sm_90a), timed, started
   beside the imports;
3. kernels: each of the twelve kernels against its plain torch version
   on the card at its main path's shapes (serving: rmsnorm — bf16 and
   f32 at a decode tick's 4 rows, phase 3's 512 and the training
   slice's 2048 — and quantize — from f32 and from bf16 at a decode
   tick's 32 rows, a tp=2 rank's 16 and phase 3's 4096 — each bitwise
   equal over two
   calls, one CUDA launch of its kernel a call by the profiler, and
   timed at every shape; paged attention, dense int8 decode attention —
   the two attention rows read the same slots' cache bytes, each also
   timed at the serving slice's 4 slots (the paged one also at grid
   (e)'s 64-token windows, the dense one also at a tp=2 rank's 16 query
   and 4 kv heads), bitwise equal over two calls, and one CUDA
   launch of its kernel a call by the profiler; training:
   rmsnorm dx, flash forward,
   dq, dk/dv (also at phase 9 (h)'s Ulysses shape, 16 query and 4 kv
   heads over 8192 tokens, checked and not timed); the zoo: the LayerNorm forward (bitwise equal over two
   calls, one launch of its row kernel a call) and backward (dx, dscale
   and dbias; bitwise equal over two calls, two launches a call and no
   other kernel), each timed cold and warm at BERT-base's and
   ViT-B/16's rows, the GroupNorm
   forward and backward at all 12 of ResNet-50's slab shapes, each with
   its launch-weighted sum a step and the device kernels one call at
   each launched, which must be the plan's and, for the backward,
   nothing else), with the stated tolerance, timed with CUDA events over
   CUDA-graph replays beside the plain version (the GroupNorm's at the
   stem's and last stage's slabs only), the library call where one
   exists (F.layer_norm's and F.group_norm's backwards take x, weight
   and bias), and its bound on this card. The times are cold: the calls cycle over copies
   of the inputs that together exceed twice the L2 cache, as the main
   paths find each layer's inputs out of L2; the warm time (the same
   inputs again and again) is kept beside them;
4. references: a small f32 model (int8 KV) served on the card (kernels)
   and on the CPU (plain versions) from the same weights — prefill
   logits close, greedy outputs equal on the fused paged grid (also with
   chunked prefill, its streams equal to the blocking grid's), the
   dense grid and the gather mode (each also with spec_k=2) and from
   `engine.generate` at batch 3 with a replayed remainder and an eos;
   the fused grid with the host swap tier (`fused_swap`: a batch stream
   suspended by an interactive request and resumed, its streams equal to
   the same requests served alone) and a warm start between two fused
   grids through the block wire (the importer's stream equal to the
   donor's, with a prefix hit); three concurrent requests on the fused
   grid, one with ids outside the vocabulary (V and -V-3), then a clean
   one on the same replica — all served to length, equal to the CPU's;
   the same model at `MeshSpec(tp=2)` (`serving.tp_replica`: this
   process leads, one follower spawned, both on the card over gloo;
   started with the smoke, beside the build and phase 3, and closed
   before the training references) against one device — prefill logits
   within 1e-5 of the CPU's largest, greedy streams equal to the card's
   (and so the CPU's) on the dense and paged gather grids, each also
   with spec_k=2 and with chunked prefill, and every rank launching
   rmsnorm, quantize and the dense decode kernel, as often as the
   other;
   `run_inference` over a checkpoint `train_and_evaluate` wrote on the
   card — its records equal `generate` on the restored params; a small
   f32 LoRA decoder (flash, fused norms) trained 5 steps on both from the
   same weights and batches — losses and adapters close; then
   `train_and_evaluate` with a model_dir writes manifested checkpoints,
   verifies them and resumes; tiny f32 BERT, ViT and ResNet (both stems)
   trained 3 steps on both — losses and parameters close — and the tiny
   ResNet checkpointed and resumed through `train_and_evaluate`; the
   tiny f32 DLRM ranker, its weights through the flax bridge, behind
   RankServer on both (ids negative and past their tables among the
   requests) — scores within 1e-5 — and trained 3 adagrad steps through
   `train_and_evaluate` on both from those weights — losses and
   parameters close; the small f32 LoRA decoder (flash, fused norms) at
   `MeshSpec(tp=2)`: two gloo ranks on the card, spawned at the smoke's
   start and waiting for this phase, train it 3 steps through
   `train_and_evaluate` against one rank in this process — losses and
   adapters within 1e-4, the ranks' adapters bitwise equal, their flash
   calls on 2 of 4 query heads and 1 of 2 kv heads; then the same two
   ranks train it at `MeshSpec(sp=2)` by the ring and by Ulysses with
   flash inside (each rank's flash calls on 2 query heads and 1 kv head
   over the whole 128 tokens; the ring launches no flash) against that
   one rank, and at `MeshSpec(pp=2)` (GPipe, 2 microbatches, xla
   attention, one layer a stage) against one rank of that config: losses
   and adapters within 1e-4, RMSNorm launched as often as the one rank,
   the sp ranks' adapters bitwise equal, the leaves every stage holds
   bitwise equal (`parallel_check`); a small f32 MoE decoder (4 experts,
   capacity factor 1.0: tokens dropped) trained 3 steps on both with
   AdamW and with adafactor (d_model 256: its leaves factor) — losses,
   aux losses and parameters close, the router's smallest top-1 margin
   above MOE_ROUTE_MARGIN — and the linear classifier 3 adagrad steps on
   both; then the same two ranks train the MoE decoder at
   `MeshSpec(ep=2)` against one rank (`moe_ep_check`: losses and
   parameters within 1e-4, the whole parameters bitwise equal across the
   ranks, 2 of 4 experts a rank);
5. serving slice: the Llama-3-8B-width decoder cut to 4 of its 32
   layers (`serving_config`; random bf16 weights from seed 0, int8 KV)
   on every serving path, each with the kernel counts
   set to 0 just before it and read just after: SlotScheduler with 4
   slots behind ServingServer on 127.0.0.1 answering 4 concurrent greedy
   /v1/generate requests — (a) paged with fused attention, (b) paged in
   the gather mode, (c) the dense grid — (d) `engine.generate` on a
   [4, 300] batch, and (e) grid (a) with chunked prefill (a chunk of 64,
   two a tick), which must run no prefill program and one window step
   of width 64 a tick; (f) the host swap tier: grid (a) with
   `num_blocks=47` and `kv_host_blocks=64`, two batch requests of 300
   tokens and 64 new filling the pool, then two interactive ones (17 and
   64 tokens, 16 new) that suspend one of them: every parked stream
   resumes, the batch streams equal the same two served alone, and the
   paged kernel launches once a layer a window step; each tier's TTFT
   and tokens/s, the blocks swapped, their seconds and the host copy's
   GB/s; (g) the warm start: replica A serves a 300-token prompt, its
   `GET /v1/blocks` is POSTed to replica B (another grid over the same
   engine), whose stream on the prompt must hit the 16 imported blocks
   and equal A's; the wire's MB and its stages' seconds. Every kernel of
   a path must have launched (the dense decode kernel on b, c and d). Bursts (a), (b) and (e) run a second burst
   of fresh prompts under torch.profiler: the device's busy share, its
   launches a scheduler tick, and the kernels that took most device time
   and that launched most often;
6. training slice: `make_experiment(llama3_8b(lora_rank=16, flash, fused
   norms, unrolled))` at batch 1 x 2048 tokens through
   `train_and_evaluate` for 4 steps, all 32 layers, random weights from
   seed 0; every training kernel's launch count must be > 0, the losses
   finite, the adapters moved and the base bit-unchanged. The steady
   step is the mean of steps 2-4, with their spread. Then a warm-up
   step, one timed step and one under torch.profiler: the device's busy
   time against the timed step gives its idle share;
6b. MoE and linear slice: the Switch MoE decoder at Llama-3-8B widths
   (8 experts of its MLP's shape, 1 of its 32 layers; `moe_config`) at 1
   x 2048 tokens through `train_and_evaluate`, 4 steps with AdamW and 4
   with adafactor, each with the training kernels' counts set to 0 just
   before it: every one launched, losses and aux losses finite, the
   router and experts moved, the share of tokens dropped, the steady
   step, peak memory and a profiled step (`moe_slice`); the linear
   classifier at BASELINE.json config 2's size (2^20 buckets, 39
   features) 60 adagrad steps at batch 4096, accuracy > 0.6
   (`linear_slice`); then two ranks spawned at the phase's start train
   the MoE decoder with adafactor at `MeshSpec(ep=2)` for 3 steps
   against the one-device run's first 3 (losses within MOE_EP_WIDE_RTOL,
   the whole parameters bitwise equal across the ranks, each rank's peak
   memory and ep all-reduces a step);
6c. text-fed LoRA slice (`text_lora_slice`): phase 6's decoder
   (`llama3_8b(lora_rank=16, flash, fused norms, unrolled)`) at its
   widths, cut to 2 of its 32 layers (`TEXT_LAYERS`) for the smoke's
   time, 1 x 2048 tokens, 4 steps through `train_and_evaluate`, its
   `input_fn` a `data.text.TextDataset` (repeat) over 20,000 lines of
   seeded pseudo-words written to a temporary directory and tokenized by
   crc32(word) % vocab_size, the training kernels' counts set to 0 just
   before it: every training kernel launched, losses finite, the adapters
   moved, the base bit-unchanged, the tokens int64 at the loss and each
   batch the loss saw bitwise (sha256) the same TextDataset iterated on
   the CPU; the steady step and its tokens/s beside the TextDataset's
   own packing rate on the host (one pass over the corpus);
7. zoo slice: each family's `make_experiment` at full width with
   `fused_norms=True` — BERT-base (32 x 128 tokens), ViT-B/16 and
   ResNet-50 with the conv stem (128 images at 224) — through
   `train_and_evaluate` for 4 steps, random weights from seed 0 and the
   JAX synthetic inputs, each with the kernel counts set to 0 just
   before it and read just after: its norm kernels launched, losses
   finite, parameters moved; the steady step, samples/s, MFU (one
   step's FLOPs from FlopCounterMode), peak memory, and a profiled step,
   in which each of BERT's and ViT's LayerNorm and ResNet's GroupNorm
   backward calls must make its two CUDA launches and no arithmetic in
   torch (no plain dscale/dbias);
8. ranker slice: `DLRMConfig.criteo()` (26 tables of 2^17 rows, 64
   wide, an 872 MB f32 table, bf16 compute; random weights from seed 0)
   behind RankEngine + MicroBatchScheduler(max_batch=256, max_wait_ms=2)
   + RankServer on 127.0.0.1, with the kernel counts set to 0 just
   before (it runs none of them): bursts of concurrent POSTs of 1, 32
   and 256 rows (rows/s each; fewer ticks than requests), the scores
   against the same weights' f32 forward on the CPU and, at
   dtype=float32 on the card, tightly; a profiled burst (the tick's wall
   and device time, the device's idle share, the top kernels); then
   `make_experiment(DLRMConfig.criteo())` through `train_and_evaluate`
   for 4 steps at batch 1024: losses finite, the table rows the batches
   read moved and no other row, the steady step, samples/s, peak memory
   and a profiled step;
9. launcher slice: `client.run_on_gpu` with LocalBackend
   (`get_safe_experiment_fn`, so no cloudpickle is needed): (a) phase
   7's BERT-base experiment (its batches from an input_fn that declares
   `start_step`) trained 4 steps in a launched worker, in chunks of
   `steps_per_loop=2`, a checkpoint every 2 steps through the async
   writer keeping the newest 1, beside an `evaluator` (on the card, as
   every task is by default) and a `tensorboard` task — Metrics carry
   the worker and the evaluator, the KV store's
   `worker:0/last_training_step` is 4, the worker launched the LayerNorm
   forward and backward kernels as often as phase 7 did in this process
   (and loaded the kernel library without rebuilding it), its losses
   equal phase 7's within 1e-5 relative; eval-done markers for ckpt-2
   and ckpt-4, the evaluator's ckpt-4 metrics equal to the worker's
   final eval within 1e-5, its LayerNorm forward launched and not its
   backward, its health keys in the KV store; the tensorboard URL logged
   and `<model_dir>/tb` events written where tensorboard imports; the
   `TPU_YARN_PROFILE_STEPS="2:4"` window's Chrome trace holding the
   LayerNorm kernels; the wall to return and the worker's chunks from
   its exported trace; (b) the same run with no visible card raises
   RunFailed carrying the port's no-CUDA error; (c) a fn of rank on
   `tasks.distributed` initialises NCCL from its TaskParameters and
   all_reduces on the card; (e) a chief and a worker of
   `allreduce_topology` train (a)'s experiment data-parallel at
   `MeshSpec(dp=2)`, each rank on its half of phase 7's global batch,
   both on the one card and so over gloo (NCCL refuses two ranks on one
   device): each rank's backend and device, its LayerNorm kernels
   launched as often as phase 7's, the ranks' parameters bitwise equal,
   the mean of their losses within `RANKS_LOSS_RTOL` of phase 7's,
   checkpoints submitted by rank 0 alone and ckpt-4 equal to its
   parameters, each step's gradient all-reduce seconds from rank 0's
   trace; (d) the run of (e) with `drain_poll_every_steps=2`, rank 1
   requesting the preemption drain after step 2 in attempt 0
   (`nb_retries=1`): both ranks drain at ckpt-2, the attempt is retried
   as PREEMPTED, attempt 1 resumes at step 2 and each rank's steps 3-4
   equal (e)'s within 1e-5 relative; (f) `pytorch.run_on_gpu` of two
   pytorch workers (`PytorchExperiment(backend="gloo")`) trains phase 7's
   BERT-base 4 steps over a DistributedSampler of phase 7's batches: the
   ranks' parameters bitwise equal, rank 0's `model_ckpt` save equal to
   them, the LayerNorm kernels launched in each worker; (g) tensor
   parallelism, run beside phase 10 (a): a chief and a worker of
   `allreduce_topology` train `make_experiment(llama3_8b(lora_rank=16,
   flash, fused norms, unrolled))` at 4 of 32 layers (`SERVE_LAYERS`),
   batch 1 x 2048, 3 steps, random weights from seed 0, at
   `MeshSpec(tp=2)`, both on the one card over gloo, with a checkpoint
   at the end; while they start, the same trains at one rank in this
   process, the training kernels' counts set to 0 just before it. Each
   rank launched RMSNorm forward and dx and flash forward, dq and dk/dv
   as often as the one rank did, its flash calls on 16 query heads and 4
   kv heads, its base bitwise unchanged; the ranks' adapters bitwise
   equal, and rank 0's change from init within 0.2 of the one rank's
   (the norm of the difference over the norm of the one rank's change);
   their losses within 5e-4 relative of the one rank's, which move by
   more than 1e-3; rank 0 alone submitted the checkpoint, whose base is
   bitwise the one rank's and whose adapters are rank 0's, and which
   loads into the one-rank model; each step's seconds, its tp all-reduce
   seconds (by op) and the logits gather's from the ranks' traces. (b),
   (c) and (f) run at once; each part's seconds. (h) and (i), sequence
   and pipeline parallelism, two ranks each spawned from this process
   on the card over gloo while (a)-(f) run, against one rank in this
   process on the same tokens and weights (`sequence_pipeline_part`):
   (h) the same decoder on 1 x 8192 tokens at `MeshSpec(sp=2)`, 3 steps
   with `attention_impl="ulysses_flash"` (each rank's flash calls on 16
   query and 4 kv heads over all 8192 tokens, launched as often as the
   one rank's flash run), then 3 with `"ring"` (no flash), losses within
   5e-4 relative; (i) the same decoder with
   `gpipe_microbatches=2` and xla attention on 2 x 2048 tokens at
   `MeshSpec(pp=2)`, two layers a stage, losses within 5e-4. Each:
   RMSNorm forward and dx launched as often as the one rank, the
   adapters' change from init within 0.3 of the one rank's, the leaves
   every stage holds bitwise equal (and under sp the adapters), rank 0's
   checkpoint holding every rank's adapters and loading into the
   one-rank model; each step's seconds and its ring shifts,
   all-to-alls or pipeline sends, and gradient sums, from rank 0's
   trace. (j) an elastic shrink, launched and checked beside (a)-(f)
   (`elastic_part`): two workers (`{"worker": TaskSpec(instances=2)}`) of
   (e)'s BERT-base run at `MeshSpec(dp=2)`, 4 steps of one step a chunk, a
   checkpoint every 2, with `ElasticPolicy(min_workers=1, max_workers=2)`,
   `nb_retries=1` and `TPU_YARN_FAULT="lose_host_at_step=3@worker:1"`,
   both on the card over gloo: the driver classifies attempt 0 LOST_TASK
   (worker:1 lost) and records the shrink 2 -> 1; attempt 1 runs one
   worker on the card, which logs the refit dp=1 mesh, reads
   `train/mesh_devices` 1 and `train/degraded` 1, finds ckpt-2's state
   bitwise at its first step and finishes step 4; the LayerNorm forward
   and backward launched in each attempt's workers as often as their
   steps call for (a FLOP-count pass and 3 steps by attempt 0's kill, the
   pass and 2 steps in attempt 1, against phase 7's pass and 4 steps);
   the losses of steps 3-4 and ckpt-4 against a one-device replay in this
   process from the same ckpt-2 on the same global batches
   (`ELASTIC_LOSS_RTOL`, `ELASTIC_PARAM_ATOL`, `ELASTIC_KEY_BIAS_ATOL`);
   the seconds from the kill to the LOST_TASK classification and from the
   relaunch to its first step. (k) remote hosts and a remote model_dir,
   launched and checked beside (a)-(f) (`remote_part`): `run_on_gpu` of
   two workers through `SshBackend` on two fake hosts — an ssh stand-in
   that gives each a HOME of its own on this machine and drops the
   caller's PYTHONPATH, so each is a bare interpreter — with
   `ship_code=True`, the code staged on a local `env_staging_dir`, a
   hand-built one-module wheel in `wheels_dir`, this script as `files=`
   and the coordinator advertised at 127.0.0.1; the experiment, sent by
   name from the shipped script, registers `smokefs://` (`SmokeFS`, a
   filesystem over a local directory that uses no pyarrow) and trains
   (e)'s BERT-base at `MeshSpec(dp=2)` over gloo on the card, 4 steps, a
   checkpoint every 2 through the async writer (staged: written locally,
   uploaded, renamed into place) keeping the newest 1, TensorBoard on,
   the model_dir on `smokefs://`. Before anything of the phase starts,
   `fs.check_model_dir_placement` refuses a local model_dir under a
   remote backend's environment. Each worker imported the port from the
   unpack root under its host's HOME, this script from its shipped
   workdir and the wheel's module from `_pydeps`, and built the kernel
   library from the shipped sources into its unpack root (its seconds);
   each rank launched the LayerNorm forward and backward as often as
   (e)'s same rank, with losses within `REMOTE_LOSS_RTOL` of (e)'s, the
   ranks' parameters bitwise equal; on the remote, ckpt-4 with its
   MANIFEST verifies through `fs` and equals rank 0's parameters, ckpt-2
   stays (retention runs before each save, as in the JAX writer), no
   staging or backup tree is left, and TensorBoard events are under
   `tb`; the wall to return, each worker's launch to its first step, and
   rank 0's `checkpoint/staged_write` seconds and bytes. (l), (m) and
   (n), launched at once beside (a)-(f) (`front_door_parts`): (l)
   `pytorch.run_on_gpu` of two pytorch workers (gloo, both on the card)
   reading a seeded Parquet file of 4096 rows through
   `data.torch_adapter.TorchParquetDataset` with 2 DataLoader workers
   each: every row read once across ranks x loader workers, the ranks'
   batch counts equal, each loader worker's batches bitwise the port's
   `ParquetDataset` on the CPU at its effective shard, each worker's
   rows/s; (m) ``python -m tf_yarn_tpu_torch.bin.check_gpu_env``: exit
   0, OK for all five checks and no FAIL, the device check's RMSNorm
   kernel launched once, each check's seconds; (n)
   examples_torch/generate_example.py on the card and with
   ``EXAMPLE_PLATFORM=cpu`` at once: both exit 0 with the same greedy
   continuation, and the kernels the card's run launched;
10. fleet slice, the launched serving fleet (`fleet_slice`), after
   phase 9 (a)-(f), with (g) beside its (a): (a) phase
   5's model (`serving_config`, 4 of 32 layers; seed 0) on grid (a) in process, prompts of 17, 64 and 300
   tokens with 16 new each, one at a time; the weights saved as ckpt-1
   (timed) and the model freed. Then one `run_on_gpu` of a mixed fleet
   (`mixed_fleet_topology(nb_serving=2, nb_rank=1)` and a prefill
   replica): two decode replicas, a prefill replica and a ranking
   replica on the card and the router on the CPU (its model on the meta
   device), one experiment fn sent by name for all of them: a
   ServingExperiment of the same model and grid over ckpt-1 with
   `prefill_tier={"offload_threshold": 64}` and round robin, or phase
   8's ranker from the seeded init. The driver logs each endpoint once.
   (b) On the first decode replica's own endpoint, the prompts one at a
   time stream bitwise equal to (a)'s (the 64- and 300-token ones
   shipped: 2 ships, 0 fallbacks) and a burst of the three is served to
   length (TTFT, tokens/s). (c) On the ranking replica's own endpoint,
   1-, 32- and 256-row POSTs one at a time score within 1e-5 of the
   driver's `dlrm.make_model(criteo, 0)` on the same rows (and whether
   bitwise), then phase 8's bursts for rows/s. (d) Through the router:
   every replica healthy by kind, the prompts one at a time twice
   bitwise equal to (a)'s, three routes on each decode replica, a burst
   served to length (TTFT, tokens/s), the ranking rows scored bitwise as
   on the replica, the fleet aggregate ok with the merged TTFT count the
   decode replicas' sum, 404 on an unknown path. (e) The second decode
   replica drained: ejected, the prompts through the router all on the
   first with (a)'s streams, one generate replica healthy, a below_min
   scale event. Then every task drained: the five tasks in the Metrics;
   the decode tasks launched rmsnorm, quantize and the paged kernel, the
   prefill task rmsnorm and quantize and no paged kernel, no task rebuilt
   the kernel library, the router initialised no CUDA; each task's peak
   memory and restore seconds (verify, read, copy), and the seconds of
   the launch to the router's endpoint, (d), (e) and the drain. Beside
   the fleet, launched with it, a tensor-parallel replica
   (`tp_serving_part`): `serving_topology(chips_per_host=2)` with
   `MeshSpec(tp=2)` over ckpt-1 on phase 5 (b)'s gather grid, its
   follower started by the task, both ranks on the card over gloo:
   phase 5 (b)'s prompts as one burst served to length, each rank's
   launches those of the leader's engine calls (as (b)'s are of its
   own), every token near-greedy against the one-device model within
   `TP_DELTA`, the burst again bitwise equal, its `/v1/blocks` hit as
   a prefix on a one-device grid, and the ranks' peak memory and the
   step's collectives from the leader's trace.

The run takes 7-11 minutes by how fast the host is (the last line before
the kernels JSON gives each phase's seconds; phases 5, 9 and 10 also
print their parts' seconds), inside a 20-minute limit.

The line before last is the card's `nvidia-smi` name and power limit
and the one before it the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without a result when
no CUDA device is available or the port's package is not beside this
file.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12         # bf16 tensor cores, dense
H100_L2_BYTES = 50 * 2 ** 20
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_flops: float, peak: float = H100_F32_FLOPS):
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, torch, inner: int = 20, outer: int = 10, arg_sets=((),)
            ) -> float:
    """Device time per call of `fn(*args)`: `inner` rounds over
    `arg_sets` captured in one CUDA graph, replayed `outer` times between
    CUDA events (no host launch cost in the measurement). One argument
    set gives the warm time; `cold_copies` gives sets whose calls find
    their inputs out of L2."""
    side = torch.cuda.Stream()  # warm up off the capture's stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
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
    library call's (None where there is none, or the plain version is not
    timed) cold times, in ms."""
    cold = cold_copies(args, touched_bytes)
    return {
        "ms": time_ms(fn, torch, inner=2, arg_sets=cold),
        "warm_ms": time_ms(fn, torch, arg_sets=(args,)),
        "plain_ms": plain and time_ms(plain, torch, inner=1,
                                      outer=max(1, plain_inner // 4),
                                      arg_sets=cold),
        "library_ms": library and time_ms(library, torch, inner=2,
                                          arg_sets=cold),
    }


def backward_ms(forward, torch, arg_sets):
    """Device time of the backward alone of a library call: forward plus
    `torch.autograd.grad` captured together (the backward runs on the
    capture's stream), less the forward alone. `forward(*args)` returns
    (output, inputs, cotangent) from leaf inputs that require grad."""
    both = time_ms(lambda *a: torch.autograd.grad(*forward(*a)), torch,
                   inner=2, arg_sets=arg_sets)
    with torch.no_grad():
        fwd = time_ms(lambda *a: forward(*a)[0], torch, inner=2,
                      arg_sets=arg_sets)
    return both - fwd, both


# The RMSNorm forward's main-path shapes, rows of Llama-3-8B's d 4096: a
# serving decode tick (4 slots), phase 3's, and the training slice's 1 x
# 2048 tokens; and the int8 quantize's, rows of head_dim 128: a decode
# tick (4 slots x 8 kv heads) and phase 3's.
RMSNORM_D = 4096
RMSNORM_ROWS = {"decode_tick": 4, "phase3": 512, "training": 2048}
QUANTIZE_D = 128
# A decode tick's K (or V) rows: 4 slots x 8 kv heads, and on each rank of
# the tp=2 replica its 4 kv heads. The tp rank's 16 rows are timed by
# CUDA events only: cold copies of 8 KB rows run to ~10,000, and a
# profiler session of their ~40,000 launches left this process's later
# sessions seeing no kernel.
QUANTIZE_ROWS = {"decode_tick": 32, "decode_tick_tp_rank": 16, "phase3": 4096}
QUANTIZE_UNPROFILED = ("decode_tick_tp_rank",)
# The tp rank's rows come from bf16 only, as the tp=2 replica hands them.
QUANTIZE_BF16_ONLY = ("decode_tick_tp_rank",)


def rmsnorm_inputs(torch, rows, dtype, dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(SEED + rows)
    x = torch.randn(rows, RMSNORM_D, device=dev, generator=gen).to(dtype)
    scale = torch.rand(RMSNORM_D, device=dev, generator=gen) + 0.5
    return x, scale


def quantize_inputs(torch, rows, dtype, dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(SEED + rows)
    x = (torch.randn(rows, QUANTIZE_D, device=dev, generator=gen) * 3).to(dtype)
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    return x


def check_codes(torch, x, values, scales, ref_v, ref_s):
    """Scales bit-equal to the plain version's; codes equal, except at most
    one where x / scale lies within 1e-6 of a half (rounding at the
    boundary)."""
    if not torch.equal(scales, ref_s):
        raise AssertionError("quantize_int8: scales are not bit-equal")
    diff = values != ref_v
    if int(diff.sum()) > 1:
        raise AssertionError(f"quantize_int8: {int(diff.sum())} codes differ")
    if int(diff.sum()) == 1:
        ratio = (x.float() / ref_s)[diff]
        if float((ratio.abs().frac() - 0.5).abs().max()) > 1e-6:
            raise AssertionError("quantize_int8: a code differs off the half")


def shape_times(torch, fn, args, n_bytes, n_flops, profile=True):
    """A kernel's cold and warm time and bound at one shape, and (with
    `profile`) each CUDA kernel's device time a call from the profiler,
    in microseconds."""
    cold = cold_copies(args, n_bytes)
    times = {
        "cold_us": time_ms(fn, torch, inner=2, arg_sets=cold) * 1e3,
        "warm_us": time_ms(fn, torch, arg_sets=(args,)) * 1e3,
        "bound_us": bound_ms(n_bytes, n_flops)[0] * 1e3,
    }
    if profile:
        times["kernel_us_per_call"] = device_kernels_us(torch, fn, args,
                                                        n_bytes)
    return times


def check_rmsnorm(torch, ops, dev):
    """The RMSNorm forward at each of its main-path shapes, in bf16 and
    f32: against the plain version, bitwise equal over two calls, one
    CUDA launch a call, and (bf16) timed. The row's own times are phase
    3's."""
    fn = lambda x, scale: ops.rmsnorm.rmsnorm(x, scale, 1e-5)
    plain = lambda x, scale: ops.rmsnorm.rmsnorm_reference(x, scale, 1e-5)
    shapes, worst = {}, 0.0
    for key, rows in RMSNORM_ROWS.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, scale = rmsnorm_inputs(torch, rows, dtype, dev)
            got, again = fn(x, scale), fn(x, scale)
            ref = plain(x, scale)
            torch.cuda.synchronize()
            # bf16: rtol 1/128, one ulp of the output; f32: 1e-5. The f32
            # sums run in another order.
            if dtype == torch.bfloat16:
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=1 / 128, atol=0)
            else:
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
            if not torch.equal(got, again):
                raise AssertionError(f"rmsnorm {key}: two calls differ")
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            if dtype == torch.float32:
                f32_err = err
                continue
            n = rows * RMSNORM_D
            shapes[key] = {
                "shape": [rows, RMSNORM_D], "max_abs_err": err,
                "f32_max_abs_err": f32_err, "bitwise_equal": True,
                "one_launch": one_launch(torch, fn, (x, scale), "rmsnorm_"),
                **shape_times(torch, fn, (x, scale), 2 * n * 2 + RMSNORM_D * 4,
                              4 * n),
            }
            if key == "phase3":
                phase3 = x, scale
    x, scale = phase3
    rows, d = x.shape
    row = {
        "name": "rmsnorm", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "tf_yarn_tpu/ops/rmsnorm.py:34",
        "shape": [rows, d], "max_abs_err": worst,
        "tolerance": "rtol 1/128 (bf16), 1e-5 (f32)", "shapes": shapes,
    }
    n = rows * d
    weight = scale.to(torch.bfloat16)
    row.update(timings(
        lambda x, scale, weight: fn(x, scale),
        lambda x, scale, weight: plain(x, scale),
        lambda x, scale, weight: torch.nn.functional.rms_norm(
            x, (d,), weight=weight, eps=1e-5),
        (x, scale, weight), 2 * n * 2, torch))
    row["bound_ms"], row["bound_by"] = bound_ms(2 * n * 2 + d * 4, 4 * n)
    return row


def check_quantize(torch, ops, dev):
    """The int8 quantize at each of its main-path shapes, from f32 and
    from bf16 (as the serving path hands it K and V): scales bit-equal to
    the plain version's, bitwise equal over two calls, one CUDA launch a
    call, timed. The row's own times are phase 3's from f32."""
    quantize = ops.quantize.quantize_int8
    shapes, worst = {}, 0
    for key, rows in QUANTIZE_ROWS.items():
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            if key in QUANTIZE_BF16_ONLY and dtype != torch.bfloat16:
                continue
            x = quantize_inputs(torch, rows, dtype, dev)
            (values, scales), again = quantize(x), quantize(x)
            ref_v, ref_s = ops.quantize.quantize_int8_reference(x)
            torch.cuda.synchronize()
            check_codes(torch, x, values, scales, ref_v, ref_s)
            if not (torch.equal(values, again[0])
                    and torch.equal(scales, again[1])):
                raise AssertionError(f"quantize_int8 {key}: two calls differ")
            err = int((values.int() - ref_v.int()).abs().max())
            worst = max(worst, err)
            n = rows * QUANTIZE_D
            shapes[f"{key}_{name}"] = {
                "shape": [rows, QUANTIZE_D], "dtype": name,
                "max_abs_err": float(err), "bitwise_equal": True,
                "one_launch": one_launch(torch, quantize, (x,),
                                         "quantize_int8_"),
                **shape_times(torch, quantize, (x,),
                              n * x.element_size() + n + rows * 4, 4 * n,
                              profile=key not in QUANTIZE_UNPROFILED),
            }
            if key == "phase3" and name == "f32":
                phase3 = x
    x = phase3
    rows = x.shape[0]
    row = {
        "name": "quantize_int8", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/quantize.cu",
        "replaces": "tf_yarn_tpu/ops/quantize.py:20",
        "shape": [rows, QUANTIZE_D], "max_abs_err": float(worst),
        "tolerance": "scales bit-equal; at most one code differs, at a half",
        "shapes": shapes,
    }
    n = rows * QUANTIZE_D
    row.update(timings(quantize, ops.quantize.quantize_int8_reference, None,
                       (x,), n * 4 + n + rows * 4, torch))
    row["bound_ms"], row["bound_by"] = bound_ms(n * 4 + n + rows * 4, 4 * n)
    row["per_block"] = check_grouped_quantize(torch, ops, dev)
    return row


# The grouped quantize at the paged pool's per-(block, kv head) groups:
# phase 3's pool [NB, 16, 8, 128] (`paged_inputs`: 8 slots of 512
# blocks and the trash block) as [NB, 8, 16, 128], one scale a group of
# the block's 16 rows — the per-block scale pools of `paged_inputs(...,
# per_block=True)`.
GROUPED_POOL = (8 * 512 + 1, 8, 16, 128)


def check_grouped_quantize(torch, ops, dev) -> dict:
    """`quantize_int8_grouped` (rows of 16 x 128 as one row of 2048, the
    kernel's general path) from f32 and from bf16: codes and scales
    against the plain version on the same grouped rows (`check_codes`),
    bitwise equal over two calls, one CUDA launch a call, timed cold and
    warm against its bound and the plain version."""
    grouped = ops.quantize.quantize_int8_grouped
    nb, n_kv, group, d = GROUPED_POOL
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        x = (torch.randn(GROUPED_POOL, device=dev, generator=gen) * 2).to(dtype)
        (values, scales), again = grouped(x, group), grouped(x, group)
        flat = x.reshape(nb, n_kv, 1, group * d)
        ref_v, ref_s = ops.quantize.quantize_int8_reference(flat)
        torch.cuda.synchronize()
        if tuple(scales.shape) != (nb, n_kv, 1, 1):
            raise AssertionError(f"grouped scales {tuple(scales.shape)}")
        check_codes(torch, flat, values.reshape(flat.shape), scales, ref_v,
                    ref_s)
        if not (torch.equal(values, again[0]) and torch.equal(scales,
                                                              again[1])):
            raise AssertionError(f"grouped quantize {name}: two calls differ")
        n = x.numel()
        n_bytes = n * x.element_size() + n + nb * n_kv * 4
        fn = lambda x: grouped(x, group)
        out[name] = {
            "shape": list(GROUPED_POOL), "group_rows": group,
            "max_abs_err": float((values.reshape(flat.shape).int()
                                  - ref_v.int()).abs().max()),
            "tolerance": "scales bit-equal; at most one code differs, at a "
                         "half",
            "one_launch": one_launch(torch, fn, (x,), "quantize_int8_kernel"),
            **shape_times(torch, fn, (x,), n_bytes, 4 * n, profile=False),
            "plain_us": time_ms(
                lambda x: ops.quantize.quantize_int8_reference(
                    x.reshape(nb, n_kv, 1, group * d)), torch, inner=1,
                outer=4, arg_sets=cold_copies((x,), n_bytes)) * 1e3,
        }
        del x, values, scales, again, flat, ref_v, ref_s
    return out


def device_kernels_us(torch, fn, args, touched_bytes):
    """Device time per call of each CUDA kernel behind a wrapper, cold,
    from the profiler."""
    cold = cold_copies(args, touched_bytes)
    calls = 4 * len(cold)
    profiled = device_profile(torch, lambda: [
        fn(*a) for _ in range(4) for a in cold])
    return {re.search(r"\w+_kernel", k["name"]).group(0): k["ms"] * 1e3 / calls
            for k in profiled["top_kernels"] if "_kernel" in k["name"]}


def one_launch(torch, fn, args, name: str) -> dict:
    """The device kernels one call of `fn(*args)` ran, by name: exactly one
    launch, of a kernel whose name holds `name`, or this raises."""
    ran = {key[:80]: count for key, count in
           kernel_launch_counts(torch, lambda: fn(*args)).items()}
    if len(ran) != 1 or name not in next(iter(ran)) \
            or next(iter(ran.values())) != 1:
        raise AssertionError(f"one call ran {ran}, not one {name} launch")
    return ran


# The decode kernels' two shapes: phase 3's (8 slots, lengths 1-4096 from
# the seed, 32/8 heads, D 128, block size 16, 512 blocks a table) and the
# serving slice's (its 4 slots: the bursts' prompts, 17-300 tokens, and
# the longest at its last step, 316).
SERVING_LENGTHS = (17, 64, 150, 316)
# The chunked grid's (e) tick: 4 slots each a 64-token window past its
# length (a chunk of the prompts at 0, 64, 128 and 192 tokens in), over
# the serving grid's 512-block tables.
CHUNK = 64
CHUNK_LENGTHS = (0, 64, 128, 192)


def paged_inputs(torch, ops, dev, lengths=None, max_blocks=512, width=1,
                 per_block=False):
    """The paged kernel's arguments (a window of `width`, bf16 q, NaN
    scales in the trash block 0, the live blocks of each table drawn from
    a permutation and the rest pointing at the trash), the bytes its call
    must move and its flops. `lengths` None draws 8 from seed 0. With
    `per_block` the pools carry one scale a (block, kv head) — scale
    pools [NB, 1, Hkv, 1], each block's rows of a head quantized as one
    group by the plain version — in place of one a row."""
    n_heads, n_kv, head_dim, bs = 32, 8, 128, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    slots = 8 if lengths is None else len(lengths)
    num_blocks = slots * max_blocks + 1

    def quantize(x):
        if not per_block:
            return ops.quantize.quantize_int8_reference(x)
        grouped = x.permute(0, 2, 1, 3).reshape(num_blocks, n_kv, 1,
                                                bs * head_dim)
        values, scales = ops.quantize.quantize_int8_reference(grouped)
        return (values.reshape(num_blocks, n_kv, bs, head_dim)
                .permute(0, 2, 1, 3).contiguous(),
                scales.reshape(num_blocks, 1, n_kv, 1))

    x = torch.randn(num_blocks, bs, n_kv, head_dim, device=dev, generator=gen)
    kq, ks = quantize(x * 2)
    vq, vs = quantize(torch.randn(x.shape, device=dev, generator=gen))
    del x
    ks[0] = float("nan")  # trash-block garbage must never leak
    vs[0] = float("nan")
    if lengths is None:
        lengths = torch.randint(1, 4097, (slots,), device=dev, generator=gen,
                                dtype=torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    perm = torch.randperm(num_blocks - 1, device=dev, generator=gen) + 1
    tables = perm[:slots * max_blocks].reshape(slots, max_blocks).to(torch.int32)
    live = (lengths.long() + width + bs - 1) // bs
    cols = torch.arange(max_blocks, device=dev)[None, :]
    tables = torch.where(cols < live[:, None], tables, torch.zeros_like(tables))
    q = torch.randn(slots, width, n_heads, head_dim, device=dev,
                    generator=gen).to(torch.bfloat16)
    # Each slot's live positions are read once (its window included):
    # K and V int8 rows plus their f32 scales (one a row, or one a live
    # block), the live table entries, q and the output once; 4 flops per
    # position, head and column.
    positions = int((lengths.long() + width).sum())
    scale_rows = int(live.sum()) if per_block else positions
    n_bytes = (positions * n_kv * 2 * head_dim + scale_rows * n_kv * 2 * 4
               + int(live.sum()) * 4 + slots * 4
               + 2 * q.numel() * q.element_size())
    n_flops = sum(int(lengths[s]) * width + width * (width + 1) // 2
                  for s in range(slots)) * n_heads * head_dim * 4
    return (q, kq, ks, vq, vs, tables, lengths), n_bytes, n_flops


def dense_inputs(torch, ops, dev, lengths, seq=8192, n_heads=32, n_kv=8):
    """The dense kernel's arguments over a cache of `seq` rows whose dead
    rows carry NaN scales, with these lengths and head counts; the bytes
    and flops."""
    batch, head_dim = len(lengths), 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(batch, seq, n_kv, head_dim, device=dev, generator=gen)
    kq, ks = ops.quantize.quantize_int8_reference(x * 2)
    vq, vs = ops.quantize.quantize_int8_reference(
        torch.randn(x.shape, device=dev, generator=gen))
    del x
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dead = (torch.arange(seq, device=dev)[None, :]
            >= lengths.long()[:, None])[:, :, None, None]
    ks = torch.where(dead, float("nan"), ks)  # dead rows must never leak
    vs = torch.where(dead, float("nan"), vs)
    del dead
    q = torch.randn(batch, n_heads, head_dim, device=dev,
                    generator=gen).to(torch.bfloat16)
    # Each row's live positions read once: K and V int8 rows and their
    # f32 scales, the lengths, q and the output; 4 flops per position,
    # query head and column.
    positions = int(lengths.long().sum())
    n_bytes = (positions * n_kv * (2 * head_dim + 2 * 4) + batch * 4
               + 2 * q.numel() * q.element_size())
    return ((q, kq, ks, vq, vs, lengths), n_bytes,
            positions * n_heads * head_dim * 4)


def _serving_shape(torch, fn, args, n_bytes, n_flops):
    """A decode kernel's cold and warm time and bound at the serving
    slice's shape, in microseconds."""
    return {"lengths": args[-1].tolist(),
            **shape_times(torch, fn, args, n_bytes, n_flops)}


def check_attention(torch, ops, dev):
    attend = ops.decode_attention.paged_int8_window_attention
    plain = ops.decode_attention.paged_int8_window_attention_reference
    args, n_bytes, n_flops = paged_inputs(torch, ops, dev)
    q, kq, ks, vq, vs, tables, lengths = args
    got = attend(*args)
    ref = plain(*args)
    again = attend(*args)
    torch.cuda.synchronize()
    # atol = rtol = 2e-2: a bf16 output, sums in another order.
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if not torch.equal(got, again):
        raise AssertionError("paged attention: two calls differ")
    row = {
        "name": "paged_int8_window_attention", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "tf_yarn_tpu/ops/decode_attention.py:199",
        "shape": {"slots": len(lengths), "width": q.shape[1],
                  "lengths": lengths.tolist(), "block_size": kq.shape[1],
                  "max_blocks": tables.shape[1]},
        "tolerance": "atol = rtol = 2e-2 (bf16 output)",
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
        "one_launch": {
            "window": one_launch(torch, attend, args, "decode_kernel"),
            "one_token": one_launch(
                torch, ops.decode_attention.paged_int8_decode_attention,
                (q[:, 0].contiguous(), *args[1:]), "decode_kernel")},
    }
    row.update(timings(attend, plain, None, args, n_bytes, torch,
                       plain_inner=8))
    row["kernel_us_per_call"] = device_kernels_us(torch, attend, args, n_bytes)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops)
    del args, got, ref, again
    serving, n_bytes, n_flops = paged_inputs(torch, ops, dev, SERVING_LENGTHS,
                                             max_blocks=32)
    torch.testing.assert_close(attend(*serving).float(),
                               plain(*serving).float(), atol=2e-2, rtol=2e-2)
    row["shape_serving"] = _serving_shape(torch, attend, serving, n_bytes,
                                          n_flops)
    del serving
    chunk, n_bytes, n_flops = paged_inputs(torch, ops, dev, CHUNK_LENGTHS,
                                           width=CHUNK)
    torch.testing.assert_close(attend(*chunk).float(), plain(*chunk).float(),
                               atol=2e-2, rtol=2e-2)
    row["shape_chunk"] = dict(_serving_shape(torch, attend, chunk, n_bytes,
                                             n_flops), width=CHUNK)
    del chunk
    row["per_block"] = check_attention_per_block(torch, ops, dev)
    return row


def check_attention_per_block(torch, ops, dev) -> dict:
    """Both paged wrappers over per-block scale pools (sb = 1, NaN scales
    in the trash block): the one-token and the window form at phase 3's
    shape, and the window at W = CHUNK on the chunk shape; each against
    the plain version on the same inputs (2e-2, a bf16 output), bitwise
    equal over two calls, one CUDA launch a call, timed cold and warm
    against its bound (its scale stream 1/16 of the per-row one)."""
    window = ops.decode_attention.paged_int8_window_attention
    one_token = ops.decode_attention.paged_int8_decode_attention
    plain = ops.decode_attention.paged_int8_window_attention_reference
    out = {}
    args, n_bytes, n_flops = paged_inputs(torch, ops, dev, per_block=True)
    q, kq, ks, vq, vs, tables, lengths = args
    one_args = (q[:, 0].contiguous(), *args[1:])
    one_plain = lambda q, *rest: plain(q[:, None], *rest,
                                       length_offset=0)[:, 0]
    cases = (("window", window, plain, args),
             ("one_token", one_token, one_plain, one_args))
    for name, fn, ref_fn, call_args in cases:
        got, again, ref = fn(*call_args), fn(*call_args), ref_fn(*call_args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        if not torch.isfinite(got).all() or not torch.equal(got, again):
            raise AssertionError(f"per-block {name}: not finite, or two "
                                 "calls differ")
        # The one-token form reads each slot's lengths positions, not
        # lengths + 1: its bytes and flops are the window's less a row.
        fewer = 0 if name == "window" else len(lengths) * kq.shape[2] * (
            2 * kq.shape[3])
        out[name] = {
            "scale_shape": list(ks.shape),
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "tolerance": "atol = rtol = 2e-2 (bf16 output)",
            "one_launch": one_launch(torch, fn, call_args, "decode_kernel"),
            **shape_times(torch, fn, call_args, n_bytes - fewer, n_flops,
                          profile=False),
            "plain_us": time_ms(ref_fn, torch, inner=1, outer=2,
                                arg_sets=cold_copies(call_args,
                                                     n_bytes)) * 1e3,
        }
        del got, again, ref
    del args, one_args
    chunk, n_bytes, n_flops = paged_inputs(torch, ops, dev, CHUNK_LENGTHS,
                                           width=CHUNK, per_block=True)
    got, again, ref = window(*chunk), window(*chunk), plain(*chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if not torch.isfinite(got).all() or not torch.equal(got, again):
        raise AssertionError("per-block chunk window: not finite, or two "
                             "calls differ")
    out["chunk_window"] = {
        "width": CHUNK, "lengths": chunk[-1].tolist(),
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
        "one_launch": one_launch(torch, window, chunk, "decode_kernel"),
        **shape_times(torch, window, chunk, n_bytes, n_flops, profile=False)}
    return out


def check_dense_attention(torch, ops, dev, paged_lengths):
    """The dense int8 decode kernel at the paged row's slots and lengths
    (each row attends over its paged length + its own token, so the two
    rows read the same cache bytes), over a dense cache of 8192 rows
    whose dead rows carry NaN scales."""
    attend = ops.decode_attention.int8_decode_attention
    plain = ops.decode_attention.int8_decode_attention_reference
    args, n_bytes, n_flops = dense_inputs(
        torch, ops, dev, [n + 1 for n in paged_lengths])
    got = attend(*args)
    ref = plain(*args)
    again = attend(*args)
    torch.cuda.synchronize()
    # atol = rtol = 2e-2: a bf16 output, sums in another order.
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if not torch.equal(got, again):
        raise AssertionError("dense attention: two calls differ")
    q, kq = args[0], args[1]
    row = {
        "name": "int8_decode_attention", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/dense_decode.cu",
        "replaces": "tf_yarn_tpu/ops/decode_attention.py:50",
        "shape": {"batch": q.shape[0], "seq": kq.shape[1],
                  "lengths": args[-1].tolist(), "heads": q.shape[1],
                  "kv_heads": kq.shape[2], "head_dim": q.shape[2]},
        "tolerance": "atol = rtol = 2e-2 (bf16 output)",
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
        "one_launch": one_launch(torch, attend, args, "decode_kernel"),
    }
    row.update(timings(attend, plain, None, args, n_bytes, torch,
                       plain_inner=8))
    row["kernel_us_per_call"] = device_kernels_us(torch, attend, args, n_bytes)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops)
    del args, got, ref, again
    # The serving shape over a 512-row cache: the kernel reads live rows
    # only, and 512 keeps the cold copies small.
    serving, n_bytes, n_flops = dense_inputs(
        torch, ops, dev, [n + 1 for n in SERVING_LENGTHS], seq=512)
    torch.testing.assert_close(attend(*serving).float(),
                               plain(*serving).float(), atol=2e-2, rtol=2e-2)
    row["shape_serving"] = _serving_shape(torch, attend, serving, n_bytes,
                                          n_flops)
    del serving
    # A tp=2 rank's share of the same tick: its 16 query and 4 kv heads
    # (GQA group 4, the bf16 instantiation), two calls bit-equal, one
    # launch a call.
    rank, n_bytes, n_flops = dense_inputs(
        torch, ops, dev, [n + 1 for n in SERVING_LENGTHS], seq=512,
        n_heads=16, n_kv=4)
    got, again, ref = attend(*rank), attend(*rank), plain(*rank)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if not torch.equal(got, again):
        raise AssertionError("dense attention at the tp rank's shape: two "
                             "calls differ")
    row["shape_tp_rank"] = {
        "heads": 16, "kv_heads": 4,
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
        "bitwise_two_calls": True,
        "one_launch": one_launch(torch, attend, rank, "decode_kernel"),
        **_serving_shape(torch, attend, rank, n_bytes, n_flops)}
    return row


# The training slice's attention and norm shapes (Llama-3-8B widths, one
# sequence of 2048 tokens).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_HEADS, TRAIN_KV_HEADS, TRAIN_HEAD_DIM = (
    1, 2048, 32, 8, 128)


def _leaves(torch, args):
    """Copies of `args` that are leaves requiring grad (library yardsticks
    differentiate with respect to them)."""
    return tuple(a.detach().clone().requires_grad_(a.is_floating_point())
                 for a in args)


def check_rmsnorm_dx(torch, ops, dev):
    rows, d = TRAIN_BATCH * TRAIN_SEQ, 4096
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = (torch.randn(rows, d, device=dev, generator=gen) * 3).to(torch.bfloat16)
    g = torch.randn(rows, d, device=dev, generator=gen).to(torch.bfloat16)
    scale = torch.rand(d, device=dev, generator=gen) + 0.5
    got = ops.rmsnorm.rmsnorm_bwd_dx(x, g, scale, 1e-5)
    ref = ops.rmsnorm.rmsnorm_bwd_dx_reference(x, g, scale, 1e-5)
    torch.cuda.synchronize()
    # rtol 1/128: one bf16 ulp of the output; atol 1% of the largest
    # entry: the two terms of dx cancel, and their f32 sums run in
    # another order.
    torch.testing.assert_close(got.float(), ref.float(), rtol=1 / 128,
                               atol=1e-2 * float(ref.float().abs().max()))
    row = {
        "name": "rmsnorm_bwd_dx", "route": "cuda",
        "source": "tf_yarn_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "tf_yarn_tpu/ops/rmsnorm.py:55",
        "shape": [rows, d], "tolerance": "rtol 1/128, atol 1e-2 * max|dx|",
        "max_abs_err": float((got.float() - ref.float()).abs().max()),
    }
    n = rows * d
    n_bytes = 3 * n * 2 + d * 4
    row.update(timings(
        lambda x, g, scale: ops.rmsnorm.rmsnorm_bwd_dx(x, g, scale, 1e-5),
        lambda x, g, scale: ops.rmsnorm.rmsnorm_bwd_dx_reference(x, g, scale, 1e-5),
        None, (x, g, scale), n_bytes, torch))
    weight = scale.to(torch.bfloat16)

    def forward(x, g):
        y = torch.nn.functional.rms_norm(x, (d,), weight=weight, eps=1e-5)
        return y, x, g

    sets = [_leaves(torch, (x, g)) for _ in range(len(cold_copies((x,), n_bytes)))]
    row["library_ms"], row["library_fwd_bwd_ms"] = backward_ms(forward, torch, sets)
    row["library"] = "F.rms_norm backward (autograd), dx"
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 8 * n)
    return row


def _live_pairs(s_q: int, s_kv: int, causal: bool = True) -> int:
    """(query, key) pairs the causal mask keeps — the work these inputs
    need."""
    if not causal:
        return s_q * s_kv
    return sum(min(i + 1, s_kv) for i in range(s_q))


# Phase 9 (h)'s sequence, and its flash calls: a Ulysses rank's 16 of 32
# query heads and 4 of 8 kv heads over the whole sequence.
SP_SEQ = 8192
SP_FLASH_SHAPE = (1, SP_SEQ, TRAIN_HEADS // 2, TRAIN_KV_HEADS // 2,
                  TRAIN_HEAD_DIM)

# o, dq, dk, dv: the error's norm within FLASH_TOL of the reference's over
# every 64-row block of the sequence, so no one large row sets the scale
# (bf16 outputs round at 2^-9 relative, and p / ds round to bf16 at
# running maxima that differ between the kernels' 64-row tiles and the
# plain version's whole-row softmax). The LSE is f32 from exact bf16
# products: FLASH_LSE_TOL absolute.
FLASH_TOL, FLASH_LSE_TOL = 1e-2, 1e-4


def flash_errors(torch, flash, dev, shape, seed: int, tag: str):
    """The three flash kernels against their plain versions on seeded bf16
    inputs of `shape` (B, S, H, Hkv, D), causal: raises past FLASH_TOL or
    FLASH_LSE_TOL, or when a second dq or dk/dv call gives other bits.
    Returns ({"fwd" | "dq" | "dkv": errors}, (q, k, v, dout, lse,
    delta))."""
    b, s, h, hkv, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *dims: torch.randn(*dims, device=dev, generator=gen).to(
        torch.bfloat16)
    q, k, v, dout = mk(b, s, h, d), mk(b, s, hkv, d), mk(b, s, hkv, d), mk(b, s, h, d)
    out, lse = flash.flash_fwd(q, k, v)
    ref_out, ref_lse = flash.flash_fwd_reference(q, k, v)
    delta = flash.flash_delta(ref_out, dout)
    dq = flash.flash_dq(q, k, v, dout, ref_lse, delta)
    dk, dv = flash.flash_dkv(q, k, v, dout, ref_lse, delta)
    # dk/dv's two blocks a kv tile meet in whichever order they finish,
    # and dq's blocks add no atomics: a second call must give the same
    # bits.
    dq2 = flash.flash_dq(q, k, v, dout, ref_lse, delta)
    dk2, dv2 = flash.flash_dkv(q, k, v, dout, ref_lse, delta)
    if not torch.equal(dq, dq2):
        raise AssertionError(f"flash_dq {tag}: two calls gave different dq")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(
            f"flash_dkv {tag}: two calls gave different dk or dv")
    del dq2, dk2, dv2
    log(f"  {tag}: dq, dk, dv: two calls bitwise equal")
    found = {"o": err_blocks(torch, out, ref_out, f"{tag} o")}
    del out, ref_out
    found["dq"] = err_blocks(
        torch, dq, flash.flash_dq_reference(q, k, v, dout, ref_lse, delta),
        f"{tag} dq")
    del dq
    ref_dk, ref_dv = flash.flash_dkv_reference(q, k, v, dout, ref_lse, delta)
    found["dk"] = err_blocks(torch, dk, ref_dk, f"{tag} dk")
    found["dv"] = err_blocks(torch, dv, ref_dv, f"{tag} dv")
    del dk, dv, ref_dk, ref_dv
    lse_err = float((lse - ref_lse).abs().max())
    log(f"  {tag} lse: max abs err {lse_err:.3g} (bound {FLASH_LSE_TOL})")
    if not lse_err <= FLASH_LSE_TOL:
        raise AssertionError(f"{tag} lse: max abs err {lse_err} > "
                             f"{FLASH_LSE_TOL}")
    pick = {"fwd": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}
    errs = {key: {"max_abs_err": max(found[n][0] for n in names),
                  "block_rel_err": max(found[n][1] for n in names)}
            for key, names in pick.items()}
    errs["fwd"]["lse_max_abs_err"] = lse_err
    errs["dq"]["bitwise_deterministic"] = True
    errs["dkv"]["bitwise_deterministic"] = True
    return errs, (q, k, v, dout, ref_lse, delta)


def err_blocks(torch, got, ref, name):
    """(max abs error, the largest error norm over reference norm of a
    64-row block of the sequence dim 1); raises past FLASH_TOL."""
    diff, ref = got.float() - ref.float(), ref.float()
    b, s = ref.shape[:2]
    blocks = lambda t: t.reshape(b, s // 64, -1).norm(dim=-1)
    e, n = blocks(diff), blocks(ref)
    ratio = torch.where(n > 0, e / n.clamp_min(1e-30),
                        torch.where(e == 0, 0.0, float("inf")))
    rel = float(ratio.max())
    worst = float(diff.abs().max())
    log(f"  {name}: block rel err {rel:.3g} (bound {FLASH_TOL}), "
        f"max abs err {worst:.3g}")
    if not rel <= FLASH_TOL:
        raise AssertionError(f"{name}: block rel err {rel} > {FLASH_TOL}")
    return worst, rel


def check_flash(torch, ops, dev):
    """The three flash kernels at the training slice's shapes, timed, and
    at phase 9 (h)'s Ulysses shape (SP_FLASH_SHAPE), checked; returns
    their three rows."""
    flash = ops.flash_attention
    sp_errs, _ = flash_errors(torch, flash, dev, SP_FLASH_SHAPE, SEED + 10,
                              "ulysses S 8192")
    torch.cuda.empty_cache()
    train_shape = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_HEADS, TRAIN_KV_HEADS,
                   TRAIN_HEAD_DIM)
    b, s, h, hkv, d = train_shape
    errs, (q, k, v, dout, ref_lse, delta) = flash_errors(
        torch, flash, dev, train_shape, SEED + 9, "training")
    tol, lse_tol = FLASH_TOL, FLASH_LSE_TOL
    live = _live_pairs(s, s)
    qb = q.numel() * 2
    kvb = k.numel() * 2
    stat = b * h * s * 4
    shape = {"batch": b, "seq": s, "heads": h, "kv_heads": hkv,
             "head_dim": d, "dtype": "bf16", "causal": True}
    base = {"route": "cuda", "source": "tf_yarn_tpu_torch/ops/csrc/flash_attention.cu",
            "shape": shape,
            "tolerance": (f"error norm <= {tol} x reference norm over every "
                          f"64-row block; lse {lse_tol} absolute")}
    # Bytes: every input read once, every output written once.
    specs = {
        "fwd": ("flash_fwd", "tf_yarn_tpu/ops/flash_attention.py:80",
                lambda q, k, v, dout, lse, delta: flash.flash_fwd(q, k, v),
                lambda q, k, v, dout, lse, delta: flash.flash_fwd_reference(q, k, v),
                2 * qb + 2 * kvb + stat, 4 * live * d * h),
        "dq": ("flash_dq", "tf_yarn_tpu/ops/flash_attention.py:240",
               flash.flash_dq, flash.flash_dq_reference,
               3 * qb + 2 * kvb + 2 * stat, 6 * live * d * h),
        "dkv": ("flash_dkv", "tf_yarn_tpu/ops/flash_attention.py:285",
                flash.flash_dkv, flash.flash_dkv_reference,
                2 * qb + 4 * kvb + 2 * stat, 8 * live * d * h),
    }
    args = (q, k, v, dout, ref_lse, delta)
    n_sets = len(cold_copies(args, 2 * qb + 2 * kvb))
    sets = [_leaves(torch, (q, k, v, dout)) for _ in range(n_sets)]

    def sdpa(q, k, v, dout):
        o = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        return o, (q, k, v), dout.transpose(1, 2)

    with torch.no_grad():
        sdpa_fwd = time_ms(lambda *a: sdpa(*a)[0], torch, inner=2, arg_sets=sets)
    sdpa_bwd, sdpa_both = backward_ms(sdpa, torch, sets)
    rows = []
    for key, (name, replaces, fn, plain, n_bytes, n_flops) in specs.items():
        row = dict(base, name=name, replaces=replaces, **errs[key])
        row["ulysses_shape"] = dict(zip(("batch", "seq", "heads",
                                         "kv_heads", "head_dim"),
                                        SP_FLASH_SHAPE), **sp_errs[key])
        row.update(timings(fn, plain, None, args, n_bytes, torch, plain_inner=4))
        if key == "fwd":
            row["library_ms"] = sdpa_fwd
            row["library"] = "F.scaled_dot_product_attention forward"
        else:
            row["library_ms"] = sdpa_bwd
            row["library"] = ("F.scaled_dot_product_attention backward "
                              "(dq, dk, dv together)")
            row["library_fwd_bwd_ms"] = sdpa_both
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops,
                                                    H100_BF16_FLOPS)
        rows.append(row)
    return rows


# The zoo slice's norm shapes: LayerNorm rows of BERT-base (32 x 128
# tokens, eps 1e-12) and ViT-B/16 (128 images x 197 tokens, eps 1e-6),
# 768 wide; GroupNorm slabs of ResNet-50 at batch 128, 32 groups, eps
# 1e-6, as (side, C): the number of each of its 53 GroupNorms a step
# (models/resnet.py: the stem, then stages of 3, 4, 6 and 3
# bottlenecks). The GroupNorm forward and backward are timed at all 12,
# their plain versions at the stem's 112x112x64 and the last stage's
# 7x7x2048 (GN_PLAIN_SHAPES). The first shape of each is the kernel's
# row; the others' numbers go beside it.
LN_SHAPES = {"bert_base": (32 * 128, 768, 1e-12),
             "vit_b16": (128 * 197, 768, 1e-6)}
GN_BATCH, GN_GROUPS = 128, 32
RESNET50_GN = {(112, 64): 1, (56, 64): 6, (56, 256): 4, (56, 128): 1,
               (28, 128): 7, (28, 512): 5, (28, 256): 1, (14, 256): 11,
               (14, 1024): 7, (14, 512): 1, (7, 512): 5, (7, 2048): 4}
GN_PLAIN_SHAPES = {(112, 64): "stem", (7, 2048): "stage4"}


def _norm_rows(specs, torch):
    """Kernel rows from ``{name: (row, timing args)}`` specs: each row
    timed at every shape, the first shape's numbers as the row's own and
    the others' under ``other_shapes``."""
    rows = []
    for name, per_shape in specs.items():
        row = None
        for key, (fields, fn, plain, library, args, n_bytes, n_flops,
                  library_bwd) in per_shape.items():
            timed = timings(fn, plain, library, args, n_bytes, torch)
            if library_bwd is not None:
                sets = [_leaves(torch, args[:2])
                        for _ in range(len(cold_copies(args, n_bytes)))]
                timed["library_ms"], timed["library_fwd_bwd_ms"] = backward_ms(
                    library_bwd, torch, sets)
            timed["bound_ms"], timed["bound_by"] = bound_ms(n_bytes, n_flops)
            timed.update(fields)
            if row is None:
                row = dict(timed, name=name, other_shapes={})
            else:
                row["other_shapes"][key] = timed
        rows.append(row)
    return rows


def check_ln_backward(torch, ln, got, x, g, scale, eps):
    """(dx, dscale, dbias) from the kernels against the plain backward;
    returns the largest absolute error of each. dx: one bf16 ulp plus
    cancellation between its terms, atol 1e-2 of the largest entry;
    dscale and dbias: f32 sums over the rows in another order than
    torch.sum's, rtol 1e-5 and, column by column, atol 1e-5 of the sum
    of the terms' magnitudes (a sum near 0 of large terms): g·x·r and
    g·mean·r for dscale (norm is their difference, and the two row
    means differ by f32 rounding), g for dbias."""
    ref = ln.layernorm_bwd_reference(x, g, scale, eps)
    d = x.shape[-1]
    x32, g32 = x.float().reshape(-1, d), g.float().reshape(-1, d)
    mean = x32.mean(-1, keepdim=True)
    centered = x32 - mean
    r = torch.rsqrt((centered * centered).mean(-1, keepdim=True) + eps)
    torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=1 / 128,
                               atol=1e-2 * float(ref[0].float().abs().max()))
    for name, out, want, terms in (
            ("dscale", got[1], ref[1],
             g32.abs() * (x32.abs() + mean.abs()) * r),
            ("dbias", got[2], ref[2], g32.abs())):
        bound = 1e-5 * want.abs() + 1e-5 * terms.sum(0)
        if not bool(((out - want).abs() <= bound).all()):
            raise AssertionError(f"layernorm_backward {name}: max abs err "
                                 f"{float((out - want).abs().max())} over "
                                 f"rtol 1e-5, atol 1e-5 * sum|terms|")
    return {name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("dx", "dscale", "dbias"), got, ref)}


def check_layernorm(torch, ops, dev):
    """The LayerNorm forward and its whole backward (dx, dscale, dbias) at
    BERT-base's and ViT-B/16's rows (bf16); returns their two rows, each
    timed cold and warm at both shapes. The forward is held against its
    plain version, bitwise equal over two calls, and one call at each
    shape must be one launch of the row kernel. The backward is held
    against its plain version, bitwise equal over two calls, and its
    device kernels one call at each shape launched must be its two and
    nothing else; its library yardstick is F.layer_norm's autograd
    backward for x, weight and bias."""
    ln = ops.layernorm
    layer_norm = torch.nn.functional.layer_norm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    specs = {"layernorm": {}, "layernorm_backward": {}}
    backwards = []
    for key, (rows, d, eps) in LN_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + rows)
        x = (torch.randn(rows, d, device=dev, generator=gen) * 3 + 1).to(
            torch.bfloat16)
        g = torch.randn(rows, d, device=dev, generator=gen).to(torch.bfloat16)
        scale = torch.rand(d, device=dev, generator=gen) + 0.5
        bias = torch.randn(d, device=dev, generator=gen)
        y = ln._forward(x, scale, bias, eps)
        y_again = ln._forward(x, scale, bias, eps)
        got = ln.layernorm_backward(x, g, scale, eps)
        again = ln.layernorm_backward(x, g, scale, eps)
        ref_y = ln.layernorm_reference(x, scale, bias, eps)
        torch.cuda.synchronize()
        # y: one bf16 ulp (f32 sums in another order).
        torch.testing.assert_close(y.float(), ref_y.float(), rtol=1 / 128,
                                   atol=1e-5)
        if not torch.equal(y, y_again):
            raise AssertionError(f"layernorm {key}: two calls gave different y")
        forward_launch = one_launch(
            torch, lambda x, s, b, eps=eps: ln._forward(x, s, b, eps),
            (x, scale, bias), "layernorm_row_kernel")
        errors = check_ln_backward(torch, ln, got, x, g, scale, eps)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("layernorm_backward: two calls gave "
                                 "different dx, dscale or dbias")
        del got, again
        backwards.append((x, g, scale, eps))
        n = rows * d
        weight, wbias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        base = {"route": "cuda",
                "source": "tf_yarn_tpu_torch/ops/csrc/layernorm.cu",
                "shape": {"rows": rows, "d": d, "eps": eps, "dtype": "bf16",
                          "model": key}}

        def library_bwd(x, g, d=d, eps=eps,
                        weight=weight.clone().requires_grad_(),
                        wbias=wbias.clone().requires_grad_()):
            return layer_norm(x, (d,), weight, wbias, eps), (x, weight, wbias), g

        # Bytes: x read and y written (the backward: x and g read, dx
        # written), the f32 vectors once (scale read, dscale and dbias
        # written); ~8 (~18) f32 operations an element. The backward's
        # [P, d, 2] f32 partials, written and read, are its kernels' own
        # traffic, not the function's: printed beside the bound.
        specs["layernorm"][key] = (
            dict(base, replaces="tf_yarn_tpu/ops/layernorm.py:36",
                 tolerance="rtol 1/128 (one bf16 ulp), atol 1e-5",
                 max_abs_err=float((y.float() - ref_y.float()).abs().max()),
                 bitwise_deterministic=True, one_launch=forward_launch,
                 library="F.layer_norm"),
            lambda x, s, b, eps=eps: ln._forward(x, s, b, eps),
            lambda x, s, b, eps=eps: ln.layernorm_reference(x, s, b, eps),
            lambda x, s, b, d=d, eps=eps, weight=weight, wbias=wbias:
                layer_norm(x, (d,), weight, wbias, eps),
            (x, scale, bias), 2 * n * 2 + 2 * d * 4, 8 * n, None)
        blocks = ln.layernorm_bwd_blocks(rows, sms)
        specs["layernorm_backward"][key] = (
            dict(base, replaces="tf_yarn_tpu/ops/layernorm.py:61 (dx) and "
                                ":102-111 (dscale, dbias)",
                 tolerance="dx rtol 1/128, atol 1e-2 * max|dx|; dscale, "
                           "dbias rtol 1e-5, atol 1e-5 * sum|terms| a column",
                 max_abs_err=errors["dx"], max_abs_err_params=errors,
                 bitwise_deterministic=True,
                 library="F.layer_norm backward (autograd): dx, dweight, dbias",
                 cuda_launches_per_call=2, blocks=blocks,
                 partials_bytes=2 * blocks * d * 2 * 4),
            lambda x, g, s, eps=eps: ln.layernorm_backward(x, g, s, eps),
            lambda x, g, s, eps=eps: ln.layernorm_bwd_reference(x, g, s, eps),
            None, (x, g, scale), 3 * n * 2 + 3 * d * 4, 18 * n, library_bwd)
    # One call at each shape: the kernels the device ran.
    launched = kernel_launch_counts(torch, lambda: [
        ln.layernorm_backward(*args) for args in backwards],
        wrapper=ln.layernorm_backward, calls=len(backwards),
        expect=2 * len(backwards))
    if not all("layernorm" in k for k in launched) \
            or sum(launched.values()) != 2 * len(backwards):
        raise AssertionError(f"layernorm_backward launched {launched} at "
                             f"{len(backwards)} shapes, planned 2 a call")
    del backwards
    rows = _norm_rows(specs, torch)
    rows[1]["device_kernels_2_calls"] = launched
    first = next(iter(LN_SHAPES))
    for key, r in {first: rows[0], **rows[0]["other_shapes"]}.items():
        log(f"  layernorm {key}: {r['ms'] * 1e3:.2f} us cold, "
            f"{r['warm_ms'] * 1e3:.2f} warm, F.layer_norm "
            f"{r['library_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.2f} "
            f"({r['bound_ms'] / r['ms']:.0%} of it), one launch "
            f"{r['one_launch']}")
    for key, r in {first: rows[1], **rows[1]["other_shapes"]}.items():
        log(f"  layernorm_backward {key}: {r['ms'] * 1e3:.2f} us cold, "
            f"{r['warm_ms'] * 1e3:.2f} warm, F.layer_norm backward "
            f"{r['library_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.2f} "
            f"(+ partials {r['partials_bytes']} bytes, "
            f"{r['partials_bytes'] / H100_BYTES_PER_S * 1e6:.2f} us), "
            f"{r['blocks']} blocks" + (
                "; slower than F.layer_norm's backward"
                if r["ms"] > r["library_ms"] else ""))
    return rows


def kernel_launch_counts(torch, run, wrapper=None, calls: int = 0,
                         expect: int = 1) -> dict:
    """Device kernels `run()` launched, by name, under torch.profiler. A
    profiler session on the card can lose launches after it starts, so
    each session first runs three spin kernels (`torch.cuda._sleep`, left
    out of the counts) and waits for them. Without `wrapper`, a session
    that saw no kernel of `run` is run again after a pause, up to six
    times (three sessions in a row once saw nothing). With `wrapper` (the
    function whose ``launches`` counts its calls that launched), the
    session also reads that counter across `run()`: short of `calls`, it
    raises at once (the wrapper skipped a launch); at `calls`, a session
    whose profiler saw fewer than `expect` device kernels lost launches
    (one saw 2 of a LayerNorm backward's 4) and is run again. The caller
    checks the counts of the last session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            before = wrapper.launches if wrapper is not None else 0
            run()
            torch.cuda.synchronize()
        if wrapper is not None and wrapper.launches - before != calls:
            raise AssertionError(
                f"{wrapper.__name__} launched {wrapper.launches - before} "
                f"times in {calls} calls")
        ran = {event.key: event.count for event in prof.key_averages()
               if event.device_type == DeviceType.CUDA and event.count
               and not getattr(event, "is_user_annotation", False)
               and "spin_kernel" not in event.key}
        if sum(ran.values()) >= expect:
            break
    return ran


def check_gn_backward(torch, gn, got, x, g, scale, stats, groups):
    """(dx, dscale, dbias) from the kernels against the plain backward
    from the same statistics; returns the largest absolute error of each.
    dx: one bf16 ulp plus cancellation, atol 1e-2 of the largest entry;
    dscale and dbias: f32 sums over B x HW positions whose longest chain
    of additions is under 64 in either version, rtol 1e-5 and atol 1e-5
    of the sum of the terms' magnitudes (a sum near 0 of large terms)."""
    ref = gn.groupnorm_bwd_reference(x, g, scale, stats, groups)
    c = x.shape[-1]
    g32 = g.float().reshape(-1, c).abs()
    norm = gn._normalize(x, stats, groups).reshape(-1, c).abs()
    torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=1 / 128,
                               atol=1e-2 * float(ref[0].float().abs().max()))
    for out, want, terms in ((got[1], ref[1], g32 * norm),
                             (got[2], ref[2], g32)):
        torch.testing.assert_close(out, want, rtol=1e-5,
                                   atol=1e-5 * float(terms.sum(0).max()))
    return {name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("dx", "dscale", "dbias"), got, ref)}


def _resnet50_step(row) -> dict:
    """A GroupNorm row's launch-weighted sums over ResNet-50's 53 calls a
    step, from its numbers at the 12 shapes."""
    shapes = [row, *row["other_shapes"].values()]
    return {
        "calls": sum(r["resnet50_calls"] for r in shapes),
        "cuda_launches": sum(r["resnet50_calls"] * r["cuda_launches_per_call"]
                             for r in shapes),
        **{f: sum(r["resnet50_calls"] * r[f] for r in shapes)
           for f in ("ms", "warm_ms", "bound_ms", "library_ms")}}


def check_groupnorm(torch, ops, dev):
    """The GroupNorm forward and backward (dx, dscale, dbias) at
    ResNet-50's 12 slab shapes (bf16, NHWC), each held against its plain
    version; returns their two rows, each with ResNet-50's launch-weighted
    sum a step and the device kernels one call at each shape launched,
    which must be the plan's and, for the backward, nothing else (no
    plain reduction). The library yardstick is F.group_norm on the same
    storage seen as channels-last NCHW, the layout the port keeps its
    activations in; its backward takes the gradients of x, weight and
    bias."""
    gn = ops.groupnorm
    group_norm = torch.nn.functional.group_norm
    nchw = lambda t: t.permute(0, 3, 1, 2)  # channels-last NCHW view
    groups = GN_GROUPS
    specs = {"groupnorm": {}, "groupnorm_backward": {}}
    forwards, backwards = [], []
    for (side, c), calls in RESNET50_GN.items():
        shape = (GN_BATCH, side, side, c)
        key = f"{side}x{side}x{c}"
        gen = torch.Generator(device=dev).manual_seed(SEED + c + side)
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(
            torch.bfloat16)
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen)
        y, stats = gn.groupnorm_forward(x, scale, bias, groups, 1e-6)
        ref_stats = gn.groupnorm_stats_reference(x, groups, 1e-6)
        ref_y = gn.groupnorm_reference(x, scale, bias, groups, 1e-6)
        torch.cuda.synchronize()
        # The kernel's statistics against the plain two-pass ones (f32
        # over up to 25,088 elements); y one bf16 ulp.
        torch.testing.assert_close(stats, ref_stats, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y.float(), ref_y.float(), rtol=1 / 128,
                                   atol=1e-5)
        max_err = float((y.float() - ref_y.float()).abs().max())
        del y, stats, ref_y
        n = x.numel()
        weight, wbias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        base = {"route": "cuda",
                "source": "tf_yarn_tpu_torch/ops/csrc/groupnorm.cu",
                "shape": {"nhwc": list(shape), "groups": groups, "eps": 1e-6,
                          "dtype": "bf16", "slab": key},
                "resnet50_calls": calls}
        plain = (side, c) in GN_PLAIN_SHAPES
        plan = gn.groupnorm_plan(GN_BATCH, side * side, c, groups, 2)
        # Bytes: x read and y written, the vectors and the [B, G, 2]
        # statistics once.
        stats_bytes = GN_BATCH * groups * 8
        forwards.append((x, scale, bias))
        specs["groupnorm"][key] = (
            dict(base, replaces="tf_yarn_tpu/ops/groupnorm.py:81",
                 tolerance="stats rtol = atol = 1e-5; y rtol 1/128, atol 1e-5",
                 max_abs_err=max_err,
                 library="F.group_norm (channels-last NCHW)",
                 cuda_launches_per_call=plan.launches, plan=plan._asdict()),
            lambda x, s, b: gn.groupnorm_forward(x, s, b, groups, 1e-6),
            (lambda x, s, b: gn.groupnorm_reference(x, s, b, groups, 1e-6))
            if plain else None,
            lambda x, s, b, weight=weight, wbias=wbias:
                group_norm(nchw(x), groups, weight, wbias, 1e-6),
            (x, scale, bias), 2 * n * 2 + 2 * c * 4 + stats_bytes, 8 * n,
            None)

        g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        got = gn.groupnorm_backward(x, g, scale, ref_stats, groups)
        torch.cuda.synchronize()
        errors = check_gn_backward(torch, gn, got, x, g, scale, ref_stats,
                                   groups)
        del got
        plan = gn.groupnorm_plan(GN_BATCH, side * side, c, groups, 2,
                                 backward=True)
        backwards.append((x, g, scale, ref_stats))

        def library_bwd(x, g, weight=weight.clone().requires_grad_(),
                        wbias=wbias.clone().requires_grad_()):
            return (group_norm(nchw(x), groups, weight, wbias, 1e-6),
                    (x, weight, wbias), nchw(g))

        # Bytes: x and g read, dx written; scale and the statistics read,
        # dscale and dbias written. The [B, C, 2] f32 partials between the
        # two launches are the kernels' own traffic, not the function's.
        specs["groupnorm_backward"][key] = (
            dict(base, replaces="tf_yarn_tpu/ops/groupnorm.py:150 (dx) and "
                                ":220-231 (dscale, dbias)",
                 tolerance="dx rtol 1/128, atol 1e-2 * max|dx|; dscale, "
                           "dbias rtol 1e-5, atol 1e-5 * sum|terms|",
                 max_abs_err=errors["dx"], max_abs_err_params=errors,
                 library="F.group_norm backward (autograd): dx, dweight, dbias",
                 cuda_launches_per_call=plan.launches, plan=plan._asdict(),
                 partials_bytes=2 * GN_BATCH * c * 2 * 4),
            lambda x, g, s, st: gn.groupnorm_backward(x, g, s, st, groups),
            (lambda x, g, s, st: gn.groupnorm_bwd_reference(x, g, s, st,
                                                            groups))
            if plain else None,
            None, (x, g, scale, ref_stats),
            3 * n * 2 + 3 * c * 4 + stats_bytes, 18 * n, library_bwd)

    # One call at each shape: the kernels the device ran.
    device_kernels = {}
    for name, calls, launched_by, wrapper in (
            ("groupnorm", forwards,
             lambda args: gn.groupnorm_forward(*args, groups, 1e-6),
             gn.groupnorm),
            ("groupnorm_backward", backwards,
             lambda args: gn.groupnorm_backward(*args, groups),
             gn.groupnorm_backward)):
        planned = sum(gn.groupnorm_plan(
            GN_BATCH, side * side, c, groups, 2,
            backward=name == "groupnorm_backward").launches
            for side, c in RESNET50_GN)
        launched = kernel_launch_counts(
            torch, lambda: [launched_by(args) for args in calls],
            wrapper=wrapper, calls=len(calls), expect=planned)
        ours = {k: v for k, v in launched.items() if "groupnorm" in k}
        if sum(ours.values()) != planned or (
                name == "groupnorm_backward" and ours != launched):
            raise AssertionError(
                f"{name} launched {launched} at the {len(RESNET50_GN)} "
                f"shapes, planned {planned} GroupNorm kernels")
        device_kernels[name] = ours
    del forwards, backwards
    rows = _norm_rows(specs, torch)
    for row in rows:
        row["device_kernels_12_calls"] = device_kernels[row["name"]]
        row["resnet50_step"] = _resnet50_step(row)
        first = next(iter(specs[row["name"]]))
        for key, r in {first: row, **row["other_shapes"]}.items():
            log(f"  {row['name']} {key} x{r['resnet50_calls']}: "
                f"{r['ms'] * 1e3:.2f} us cold, {r['warm_ms'] * 1e3:.2f} warm, "
                f"F.group_norm {r['library_ms'] * 1e3:.2f}, bound "
                f"{r['bound_ms'] * 1e3:.2f}, {r['cuda_launches_per_call']} "
                f"launch(es), plan {r['plan']}")
        step = row["resnet50_step"]
        log(f"  {row['name']} ResNet-50 step ({step['calls']} calls, "
            f"{step['cuda_launches']} launches): {step['ms'] * 1e3:.2f} us "
            f"cold, F.group_norm {step['library_ms'] * 1e3:.2f}, bound "
            f"{step['bound_ms'] * 1e3:.2f}; kernels "
            f"{row['device_kernels_12_calls']}")
    return rows


def train_tiny_reference(torch, tt, common, training, experiment, ckpt, dev):
    """A small f32 LoRA decoder (flash, fused norms) trained 5 steps
    through the kernels on the card and through the plain versions on
    the CPU, from the same weights and batches; then train_and_evaluate
    with a model_dir on the card: manifested checkpoints, verified, and
    a resume."""
    import tempfile

    cfg = tt.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=512,
                               max_seq_len=128, dtype=torch.float32,
                               attention_impl="flash", fused_norms=True,
                               scan_layers=False, remat=True, lora_rank=8)
    cpu_model = tt.make_model(cfg, seed=SEED, device="cpu", trainable=True)
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():  # nonzero lora_b: every adapter gets a gradient
        for name, param in cpu_model.named_parameters():
            if name.endswith("lora_b"):
                param.copy_(torch.randn(param.shape, generator=gen) * 0.05)
    gpu_model = tt.Transformer(cfg, device=dev, trainable=True)
    gpu_model.load_state_dict(cpu_model.state_dict())
    losses = []
    for model in (gpu_model, cpu_model):
        optimizer = tt.make_lora_optimizer(1e-3)(model)
        step = training.build_train_step(model, common.lm_loss, optimizer)
        state = training.TrainState(0, model, optimizer)
        batches = common.synthetic_token_iter(2, 128, cfg.vocab_size, seed=SEED)
        run = []
        for _ in range(5):
            tokens = torch.as_tensor(next(batches)["tokens"]).long()
            state, metrics = step(state, {"tokens": tokens.to(model.device)})
            run.append(float(metrics["loss"]))
        losses.append(run)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    cpu_params = dict(cpu_model.named_parameters())
    lora_err = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
                   for n, p in gpu_model.named_parameters() if "lora" in n)
    # f32 kernels against plain f32 on the CPU: sums in another order;
    # five Adam steps at lr 1e-3 bound any drift of an adapter by 5e-3.
    if not all(map(lambda v: v == v and abs(v) < 1e9, losses[0])) \
            or loss_err > 1e-4 or lora_err > 5e-4:
        raise AssertionError(f"card vs CPU training: losses {losses}, "
                             f"adapter max abs err {lora_err}")
    with tempfile.TemporaryDirectory() as model_dir:
        def run(steps):
            exp = tt.make_experiment(cfg, model_dir=model_dir, train_steps=steps,
                                     batch_size=2, seq_len=128,
                                     learning_rate=1e-3,
                                     checkpoint_every_steps=2, keep_last_n=1,
                                     log_every_steps=1)
            return training.train_and_evaluate(
                experiment.as_core_experiment(exp), device=dev)

        first = run(4)
        steps = ckpt.list_checkpoint_steps(model_dir)
        if steps != [2, 4]:
            raise AssertionError(f"checkpoints {steps}, expected [2, 4]")
        for at in steps:
            ckpt.verify_checkpoint(ckpt.checkpoint_path(model_dir, at))
        resumed = run(6)
        steps = ckpt.list_checkpoint_steps(model_dir)
        if steps != [4, 6] or ckpt.restore_checkpoint(model_dir, 6)["step"] != 6:
            raise AssertionError(f"resume: checkpoints {steps}")
    return {"losses_card": losses[0], "losses_cpu": losses[1],
            "loss_max_rel_err": loss_err, "lora_max_abs_err": lora_err,
            "train_and_evaluate_loss": [first["loss"], resumed["loss"]],
            "checkpoints": steps}


def train_slice(torch, tt, training, experiment, telemetry, counted, dev):
    """The Llama-3-8B-width LoRA fine-tune through train_and_evaluate."""
    cfg = tt.TransformerConfig.llama3_8b(lora_rank=16, attention_impl="flash",
                                         fused_norms=True, scan_layers=False)
    exp = tt.make_experiment(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             train_steps=4, log_every_steps=1)
    built = {}
    init = exp.init_fn

    def init_fn(device, seed):
        started = time.perf_counter()
        model = init(device, seed)
        torch.cuda.synchronize()
        built["seconds"] = time.perf_counter() - started
        built["model"] = model
        with torch.no_grad():  # snapshots on the card: base and adapters
            built["before"] = {n: p.detach().clone()
                               for n, p in model.named_parameters()}
        return model

    recorded = []
    loss_fn = exp.loss_fn

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            recorded.append(loss.detach())
        return loss, aux

    exp.init_fn = init_fn
    exp.loss_fn = recording_loss
    tracer = telemetry.get_tracer()
    tracer.clear()
    for fn in counted:
        fn.launches = 0
    started = time.perf_counter()
    metrics = training.train_and_evaluate(experiment.as_core_experiment(exp),
                                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    launches = {fn.__name__: fn.launches for fn in counted}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the training path")
    losses = [float(x) for x in recorded]
    if len(losses) != 4 or not all(abs(x) < 1e9 and x == x for x in losses):
        raise AssertionError(f"training losses {losses}")
    model = built.pop("model")
    before = built.pop("before")
    moved = changed = 0
    for name, param in model.named_parameters():
        same = torch.equal(param.detach(), before[name])
        if "lora" in name:
            moved += not same
        elif not same:
            changed += 1
    del before
    n_lora = sum("lora" in n for n, _ in model.named_parameters())
    if changed or moved != n_lora:
        raise AssertionError(f"{changed} base params changed, {moved} of "
                             f"{n_lora} adapters moved")
    spans = tracer.records()
    step_s = [a.duration + b.duration for a, b in zip(
        [r for r in spans if r.name == "train/step_dispatch"],
        [r for r in spans if r.name == "train/device_wait"])]
    registry = telemetry.get_registry()
    flops = training.flops_lib.transformer_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    # The steady step: the mean over the steps after the first (which
    # pays for the allocator's growth and the optimizer's state), with
    # their spread beside it.
    steady = sum(step_s[1:]) / len(step_s[1:])
    result = {
        "params": sum(p.numel() for p in model.parameters()),
        "lora_params": sum(p.numel() for n, p in model.named_parameters()
                           if "lora" in n),
        "init_s": built["seconds"],
        "losses": losses,
        "final_loss": metrics["loss"],
        "step_s": step_s,
        "steady_step_s": steady,
        "steady_step_spread_s": [min(step_s[1:]), max(step_s[1:])],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
        "mfu": flops / steady / H100_BF16_FLOPS,
        "loop_mfu_last_step": registry.gauge("train/mfu").value,
        "model_flops_per_step": flops,
        "wall_s": wall,
        "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "adapters_moved": moved,
        "base_params_changed": changed,
    }
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(SEED))
    result.update(profile_step(torch, training, model, loss_fn,
                               exp.optimizer(model), {"tokens": tokens},
                               steady))
    return result


def profile_step(torch, training, model, loss_fn, optimizer, batch, steady,
                 flops_lib=None, node=None):
    """Three steps outside the loop (their launches are not counted), one
    train step function and optimizer for all three: a warm-up (with
    `flops_lib`, counted by FlopCounterMode), one timed step, and one
    under the profiler for the device's busy time and top kernels (and
    what ran under the autograd node `node`)."""
    step = training.build_train_step(model, loss_fn, optimizer)
    state = training.TrainState(0, model, optimizer)
    result = {}
    if flops_lib is None:
        step(state, batch)
    else:
        _, result["counted_flops_per_step"] = flops_lib.count_flops(
            step, state, batch)
    torch.cuda.synchronize()
    started = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - started
    profiled = device_profile(torch, lambda: step(state, batch), node)
    result["profiled_step"] = profiled
    result["unprofiled_step_s"] = unprofiled
    # The profiler slows the host, so the profiled step's own idle share
    # overstates the loop's. The device's busy time in the profiled step
    # against the same step run unprofiled just before it, and against
    # the loop's steady step, gives the idle share without that cost
    # (unclipped: a negative value means the busy time outran the step).
    result["idle_share_vs_unprofiled_step"] = (
        1 - profiled["device_busy_s"] / unprofiled)
    result["idle_share_vs_steady_step"] = 1 - profiled["device_busy_s"] / steady
    return result


def _zoo_cases(zoo, torch, tiny: bool):
    """{name: (module, config, make_experiment kwargs)}: the tiny f32
    configs of phase 4 (each family's learning rate spelled out), or the
    full-width bf16 ones of phase 7 at their make_experiment defaults."""
    f32 = torch.float32
    if tiny:
        return {
            "bert": (zoo.bert, zoo.bert.BertConfig.tiny(dtype=f32),
                     dict(batch_size=4, seq_len=16, learning_rate=1e-3)),
            "vit": (zoo.vit, zoo.vit.ViTConfig.tiny(dtype=f32),
                    dict(batch_size=4, learning_rate=3e-4)),
            "resnet": (zoo.resnet, zoo.resnet.ResNetConfig.tiny(dtype=f32),
                       dict(batch_size=4, image_size=32, learning_rate=0.1)),
            "resnet_s2d": (zoo.resnet, zoo.resnet.ResNetConfig.tiny(
                dtype=f32, stem="space_to_depth"),
                dict(batch_size=4, image_size=32, learning_rate=0.1)),
        }
    return {
        "bert_base": (zoo.bert, zoo.bert.BertConfig.base(fused_norms=True), {}),
        "vit_b16": (zoo.vit, zoo.vit.ViTConfig.base16(fused_norms=True), {}),
        "resnet50": (zoo.resnet, zoo.resnet.ResNetConfig.resnet50(
            fused_norms=True), {}),
    }


def train_zoo_reference(torch, zoo, training, experiment, ckpt, dev):
    """Tiny f32 BERT, ViT and ResNet (both stems) trained 3 steps through
    the kernels on the card and through the plain versions on the CPU,
    from the same weights and batches, with each family's make_experiment
    optimizer, loss and synthetic input; then the tiny ResNet through
    train_and_evaluate with a model_dir: a checkpoint at step 2, verified,
    and a resume to step 4."""
    import tempfile

    result = {}
    for name, (module, cfg, kwargs) in _zoo_cases(zoo, torch, True).items():
        exp = module.make_experiment(cfg, **kwargs)
        cpu_model = module.make_model(cfg, seed=SEED, device="cpu")
        card_model = type(cpu_model)(cfg, device=dev)
        card_model.load_state_dict(cpu_model.state_dict())
        losses = []
        for model in (card_model, cpu_model):
            optimizer = exp.optimizer(model)
            step = training.build_train_step(model, exp.loss_fn, optimizer)
            state = training.TrainState(0, model, optimizer)
            place = training._batch_placer(model.device)
            batches = exp.train_input_fn()
            run = []
            for _ in range(3):
                state, metrics = step(state, place(next(batches)))
                run.append(float(metrics["loss"]))
            losses.append(run)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        cpu_params = dict(cpu_model.named_parameters())
        lr = kwargs["learning_rate"]
        param_err = bias_drift = 0.0
        for pname, param in card_model.named_parameters():
            diff = float((param.detach().cpu() - cpu_params[pname].detach())
                         .abs().max())
            # Softmax cannot see a key bias: its gradient is rounding noise
            # that Adam scales to steps of ±lr (tests/test_torch_zoo.py).
            if pname.endswith("wk.bias"):
                bias_drift = max(bias_drift, diff)
            else:
                param_err = max(param_err, diff)
        # f32 kernels and cuDNN (TF32 off) against plain f32 on the CPU:
        # sums in another order; three optimizer steps bound the drift.
        if not all(v == v and abs(v) < 1e9 for v in losses[0]) \
                or loss_err > 1e-4 or param_err > 5e-4 or bias_drift > 6 * lr:
            raise AssertionError(
                f"{name}: card vs CPU training: losses {losses}, param max "
                f"abs err {param_err}, key-bias drift {bias_drift}")
        result[name] = {"losses_card": losses[0], "losses_cpu": losses[1],
                        "loss_max_rel_err": loss_err,
                        "param_max_abs_err": param_err}
    module, cfg, kwargs = _zoo_cases(zoo, torch, True)["resnet"]
    with tempfile.TemporaryDirectory() as model_dir:
        def run(steps):
            exp = module.make_experiment(
                cfg, model_dir=model_dir, train_steps=steps,
                checkpoint_every_steps=2, keep_last_n=1, log_every_steps=1,
                **kwargs)
            return training.train_and_evaluate(
                experiment.as_core_experiment(exp), device=dev)

        first = run(2)
        ckpt.verify_checkpoint(ckpt.checkpoint_path(model_dir, 2))
        resumed = run(4)
        steps = ckpt.list_checkpoint_steps(model_dir)
        if steps != [2, 4] or ckpt.restore_checkpoint(model_dir, 4)["step"] != 4:
            raise AssertionError(f"resume: checkpoints {steps}")
    result["resnet_train_and_evaluate"] = {
        "loss": [first["loss"], resumed["loss"]], "checkpoints": steps}
    return result


def zoo_slice(torch, module, cfg, kwargs, training, experiment, telemetry,
              flops_lib, counted, needed, dev, node=None):
    """One family's make_experiment at full width through
    train_and_evaluate for 4 steps, random weights from seed 0 and the
    JAX synthetic inputs, with every kernel count set to 0 just before
    it: the needed kernels launched, the losses finite, the parameters
    moved; the steady step (mean of steps 2-4) and its spread,
    samples/s, MFU, peak memory; then one profiled step. With `node`
    (ResNet's `_GroupNormBackward`, BERT's and ViT's
    `_LayerNormBackward`), the profiled step must show each of that
    node's calls making its planned CUDA launches (NODE_KERNELS) and no
    arithmetic in torch (no plain dscale/dbias path), and the kernels
    the profiler attributes to them being its norm's."""
    exp = module.make_experiment(cfg, train_steps=4, log_every_steps=1,
                                 **kwargs)
    built = {}
    init = exp.init_fn

    def init_fn(device, seed):
        model = init(device, seed)
        with torch.no_grad():
            built["before"] = {n: p.detach().clone()
                               for n, p in model.named_parameters()}
        built["model"] = model
        return model

    recorded = []
    loss_fn = exp.loss_fn

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            recorded.append(loss.detach())
        return loss, aux

    exp.init_fn, exp.loss_fn = init_fn, recording_loss
    tracer = telemetry.get_tracer()
    tracer.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(counted)
    started = time.perf_counter()
    metrics = training.train_and_evaluate(experiment.as_core_experiment(exp),
                                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    launches = _launches(counted)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for fn in needed:
        if launches[fn.__name__] <= 0:
            raise AssertionError(f"{fn.__name__} never launched on the "
                                 f"{type(built['model']).__name__} path")
    losses = [float(x) for x in recorded]
    if len(losses) != 4 or not all(abs(x) < 1e9 and x == x for x in losses):
        raise AssertionError(f"training losses {losses}")
    model, before = built.pop("model"), built.pop("before")
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in model.named_parameters())
    del before
    n_params = len(list(model.parameters()))
    # Embedding tables whose rows this batch never reads, and a decay too
    # small for f32, may stay put; nearly every tensor must move.
    if moved < 0.9 * n_params:
        raise AssertionError(f"{moved} of {n_params} parameters moved")
    spans = tracer.records()
    step_s = [a.duration + b.duration for a, b in zip(
        [r for r in spans if r.name == "train/step_dispatch"],
        [r for r in spans if r.name == "train/device_wait"])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    batch = training._batch_placer(dev)(next(exp.train_input_fn()))
    samples = next(iter(batch.values())).shape[0]
    result = {
        "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                   for k, v in vars(cfg).items()},
        "params": sum(p.numel() for p in model.parameters()),
        "batch": list(next(iter(batch.values())).shape),
        "losses": losses, "final_loss": metrics["loss"],
        "step_s": step_s, "steady_step_s": steady,
        "steady_step_spread_s": [min(step_s[1:]), max(step_s[1:])],
        "samples_per_s": samples / steady,
        "loop_mfu_last_step": telemetry.get_registry().gauge("train/mfu").value,
        "wall_s": wall, "launches": launches, "peak_memory_gb": peak,
        "params_moved": [moved, n_params],
    }
    result.update(profile_step(torch, training, model, loss_fn,
                               exp.optimizer(model), batch, steady,
                               flops_lib=flops_lib, node=node))
    if node is not None:
        prefix, planned = NODE_KERNELS[node]
        under = result["profiled_step"]["under_node"]
        arithmetic = [op for op in under["ops"]
                      if op.startswith("aten::") and op not in HOST_ONLY_OPS]
        kernels = under["kernels"]
        if (under["count"] == 0 or arithmetic
                or under["launches"] != planned * under["count"]
                or (kernels and (
                    not all(k.startswith(prefix) for k in kernels)
                    or sum(kernels.values()) != planned * under["count"]))):
            raise AssertionError(f"{node} in the profiled step: {under}")
    result["mfu"] = (result["counted_flops_per_step"] / steady
                     / H100_BF16_FLOPS)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _drive(scheduler, prompts, sampling):
    """Submit every prompt and tick the scheduler to the end; returns the
    streams in prompt order."""
    try:
        responses = [scheduler.submit(p, sampling) for p in prompts]
        for _ in range(400):
            scheduler.tick()
            if all(r.done for r in responses):
                break
        return [r.result(timeout=1) for r in responses]
    finally:
        scheduler.close()


# The small f32 model served on the card and on the CPU: head_dim 128 at
# GQA group 2, the f32 instantiation of the decode kernels.
TINY_SERVE = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=1024, max_seq_len=256)
# The tiny swap grid: a pool of 4 usable blocks holds the 40-token batch
# stream (24 new tokens: 4 blocks) and nothing else, so the interactive
# request (1 block) suspends it to the host tier.
TINY_SWAP = dict(max_slots=2, block_size=16, num_blocks=5, kv_host_blocks=8,
                 kv_layout="paged", decode_attention="fused")


def _finish(scheduler, responses):
    for _ in range(400):
        if all(r.done for r in responses):
            return [r.result(timeout=1) for r in responses]
        scheduler.tick()
    raise AssertionError("a request did not finish in 400 ticks")


def tiny_swap(engine, sched_mod, batch_prompt, inter_prompt):
    """The fused_swap grid driven tick by tick: the batch stream alone for
    3 ticks, then the interactive request. Returns (streams, the same two
    requests each served alone, the swap counters)."""
    sampling = sched_mod.SamplingParams
    requests = ((batch_prompt, 24, "batch"), (inter_prompt, 8, "interactive"))
    alone = []
    for prompt, new, tier in requests:
        scheduler = sched_mod.SlotScheduler(engine, **TINY_SWAP)
        alone += _finish(scheduler, [scheduler.submit(
            prompt, sampling(max_new_tokens=new), tier=tier)])
        scheduler.close()
    scheduler = sched_mod.SlotScheduler(engine, **TINY_SWAP)
    (prompt, new, tier), second = requests
    responses = [scheduler.submit(prompt, sampling(max_new_tokens=new),
                                  tier=tier)]
    for _ in range(3):
        scheduler.tick()
    prompt, new, tier = second
    responses.append(scheduler.submit(prompt, sampling(max_new_tokens=new),
                                      tier=tier))
    streams = _finish(scheduler, responses)
    swap = scheduler.stats()["swap"]
    scheduler.close()
    return streams, alone, swap


def tiny_warm_start(engine, sched_mod, server_mod, prompt):
    """A donor fused grid serves `prompt`; its hot prefixes go through the
    block wire (export, encode, JSON, decode) into a fresh grid, whose
    stream on the same prompt is returned with its prefix hits."""
    grid = dict(max_slots=2, block_size=16, kv_layout="paged",
                decode_attention="fused")
    sampling = sched_mod.SamplingParams(max_new_tokens=8)
    donor = sched_mod.SlotScheduler(engine, **grid)
    receiver = sched_mod.SlotScheduler(engine, **grid)
    try:
        (donor_stream,) = _finish(donor, [donor.submit(prompt, sampling)])
        wire = server_mod.decode_block_wire(json.loads(json.dumps(
            server_mod.encode_block_wire(donor.export_hot_prefixes()))))
        imported = receiver.import_prefixes(wire)
        (stream,) = _finish(receiver, [receiver.submit(prompt, sampling)])
        return {"donor": donor_stream, "receiver": stream,
                "imported": imported,
                "hits": receiver.stats()["prefix_cache"]["hits"]}
    finally:
        donor.close()
        receiver.close()


def tiny_out_of_vocabulary(torch, engine, sched_mod, clean):
    """Three concurrent requests on a fused grid of 3 slots, the second
    with the ids V and -V-3 (outside the vocabulary: the embedding reads
    rows V-1 and 0, as the JAX package does); then one more request on
    the same replica, `clean` alone. Returns the streams, the finish
    reasons (the clean request's last) and the clean request's stream.
    On the card an index outside the table would be a device-side assert
    that fails every later request; the synchronize surfaces it here."""
    vocab = engine.model.config.vocab_size
    prompts = [list(range(3, 10)), [1, vocab, -vocab - 3, 2], [1, 2]]
    sampling = sched_mod.SamplingParams(max_new_tokens=8)
    scheduler = sched_mod.SlotScheduler(
        engine, max_slots=3, block_size=16, kv_layout="paged",
        decode_attention="fused")
    try:
        responses = [scheduler.submit(p, sampling) for p in prompts]
        streams = _finish(scheduler, responses)
        last = scheduler.submit(clean, sampling)
        (after,) = _finish(scheduler, [last])
        responses.append(last)
    finally:
        scheduler.close()
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize()
    return {"streams": streams, "after": after,
            "reasons": [r.finish_reason for r in responses]}


def serve_tiny_reference(torch, tt, engine_mod, sched_mod, server_mod, dev):
    """The same small f32 model (int8 KV) served through the kernels on
    the card and through the plain versions on the CPU: prefill logits
    close, and greedy outputs equal on every decode path — the fused
    paged grid (also with chunked prefill: windows of 8 prompt tokens, 16
    a tick, its streams equal to the blocking grid's), the dense grid and
    the gather mode (each also with two n-gram drafts per tick) and
    `generate` at batch 3 with a replayed prompt remainder and an eos;
    the fused grid with the host swap tier (a batch stream suspended by
    an interactive request and resumed: its streams equal to the same
    requests served alone); and a warm start between two fused grids
    through the block wire (the importer's stream equal to the donor's,
    with a prefix hit); and three concurrent requests on the fused grid,
    one with ids outside the vocabulary, then a clean one on the same
    replica (`tiny_out_of_vocabulary`): all served to length, equal to
    the CPU's."""
    cfg = tt.TransformerConfig(dtype=torch.float32, kv_cache_dtype="int8",
                               **TINY_SERVE)
    cpu_model = tt.make_model(cfg, seed=SEED, device="cpu")
    gpu_model = tt.Transformer(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = tiny_serve_prompts()
    grids = {
        "fused": dict(kv_layout="paged", decode_attention="fused"),
        "dense": dict(kv_layout="dense"),
        "gather": dict(kv_layout="paged", decode_attention="gather"),
        "dense_spec2": dict(kv_layout="dense", spec_k=2),
        "gather_spec2": dict(kv_layout="paged", decode_attention="gather",
                             spec_k=2),
        "fused_chunked": dict(kv_layout="paged", decode_attention="fused",
                              prefill_chunk=8, prefill_budget_per_tick=16),
        # The tp=2 replica's chunked grids (`tiny_tp_check`).
        "dense_chunked": TP_SERVE_GRIDS["dense_chunked"],
        "gather_chunked": TP_SERVE_GRIDS["gather_chunked"],
    }
    batch = [[(5 * i + 2 * r + 1) % 512 for i in range(19)] for r in range(3)]
    results = []
    for model in (gpu_model, cpu_model):
        engine = engine_mod.DecodeEngine(model)
        run = {"logits": engine.prefill([prompts[1][:32]])[1].cpu()}
        for name, options in grids.items():
            scheduler = sched_mod.SlotScheduler(engine, max_slots=2,
                                                block_size=16, **options)
            run[name] = _drive(scheduler, prompts,
                               sched_mod.SamplingParams(max_new_tokens=8))
        # Batch 3 pads to 4; 19 tokens prefill at 16 and replay 3.
        free = engine.generate(batch, 8).cpu()
        run["eos"] = int(free[0, 19 + 2])
        run["generate"] = engine.generate(batch, 8,
                                          eos_token=run["eos"]).cpu().tolist()
        run["fused_swap"], run["fused_swap_alone"], run["swap"] = tiny_swap(
            engine, sched_mod, prompts[1], prompts[0])
        run["warm_start"] = tiny_warm_start(engine, sched_mod, server_mod,
                                            prompts[1])
        run["fused_oov"] = tiny_out_of_vocabulary(torch, engine, sched_mod,
                                                  prompts[1])
        results.append(run)
    card, cpu = results
    err = float((card["logits"] - cpu["logits"]).abs().max())
    if not torch.isfinite(card["logits"]).all() or err > 1e-3:
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    for name in (*grids, "eos", "generate", "fused_swap", "warm_start",
                 "fused_oov"):
        if card[name] != cpu[name]:
            raise AssertionError(f"{name}: card {card[name]} != CPU {cpu[name]}")
    swap, warm = card["swap"], card["warm_start"]
    if card["fused_swap"] != card["fused_swap_alone"] or swap["suspends"] < 1 \
            or swap["resumes"] != swap["suspends"]:
        raise AssertionError(f"fused_swap: {card['fused_swap']} against "
                             f"{card['fused_swap_alone']} alone, {swap}")
    if warm["receiver"] != warm["donor"] or warm["hits"] < 1 \
            or warm["imported"]["imported_blocks"] < 1:
        raise AssertionError(f"warm start: {warm}")
    oov = card["fused_oov"]
    if oov["reasons"] != ["length"] * 4 or len(oov["after"]) != 8:
        raise AssertionError(f"out-of-vocabulary ids on the fused grid: "
                             f"{oov}")
    if card["dense"] != card["fused"] or card["gather"] != card["dense"] \
            or card["fused_chunked"] != card["fused"]:
        raise AssertionError(f"the decode paths disagree on the card: {card}")
    return {"prefill_logits_max_abs_err": err,
            "streams": {name: card[name] for name in grids},
            "generate": card["generate"], "generate_eos": card["eos"],
            "fused_swap": card["fused_swap"], "swap": swap,
            "warm_start": warm, "fused_oov": oov}


# Phase 4's tensor-parallel replica: TINY_SERVE at tp=2 (2 query and 1 kv
# head a rank, GQA group 2: the f32 instantiation of the decode kernel),
# two gloo ranks on the card. Its grids: dense and paged gather, greedy,
# each also with two n-gram drafts and with chunked prefill.
TP_SERVE_GRIDS = {
    "dense": dict(kv_layout="dense"),
    "gather": dict(kv_layout="paged", decode_attention="gather"),
    "dense_spec2": dict(kv_layout="dense", spec_k=2),
    "gather_spec2": dict(kv_layout="paged", decode_attention="gather",
                         spec_k=2),
    "dense_chunked": dict(kv_layout="dense", prefill_chunk=8,
                          prefill_budget_per_tick=16),
    "gather_chunked": dict(kv_layout="paged", decode_attention="gather",
                           prefill_chunk=8, prefill_budget_per_tick=16),
}
TP_RANKS_SERVING = 2
TP_LOGITS_RTOL = 1e-5
# The serving path's kernels, as a rank's report names them.
TP_SERVE_KERNELS = ("rmsnorm", "quantize_int8", "int8_decode_attention")


def tiny_serve_prompts():
    prompts = [[(7 * i + 3) % 512 for i in range(n)] for n in (5, 40)]
    prompts.append([11, 12, 13, 14] * 6)  # repeats: the drafter proposes
    return prompts


def tiny_tp_replica(torch, tt, engine_mod, tp_replica, mesh_lib):
    """Phase 4's tp=2 replica of the small f32 model (int8 KV, seed 0):
    its follower spawned, both ranks' shards loaded from the one-device
    state dict. Returns (replica, the one-device prefill logits on the
    CPU of `tiny_tp_check`'s prompt)."""
    cfg = tt.TransformerConfig(dtype=torch.float32, kv_cache_dtype="int8",
                               **TINY_SERVE)
    cpu_model = tt.make_model(cfg, seed=SEED, device="cpu")
    logits = engine_mod.DecodeEngine(cpu_model).prefill(
        [tiny_serve_prompts()[1][:32]])[1]
    replica = tp_replica.start(mesh_lib.MeshSpec(tp=TP_RANKS_SERVING))
    try:
        replica.load(cfg, state=cpu_model.state_dict())
    except BaseException:
        replica.close()
        raise
    return replica, logits


def tiny_tp_check(torch, sched_mod, replica, want, streams, wall):
    """The tp=2 replica against one device: prefill logits within
    TP_LOGITS_RTOL of the largest of the CPU's (`want`), greedy streams
    equal to `serve_tiny_reference`'s (the card's, equal to the CPU's) on
    every TP_SERVE_GRIDS grid, and on the card every rank launched the
    serving path's kernels, each as often as the other rank. Closes the
    replica."""
    engine = replica.engine
    prompts = tiny_serve_prompts()
    sampling = sched_mod.SamplingParams(max_new_tokens=8)
    started = time.perf_counter()
    try:
        engine.rank_report(reset_launches=True)
        got = engine.prefill([prompts[1][:32]])[1].cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        for name, grid in TP_SERVE_GRIDS.items():
            tp = _drive(sched_mod.SlotScheduler(engine, max_slots=2,
                                                block_size=16, **grid),
                        prompts, sampling)
            if tp != streams[name]:
                raise AssertionError(f"tp=2 {name}: {tp} != one device "
                                     f"{streams[name]}")
        ranks = engine.rank_report()
        serve_s = time.perf_counter() - started
    finally:
        replica.close()
    if not torch.isfinite(got).all() or rel > TP_LOGITS_RTOL:
        raise AssertionError(f"tp=2 prefill logits off by {rel} (relative)")
    launches = [{name: rank["launches"][name] for name in TP_SERVE_KERNELS}
                for rank in ranks]
    if engine.device.type == "cuda" and (
            min(min(rank.values()) for rank in launches) <= 0
            or any(rank != launches[0] for rank in launches)):
        raise AssertionError(f"the ranks' launches: {launches}")
    if [p.exitcode for p in replica.processes] != [0]:
        raise AssertionError(f"the follower exited with "
                             f"{[p.exitcode for p in replica.processes]}")
    return {"prefill_logits_rel_err": rel, "streams_equal_cpu": True,
            "grids": list(TP_SERVE_GRIDS), "rank_launches": launches,
            "follower_peak_memory_gb": [
                None if rank["peak_memory_bytes"] is None
                else rank["peak_memory_bytes"] / 1e9 for rank in ranks[1:]],
            "start_s": wall, "serve_s": serve_s}


def inference_reference(torch, tt, engine_mod, training, experiment, ckpt,
                        inference, dev):
    """`run_inference` on the card over a checkpoint `train_and_evaluate`
    wrote on the card (2 steps of the small f32 model): its records must
    equal `generate` on the restored params."""
    import tempfile

    cfg = tt.TransformerConfig(dtype=torch.float32, kv_cache_dtype="int8",
                               **TINY_SERVE)
    batches = [{"tokens": [[(3 * i + 7 * r + b) % 512 for i in range(21)]
                           for r in range(2)], "id": [2 * b, 2 * b + 1]}
               for b in range(2)]
    with tempfile.TemporaryDirectory() as model_dir:
        exp = tt.make_experiment(cfg, model_dir=model_dir, train_steps=2,
                                 batch_size=2, seq_len=64,
                                 checkpoint_every_steps=2, log_every_steps=1)
        training.train_and_evaluate(experiment.as_core_experiment(exp),
                                    device=dev)
        out = Path(model_dir) / "records.jsonl"
        model = tt.Transformer(cfg, device=dev)
        stats = inference.run_inference(experiment.InferenceExperiment(
            model=model, model_dir=model_dir, input_fn=lambda: iter(batches),
            output_path=str(out), max_new_tokens=6))
        records = [json.loads(line) for line in out.read_text().splitlines()]
        restored = tt.Transformer(cfg, device=dev)
        restored.load_state_dict(
            ckpt.restore_checkpoint(model_dir, 2, map_location=dev)["params"])
    engine = engine_mod.DecodeEngine(restored)
    expected = [row[21:] for b in batches
                for row in engine.generate(b["tokens"], 6).cpu().tolist()]
    if [r["tokens"] for r in records] != expected \
            or [r["id"] for r in records] != [0, 1, 2, 3]:
        raise AssertionError(f"run_inference records {records} != {expected}")
    if not 0 < stats["tokens_per_sec"] <= stats["padded_tokens_per_sec"]:
        raise AssertionError(f"run_inference stats {stats}")
    return {"records": len(records), "ckpt_step": stats["ckpt_step"],
            "tokens_per_sec": stats["tokens_per_sec"]}


def post(port: int, body: dict, path: str = "/v1/generate") -> tuple:
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
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


# The hand-written kernels' names as the profiler shows them (with their
# template arguments), whatever their place among the top kernels.
PORT_KERNEL = re.compile(r"(flash_\w+|groupnorm_\w+|layernorm_\w+|rmsnorm_\w+"
                         r"|quantize_int8_\w+|decode_kernel)"
                         r"(<[^>(]*>)?")


# A kernel backward's autograd node: the name prefix of its kernels and
# its CUDA launches a call (the dx or column-sum kernel, then the
# parameter sums).
NODE_KERNELS = {"_GroupNormBackward": ("groupnorm_", 2),
                "_LayerNormBackward": ("layernorm_", 2)}


# The only operators a kernel backward may call under its autograd node
# on the card: allocations, views and dtype no-ops. Anything else (the
# plain dscale/dbias path's mul, sub and sum) is arithmetic in torch.
HOST_ONLY_OPS = ("aten::to", "aten::detach", "detach", "aten::empty",
                 "aten::empty_like", "aten::empty_strided", "aten::contiguous",
                 "aten::view", "aten::reshape", "aten::_reshape_alias")


def _under_node(prof, node: str) -> dict:
    """What ran under each host range of the autograd node `node`: how
    many there were, the operators and runtime calls they made, the CUDA
    launches among those, and the device kernels the profiler attributes
    to the node or its operators, by name."""
    found, ops, kernels = 0, {}, {}

    def count_kernels(event):
        for kernel in event.kernels:
            name = (PORT_KERNEL.search(kernel.name) or
                    re.match(r".{0,80}", kernel.name)).group(0)
            kernels[name] = kernels.get(name, 0) + 1

    def walk(event):
        for child in event.cpu_children:
            ops[child.name] = ops.get(child.name, 0) + 1
            count_kernels(child)
            walk(child)

    for event in prof.events():
        if event.name == node:
            found += 1
            count_kernels(event)
            walk(event)
    return {"node": node, "count": found, "ops": ops, "kernels": kernels,
            "launches": sum(n for op, n in ops.items()
                            if op.startswith("cudaLaunchKernel"))}


def device_profile(torch, run, node=None):
    """`run()` under torch.profiler: the device's busy share of the wall
    time and the kernels that took most device time; with `node`, what
    ran under that autograd node (`_under_node`). Only device-side events
    count, and of those not the user annotations (the optimizer's
    ``Optimizer.step#...`` range on the device timeline): host ops and
    annotations carry their kernels' device time too, and summing them
    would count it twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    rows = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA \
                or getattr(event, "is_user_annotation", False):
            continue
        device_us = event.self_device_time_total
        if device_us > 0:
            rows.append((device_us, event.count, event.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _count, _key in rows) / 1e6
    if busy_s <= 0:
        raise AssertionError("the profiler saw no device time")
    port = [(PORT_KERNEL.search(key), us, count) for us, count, key in rows
            if "at::native" not in key]
    by_calls = sorted(rows, key=lambda row: -row[1])
    result = {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / wall,
        "device_launches": sum(count for _us, count, _key in rows),
        "top_kernels": [{"name": key[:80], "ms": us / 1e3, "calls": count}
                        for us, count, key in rows[:8]],
        "most_launched": [{"name": key[:80], "calls": count}
                          for _us, count, key in by_calls[:8]],
        "port_kernels": [{"name": found.group(0), "ms": us / 1e3, "calls": count}
                         for found, us, count in port if found],
    }
    if node is not None:
        result["under_node"] = _under_node(prof, node)
    return result


# The serving slice's bursts: four concurrent greedy requests of these
# prompt lengths, 16 new tokens each, on a grid of 4 slots.
BURST_LENGTHS = (17, 64, 150, 300)
BURST_NEW = 16


def _launches(counted):
    return {fn.__name__: fn.launches for fn in counted}


def _zero(counted):
    for fn in counted:
        fn.launches = 0


def serve_burst(torch, engine, sched_mod, server_mod, counted, needed,
                gen, vocab, profile, **grid):
    """One SlotScheduler grid behind ServingServer: a burst of fresh
    prompts with every kernel count set to 0 just before it and read
    just after; with `profile`, a second burst of fresh prompts under
    torch.profiler. The grid's KV memory is freed on return."""
    torch.cuda.reset_peak_memory_stats()
    scheduler = sched_mod.SlotScheduler(engine, max_slots=4, block_size=16,
                                        **grid)
    server = server_mod.ServingServer(scheduler, "127.0.0.1", 0)
    scheduler.start()
    server.start()
    try:
        prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                   for n in BURST_LENGTHS]
        before = dict(engine.stats)
        _zero(counted)
        results, wall = burst(server.port, prompts, BURST_NEW)
        launches = _launches(counted)
        for status, body in results:
            if status != 200 or len(body["tokens"]) != BURST_NEW:
                raise AssertionError(f"bad reply {status}: {body}")
            if not all(0 <= t < vocab for t in body["tokens"]):
                raise AssertionError(f"token out of range: {body['tokens']}")
        status, health = get(server.port, "/healthz")
        if status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {status} {health}")
        status, stats = get(server.port, "/stats")
        if status != 200 or "decode_engine" not in stats:
            raise AssertionError(f"/stats: {status}")
        calls = {key: stats["decode_engine"].get(key, 0) - before.get(key, 0)
                 for key in ("prefill_calls", "paged_spec_step_calls",
                             "spec_step_calls", "paged_step_calls",
                             "step_calls")}
        for fn in needed:
            if launches[fn.__name__] <= 0:
                raise AssertionError(f"{fn.__name__} never launched on the "
                                     f"{grid} burst")
        result = {
            "grid": grid, "layers": engine.model.config.n_layers,
            "prompts": prompts,
            "streams": [body["tokens"] for _status, body in results],
            "requests": len(prompts),
            "prompt_tokens": list(BURST_LENGTHS),
            "new_tokens": BURST_NEW,
            "wall_s": wall,
            "tokens_per_s": BURST_NEW * len(prompts) / wall,
            "ttft_s": sorted(body["ttft_s"] for _status, body in results),
            "ticks": stats["ticks"],
            "engine_calls": calls,
            "prefill_chunk": stats["prefill_chunk"],
            "prefill_budget_per_tick": stats["prefill_budget_per_tick"],
            "kv_cache_bytes": stats["kv_cache_hbm_bytes"],
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        if profile:
            # Fresh prompts again (no prefix-cache hits): where the device
            # time goes, and how idle the device is.
            fresh = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                     for n in BURST_LENGTHS]
            ticks = get(server.port, "/stats")[1]["ticks"]
            profiled = device_profile(
                torch, lambda: burst(server.port, fresh, BURST_NEW))
            profiled["ticks"] = get(server.port, "/stats")[1]["ticks"] - ticks
            profiled["device_launches_per_tick"] = (
                profiled["device_launches"] / max(1, profiled["ticks"]))
            result["profiled_burst"] = profiled
        return result
    finally:
        server.stop()
        scheduler.close()
        # The grid's KV is freed before the next path: the scheduler and
        # its server thread hold each other, so collect the cycle.
        del scheduler, server
        gc.collect()
        torch.cuda.empty_cache()


# Burst (f): two batch streams of SWAP_BATCH-token prompts fill a pool of
# 46 usable blocks (2 x ceil((300 + 64 - 1) / 16)), then two interactive
# requests arrive and must suspend one of them to the host tier.
SWAP_BATCH, SWAP_BATCH_NEW = (300, 300), 64
SWAP_INTER, SWAP_INTER_NEW = (17, 64), 16
SWAP_GRID = dict(max_slots=4, block_size=16, num_blocks=47, kv_host_blocks=64,
                 kv_layout="paged", decode_attention="fused")


def post_all(port: int, bodies, path: str = "/v1/generate"):
    """Start one POST a body and return (threads, replies, started), the
    replies filled in as (status, body, wall seconds) when they come."""
    replies = [None] * len(bodies)
    started = time.perf_counter()

    def call(i):
        status, reply = post(port, bodies[i], path)
        replies[i] = (status, reply, time.perf_counter() - started)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for thread in threads:
        thread.start()
    return threads, replies, started


def join_all(threads, replies):
    for thread in threads:
        thread.join(timeout=900)
    if any(thread.is_alive() for thread in threads) or None in replies:
        raise AssertionError("a request did not finish")
    for status, body, _wall in replies:
        if status != 200:
            raise AssertionError(f"bad reply {status}: {body}")
    return replies


def wait_for(condition, what: str, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def tier_summary(replies, new_tokens: int) -> dict:
    walls = [wall for _status, _body, wall in replies]
    return {"ttft_s": [body["ttft_s"] for _s, body, _w in replies],
            "wall_s": walls,
            "tokens_per_s": new_tokens * len(replies) / max(walls)}


def host_copy_rates(torch, engine, n_blocks: int) -> dict:
    """D2H and H2D GB/s of `n_blocks` pool blocks as the swap moves them:
    `extract_blocks` then one host copy a leaf, and `inject_blocks` from
    the host copy; the median of 5 of each after a warm-up."""
    pool = engine.make_paged_pool(2 * n_blocks + 1, 16)
    ids = list(range(1, n_blocks + 1))
    back = list(range(n_blocks + 1, 2 * n_blocks + 1))
    out_s, in_s = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        started = time.perf_counter()
        payload = engine.extract_blocks(pool, ids, 16)
        host = type(payload)(**{name: None if leaf is None else leaf.cpu()
                                for name, leaf in vars(payload).items()})
        out_s.append(time.perf_counter() - started)
        started = time.perf_counter()
        engine.inject_blocks(pool, back, host, 16)
        torch.cuda.synchronize()
        in_s.append(time.perf_counter() - started)
    n_bytes = pool.nbytes() / pool.num_blocks * n_blocks
    del pool, payload, host
    median = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
    return {"blocks": n_blocks, "bytes": n_bytes,
            "d2h_s": median(out_s), "h2d_s": median(in_s),
            "d2h_gb_per_s": n_bytes / median(out_s) / 1e9,
            "h2d_gb_per_s": n_bytes / median(in_s) / 1e9}


def serve_swap(torch, engine, sched_mod, server_mod, telemetry, counted,
               gen, vocab, n_layers):
    """Burst (f): SWAP_GRID behind ServingServer. The two batch requests
    are served alone first (the reference); then again, and once both
    are active the two interactive requests arrive, suspending a batch
    stream that resumes when they retire. The batch streams must equal
    the reference, every parked stream must resume, and the paged kernel
    must launch once a layer a window step."""
    rmsnorm, quantize, paged, _dense = counted
    batch = [{"prompt": torch.randint(0, vocab, (n,), generator=gen).tolist(),
              "max_new_tokens": SWAP_BATCH_NEW, "tier": "batch"}
             for n in SWAP_BATCH]
    inter = [{"prompt": torch.randint(0, vocab, (n,), generator=gen).tolist(),
              "max_new_tokens": SWAP_INTER_NEW, "tier": "interactive"}
             for n in SWAP_INTER]
    registry = telemetry.get_registry()
    swap_seconds = registry.histogram("serving/swap_seconds")
    runs = {}
    for name in ("alone", "contended"):
        torch.cuda.reset_peak_memory_stats()
        scheduler = sched_mod.SlotScheduler(engine, **SWAP_GRID)
        server = server_mod.ServingServer(scheduler, "127.0.0.1", 0)
        scheduler.start()
        server.start()
        try:
            before = dict(engine.stats)
            seconds = (swap_seconds.count, swap_seconds.total)
            _zero(counted)
            threads, replies, _ = post_all(server.port, batch)
            inter_replies = None
            if name == "contended":
                wait_for(lambda: scheduler.stats()["active_slots"] >= 2,
                         "both batch streams to be active")
                more, inter_replies, _ = post_all(server.port, inter)
                join_all(more, inter_replies)
            join_all(threads, replies)
            launches = _launches(counted)
            stats = scheduler.stats()
            runs[name] = {
                "replies": replies,
                "inter": inter_replies,
                "stats": stats, "launches": launches,
                "steps": stats["decode_engine"]["paged_spec_step_calls"]
                - before.get("paged_spec_step_calls", 0),
                "swap_observations": swap_seconds.count - seconds[0],
                "swap_seconds": swap_seconds.total - seconds[1],
                "block_bytes": stats["kv_cache_hbm_bytes"]
                / stats["block_pool"]["num_blocks"],
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
        finally:
            server.stop()
            scheduler.close()
            del scheduler, server
            gc.collect()
    alone, run = runs["alone"], runs["contended"]
    swap = run["stats"]["swap"]
    streams = [body["tokens"] for _s, body, _w in run["replies"]]
    reference = [body["tokens"] for _s, body, _w in alone["replies"]]
    if swap["suspends"] < 1 or swap["resumes"] != swap["suspends"] \
            or run["stats"]["suspended_streams"]:
        raise AssertionError(f"burst (f) did not suspend and resume: {swap}")
    if streams != reference:
        raise AssertionError("burst (f): the resumed batch streams differ "
                             "from the same requests served alone")
    launches = run["launches"]
    if launches[paged.__name__] != n_layers * run["steps"] \
            or launches[rmsnorm.__name__] <= 0 \
            or launches[quantize.__name__] <= 0:
        raise AssertionError(f"burst (f) launches {launches} over "
                             f"{run['steps']} window steps")
    for _s, body, _w in run["replies"] + run["inter"]:
        if not all(0 <= t < vocab for t in body["tokens"]):
            raise AssertionError(f"token out of range: {body['tokens']}")
    moved = swap["swap_out_blocks"] + swap["swap_in_blocks"]
    return {
        "grid": SWAP_GRID,
        "batch_prompt_tokens": list(SWAP_BATCH),
        "batch_new_tokens": SWAP_BATCH_NEW,
        "interactive_prompt_tokens": list(SWAP_INTER),
        "interactive_new_tokens": SWAP_INTER_NEW,
        "batch": tier_summary(run["replies"], SWAP_BATCH_NEW),
        "interactive": tier_summary(run["inter"], SWAP_INTER_NEW),
        "batch_alone": tier_summary(alone["replies"], SWAP_BATCH_NEW),
        "swap": swap,
        "blocks_moved": moved,
        "mb_per_block": run["block_bytes"] / 1e6,
        "swap_seconds": run["swap_seconds"],
        "swap_observations": run["swap_observations"],
        "swap_seconds_per_swap": run["swap_seconds"]
        / max(1, run["swap_observations"]),
        "swap_gb_per_s": moved * run["block_bytes"]
        / max(run["swap_seconds"], 1e-9) / 1e9,
        "host_copy": host_copy_rates(torch, engine, swap["swap_out_blocks"]),
        "ticks": run["stats"]["ticks"],
        "window_steps": run["steps"],
        "launches": launches,
        "peak_memory_gb": run["peak_memory_gb"],
    }


def serve_warm_start(torch, engine, sched_mod, server_mod, telemetry,
                     counted, gen, vocab):
    """Grid (g): replica A (a fused grid) serves a 300-token prompt whose
    first 256 tokens prefill as one bucket, so its prefix cache holds 16
    blocks; `GET /v1/blocks` from A is POSTed to replica B (its own small
    pool, the same engine); B then serves the same prompt through the
    imported prefix (at least 16 blocks hit, no prefill) with A's greedy
    stream. Also the wire's size and, in process, the seconds of export,
    encode and decode."""
    rmsnorm, quantize, paged, _dense = counted
    body = {"prompt": torch.randint(0, vocab, (300,), generator=gen).tolist(),
            "max_new_tokens": BURST_NEW}
    grid = dict(max_slots=4, block_size=16, kv_layout="paged",
                decode_attention="fused")
    replica_a = sched_mod.SlotScheduler(engine, num_blocks=64, **grid)
    replica_b = sched_mod.SlotScheduler(engine, num_blocks=40, **grid)
    servers = [server_mod.ServingServer(s, "127.0.0.1", 0)
               for s in (replica_a, replica_b)]
    for scheduler, server in zip((replica_a, replica_b), servers):
        scheduler.start()
        server.start()
    try:
        _zero(counted)
        status, reply_a = post(servers[0].port, body)
        started = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{servers[0].port}/v1/blocks",
                timeout=600) as reply:
            raw = reply.read()
        get_s = time.perf_counter() - started
        started = time.perf_counter()
        request = urllib.request.Request(
            f"http://127.0.0.1:{servers[1].port}/v1/blocks", data=raw,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=600) as reply:
            imported = json.loads(reply.read())
        post_s = time.perf_counter() - started
        before = dict(replica_b.stats())
        status_b, reply_b = post(servers[1].port, body)
        after = replica_b.stats()
        launches = _launches(counted)
        # In process, the wire's stages on the same snapshot.
        started = time.perf_counter()
        wire = replica_a.export_hot_prefixes()
        export_s = time.perf_counter() - started
        started = time.perf_counter()
        encoded = server_mod.encode_block_wire(wire)
        encode_s = time.perf_counter() - started
        started = time.perf_counter()
        server_mod.decode_block_wire(json.loads(raw))
        decode_s = time.perf_counter() - started
        del wire, encoded
    finally:
        for scheduler, server in zip((replica_a, replica_b), servers):
            server.stop()
            scheduler.close()
        del replica_a, replica_b, servers
        gc.collect()
        torch.cuda.empty_cache()
    hits = after["prefix_cache"]["hits"] - before["prefix_cache"]["hits"]
    replayed = after["prefill_tokens"] - before["prefill_tokens"]
    prefills = (after["decode_engine"]["prefill_calls"]
                - before["decode_engine"]["prefill_calls"])
    if status != 200 or status_b != 200 or imported["imported_blocks"] < 16 \
            or hits != 1 or prefills or replayed > 300 - 16 * 16:
        raise AssertionError(f"grid (g): {status} {status_b} {imported}, "
                             f"{hits} hits, {prefills} prefills, "
                             f"{replayed} tokens replayed")
    if reply_b["tokens"] != reply_a["tokens"]:
        raise AssertionError(f"grid (g): B's stream {reply_b['tokens']} != "
                             f"A's {reply_a['tokens']}")
    if launches[paged.__name__] <= 0 or launches[rmsnorm.__name__] <= 0 \
            or launches[quantize.__name__] <= 0:
        raise AssertionError(f"grid (g) launches {launches}")
    return {"prompt_tokens": 300, "new_tokens": BURST_NEW,
            "imported": imported, "hit_blocks": (300 - replayed) // 16,
            "wire_mb": len(raw) / 1e6, "get_s": get_s, "post_s": post_s,
            "export_s": export_s, "encode_s": encode_s, "decode_s": decode_s,
            "ttft_s": {"a": reply_a["ttft_s"], "b": reply_b["ttft_s"]},
            "launches": launches}


# Phase 5's and phase 10's depth: Llama-3-8B's widths and 4 of its 32
# layers, cut for the smoke's time limit. Every layer repeats the one
# before it; the kernels' launches a path scale with the depth.
SERVE_LAYERS = 4


def serving_config(torch, tt):
    """Phase 5's decoder: Llama-3-8B widths, SERVE_LAYERS layers, bf16,
    int8 KV."""
    return dataclasses.replace(
        tt.TransformerConfig.llama3_8b(dtype=torch.bfloat16,
                                       kv_cache_dtype="int8"),
        n_layers=SERVE_LAYERS)


def serve_slice(torch, tt, engine_mod, sched_mod, server_mod, telemetry,
                counted, dev):
    """The Llama-3-8B-width decoder (int8 KV, SERVE_LAYERS layers) on
    every serving path: (a) the fused paged burst, (b) the gather burst,
    (c) the dense burst, (d) `engine.generate` on a [4, 300] batch, 16 new
    tokens, (e) the fused paged burst with chunked prefill (windows of
    CHUNK prompt tokens, two chunks a tick): no prefill program, every
    tick one window step of width CHUNK, (f) the host swap tier's burst
    and (g) the warm start between two replicas over /v1/blocks. Returns
    the paths' results and each path's seconds."""
    rmsnorm, quantize, paged, dense = counted
    cfg = serving_config(torch, tt)
    started = time.perf_counter()
    model = tt.make_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"model: llama3_8b widths, {cfg.n_layers} layers, bf16, int8 KV, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}e9 params, "
        f"built in {time.perf_counter() - started:.1f} s")
    engine = engine_mod.DecodeEngine(model)
    _cache, logits = engine.prefill([[1, 2, 3, 4, 5, 6, 7, 8]])
    if tuple(logits.shape) != (1, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    del _cache
    gen = torch.Generator().manual_seed(SEED)
    seconds = {"build": time.perf_counter() - started}
    paths = {}

    def timed(name, run):
        started = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - started

    common = (torch, engine, sched_mod, server_mod, counted)
    timed("fused_burst", lambda: serve_burst(
        *common, (rmsnorm, quantize, paged), gen, cfg.vocab_size, True,
        kv_layout="paged", decode_attention="fused"))
    timed("gather_burst", lambda: serve_burst(
        *common, (rmsnorm, quantize, dense), gen, cfg.vocab_size, True,
        kv_layout="paged", decode_attention="gather"))
    timed("dense_burst", lambda: serve_burst(
        *common, (rmsnorm, quantize, dense), gen, cfg.vocab_size, False,
        kv_layout="dense"))

    def generate():
        torch.cuda.reset_peak_memory_stats()
        batch = torch.randint(0, cfg.vocab_size, (4, 300), generator=gen)
        _zero(counted)
        started = time.perf_counter()
        out = engine.generate(batch, BURST_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
        launches = _launches(counted)
        if tuple(out.shape) != (4, 300 + BURST_NEW) \
                or not torch.equal(out[:, :300].cpu(), batch.int()) \
                or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"generate output {tuple(out.shape)} "
                                 f"malformed")
        for fn in (rmsnorm, quantize, dense):
            if launches[fn.__name__] <= 0:
                raise AssertionError(f"{fn.__name__} never launched in "
                                     f"generate")
        return {
            "layers": cfg.n_layers, "batch": [4, 300],
            "new_tokens": BURST_NEW, "wall_s": wall,
            "tokens_per_s": 4 * BURST_NEW / wall, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }

    timed("generate", generate)

    def chunked_burst():
        chunked = serve_burst(
            *common, (rmsnorm, quantize, paged), gen, cfg.vocab_size, True,
            kv_layout="paged", decode_attention="fused", prefill_chunk=CHUNK,
            prefill_budget_per_tick=2 * CHUNK)
        calls = chunked["engine_calls"]
        steps = calls["paged_spec_step_calls"]
        if chunked["prefill_chunk"] != CHUNK or calls["prefill_calls"] \
                or steps != chunked["ticks"] \
                or chunked["launches"][paged.__name__] != cfg.n_layers * steps:
            raise AssertionError(f"the chunked burst did not run one window "
                                 f"step of width {CHUNK} a tick: {chunked}")
        return chunked

    timed("chunked_burst", chunked_burst)
    timed("swap_burst", lambda: serve_swap(
        torch, engine, sched_mod, server_mod, telemetry, counted, gen,
        cfg.vocab_size, cfg.n_layers))
    timed("warm_start", lambda: serve_warm_start(
        torch, engine, sched_mod, server_mod, telemetry, counted, gen,
        cfg.vocab_size))
    return paths, seconds


# The ranker (phases 4 and 8). Its features as the JAX synthetic input
# draws them: ids in [low, high) for every table, log1p of log-normal
# dense values.
def rank_features(cfg, rows: int, seed: int, low: int = 0, high=None):
    import numpy as np

    rng = np.random.RandomState(seed)
    high = max(cfg.table_sizes) if high is None else high
    cat = rng.randint(low, high, (rows, len(cfg.table_sizes))).astype(np.int32)
    dense = np.log1p(rng.lognormal(0.0, 1.0, (rows, cfg.n_dense)))
    return cat, dense.astype(np.float32)


def rank_config(cfg) -> str:
    return (f"{len(cfg.table_sizes)} tables of {max(cfg.table_sizes)} rows x "
            f"{cfg.embed_dim}, {cfg.n_dense} dense, bottom {cfg.bottom_mlp}, "
            f"top {cfg.top_mlp}, {cfg.dtype}")


def rank_bodies(cfg, sizes, seed: int, **kwargs):
    """One /v1/rank body a request of each row count in `sizes`, with the
    features of all of them in order."""
    import numpy as np

    cat, dense = rank_features(cfg, sum(sizes), seed, **kwargs)
    edges = np.cumsum((0,) + tuple(sizes))
    bodies = [{"cat": cat[a:b].tolist(), "dense": dense[a:b].tolist()}
              for a, b in zip(edges[:-1], edges[1:])]
    return bodies, cat, dense


def rank_serve(ranker, model, bodies, max_batch: int, buckets=None):
    """`model` behind RankEngine + MicroBatchScheduler + RankServer on
    127.0.0.1, warmed up, then started: every body POSTed at once.
    Returns the replies' scores in order and the server's /stats."""
    kwargs = {} if buckets is None else {"batch_buckets": buckets}
    engine = ranker.engine.RankEngine(model, **kwargs)
    scheduler = ranker.MicroBatchScheduler(engine, max_batch=max_batch,
                                           max_wait_ms=2.0)
    server = ranker.RankServer(scheduler, "127.0.0.1", 0)
    engine.warmup(max_batch=max_batch)
    scheduler.start()
    server.start()
    try:
        replies = join_all(*post_all(server.port, bodies, "/v1/rank")[:2])
        stats = get(server.port, "/stats")[1]
    finally:
        server.stop()
        scheduler.close()
    return [s for _status, body, _wall in replies for s in body["scores"]], \
        stats


def _as_flax_tree(state) -> dict:
    """A state dict as the flax variables the bridge reads."""
    params = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.cpu().numpy()
    return {"params": params}


def rank_tiny_reference(torch, ranker, training, experiment, dev):
    """The tiny f32 DLRM with the same weights (through the flax bridge)
    on the card and on the CPU: each served by RankServer over three
    concurrent requests whose ids include negatives and ids past their
    table and the stacked table — scores within 1e-5 (f32 sums in
    another order); then three adagrad steps through train_and_evaluate
    from those weights on the same batches — losses within 1e-5
    relative, parameters within 1e-4."""
    dlrm = ranker.dlrm
    cfg = dlrm.DLRMConfig.tiny(dtype=torch.float32)
    state = ranker.weights.dlrm_from_flax(_as_flax_tree(
        dlrm.make_model(cfg, seed=SEED, device="cpu").state_dict()), cfg)
    bodies, _, _ = rank_bodies(cfg, (1, 7, 16), seed=1, low=-300, high=300)
    bodies[1]["cat"][0] = [64, -1, 255, -65]
    bodies[1]["cat"][1] = [2 ** 30, -2 ** 30, 1000, 0]
    scores, models, losses = [], [], []
    for device in (dev, torch.device("cpu")):
        model = dlrm.DLRM(cfg, device=device)
        model.load_state_dict(state)
        scores.append(rank_serve(ranker, model, bodies, 16,
                                 buckets=(1, 2, 4, 8, 16))[0])
        exp = dlrm.make_experiment(cfg, batch_size=64, train_steps=3,
                                   learning_rate=0.05, log_every_steps=1)
        recorded = []

        def init_fn(device, seed):
            model = dlrm.DLRM(cfg, device=device)
            model.load_state_dict(state)
            models.append(model)
            return model

        def recording_loss(model, batch, train=True, loss_fn=exp.loss_fn,
                           recorded=recorded):
            loss, aux = loss_fn(model, batch, train=train)
            if train:
                recorded.append(loss.detach())
            return loss, aux

        exp.init_fn, exp.loss_fn = init_fn, recording_loss
        training.train_and_evaluate(experiment.as_core_experiment(exp),
                                    device=device)
        losses.append([float(x) for x in recorded])
    card, cpu = scores
    score_err = max(abs(a - b) for a, b in zip(card, cpu))
    if len(card) != 24 or not all(abs(x) < 1e9 for x in card) \
            or score_err > 1e-5:
        raise AssertionError(f"ranker scores: card {card}, CPU {cpu}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    cpu_params = dict(models[1].named_parameters())
    param_err = max(float((p.detach().cpu() - cpu_params[n].detach())
                          .abs().max())
                    for n, p in models[0].named_parameters())
    moved = float((models[1].embedding.detach()
                   - state["embedding"]).abs().max())
    if len(losses[0]) != 3 or loss_err > 1e-5 or param_err > 1e-4 \
            or moved <= 0:
        raise AssertionError(f"ranker training: losses {losses}, param max "
                             f"abs err {param_err}, table moved {moved}")
    return {"score_max_abs_err": score_err, "scores": len(card),
            "losses_card": losses[0], "losses_cpu": losses[1],
            "loss_max_rel_err": loss_err, "param_max_abs_err": param_err}


# Phase 8's concurrent requests: (rows a request, requests), the row
# counts a ranking frontend sees (one candidate to a full page of 256).
RANK_BURSTS = ((1, 32), (32, 16), (256, 8))
RANK_MAX_BATCH = 256
# The bf16 ranker's scores against the same weights' f32 forward on the
# CPU (measured 1.87e-3 at scores up to 0.25 on the H100), and the f32
# ranker's on the card against that forward (measured 2.4e-7; TF32 off).
RANK_BF16_TOL = 1e-2
RANK_F32_TOL = 1e-5


def busy_ticks(spans) -> list:
    """The seconds of each ``ranking/tick`` span that ran a forward (a
    ``rank_engine/forward`` span starts inside it)."""
    forwards = [r.start for r in spans if r.name == "rank_engine/forward"]
    return [r.duration for r in spans if r.name == "ranking/tick"
            and any(r.start <= t < r.start + r.duration for t in forwards)]


def _mean(values) -> float:
    return sum(values) / max(1, len(values))


def _forward_f32(torch, model, cat, dense, rows: int = 4096):
    out = []
    with torch.inference_mode():
        for a in range(0, len(cat), rows):
            out.append(model(
                torch.from_numpy(cat[a:a + rows]).to(model.device),
                torch.from_numpy(dense[a:a + rows]).to(model.device)
            ).float().squeeze(-1).cpu())
    return torch.cat(out)


def rank_slice(torch, ranker, telemetry, counted, dev, cfg=None):
    """`DLRMConfig.criteo()` (26 tables of 2^17 rows, 64 wide: an f32
    table of 872 MB; bf16 compute), random weights from seed 0, behind
    RankEngine + MicroBatchScheduler(max_batch=256, max_wait_ms=2) +
    RankServer, warmed up, then started, with every kernel count set to
    0 just before and read just after (the ranker runs none of them).
    RANK_BURSTS: each a burst of concurrent POSTs; rows/s a burst, and
    /stats must show fewer ticks than requests. The card's scores
    against the same weights' f32 forward on the CPU (RANK_BF16_TOL),
    and the same weights at dtype=float32 on the card against it
    (RANK_F32_TOL). Then the 256-row burst again under torch.profiler:
    the tick's wall time (the `ranking/tick` span) and the engine
    forward's within it (`rank_engine/forward`: inputs to the card, the
    forward, the scores back), the tick's device time, the device's idle
    share, the top kernels."""
    import numpy as np

    dlrm = ranker.dlrm
    started = time.perf_counter()
    cfg = cfg or dlrm.DLRMConfig.criteo()
    model = dlrm.make_model(cfg, seed=SEED, device=dev)
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    # The CPU reference holds a copy of the card's weights, made once.
    cpu_model = dlrm.DLRM(f32_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()}, assign=True)
    setup_s = time.perf_counter() - started
    engine = ranker.engine.RankEngine(model)
    scheduler = ranker.MicroBatchScheduler(engine, max_batch=RANK_MAX_BATCH,
                                           max_wait_ms=2.0)
    server = ranker.RankServer(scheduler, "127.0.0.1", 0)
    warm_started = time.perf_counter()
    warmed = engine.warmup(max_batch=RANK_MAX_BATCH)
    warmup_s = time.perf_counter() - warm_started
    scheduler.start()
    server.start()
    tracer = telemetry.get_tracer()
    cats, denses, scores, bursts = [], [], [], {}
    try:
        _zero(counted)
        for i, (rows, requests) in enumerate(RANK_BURSTS):
            bodies, cat, dense = rank_bodies(cfg, (rows,) * requests,
                                             seed=100 + i)
            before = get(server.port, "/stats")[1]
            tracer.clear()
            threads, replies, begun = post_all(server.port, bodies,
                                               "/v1/rank")
            join_all(threads, replies)
            wall = time.perf_counter() - begun
            stats = get(server.port, "/stats")[1]
            cats.append(cat)
            denses.append(dense)
            scores += [s for _st, body, _w in replies for s in body["scores"]]
            bursts[rows] = {
                "requests": requests, "rows": rows * requests,
                "wall_s": wall, "rows_per_s": rows * requests / wall,
                "ticks": stats["ticks"] - before["ticks"],
                "tick_wall_s_mean": _mean(busy_ticks(tracer.records())),
                "request_s_max": max(w for _s, _b, w in replies)}
        launches = _launches(counted)
        if any(launches.values()):
            raise AssertionError(f"the ranker launched port kernels: "
                                 f"{launches}")
        if stats["ticks"] >= stats["requests_total"]:
            raise AssertionError(f"no coalescing: {stats['ticks']} ticks for "
                                 f"{stats['requests_total']} requests")
        status, health = get(server.port, "/healthz")
        if status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {status} {health}")
        # The profiled burst: the 256-row one again.
        bodies, _, _ = rank_bodies(cfg, (256,) * 8, seed=200)
        ticks = get(server.port, "/stats")[1]["ticks"]
        tracer.clear()
        profiled = device_profile(torch, lambda: join_all(
            *post_all(server.port, bodies, "/v1/rank")[:2]))
        profiled["ticks"] = get(server.port, "/stats")[1]["ticks"] - ticks
        spans = tracer.records()
        for name, key in (("ranking/tick", "tick_wall_s_mean"),
                          ("rank_engine/forward", "forward_wall_s_mean")):
            seconds = [r.duration for r in spans if r.name == name]
            profiled[key] = sum(seconds) / max(1, len(seconds))
        profiled["tick_device_s_mean"] = (profiled["device_busy_s"]
                                          / max(1, profiled["ticks"]))
        final = get(server.port, "/stats")[1]
    finally:
        server.stop()
        scheduler.close()
    cat, dense = np.concatenate(cats), np.concatenate(denses)
    card = torch.tensor(scores)
    cpu = _forward_f32(torch, cpu_model, cat, dense)
    f32_model = dlrm.DLRM(f32_cfg, device=dev)
    f32_model.load_state_dict(model.state_dict())
    card_f32 = _forward_f32(torch, f32_model, cat, dense)
    del f32_model
    bf16_err = float((card - cpu).abs().max())
    f32_err = float((card_f32 - cpu).abs().max())
    scale = float(cpu.abs().max())
    if not torch.isfinite(card).all() or len(card) != len(cat) \
            or bf16_err > RANK_BF16_TOL or f32_err > RANK_F32_TOL:
        raise AssertionError(f"criteo scores: bf16 card vs f32 CPU {bf16_err}"
                             f", f32 card vs CPU {f32_err} (|score| <= "
                             f"{scale})")
    return {"config": rank_config(cfg), "table_bytes":
            model.embedding.numel() * model.embedding.element_size(),
            "params_hbm_bytes": final["params_hbm_bytes_per_device"],
            "setup_s": setup_s, "warmup_s": warmup_s, "warmed_buckets": warmed,
            "bursts": bursts, "ticks": final["ticks"],
            "requests": final["requests_total"],
            "avg_batch_rows": final["avg_batch_rows"],
            "rank_engine": final["rank_engine"],
            "bf16_vs_cpu_f32_max_abs_err": bf16_err,
            "f32_vs_cpu_f32_max_abs_err": f32_err, "score_abs_max": scale,
            "launches": launches, "profiled_burst": profiled}


# Phase 8's tp=2 ranker: the same criteo model with its table's rows over
# two ranks that share the card over gloo (`serving.tp_replica`,
# `RankEngine(mesh=)`), each drawing the seeded init whole as make_model
# does and keeping its rows.
RANK_TP = 2


def rank_tp_replica(ranker, tp_replica, mesh_lib, cfg):
    """Phase 8's tp replica: its follower spawned, every rank's RankEngine
    over its rows of `cfg`'s seeded init (seed SEED). It starts beside the
    one-device ranker; its group is this process's default one, which
    `rank_tp_slice`'s caller closes before the ranker trains."""
    replica = tp_replica.start(mesh_lib.MeshSpec(tp=RANK_TP))
    try:
        replica.load(cfg, builder=tp_replica.ranker_shard, init_seed=SEED)
    except BaseException:
        replica.close()
        raise
    return replica


def rank_tp_slice(torch, ranker, telemetry, counted, dev, replica, one,
                  cfg=None):
    """`cfg` (criteo by default) behind RankEngine(mesh=tp=2) +
    MicroBatchScheduler(max_batch=256, max_wait_ms=2) + RankServer, warmed
    up, then started, every kernel count set to 0 just before and read
    just after (the ranker runs none): `rank_slice`'s RANK_BURSTS with
    its seeds. The leader records each tick's padded batch and scores;
    afterwards a one-device RankEngine over make_model(cfg, SEED) scores
    the same padded batches, and every tick's scores (so every served
    row) must be bitwise its. Per burst: rows/s, the tick's wall against
    the one-device ranker's (`one`, rank_slice's result), the ``embed``
    all-reduce's seconds and bytes a tick and the header's; each rank's
    parameter bytes and table rows."""
    import numpy as np

    dlrm = ranker.dlrm
    cfg = cfg or dlrm.DLRMConfig.criteo()
    engine = replica.engine
    forward = engine.score
    ticks_in = []

    def recorded(cat, dense=None):
        out = forward(cat, dense)
        ticks_in.append((cat, dense, out))
        return out

    engine.score = recorded
    scheduler = ranker.MicroBatchScheduler(engine, max_batch=RANK_MAX_BATCH,
                                           max_wait_ms=2.0)
    server = ranker.RankServer(scheduler, "127.0.0.1", 0)
    tracer = telemetry.get_tracer()
    bursts = {}
    try:
        started = time.perf_counter()
        warmed = engine.warmup(max_batch=RANK_MAX_BATCH)
        warmup_s = time.perf_counter() - started
        scheduler.start()
        server.start()
        _zero(counted)
        for i, (rows, requests) in enumerate(RANK_BURSTS):
            bodies, _, _ = rank_bodies(cfg, (rows,) * requests, seed=100 + i)
            tracer.clear()
            threads, replies, begun = post_all(server.port, bodies,
                                               "/v1/rank")
            join_all(threads, replies)
            wall = time.perf_counter() - begun
            bad = [status for status, _b, _w in replies if status != 200]
            if bad:
                raise AssertionError(f"tp ranker: statuses {bad}")
            spans = tracer.records()
            ticks = busy_ticks(spans)
            embeds = [r for r in spans if r.name == "train/tp_allreduce"
                      and r.args.get("op") == "embed"]
            headers = [r for r in spans if r.name == "ranking/tp_header"
                       and r.args.get("op") == "score"]
            n = max(1, len(ticks))
            tick_s = sum(ticks) / n
            one_tick_s = one["bursts"][rows]["tick_wall_s_mean"]
            bursts[rows] = {
                "requests": requests, "rows": rows * requests, "wall_s": wall,
                "rows_per_s": rows * requests / wall,
                "one_device_rows_per_s": one["bursts"][rows]["rows_per_s"],
                "ticks": len(ticks), "tick_wall_s_mean": tick_s,
                "one_device_tick_wall_s_mean": one_tick_s,
                "tick_wall_vs_one_device": tick_s / max(1e-12, one_tick_s),
                "embed_allreduces": len(embeds),
                "embed_allreduce_s_per_tick":
                    sum(r.duration for r in embeds) / n,
                "embed_allreduce_bytes_per_tick":
                    sum(r.args["bytes"] for r in embeds) / n,
                "embed_share_of_tick":
                    sum(r.duration for r in embeds) / max(1e-12, sum(ticks)),
                "header_s_per_tick": sum(r.duration for r in headers) / n,
                "header_bytes_per_tick":
                    sum(r.args["bytes"] for r in headers) / n}
        launches = _launches(counted)
        if any(launches.values()):
            raise AssertionError(f"the tp ranker launched port kernels: "
                                 f"{launches}")
        status, _, body = call(server.port, "POST", "/v1/rank",
                               {"cat": [[0, 1]], "dense": [[0.0]]})
        if status != 400:
            raise AssertionError(f"a malformed request got {status} {body}")
        stats = get(server.port, "/stats")[1]
    finally:
        server.stop()
        scheduler.close()
        del engine.score
    reports = engine.rank_report()
    if stats["tp_degree"] != RANK_TP or len(reports) != RANK_TP:
        raise AssertionError(f"tp_degree {stats['tp_degree']}, reports "
                             f"{reports}")
    served = sum(rows * requests for rows, requests in RANK_BURSTS)
    if sum(int(t[0].shape[0]) for t in ticks_in) < served:
        raise AssertionError(f"{len(ticks_in)} ticks recorded for {served} "
                             "rows")
    reference = ranker.engine.RankEngine(dlrm.make_model(cfg, seed=SEED,
                                                         device=dev))
    rows_here = engine.model.embedding.shape[0]
    weights_equal = torch.equal(engine.model.embedding,
                                reference.model.embedding[:rows_here])
    differ = [i for i, (cat, dense, out) in enumerate(ticks_in)
              if not np.array_equal(out, reference.score(cat, dense))]
    del reference
    if differ or not weights_equal:
        raise AssertionError(f"tp=2 scores differ from one device's in "
                             f"{len(differ)} of {len(ticks_in)} ticks "
                             f"(leader's table rows equal: {weights_equal})")
    return {"config": rank_config(cfg), "tp": RANK_TP,
            "table_bytes": cfg.total_buckets * cfg.embed_dim * 4,
            "rank_params_bytes": [r["params_bytes"] for r in reports],
            "rank_table_rows": [r["table_rows"] for r in reports],
            "follower_peak_memory_gb": [
                None if r["peak_memory_bytes"] is None
                else r["peak_memory_bytes"] / 1e9 for r in reports[1:]],
            "params_hbm_bytes_per_device":
                stats["params_hbm_bytes_per_device"],
            "one_device_params_hbm_bytes": one["params_hbm_bytes"],
            "warmup_s": warmup_s, "warmed_buckets": warmed,
            "ticks_recorded": len(ticks_in),
            "scores_bitwise_one_device": True, "rows_served": served,
            "bursts": bursts, "launches": launches}


def rank_train_slice(torch, ranker, training, experiment, telemetry, dev,
                     cfg=None):
    """`make_experiment(DLRMConfig.criteo())` through train_and_evaluate
    for 4 steps at batch 1024, random weights from seed 0, adagrad: the
    losses finite, every table row a batch read moved (at least 99% of
    them: a row's gradient can be exactly 0) and every other row
    unchanged bit for bit; the steady step (mean of steps 2-4), samples/s
    and peak memory (the table, its gradient and adagrad's sums, ~2.6
    GB, and one update temporary); then one profiled step."""
    import numpy as np

    dlrm = ranker.dlrm
    cfg = cfg or dlrm.DLRMConfig.criteo()
    exp = dlrm.make_experiment(cfg, train_steps=4, log_every_steps=1)
    built = {}
    init = exp.init_fn

    def init_fn(device, seed):
        model = init(device, seed)
        built["before"] = model.embedding.detach().to("cpu", copy=True)
        built["model"] = model
        return model

    recorded = []
    loss_fn = exp.loss_fn

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            recorded.append(loss.detach())
        return loss, aux

    exp.init_fn, exp.loss_fn = init_fn, recording_loss
    tracer = telemetry.get_tracer()
    tracer.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    metrics = training.train_and_evaluate(experiment.as_core_experiment(exp),
                                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in recorded]
    if len(losses) != 4 or not all(abs(x) < 1e9 and x == x for x in losses):
        raise AssertionError(f"ranker training losses {losses}")
    model = built.pop("model")
    moved = (model.embedding.detach().cpu() != built.pop("before")).any(1)
    sizes = np.asarray(cfg.table_sizes)
    offsets = np.concatenate(([0], np.cumsum(sizes[:-1])))
    batches = exp.train_input_fn()
    read = np.zeros(cfg.total_buckets, bool)
    for _ in range(4):
        read[(next(batches)["cat"] % sizes + offsets).ravel()] = True
    read = torch.from_numpy(read)
    moved_read = int((moved & read).sum())
    if bool((moved & ~read).any()) or moved_read < 0.99 * int(read.sum()):
        raise AssertionError(
            f"table rows: {int(moved.sum())} moved, {int(read.sum())} read, "
            f"{int((moved & ~read).sum())} moved unread")
    spans = tracer.records()
    step_s = [a.duration + b.duration for a, b in zip(
        [r for r in spans if r.name == "train/step_dispatch"],
        [r for r in spans if r.name == "train/device_wait"])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    batch = training._batch_placer(dev)(next(exp.train_input_fn()))
    result = {
        "config": rank_config(cfg), "batch": 1024,
        "params": sum(p.numel() for p in model.parameters()),
        "losses": losses, "final_loss": metrics["loss"],
        "table_rows_read": int(read.sum()), "table_rows_moved": moved_read,
        "step_s": step_s, "steady_step_s": steady,
        "steady_step_spread_s": [min(step_s[1:]), max(step_s[1:])],
        "samples_per_s": 1024 / steady, "wall_s": wall,
        "peak_memory_gb": peak,
    }
    result.update(profile_step(torch, training, model, loss_fn,
                               exp.optimizer(model), batch, steady))
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return result


# Phase 9: the launcher. The experiment fns below are module-level, so
# `client.get_safe_experiment_fn("chip_smoke.<fn>")` sends them to the
# launched tasks by name: the stdlib pickle does, without cloudpickle.
LAUNCHER_STEPS = 4
LAUNCHER_COUNTS = "launcher_counts.json"
# Loss tolerance of the launched BERT-base run against phase 7's
# in-process run (relative). Same card, code, weights, batches and
# dropout stream, and no float atomics in the LayerNorm kernels, so the
# losses come out bitwise equal (0.0 in every H100 run so far, PERF.md
# §5). 1e-5 is the bound tests/test_torch_kernels.py holds the same path
# to: it leaves room for a reordered f32 sum, while another batch or
# dropout stream moves a loss of 0.7-1.9 by orders of magnitude more.
LAUNCHER_LOSS_RTOL = 1e-5


LAUNCHER_EVAL_STEPS = 2
EVALUATOR_COUNTS = "evaluator_counts.json"
WORKER_EVAL = "worker_eval.json"


def bert_stream(config, batch_size: int, seq_len: int, seed: int):
    """`bert.make_experiment`'s synthetic stream (tokens from
    RandomState(seed), labels the first token modulo the classes) as an
    input_fn that declares `start_step`, `host_index` and `num_hosts`: a
    resumed run skips the batches its steps consumed, and a rank of a
    data-parallel run reads its contiguous share of each global batch.
    `seen["start_step"]` keeps the step it was last called with."""
    import numpy as np

    seen = {"start_step": None}

    def input_fn(start_step: int = 0, host_index: int = 0,
                 num_hosts: int = 1):
        seen["start_step"] = start_step
        rng = np.random.RandomState(seed)
        rows = slice(host_index * batch_size // num_hosts,
                     (host_index + 1) * batch_size // num_hosts)
        drawn = 0
        while True:
            tokens = rng.randint(0, config.vocab_size, (batch_size, seq_len))
            labels = (tokens[:, 0] % config.num_classes).astype(np.int32)
            drawn += 1
            if drawn > start_step:
                yield {"x": tokens[rows].astype(np.int32),
                       "y": labels[rows]}

    return input_fn, seen


def params_digest(state) -> str:
    """sha256 of a state — a state dict, or nested dicts and lists of
    tensors and other leaves — tensor by tensor in key order."""
    import hashlib

    import torch

    digest = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            digest.update(path.encode())
            digest.update(node.detach().cpu().contiguous().flatten()
                          .view(torch.uint8).numpy().tobytes())
        elif isinstance(node, dict):
            for key in sorted(node, key=str):
                walk(node[key], f"{path}/{key}")
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, f"{path}/{i}")
        else:
            digest.update(f"{path}={node!r}".encode())

    walk(state, "")
    return digest.hexdigest()


def rank_counts_path(model_dir, rank: int) -> Path:
    """Where rank `rank` of phase 9's run writes its record."""
    return Path(model_dir) / (LAUNCHER_COUNTS if rank == 0
                              else f"launcher_counts-{rank}.json")


def _evaluator_record(model_dir: str, params, metrics, step) -> None:
    """Phase 9's exporter, run by the evaluator after each checkpoint:
    the checkpoint's metrics and this process's LayerNorm launches, to
    <model_dir>/evaluator_counts.json."""
    from tf_yarn_tpu_torch._device import task_device
    from tf_yarn_tpu_torch.ops import layernorm

    path = Path(model_dir) / EVALUATOR_COUNTS
    record = (json.loads(path.read_text()) if path.exists()
              else {"metrics": {}})
    record["metrics"][str(step)] = metrics
    record["launches"] = {fn.__name__: fn.launches for fn in (
        layernorm.layernorm, layernorm.layernorm_backward)}
    record["device"] = str(task_device())
    record["params"] = len(params)
    path.write_text(json.dumps(record))


def launcher_bert_experiment(model_dir: str, tiny: bool = False,
                             preempt_at=None, dp: int = 1,
                             drain_poll=None, preempt_rank: int = 0,
                             record_dir=None, extra=None):
    """Phase 9's experiment fn, called in the launched tasks: phase 7's
    BERT-base experiment (make_experiment at its JAX defaults,
    fused_norms=True, 32 x 128, AdamW, 4 steps, seed 0, the same
    batches) with a model_dir, steps_per_loop=2, a checkpoint every 2
    steps keeping the newest 1, and an eval stream (LAUNCHER_EVAL_STEPS
    batches from seed 1). Its loss records the training losses, and
    after the last optimizer step it writes them, the LayerNorm kernels'
    launch counts in this process, whether this process built the kernel
    library, the attempt and the step the input resumed at to
    <model_dir>/launcher_counts.json; after the final eval, the eval
    metrics the loop computed to <model_dir>/worker_eval.json. Its
    exporter (`_evaluator_record`) runs in the evaluator. `preempt_at`:
    attempt 0's rank `preempt_rank` requests the preemption drain after
    that step. `dp`: data-parallel over that many ranks
    (``MeshSpec(dp=dp)``), each reading its share of the global batch;
    rank r > 0 writes its record to launcher_counts-<r>.json, and every
    record holds the rank, its backend and device and the digest of its
    parameters after the last step. `drain_poll`: the run's
    ``drain_poll_every_steps``. `record_dir`: where the records go when
    the model_dir is a URI (default the model_dir); `extra`: a fn whose
    dict joins each record. `tiny`: the tiny f32 config, for a rehearsal
    on the CPU."""
    import functools

    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch import constants, preemption, telemetry
    from tf_yarn_tpu_torch.models import bert
    from tf_yarn_tpu_torch.ops import _build, layernorm
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    if tiny:
        config = bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True)
        shape = dict(batch_size=4, seq_len=16)
    else:
        config = bert.BertConfig.base(fused_norms=True)
        shape = dict(batch_size=32, seq_len=128)
    input_fn, seen = bert_stream(config, seed=0, **shape)
    exp = bert.make_experiment(
        config, model_dir=model_dir, train_steps=LAUNCHER_STEPS,
        log_every_steps=2, steps_per_loop=2, checkpoint_every_steps=2,
        keep_last_n=1, eval_steps=LAUNCHER_EVAL_STEPS, input_fn=input_fn,
        mesh_spec=MeshSpec(dp=dp) if dp > 1 else None,
        drain_poll_every_steps=drain_poll, **shape)
    exp.eval_input_fn = bert_stream(config, seed=1, **shape)[0]
    exp.exporters = functools.partial(_evaluator_record, model_dir)
    n_try = int(os.environ.get(constants.ENV_N_TRY, "0"))
    losses, evals = [], []
    loss_fn, make_optimizer = exp.loss_fn, exp.optimizer

    def done() -> bool:
        return (seen["start_step"] or 0) + len(losses) == LAUNCHER_STEPS

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(loss.detach())
        elif done() and dp == 1:
            # The final eval's batches, averaged as `training.evaluate`
            # averages them.
            evals.append({"loss": loss, **aux})
            if len(evals) == LAUNCHER_EVAL_STEPS:
                totals = {}
                for metrics in evals:
                    for key, value in metrics.items():
                        totals[key] = totals.get(key, 0.0) + float(value)
                (Path(model_dir) / WORKER_EVAL).write_text(json.dumps(
                    {k: v / len(evals) for k, v in totals.items()}))
        return loss, aux

    def optimizer(model):
        opt = make_optimizer(model)

        def after_step(opt, args, kwargs):
            step = (seen["start_step"] or 0) + len(losses)
            grouped = dist.is_available() and dist.is_initialized()
            rank = dist.get_rank() if grouped else 0
            if n_try == 0 and step == preempt_at and rank == preempt_rank:
                preemption.request()
            if not done():
                return
            record = {
                "losses": [float(x) for x in losses],
                "launches": {fn.__name__: fn.launches for fn in (
                    layernorm.layernorm, layernorm.layernorm_backward)},
                "built_kernels_here": _build.build_seconds is not None,
                "device": str(model.device),
                "n_try": n_try, "start_step": seen["start_step"],
                "rank": rank,
                "world": dist.get_world_size() if grouped else 1,
                "backend": dist.get_backend() if grouped else None,
                "params_sha256": params_digest(model.state_dict()),
                # The checkpoint ops this process's registry has timed by
                # its last step (so in its last log step's flush).
                "checkpoint_ops": sorted({
                    re.search(r"\{op=(\w+)\}", key).group(1)
                    for key in telemetry.get_registry().snapshot()
                    if key.startswith("checkpoint/seconds")}),
                **(extra() if extra else {}),
            }
            records = Path(record_dir or model_dir)
            records.mkdir(parents=True, exist_ok=True)
            rank_counts_path(records, rank).write_text(json.dumps(record))

        opt.register_step_post_hook(after_step)
        return opt

    exp.loss_fn, exp.optimizer = recording_loss, optimizer
    return exp


PYTORCH_STEPS = 4


def launcher_pytorch_experiment(out_dir: str, tiny: bool = False):
    """Phase 9 (f)'s experiment fn, called in each launched pytorch
    worker: phase 7's BERT-base (seed 0, on the task's device; ranks that
    share the card talk gloo) as a `PytorchExperiment`, its dataset phase
    7's PYTORCH_STEPS global batches as rows. The `main_fn` trains one
    pass over the rank's `DistributedSampler` share (batches of half the
    global batch: PYTORCH_STEPS steps) with the recipe's AdamW, counts
    the LayerNorm kernels' launches over it, has rank 0 save through
    `utils.model_ckpt`, and writes the rank's record (launches, backend,
    device, wrapper, digest of its parameters) to pytorch-<rank>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch import pytorch
    from tf_yarn_tpu_torch._device import task_device
    from tf_yarn_tpu_torch.models import bert, common
    from tf_yarn_tpu_torch.ops import layernorm
    from tf_yarn_tpu_torch.utils import model_ckpt

    if tiny:
        config = bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True)
        shape = dict(batch_size=4, seq_len=16)
    else:
        config = bert.BertConfig.base(fused_norms=True)
        shape = dict(batch_size=32, seq_len=128)
    stream = bert_stream(config, seed=0, **shape)[0]()
    batches = [next(stream) for _ in range(PYTORCH_STEPS)]
    dataset = torch.utils.data.TensorDataset(
        torch.from_numpy(np.concatenate([b["x"] for b in batches])).long(),
        torch.from_numpy(np.concatenate([b["y"] for b in batches])).long())
    model = bert.make_model(config, seed=0, device=task_device())
    counted = (layernorm.layernorm, layernorm.layernorm_backward)

    def main_fn(model, loader, device, rank, tb_writer):
        optimizer = common.adamw(2e-5)(model)
        before = {fn.__name__: fn.launches for fn in counted}
        losses = []
        for x, y in loader:
            optimizer.zero_grad(set_to_none=True)
            loss, _ = bert.loss_fn(model, {"x": x.to(device), "y": y.to(device)})
            loss.backward()
            optimizer.step()
            losses.append(float(loss))
        launches = {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in counted}
        if rank == 0:
            model_ckpt.save_ckpt(out_dir, model, optimizer, PYTORCH_STEPS)
        Path(out_dir, f"pytorch-{rank}.json").write_text(json.dumps({
            "rank": rank, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "device": str(device),
            "wrapper": type(model).__name__, "steps": len(losses),
            "losses": losses, "launches": launches,
            "params_sha256": params_digest(model.module.state_dict())}))

    return pytorch.PytorchExperiment(
        model=model, main_fn=main_fn, train_dataset=dataset,
        dataloader_args=pytorch.DataLoaderArgs(
            batch_size=shape["batch_size"] // 2, shuffle=False),
        # BERT's segment embedding is unused without segments.
        ddp_args=pytorch.DistributedDataParallelArgs(
            find_unused_parameters=True),
        # Both ranks share the one card: NCCL refuses that.
        backend="gloo")


def _all_reduce_rank(out_path: str, params) -> None:
    """The fn of rank of phase 9 (c): join a process group from the
    TaskParameters (NCCL on the card, gloo on the CPU), all_reduce a
    tensor of rank + 1 on the task's device and write the result."""
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch._device import task_device

    device = task_device()
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{params.master_addr}:{params.master_port}",
        rank=params.rank, world_size=params.world_size)
    try:
        x = torch.full((4,), float(params.rank + 1), device=device)
        dist.all_reduce(x)
        result = x.tolist()
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps({
        "rank": params.rank, "world_size": params.world_size,
        "backend": backend, "device": str(device), "result": result}))


def launcher_all_reduce_fn(out_path: str):
    """Phase 9 (c)'s experiment fn: the fn of rank, bound to its output."""
    import functools

    return functools.partial(_all_reduce_rank, out_path)


class kv_snapshot:
    """Read `keys` from the run's KV store when each attempt ends, before
    the driver stops the server: `client.handle_events` is wrapped while
    any block is open, and a block reads the attempts of the runs driven
    from its own thread only (phase 9 (j) runs beside the other parts).
    `values` is the last attempt's, `attempts` every attempt's in
    order."""

    _lock = threading.Lock()
    _open = {}  # thread ident -> the snapshot that thread opened
    _original = None

    def __init__(self, client, keys):
        self._client, self._keys = client, keys
        self.values = {}
        self.attempts = []

    def _read(self, kv):
        self.values = {key: kv.get_str(key) for key in self._keys}
        self.attempts.append(self.values)

    def __enter__(self):
        cls = type(self)
        with cls._lock:
            if not cls._open:
                cls._original = original = self._client.handle_events

                def reading(kv, tasks):
                    snapshot = cls._open.get(threading.get_ident())
                    if snapshot is not None:
                        snapshot._read(kv)
                    return original(kv, tasks)

                self._client.handle_events = reading
            cls._open[threading.get_ident()] = self
        return self

    def __exit__(self, *exc):
        cls = type(self)
        with cls._lock:
            cls._open.pop(threading.get_ident(), None)
            if not cls._open:
                self._client.handle_events = cls._original
        return False


def _trace_spans(trace_path: Path):
    """{span name: sorted [(start, end)]} in perf_counter seconds, from a
    task's exported Chrome trace."""
    spans = {}
    for e in json.loads(trace_path.read_text())["traceEvents"]:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(
                (e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6))
    return {name: sorted(found) for name, found in spans.items()}


# The worker's phases before its first step and after its last, by span.
LAUNCHER_SPANS = ("experiment/run", "train/first_batch", "train/init",
                  "train/restore_latest", "train/count_flops",
                  "train/checkpoint_save")


EVALUATOR_HEALTH = ("awake_time_ratio", "eval_step_mean_duration",
                    "last_training_step", "nb_eval_steps")
# Evaluator against the worker's own final eval of the same weights.
EVALUATOR_TOL = 1e-5


def _profile_kernels(profile_dir: Path) -> dict:
    """{kernel name: launches} of the port's kernels in the one Chrome
    trace the worker's profile window wrote."""
    traces = sorted(profile_dir.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile window traces: {traces}")
    found = {}
    for e in json.loads(traces[0].read_text())["traceEvents"]:
        if e.get("cat") == "kernel" and PORT_KERNEL.search(e.get("name", "")):
            name = PORT_KERNEL.search(e["name"]).group(1)
            found[name] = found.get(name, 0) + 1
    return found


def _imports(module: str) -> bool:
    """Whether `module` imports in this environment (the tasks' too)."""
    import importlib

    try:
        importlib.import_module(module)
    except Exception:
        return False
    return True


def launcher_slice(torch, client, topologies, reference_losses,
                   reference_launches, tiny=False, env=None):
    """Phase 9: (a) BERT-base trained LAUNCHER_STEPS steps (chunks of 2)
    in a worker that `run_on_gpu` launched beside an evaluator (on the
    card, the default) and a tensorboard task: Metrics with
    the worker, the KV's last_training_step, the LayerNorm kernels
    launched in the worker as often as phase 7 launched them in this
    process, the losses equal to phase 7's within LAUNCHER_LOSS_RTOL, the
    library not rebuilt; eval-done markers for ckpt-2 and ckpt-4, the
    evaluator's ckpt-4 metrics equal to the worker's final eval within
    EVALUATOR_TOL, the evaluator's LayerNorm forward launched and not its
    backward, its health keys in the KV, the tensorboard URL logged and
    the ``tb/`` events written where tensorboard imports, and the
    TPU_YARN_PROFILE_STEPS="2:4" window's trace holding the LayerNorm
    kernels; the wall to return and the worker's steps from its exported
    trace (task and driver share CLOCK_MONOTONIC). (b) the same run with
    no visible card raises RunFailed with the port's no-CUDA error. (c)
    the fn of rank on tasks.distributed (1 host x 1 process) all_reduces
    through NCCL. (d) the worker requests the preemption drain after
    step 2 in attempt 0 (nb_retries=1): attempt 0 saves ckpt-2 and is
    classified PREEMPTED, attempt 1 resumes at step 2 and its steps 3-4
    equal phase 7's within LAUNCHER_LOSS_RTOL. (e), (d) and (f): see
    `ranks_parts` and `pytorch_part`; (g) runs beside phase 10 (a)
    (`tp_launch`, `tp_check`). `env` adds to every task's environment (the CPU rehearsal's
    TPU_YARN_PLATFORM=cpu goes to every part but (b)). Each part's
    seconds are under "seconds"."""
    import tempfile

    from tf_yarn_tpu_torch import telemetry

    spec = {"worker": topologies.TaskSpec(
        instances=1, chips_per_host=1, label=topologies.NodeLabel.GPU)}
    side_cars = dict(spec,
                     evaluator=topologies.TaskSpec(instances=1),
                     tensorboard=topologies.TaskSpec(
                         instances=1, tb_termination_timeout_seconds=0))
    base_env = {"PYTHONPATH": str(REPO)}
    board = {"writer": _imports("torch.utils.tensorboard"),
             "server": _imports("tensorboard.program")}
    result = {"seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model = tmp / "model"
        keys = ("worker:0/last_training_step", "worker:0/metrics",
                "worker:0/container_start_time", "worker:0/stop",
                *(f"evaluator:0/{key}" for key in EVALUATOR_HEALTH))
        run_env = dict(base_env, TPU_YARN_TRACE=str(tmp / "trace"),
                       TPU_YARN_PROFILE=str(tmp / "profile"),
                       TPU_YARN_PROFILE_STEPS="2:4",
                       TPU_YARN_EVAL_IDLE_TIMEOUT="120", **(env or {}))
        with kv_snapshot(client, keys) as seen, endpoint_log() as log:
            started, started_wall = time.perf_counter(), time.time()
            metrics = client.run_on_gpu(
                client.get_safe_experiment_fn(
                    "chip_smoke.launcher_bert_experiment", str(model), tiny),
                side_cars, env=run_env, poll_every_secs=0.5,
                dead_task_secs=120)
            wall = time.perf_counter() - started
        result["seconds"]["a_train"] = wall
        if (metrics is None or metrics.total_training_duration is None
                or metrics.train_eval_time_per_node.get("worker:0") is None
                or metrics.train_eval_time_per_node.get("evaluator:0") is None):
            raise AssertionError(f"launcher metrics {metrics}")
        if seen.values["worker:0/last_training_step"] != str(LAUNCHER_STEPS):
            raise AssertionError(f"KV after the run: {seen.values}")
        record = json.loads((model / LAUNCHER_COUNTS).read_text())
        # (The CPU rehearsal's plain versions launch nothing.)
        if record["launches"] != reference_launches \
                or (not tiny and min(record["launches"].values()) <= 0):
            raise AssertionError(
                f"LayerNorm launches in the task {record['launches']}, in "
                f"process {reference_launches}")
        if record["built_kernels_here"]:
            raise AssertionError("the launched worker rebuilt the kernels")
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(record["losses"], reference_losses))
        if len(record["losses"]) != LAUNCHER_STEPS \
                or loss_err > LAUNCHER_LOSS_RTOL:
            raise AssertionError(f"launched losses {record['losses']} against "
                                 f"in-process {reference_losses}")
        markers = sorted(p.name for p in (model / "eval-done").glob("*.json"))
        if markers != ["eval-done-2.json", "eval-done-4.json"]:
            raise AssertionError(f"eval-done markers {markers}")
        evaluator = json.loads((model / EVALUATOR_COUNTS).read_text())
        worker_eval = json.loads((model / WORKER_EVAL).read_text())
        final = evaluator["metrics"][str(LAUNCHER_STEPS)]
        eval_err = max(abs(final[k] - worker_eval[k]) for k in worker_eval)
        if sorted(final) != sorted(worker_eval) or eval_err > EVALUATOR_TOL:
            raise AssertionError(f"evaluator's ckpt-{LAUNCHER_STEPS} metrics "
                                 f"{final}, the worker's {worker_eval}")
        if not tiny and (evaluator["launches"]["layernorm"] <= 0
                         or evaluator["launches"]["layernorm_backward"]):
            raise AssertionError(f"evaluator launches {evaluator}")
        health = {key: seen.values[f"evaluator:0/{key}"]
                  for key in EVALUATOR_HEALTH}
        if None in health.values() or health["last_training_step"] != str(
                LAUNCHER_STEPS):
            raise AssertionError(f"evaluator health keys {health}")
        # Where tensorboard does not import, the run goes on without it:
        # no event files, no URL.
        tb_url = log.endpoints("tensorboard URL")
        tb_events = sorted(p.name for p in (model / "tb").glob("events.*"))
        if board["server"] != (len(tb_url) == 1) \
                or board["writer"] != bool(tb_events):
            raise AssertionError(
                f"tensorboard imports {board}; URL logged {tb_url}; events "
                f"{tb_events}")
        profiled = _profile_kernels(tmp / "profile")
        if not tiny and not any(name.startswith("layernorm")
                                for name in profiled):
            raise AssertionError(f"profile window kernels {profiled}")
        spans = _trace_spans(tmp / "trace" / "trace_worker-0.json")
        # A chunk: its dispatch span through the end of its device wait.
        chunks = [(start, wait_end) for (start, _), (_, wait_end) in zip(
            spans["train/step_dispatch"], spans["train/device_wait"])]
        chunk_s = [end - start for start, end in chunks]
        task_metrics = json.loads(seen.values["worker:0/metrics"])
        result["a_train"] = {
            "wall_s": wall,
            "launch_to_task_start_s":
                float(seen.values["worker:0/container_start_time"])
                - started_wall,
            "task_spans_s": {name: [end - start for start, end in spans[name]]
                             for name in LAUNCHER_SPANS if name in spans},
            "launch_to_first_chunk_start_s": chunks[0][0] - started,
            "launch_to_first_chunk_end_s": chunks[0][1] - started,
            "chunk_s": chunk_s, "steps_per_chunk": 2,
            "total_training_duration_s": metrics.total_training_duration,
            "container_duration_s": metrics.container_duration,
            "last_training_step": seen.values["worker:0/last_training_step"],
            "task_metrics_keys": len(task_metrics),
            "task_steps_total": task_metrics.get("train/steps_total"),
            "checkpoint_seconds": {
                key: value for key, value in task_metrics.items()
                if key.startswith("checkpoint/seconds")},
            "checkpoint_ops_at_last_step": record["checkpoint_ops"],
            "launches": record["launches"],
            "reference_launches": reference_launches,
            "losses": record["losses"], "reference_losses": reference_losses,
            "loss_max_rel_err": loss_err,
            "losses_bitwise_equal": record["losses"] == list(reference_losses),
            "device": record["device"],
            "evaluator": {"markers": markers, "device": evaluator["device"],
                          "launches": evaluator["launches"],
                          "ckpt_metrics": evaluator["metrics"],
                          "worker_final_eval": worker_eval,
                          "max_abs_err": eval_err, "health": health,
                          "train_eval_s":
                              metrics.train_eval_time_per_node["evaluator:0"]},
            "tensorboard": {"imports": board, "url": tb_url,
                            "events": tb_events},
            "profile_window_kernels": profiled,
        }

        def no_card():
            started = time.perf_counter()
            try:
                client.run_on_gpu(
                    client.get_safe_experiment_fn(
                        "chip_smoke.launcher_bert_experiment",
                        str(tmp / "no_card"), tiny),
                    spec, env=dict(base_env, CUDA_VISIBLE_DEVICES=""),
                    poll_every_secs=0.5, dead_task_secs=120)
            except client.RunFailed as exc:
                if "no CUDA device is available" not in str(exc):
                    raise AssertionError(
                        f"no-card run failed otherwise: {exc}")
                out = {"raised": "RunFailed", "kind": exc.kind.value,
                       "wall_s": time.perf_counter() - started}
            else:
                raise AssertionError("a worker with no visible card trained")
            if (tmp / "no_card" / LAUNCHER_COUNTS).exists():
                raise AssertionError("the no-card run reached a training step")
            return out

        def fn_of_rank():
            out = tmp / "all_reduce.json"
            started = time.perf_counter()
            client.run_on_gpu(
                client.get_safe_experiment_fn(
                    "chip_smoke.launcher_all_reduce_fn", str(out)),
                spec, custom_task_module="tf_yarn_tpu_torch.tasks.distributed",
                env=dict(base_env, **(env or {})), poll_every_secs=0.5,
                dead_task_secs=120)
            reduced = json.loads(out.read_text())
            if reduced["result"] != [1.0] * 4 or reduced["world_size"] != 1 \
                    or reduced["backend"] != ("gloo" if tiny else "nccl"):
                raise AssertionError(f"fn of rank: {reduced}")
            return dict(reduced, wall_s=time.perf_counter() - started)

        result.update(ranks_parts(torch, client, topologies, tmp, base_env,
                                  env, reference_losses, reference_launches,
                                  tiny, result["seconds"]))
        # (b), (c) and (f) share no KV snapshot: they run at once, each
        # timed on its own, and "bcf_together" is their common wall.
        started = time.perf_counter()
        parts = concurrently({
            "b_no_card": no_card, "c_all_reduce": fn_of_rank,
            "f_pytorch": lambda: pytorch_part(client, topologies, tmp,
                                              base_env, env, tiny)})
        result["seconds"]["bcf_together"] = time.perf_counter() - started
        for name, (value, seconds) in parts.items():
            result[name] = value
            result["seconds"][name] = seconds
    return result


# Phase 9 (d), (e) and (f): two ranks, a chief and a worker of
# `allreduce_topology`, share the one card, so their process group is gloo
# (NCCL refuses two ranks on one device).
LAUNCHER_RANKS = 2
RANK_TASKS = ("chief:0", "worker:0")
# Loss band of (e)'s two ranks (the mean of their losses, each on its half
# of the global batch) against phase 7's one device, relative. Not the
# same computation: BERT-base's dropout (0.1) draws other masks in each
# rank (the rank is in its seed), and the bf16 GEMMs run on half the rows.
# The first H100 run measured 0.115 (step 4; 0.018 at step 1), so this is
# a sanity band; the data-parallel arithmetic is held at 1e-5 on the CPU
# against the JAX package with dropout 0 (tests/test_torch_data_parallel.py).
RANKS_LOSS_RTOL = 0.3


def _grad_allreduce_by_step(trace_path: Path) -> dict:
    """{step: {"buckets", "bytes", "sum_s", "wall_s"}} of the DDP
    gradient all-reduces (`train/grad_allreduce` spans) in a rank's
    exported trace: the buckets' bytes, their summed seconds and their
    first start to last end, launch to completion as the host saw
    them."""
    steps = {}
    for e in json.loads(trace_path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "train/grad_allreduce":
            steps.setdefault(int(e["args"]["step"]), []).append(
                (e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6,
                 e["args"]["bytes"]))
    return {step: {"buckets": len(spans),
                   "bytes": sum(n for _, _, n in spans),
                   "sum_s": sum(end - start for start, end, _ in spans),
                   "wall_s": max(end for _, end, _ in spans)
                   - min(start for start, _, _ in spans)}
            for step, spans in sorted(steps.items())}


def ranks_parts(torch, client, topologies, tmp, base_env, env,
                reference_losses, reference_launches, tiny, seconds):
    """Phase 9 (e) and (d). (e) `run_on_gpu` of `allreduce_topology`'s
    chief and one worker trains phase 7's BERT-base LAUNCHER_STEPS steps at
    ``MeshSpec(dp=2)``, each rank on its half of phase 7's global batch,
    a checkpoint every 2 steps: each rank's backend and device; its
    LayerNorm kernels launched as often as phase 7 launched them; the
    ranks' parameters bitwise equal; the mean of their losses within
    RANKS_LOSS_RTOL of phase 7's; checkpoints written by rank 0 alone and
    ckpt-4 equal to its parameters; each step's gradient all-reduce
    seconds from rank 0's trace. (d) the same run with
    ``drain_poll_every_steps=2`` and ``nb_retries=1``, rank 1 requesting
    the drain after step 2 in attempt 0: both ranks drain at ckpt-2, the
    attempt is PREEMPTED, and attempt 1 resumes at step 2 with each
    rank's steps 3-4 equal to (e)'s within LAUNCHER_LOSS_RTOL. `seconds`
    gets each part's wall. (f) is `pytorch_part`."""
    from tf_yarn_tpu_torch import checkpoint as ckpt
    from tf_yarn_tpu_torch import telemetry

    out = {}
    spec = topologies.allreduce_topology(nb_workers=1, chips_per_host=1)
    want_device = "cpu" if tiny else "cuda"

    def records(model_dir):
        return [json.loads(rank_counts_path(model_dir, rank).read_text())
                for rank in range(LAUNCHER_RANKS)]

    ranks_dir = tmp / "ranks"
    started = time.perf_counter()
    with kv_snapshot(client, tuple(f"{task}/last_training_step"
                                   for task in RANK_TASKS)) as seen:
        client.run_on_gpu(
            client.get_safe_experiment_fn(
                "chip_smoke.launcher_bert_experiment", str(ranks_dir), tiny,
                None, LAUNCHER_RANKS),
            spec, env=dict(base_env, TPU_YARN_TRACE=str(tmp / "ranks_trace"),
                           **(env or {})),
            poll_every_secs=0.5, dead_task_secs=120)
    seconds["e_ranks"] = time.perf_counter() - started
    ranked = records(ranks_dir)
    global_losses = [sum(r["losses"][i] for r in ranked) / LAUNCHER_RANKS
                     for i in range(LAUNCHER_STEPS)]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(global_losses, reference_losses))
    traces = {task: _trace_spans(tmp / "ranks_trace"
                                 / f"trace_{task.replace(':', '-')}.json")
              for task in RANK_TASKS}
    saves = {task: len(spans.get("checkpoint/save_submit", []))
             for task, spans in traces.items()}
    restored = ckpt.restore_checkpoint(str(ranks_dir), LAUNCHER_STEPS,
                                       map_location="cpu")["params"]
    allreduce = _grad_allreduce_by_step(
        tmp / "ranks_trace" / "trace_chief-0.json")
    problems = [
        r for r in ranked
        if (r["world"], r["backend"], r["n_try"]) != (LAUNCHER_RANKS, "gloo", 0)
        or not r["device"].startswith(want_device)
        or r["launches"] != reference_launches
        or len(r["losses"]) != LAUNCHER_STEPS]
    if (problems or len({r["params_sha256"] for r in ranked}) != 1
            or loss_err > RANKS_LOSS_RTOL
            or saves != {"chief:0": 2, "worker:0": 0}
            or params_digest(restored) != ranked[0]["params_sha256"]
            or seen.values != {"chief:0/last_training_step":
                               str(LAUNCHER_STEPS),
                               "worker:0/last_training_step": None}
            or sorted(allreduce) != list(range(LAUNCHER_STEPS))):
        raise AssertionError(
            f"two ranks: records {ranked}, global losses {global_losses} "
            f"against {reference_losses}, checkpoint saves {saves}, KV "
            f"{seen.values}, all-reduces {allreduce}\n{task_log_tails()}")
    out["e_ranks"] = {
        "ranks": [{key: r[key] for key in ("rank", "world", "backend",
                                           "device", "launches", "losses")}
                  for r in ranked],
        "global_losses": global_losses,
        "reference_losses": reference_losses,
        "loss_max_rel_err": loss_err,
        "params_bitwise_equal_across_ranks": True,
        "ckpt_restored_equal_rank0": True,
        "checkpoint_save_submits": saves,
        "grad_allreduce_by_step": allreduce,
        # A chunk of 2 steps: its dispatch through its device wait, rank 0.
        "chunk_s": [wait_end - start for (start, _), (_, wait_end) in zip(
            traces["chief:0"]["train/step_dispatch"],
            traces["chief:0"]["train/device_wait"])],
        "task_spans_s": {task: {name: [end - start for start, end
                                       in spans[name]]
                                for name in LAUNCHER_SPANS
                                + ("train/parallel_wrap",) if name in spans}
                         for task, spans in traces.items()},
        "wall_s": seconds["e_ranks"],
    }

    drained = tmp / "drained"
    retries = telemetry.get_registry().counter(
        "driver/retries_total", kind="PREEMPTED")
    retried_before = retries.value
    started = time.perf_counter()
    with kv_snapshot(client, tuple(f"{task}/stop" for task in RANK_TASKS)
                     + ("chief:0/last_training_step",)) as seen:
        client.run_on_gpu(
            client.get_safe_experiment_fn(
                "chip_smoke.launcher_bert_experiment", str(drained), tiny, 2,
                LAUNCHER_RANKS, 2, 1),
            spec, env=dict(base_env, **(env or {})), nb_retries=1,
            poll_every_secs=0.5, dead_task_secs=120)
    seconds["d_drain"] = time.perf_counter() - started
    first, last = (seen.attempts + [{}, {}])[:2]
    stops = {task: (first.get(f"{task}/stop") or "").strip()
             for task in RANK_TASKS}
    resumed = records(drained)
    resume_err = max(abs(a - b) / abs(b) for r, e in zip(resumed, ranked)
                     for a, b in zip(r["losses"], e["losses"][2:]))
    if (len(seen.attempts) != 2
            or any("preempted at step 2; checkpoint saved to" not in stop
                   for stop in stops.values())
            or retries.value - retried_before != 1
            or any((r["n_try"], r["start_step"], len(r["losses"]))
                   != (1, 2, LAUNCHER_STEPS - 2) for r in resumed)
            or last.get("chief:0/last_training_step") != str(LAUNCHER_STEPS)
            or resume_err > LAUNCHER_LOSS_RTOL):
        raise AssertionError(
            f"drain at two ranks: attempts {seen.attempts}, records "
            f"{resumed}, retries {retries.value - retried_before}, (e)'s "
            f"records {ranked}\n{task_log_tails(runs=2)}")
    out["d_drain"] = {
        "attempts": len(seen.attempts),
        "attempt_0_stops": {task: stop.splitlines()[-1]
                            for task, stop in stops.items()},
        "preempted_retries": retries.value - retried_before,
        "resumed_at": [r["start_step"] for r in resumed],
        "losses": [r["losses"] for r in resumed],
        "reference_losses": [r["losses"][2:] for r in ranked],
        "loss_max_rel_err": resume_err,
        "losses_bitwise_equal": all(
            r["losses"] == e["losses"][2:] for r, e in zip(resumed, ranked)),
        "wall_s": seconds["d_drain"],
    }

    return out


def concurrently_started(parts: dict):
    """Start each zero-argument fn of `parts` in a thread of its own, all
    at once; returns a fn that waits for them and gives `concurrently`'s
    {name: (its result, its seconds)}, raising the first failure."""
    done, errors = {}, []

    def run(name, fn):
        started = time.perf_counter()
        try:
            done[name] = (fn(), time.perf_counter() - started)
        except BaseException as exc:  # re-raised by the waiter
            errors.append(exc)

    threads = [threading.Thread(target=run, args=item, name=item[0])
               for item in parts.items()]
    for thread in threads:
        thread.start()

    def wait() -> dict:
        for thread in threads:
            thread.join()
        if errors:
            raise errors[0]
        return done

    return wait


def concurrently(parts: dict) -> dict:
    """Run each zero-argument fn of `parts` in a thread of its own, all at
    once: {name: (its result, its seconds)}; the first failure is raised
    after all have ended."""
    done = concurrently_started(parts)()
    return {name: done[name] for name in parts}


def pytorch_part(client, topologies, tmp, base_env, env, tiny):
    """Phase 9 (f): `pytorch.run_on_gpu` of two pytorch workers running
    `launcher_pytorch_experiment`: the ranks' parameters bitwise equal,
    rank 0's `model_ckpt` save equal to them, the LayerNorm kernels
    launched in each worker."""
    from tf_yarn_tpu_torch import pytorch
    from tf_yarn_tpu_torch.utils import model_ckpt

    want_device = "cpu" if tiny else "cuda"
    torch_dir = tmp / "pytorch"
    torch_dir.mkdir()
    started = time.perf_counter()
    pytorch.run_on_gpu(
        client.get_safe_experiment_fn("chip_smoke.launcher_pytorch_experiment",
                                      str(torch_dir), tiny),
        {"worker": topologies.TaskSpec(instances=LAUNCHER_RANKS,
                                       chips_per_host=1,
                                       label=topologies.NodeLabel.GPU)},
        env=dict(base_env, **(env or {})), poll_every_secs=0.5,
        dead_task_secs=120)
    wall = time.perf_counter() - started
    workers = [json.loads((torch_dir / f"pytorch-{rank}.json").read_text())
               for rank in range(LAUNCHER_RANKS)]
    saved = model_ckpt.load_latest_ckpt(str(torch_dir))
    if (any((w["world"], w["backend"], w["wrapper"], w["steps"])
            != (LAUNCHER_RANKS, "gloo", "DistributedDataParallel",
                PYTORCH_STEPS) or not w["device"].startswith(want_device)
            or (not tiny and min(w["launches"].values()) <= 0)
            for w in workers)
            or len({w["params_sha256"] for w in workers}) != 1
            or saved["epoch"] != PYTORCH_STEPS
            or params_digest(saved["model"]) != workers[0]["params_sha256"]):
        raise AssertionError(f"pytorch workers {workers}, saved epoch "
                             f"{saved['epoch']}\n{task_log_tails(runs=3)}")
    return {
        "workers": [{key: w[key] for key in ("rank", "backend", "device",
                                             "losses", "launches")}
                    for w in workers],
        "params_bitwise_equal_across_ranks": True,
        "model_ckpt_restored_equal": True,
        "wall_s": wall,
    }


# Phase 9 (g) and phase 4's tiny check: the LoRA decoder trained at
# ``MeshSpec(tp=2)`` by two ranks that share the one card (gloo), held
# against the same experiment at one rank in this process.
TP_RANKS = 2
TP_STEPS = 3
# (g)'s losses against the one-rank run, relative: bf16 GEMMs whose K is
# split over the ranks in `wo` and `w_down` (summed after), the same
# weights, batches and kernels; the decoder has no dropout. The one rank's
# losses move by 1.0e-3 and 2.9e-3 relative from the first over its 3
# steps, and the tp=2 ranks were 1.03e-4 from them (the card runs of
# PERF.md §6): the bound lies between, so ranks whose adapters did not
# train fail it. The one rank's own movement must exceed twice the bound.
TP_LOSS_RTOL = 5e-4
# (g)'s adapters against the one-rank run: the change from the init of
# every LoRA factor, ||rank 0's change - the one rank's|| over ||the one
# rank's change||, all factors at once (1.0 for adapters that never
# moved). Adam moves an element whose gradient is near zero by up to the
# learning rate either way, and bf16 noise decides which way: the card
# measured 0.0925 (PERF.md §6), and the bound is about twice that.
TP_ADAPTER_RTOL = 0.2
# Phase 4's tiny f32 decoder at tp=2 against one rank: f32 sums in another
# order (losses relative, adapters absolute).
TP_TINY_TOL = 1e-4
# Flash calls' (query heads, kv heads) and (query heads, kv heads,
# sequence), recorded by `record_flash_heads`.
_FLASH_HEADS = set()
_FLASH_SHAPES = set()
# The one-rank reference's model, kept by `tp_experiment(keep=True)`,
# and its LoRA factors at init (on the host).
_TP_MODELS = []
_TP_INIT = {}


# Phase 9 (j): an elastic shrink. Two workers of (e)'s BERT-base run at
# MeshSpec(dp=2) share the card over gloo; chaos SIGKILLs worker:1 after
# step ELASTIC_KILL_STEP of attempt 0, and the driver's ElasticPolicy
# relaunches one worker, which refits the mesh to dp=1 and resumes.
ELASTIC_STEPS = 4
ELASTIC_KILL_STEP = 3
ELASTIC_FAULT = f"lose_host_at_step={ELASTIC_KILL_STEP}@worker:1"
# A worker silent this long is declared lost (the watchdog's path; a
# survivor whose gloo peer died usually fails on its own first).
ELASTIC_DEAD_TASK_SECS = 15.0
# Attempt 1 against the in-process one-device replay of steps 3-4 from the
# same ckpt-2 on the same global batches: the same code, weights, batches
# and one-device dropout masks (`training.step_seed`), so the losses come
# out equal but for the order of the embedding backward's float atomics,
# as (d)'s resumed steps do (LAUNCHER_LOSS_RTOL). The parameters are f32
# masters: an atomic's reordering moves an Adam update by ~1e-7 of it,
# except on the key biases, whose gradient is rounding noise that Adam
# turns into a step of up to the learning rate (2e-5, bert.make_experiment).
ELASTIC_LOSS_RTOL = 1e-5
ELASTIC_PARAM_ATOL = 1e-5
ELASTIC_KEY_BIAS_ATOL = 2 * 2e-5


def elastic_record_path(model_dir, n_try: int, rank: int) -> Path:
    return Path(model_dir) / f"elastic-{n_try}-{rank}.json"


def elastic_bert_experiment(model_dir: str, tiny: bool = False,
                            replay: bool = False):
    """Phase 9 (j)'s experiment fn: phase 7's BERT-base experiment (the
    same batches from `bert_stream`) with a model_dir, ELASTIC_STEPS steps
    of one step a chunk (so the chaos hook sees every step), a checkpoint
    every 2 steps, all kept, at a declared ``MeshSpec(dp=2)`` (none for
    the in-process `replay`). After each optimizer step it writes
    elastic-<attempt>-<rank>.json: the losses, the wall time of each
    step's end, the LayerNorm launches of this process, the world, its
    backend and device, the train loop's capacity gauges and its
    "elastic:" log lines, the digest of the state the attempt's first
    step found (taken before its update: the restored checkpoint on a
    resumed attempt) and of the parameters after the last step. `tiny`:
    the tiny f32 config, for a rehearsal on the CPU."""
    import logging

    import torch.distributed as dist

    from tf_yarn_tpu_torch import constants, telemetry
    from tf_yarn_tpu_torch.models import bert
    from tf_yarn_tpu_torch.ops import layernorm
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    if tiny:
        import torch

        config = bert.BertConfig.tiny(dtype=torch.float32, fused_norms=True)
        shape = dict(batch_size=4, seq_len=16)
    else:
        config = bert.BertConfig.base(fused_norms=True)
        shape = dict(batch_size=32, seq_len=128)
    input_fn, seen = bert_stream(config, seed=0, **shape)
    exp = bert.make_experiment(
        config, model_dir=model_dir, train_steps=ELASTIC_STEPS,
        log_every_steps=1, steps_per_loop=1, checkpoint_every_steps=2,
        keep_last_n=None, input_fn=input_fn,
        mesh_spec=None if replay else MeshSpec(dp=2), **shape)
    n_try = int(os.environ.get(constants.ENV_N_TRY, "0"))
    record = {"n_try": n_try, "losses": [], "step_end_wall": [],
              "elastic_log": []}
    if not replay:
        class Refits(logging.Handler):
            def emit(self, entry):
                if entry.getMessage().startswith("elastic:"):
                    record["elastic_log"].append(entry.getMessage())

        logging.getLogger("tf_yarn_tpu_torch.training").addHandler(
            Refits(logging.WARNING))
    loss_fn, make_optimizer = exp.loss_fn, exp.optimizer
    losses = []

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(loss.detach())
        return loss, aux

    def optimizer(model):
        opt = make_optimizer(model)

        def before_step(opt, args, kwargs):
            if "restored_sha256" not in record:
                record["restored_sha256"] = {
                    "params": params_digest(model.state_dict()),
                    "optimizer": params_digest(opt.state_dict()["state"])}

        def after_step(opt, args, kwargs):
            grouped = dist.is_available() and dist.is_initialized()
            rank = dist.get_rank() if grouped else 0
            gauges = telemetry.get_registry().snapshot()
            record.update(
                losses=[float(x) for x in losses], start_step=seen["start_step"],
                launches={fn.__name__: fn.launches for fn in (
                    layernorm.layernorm, layernorm.layernorm_backward)},
                device=str(model.device), rank=rank,
                world=dist.get_world_size() if grouped else 1,
                backend=dist.get_backend() if grouped else None,
                gauges={key: gauges.get(key) for key in (
                    "train/mesh_devices", "train/degraded")})
            record["step_end_wall"].append(time.time())
            if (seen["start_step"] or 0) + len(losses) == ELASTIC_STEPS:
                record["params_sha256"] = params_digest(model.state_dict())
            Path(model_dir).mkdir(parents=True, exist_ok=True)
            elastic_record_path(model_dir, n_try, rank).write_text(
                json.dumps(record))

        opt.register_step_pre_hook(before_step)
        opt.register_step_post_hook(after_step)
        return opt

    exp.loss_fn, exp.optimizer = recording_loss, optimizer
    return exp


def _max_abs_err(torch, got, want, keep):
    """The largest |got - want| over the tensors of `want` that `keep`
    names, and whether all of them are bitwise equal."""
    worst, equal = 0.0, True
    for name, value in want.items():
        if keep(name):
            diff = (got[name].double() - value.double()).abs().max().item()
            worst = max(worst, diff)
            equal = equal and torch.equal(got[name], value)
    return worst, equal


def elastic_part(torch, client, topologies, training, experiment, counted,
                 reference_launches, dev, tiny=False, env=None):
    """Phase 9 (j): `run_on_gpu` of two workers (`elastic_bert_experiment`)
    with ``ElasticPolicy(min_workers=1, max_workers=2)``, ``nb_retries``
    1 and ``TPU_YARN_FAULT=ELASTIC_FAULT``: the driver classifies attempt
    0 LOST_TASK and records the shrink 2 -> 1; attempt 1 runs one worker
    on the card, logs the dp=1 refit, reads `train/mesh_devices` 1 and
    `train/degraded` 1, resumes at ckpt-2 with ckpt-2's state bitwise and
    finishes step 4; each attempt's workers launched the LayerNorm
    forward and backward as often as their steps call for; its losses
    and ckpt-4 match a one-device replay of steps 3-4 in this process
    from the same ckpt-2 (`counted`'s counts set to 0 just before it).
    Returns the part's record, with the seconds from the kill to the
    LOST_TASK classification and from the relaunch to its first step.
    `reference_launches`: phase 7's BERT-base counts (its count_flops
    pass and 4 steps)."""
    from tf_yarn_tpu_torch import checkpoint as ckpt
    from tf_yarn_tpu_torch import resilience, telemetry

    tmp = Path(tempfile.mkdtemp(prefix="elastic_j"))
    try:
        model_dir = tmp / "model"
        want_device = "cpu" if tiny else "cuda"
        retry = resilience.RetryPolicy.from_nb_retries(
            1, seed=0, base_backoff_secs=0.5, max_backoff_secs=1.0)
        elastic = resilience.ElasticPolicy(min_workers=1, max_workers=2)
        shrinks = telemetry.get_registry().counter(
            "driver/elastic_resizes_total", direction="shrink")
        shrinks_before = shrinks.value
        # The driver's moments in this thread (other parts run beside it):
        # each attempt's launch and each classified failure, wall clock.
        me = threading.get_ident()
        launched, failed = [], []
        setup, execute = client._setup_cluster, client._execute_and_await_termination

        def timed_setup(*args, **kwargs):
            if threading.get_ident() == me:
                launched.append(time.time())
            return setup(*args, **kwargs)

        def timed_execute(*args, **kwargs):
            try:
                return execute(*args, **kwargs)
            except client.RunFailed as exc:
                if threading.get_ident() == me:
                    failed.append((time.time(), exc.kind.value, exc.lost_tasks))
                raise

        client._setup_cluster = timed_setup
        client._execute_and_await_termination = timed_execute
        started = time.perf_counter()
        try:
            client.run_on_gpu(
                client.get_safe_experiment_fn(
                    "chip_smoke.elastic_bert_experiment", str(model_dir), tiny),
                {"worker": topologies.TaskSpec(instances=2)}, name="elastic",
                env=dict({"PYTHONPATH": str(REPO), "TPU_YARN_FAULT": ELASTIC_FAULT,
                          "TPU_YARN_HEARTBEAT_SECS": "0.5"}, **(env or {})),
                retry_policy=retry, elastic_policy=elastic,
                dead_task_secs=ELASTIC_DEAD_TASK_SECS, poll_every_secs=0.5)
        except Exception as exc:
            raise AssertionError(
                f"(j) elastic run failed: {exc}\n"
                f"{task_log_tails(runs=2, name='elastic')}") from exc
        finally:
            client._setup_cluster = setup
            client._execute_and_await_termination = execute
        launched_wall = time.perf_counter() - started
        records = {(n_try, rank): json.loads(
            elastic_record_path(model_dir, n_try, rank).read_text())
            for n_try, rank in ((0, 0), (0, 1), (1, 0))
            if elastic_record_path(model_dir, n_try, rank).exists()}
        stored = ckpt.restore_checkpoint(str(model_dir), 2, map_location="cpu")
        ckpt2 = {"params": params_digest(stored["params"]),
                 "optimizer": params_digest(stored["optimizer"]["state"])}
        del stored
        relaunch = records.get((1, 0), {})
        problems = []
        if [d.kind.value for d in retry.history] != ["LOST_TASK"] \
                or [kind for _, kind, _ in failed] != ["LOST_TASK"] \
                or failed[0][2] != ["worker:1"]:
            problems.append(f"retries {retry.history}, failures {failed}")
        if [(r.direction, r.from_workers, r.to_workers, r.kind.value)
                for r in elastic.history] != [("shrink", 2, 1, "LOST_TASK")] \
                or shrinks.value - shrinks_before != 1:
            problems.append(f"elastic history {elastic.history}")
        for rank in (0, 1):
            r = records.get((0, rank), {})
            if (r.get("world"), r.get("backend"), len(r.get("losses", ()))) \
                    != (2, "gloo", ELASTIC_KILL_STEP) \
                    or not r.get("device", "").startswith(want_device):
                problems.append(f"attempt 0 rank {rank}: {r}")
        if (relaunch.get("world"), relaunch.get("start_step"),
                len(relaunch.get("losses", ()))) != (1, 2, ELASTIC_STEPS - 2) \
                or not relaunch.get("device", "").startswith(want_device) \
                or relaunch.get("gauges") != {"train/mesh_devices": 1.0,
                                              "train/degraded": 1.0} \
                or len(relaunch.get("elastic_log", ())) != 1 \
                or "refit onto 1 ranks -> MeshSpec(dp=1," \
                not in relaunch["elastic_log"][0]:
            problems.append(f"attempt 1: {relaunch}")
        if relaunch.get("restored_sha256") != ckpt2:
            problems.append(f"attempt 1 restored {relaunch.get('restored_sha256')}"
                            f", ckpt-2 {ckpt2}")
        if ckpt.latest_verified_step(str(model_dir)) != ELASTIC_STEPS:
            problems.append(f"checkpoints {ckpt.list_checkpoint_steps(str(model_dir))}")
        if problems:
            raise AssertionError(
                "(j) elastic shrink: " + "; ".join(problems)
                + f"\n{task_log_tails(runs=2, name='elastic')}")

        # The one-device replay of steps 3-4 from the same ckpt-2.
        replay_dir = tmp / "replay"
        replay_dir.mkdir()
        shutil.copytree(model_dir / "ckpt-2", replay_dir / "ckpt-2")
        _zero(counted)
        started = time.perf_counter()
        training.train_and_evaluate(experiment.as_core_experiment(
            elastic_bert_experiment(str(replay_dir), tiny, replay=True)),
            device=dev)
        replay_s = time.perf_counter() - started
        replay = json.loads(elastic_record_path(replay_dir, 0, 0).read_text())
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(relaunch["losses"], replay["losses"]))
        got = ckpt.restore_checkpoint(str(model_dir), ELASTIC_STEPS,
                                      map_location="cpu")["params"]
        want = ckpt.restore_checkpoint(str(replay_dir), ELASTIC_STEPS,
                                       map_location="cpu")["params"]
        param_err, params_equal = _max_abs_err(
            torch, got, want, lambda name: not name.endswith("wk.bias"))
        key_bias_err, key_biases_equal = _max_abs_err(
            torch, got, want, lambda name: name.endswith("wk.bias"))
        # Launches: every run makes one count_flops pass (c) before its steps
        # (s each). The replay and attempt 1 run c + 2s, attempt 0's ranks
        # c + 3s by their step 3, phase 7 c + 4s.
        launch_problems = []
        for name, replayed in replay["launches"].items():
            step = records[(0, 0)]["launches"][name] - replayed
            counts = (relaunch["launches"][name], records[(0, 1)]["launches"][name],
                      reference_launches[name])
            if counts != (replayed, replayed + step, replayed + 2 * step) \
                    or (not tiny and step <= 0):
                launch_problems.append((name, replayed, step, counts))
        if (len(replay["losses"]) != ELASTIC_STEPS - 2 or loss_err
                > ELASTIC_LOSS_RTOL or param_err > ELASTIC_PARAM_ATOL
                or key_bias_err > ELASTIC_KEY_BIAS_ATOL or launch_problems
                or replay.get("restored_sha256") != ckpt2):
            raise AssertionError(
                f"(j) against the one-device replay: losses {relaunch['losses']}"
                f" and {replay['losses']}, parameters max abs err {param_err}, "
                f"key biases {key_bias_err}, launches {launch_problems}, replay "
                f"restored {replay.get('restored_sha256')}")
        kill_at = records[(0, 1)]["step_end_wall"][-1]
        result = {
            "retries": [d.kind.value for d in retry.history],
            "elastic_history": [[r.direction, r.from_workers, r.to_workers,
                                 r.kind.value] for r in elastic.history],
            "lost_tasks": failed[0][2],
            "attempt_0": [{key: records[(0, rank)][key] for key in (
                "rank", "world", "backend", "device", "losses", "launches")}
                for rank in (0, 1)],
            "attempt_1": {key: relaunch[key] for key in (
                "world", "device", "start_step", "losses", "launches", "gauges",
                "elastic_log")},
            "restored_bitwise_ckpt_2": True,
            "replay_losses": replay["losses"],
            "loss_max_rel_err": loss_err,
            "losses_bitwise_equal": relaunch["losses"] == replay["losses"],
            "ckpt_4_max_abs_err": param_err, "ckpt_4_bitwise": params_equal,
            "key_bias_max_abs_err": key_bias_err,
            "key_biases_bitwise": key_biases_equal,
            "kill_to_lost_task_s": failed[0][0] - kill_at,
            "relaunch_to_first_step_s":
                relaunch["step_end_wall"][0] - launched[1],
            "launched_run_s": launched_wall, "replay_s": replay_s,
        }
        shutil.rmtree(tmp, ignore_errors=True)
        return result
    finally:
        # After any failure message has taken the task logs' tails.
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 9 (k): remote hosts and remote storage. Two fake hosts reached
# through an ssh stand-in, each a bare interpreter under a HOME of its own
# on this machine; the code, this script and a hand-built wheel shipped to
# them; the model_dir on a registered scheme over a local directory.
REMOTE_HOSTS = 2
REMOTE_SCHEME = "smokefs"
REMOTE_DEP = "smokedep"
REMOTE_DEP_VALUE = 4242
# (k)'s ranks against (e)'s: the same ranks, code, weights, batches and
# dropout streams on the same card, run from shipped copies (so bitwise
# so far, as (a) is against phase 7; LAUNCHER_LOSS_RTOL's reasoning).
REMOTE_LOSS_RTOL = LAUNCHER_LOSS_RTOL

_REMOTE_SHIM = '''#!{python} -S
"""ssh stand-in: `shim <host> <command>` runs the command in /bin/sh with
HOME={base}/<host>, from there, without the caller's PYTHONPATH (a bare
host: the interpreter's site-packages and nothing of the checkout); a
SIGTERM reaches the command's whole process group."""
import os, signal, subprocess, sys

host, command = sys.argv[1], sys.argv[2]
home = os.path.join({base!r}, host)
os.makedirs(home, exist_ok=True)
env = {{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}}
env["HOME"] = home
proc = subprocess.Popen(["/bin/sh", "-c", command], cwd=home, env=env,
                        start_new_session=True)
for sig in (signal.SIGTERM, signal.SIGINT):
    signal.signal(sig, lambda s, f: os.killpg(proc.pid, s))
code = proc.wait()
sys.exit(128 - code if code < 0 else code)
'''


class SmokeFS:
    """A filesystem for `fs.register_scheme` over a local directory, with
    the pyarrow.fs.FileSystem methods the port's `fs` calls and no pyarrow:
    what a vendor filesystem plugs in. Paths are relative to `root`."""

    def __init__(self, root: str):
        self.root = root

    def _local(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def _info(self, fs, path: str):
        local = self._local(path)
        if os.path.isdir(local):
            return fs.FileInfo(path, fs.FileType.Directory)
        if os.path.exists(local):
            return fs.FileInfo(path, fs.FileType.File,
                               os.path.getsize(local))
        return fs.FileInfo(path, fs.FileType.NotFound)

    def get_file_info(self, target):
        from tf_yarn_tpu_torch import fs

        if not isinstance(target, fs.FileSelector):
            return self._info(fs, target)
        base = target.base_dir.rstrip("/")
        found = []
        for root, dirs, files in os.walk(self._local(base)):
            rel = os.path.relpath(root, self._local(base))
            prefix = base if rel == "." else f"{base}/{rel}"
            found += [self._info(fs, f"{prefix}/{name}".lstrip("/"))
                      for name in sorted(dirs) + sorted(files)]
            if not target.recursive:
                break
        return found

    def create_dir(self, path, recursive=True):
        os.makedirs(self._local(path), exist_ok=True)

    def delete_dir(self, path):
        shutil.rmtree(self._local(path))

    def move(self, src, dst):
        os.replace(self._local(src), self._local(dst))

    def open_output_stream(self, path):
        return open(self._local(path), "wb")

    def open_input_stream(self, path):
        return open(self._local(path), "rb")

    open_input_file = open_input_stream


def register_smokefs(fs_root: str) -> None:
    from tf_yarn_tpu_torch import fs

    fs.register_scheme(REMOTE_SCHEME, lambda uri: (
        SmokeFS(fs_root), uri[len(REMOTE_SCHEME) + 3:]))


def make_wheel(out_dir: str, name: str = REMOTE_DEP, version: str = "1.0",
               body: str = f"VALUE = {REMOTE_DEP_VALUE}\n") -> str:
    """A `<name>-<version>-py3-none-any.whl` holding one module (the
    recipe of tests/_wheels.py: the dist-info trio pip needs)."""
    import zipfile

    os.makedirs(out_dir, exist_ok=True)
    wheel = os.path.join(out_dir, f"{name}-{version}-py3-none-any.whl")
    info = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(wheel, "w") as zf:
        zf.writestr(f"{name}.py", body)
        zf.writestr(f"{info}/METADATA", f"Metadata-Version: 2.1\nName: "
                    f"{name}\nVersion: {version}\n")
        zf.writestr(f"{info}/WHEEL", "Wheel-Version: 1.0\nGenerator: "
                    "chip_smoke\nRoot-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{info}/RECORD", f"{name}.py,,\n{info}/METADATA,,\n"
                    f"{info}/WHEEL,,\n{info}/RECORD,,\n")
    return wheel


def remote_bert_experiment(model_dir: str, record_dir: str, fs_root: str,
                           tiny: bool = False):
    """Phase 9 (k)'s experiment fn, called in the shipped workers: (e)'s
    BERT-base run at ``MeshSpec(dp=2)`` (`launcher_bert_experiment`) with
    its model_dir on `REMOTE_SCHEME` (registered here over `fs_root`), the
    records to `record_dir`. Each record adds where this process imported
    the port, this script and the shipped wheel's module from, the
    wheel's value, this process's kernel build (its seconds, the sources
    and the library), and the wall clock at this call and at its first
    optimizer step."""
    import importlib

    import torch

    called = time.time()
    dep = importlib.import_module(REMOTE_DEP)
    register_smokefs(fs_root)
    first_step = []

    def extra():
        import tf_yarn_tpu_torch
        from tf_yarn_tpu_torch.ops import _build

        return {
            "package": os.path.abspath(tf_yarn_tpu_torch.__file__),
            "script": os.path.abspath(__file__),
            "dep": [dep.VALUE, os.path.abspath(dep.__file__)],
            "home": os.environ["HOME"],
            "build_seconds": _build.build_seconds,
            "csrc": str(_build.CSRC),
            "library": (str(_build._library_path())
                        if _build._library is not None else None),
            "called_wall": called, "first_step_wall": first_step[0],
            "placement": os.environ.get("TPU_YARN_REMOTE_BACKEND"),
        }

    exp = launcher_bert_experiment(model_dir, tiny, None, LAUNCHER_RANKS,
                                   record_dir=record_dir, extra=extra)
    make_optimizer = exp.optimizer

    def optimizer(model):
        opt = make_optimizer(model)

        def first(opt, args, kwargs):
            if not first_step:
                if model.device.type == "cuda":
                    torch.cuda.synchronize(model.device)
                first_step.append(time.time())

        opt.register_step_post_hook(first)
        return opt

    exp.optimizer = optimizer
    return exp


def remote_preflight() -> str:
    """(k)'s placement check, in this process before anything of (k)
    starts (and before the parts beside it read the environment): with a
    remote backend's ``TPU_YARN_REMOTE_BACKEND=1``, `fs.check_model_dir_
    placement` refuses a host-local model_dir and passes the scheme's.
    Returns the refusal's message."""
    from tf_yarn_tpu_torch import fs

    before = os.environ.get("TPU_YARN_REMOTE_BACKEND")
    os.environ["TPU_YARN_REMOTE_BACKEND"] = "1"
    try:
        fs.check_model_dir_placement(f"{REMOTE_SCHEME}://bert")
        try:
            fs.check_model_dir_placement(tempfile.gettempdir())
        except ValueError as exc:
            return str(exc)
        raise AssertionError("a local model_dir passed the placement check "
                             "of a remote backend")
    finally:
        if before is None:
            os.environ.pop("TPU_YARN_REMOTE_BACKEND")
        else:
            os.environ["TPU_YARN_REMOTE_BACKEND"] = before


def _staged_writes(trace_path: Path) -> list:
    """[(seconds, bytes)] of the `checkpoint/staged_write` spans in a
    task's exported trace."""
    return [(e["dur"] / 1e6, e["args"].get("bytes"))
            for e in json.loads(trace_path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e["name"] == "checkpoint/staged_write"]


def remote_part(torch, client, topologies, backends, fs, ckpt, refusal,
                tiny=False, env=None):
    """Phase 9 (k): `run_on_gpu` of two workers through `SshBackend` on
    two fake hosts (`_REMOTE_SHIM`: a HOME each, a bare interpreter), with
    the code shipped (`ship_code=True`, staged on a local
    `env_staging_dir`), a one-module wheel (`wheels_dir`), this script as
    `files=` and the coordinator advertised at 127.0.0.1, training (e)'s
    BERT-base at ``MeshSpec(dp=2)`` 4 steps with a checkpoint every 2
    (async writer, keep 1) and TensorBoard, the model_dir on
    `REMOTE_SCHEME`. Checks each worker imported the port from the unpack
    root under its host's HOME, this script from its shipped workdir and
    the wheel's module from `_pydeps`; on the card, that each built the
    kernel library from the shipped sources into the unpack root; the
    ranks' parameters bitwise equal; on the remote, ckpt-4 with its
    MANIFEST, verified through `fs`, equal to rank 0's parameters, no
    staging or backup tree, and TensorBoard events under ``tb``. Returns
    the record (the ranks' losses and launches for the comparison with
    (e) in `main`), with the wall to return, each worker's launch and
    call to its first step, the staged writes' seconds and bytes."""
    started = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="remote_k"))
    try:
        hosts_base = tmp / "hosts"
        hosts_base.mkdir()
        shim = tmp / "ssh_shim"
        shim.write_text(_REMOTE_SHIM.format(python=sys.executable,
                                            base=str(hosts_base)))
        shim.chmod(0o755)
        make_wheel(str(tmp / "wheels"))
        fs_root = tmp / "remote_fs"
        fs_root.mkdir()
        register_smokefs(str(fs_root))
        model_dir = f"{REMOTE_SCHEME}://bert"
        records_dir = tmp / "records"
        backend = backends.SshBackend(
            hosts=[backends.GpuHost(f"host-{i}", i)
                   for i in range(REMOTE_HOSTS)],
            python=sys.executable, ssh_cmd=[str(shim)])
        launch_wall = time.time()
        try:
            client.run_on_gpu(
                client.get_safe_experiment_fn(
                    "chip_smoke.remote_bert_experiment", model_dir,
                    str(records_dir), str(fs_root), tiny),
                {"worker": topologies.TaskSpec(instances=REMOTE_HOSTS)},
                name="remote", backend=backend, ship_code=True,
                wheels_dir=str(tmp / "wheels"),
                env_staging_dir=str(tmp / "staging"),
                files={"chip_smoke.py": str(REPO / "chip_smoke.py")},
                coordinator_advertise="127.0.0.1",
                env=dict({"TPU_YARN_TRACE": str(tmp / "trace")}, **(env or {})),
                poll_every_secs=0.5, dead_task_secs=300)
        except Exception as exc:
            raise AssertionError(
                f"(k) remote run failed: {exc}\n"
                f"{task_log_tails(name='remote')}") from exc
        wall_s = time.perf_counter() - started
        records = [json.loads(rank_counts_path(records_dir, rank).read_text())
                   for rank in range(REMOTE_HOSTS)]
        problems = []
        for rank, r in enumerate(records):
            home = str(hosts_base / f"host-{rank}")
            root = os.path.join(home, ".tpu_yarn_code")
            unpack = Path(r["package"]).parents[1]
            if (r["home"] != home or not r["package"].startswith(root + "/")
                    or not r["script"].startswith(
                        os.path.join(home, ".tpu_yarn_runs") + "/")
                    or r["dep"][0] != REMOTE_DEP_VALUE
                    or not r["dep"][1].startswith(str(unpack / "_pydeps"))
                    or r["placement"] != "1"
                    or (r["world"], r["backend"], r["rank"])
                    != (REMOTE_HOSTS, "gloo", rank)
                    or len(r["losses"]) != LAUNCHER_STEPS
                    or not r["device"].startswith("cpu" if tiny else "cuda")):
                problems.append(f"rank {rank}: {r}")
            if not tiny and (
                    r["build_seconds"] is None
                    or r["csrc"] != str(unpack / "tf_yarn_tpu_torch" / "ops"
                                        / "csrc")
                    or not (r["library"] or "").startswith(
                        str(unpack / "build") + "/")
                    or not Path(r["library"]).is_file()):
                problems.append(f"rank {rank}'s kernel build: {r}")
        if len({r["params_sha256"] for r in records}) != 1:
            problems.append("the ranks' parameters differ")
        names = [name for name, _ in fs.listdir(model_dir)]
        ckpt_4 = ckpt.checkpoint_path(model_dir, LAUNCHER_STEPS)
        if not fs.exists(fs.join(ckpt_4, ckpt.MANIFEST_NAME)) \
                or [n for n in names if n.startswith(".")] \
                or sorted(n for n in names if n.startswith("ckpt-")) \
                != ["ckpt-2", "ckpt-4"]:
            problems.append(f"the remote model_dir holds {names}")
        else:
            ckpt.verify_checkpoint(ckpt_4)
            stored = ckpt.restore_checkpoint(model_dir, LAUNCHER_STEPS,
                                             map_location="cpu",
                                             parts=("params",))["params"]
            if params_digest(stored) != records[0]["params_sha256"]:
                problems.append("ckpt-4 differs from rank 0's parameters")
            del stored
        events = [n for n, _ in fs.listdir(fs.join(model_dir, "tb"))
                  if "tfevents" in n]
        if not events:
            problems.append(f"no TensorBoard events under {model_dir}/tb")
        writes = _staged_writes(tmp / "trace" / "trace_worker-0.json")
        if len(writes) != 2 or any(not n for _, n in writes):
            problems.append(f"rank 0's staged writes {writes}")
        if problems:
            raise AssertionError("(k) remote hosts: " + "; ".join(problems)
                                 + f"\n{task_log_tails(name='remote')}")
        return {
            "ranks": [{key: r[key] for key in (
                "rank", "world", "backend", "device", "losses", "launches",
                "build_seconds")} for r in records],
            "params_bitwise_equal_across_ranks": True,
            "imports": [{"package": r["package"], "script": r["script"],
                         "dep": r["dep"][1]} for r in records],
            "remote_model_dir": sorted(names),
            "tb_events": len(events),
            "ckpt_4_verified_equal_rank0": True,
            "placement_refusal": refusal.splitlines()[0][:160],
            "staged_write_s": [w for w, _ in writes],
            "staged_write_bytes": [n for _, n in writes],
            "launch_to_first_step_s": [r["first_step_wall"] - launch_wall
                                       for r in records],
            "call_to_first_step_s": [r["first_step_wall"] - r["called_wall"]
                                     for r in records],
            "wall_s": wall_s,
        }
    finally:
        fs.unregister_scheme(REMOTE_SCHEME)
        shutil.rmtree(tmp, ignore_errors=True)


def remote_check(remote: dict, ranked: list, tiny: bool = False) -> dict:
    """(k)'s ranks against (e)'s (`ranks_parts`, the same ranks of the same
    run): each rank's losses within REMOTE_LOSS_RTOL relative and its
    LayerNorm launches equal. Returns the comparison."""
    err = max(abs(a - b) / abs(b) for mine, theirs in zip(remote["ranks"],
                                                          ranked)
              for a, b in zip(mine["losses"], theirs["losses"]))
    launches = [[mine["launches"], theirs["launches"]]
                for mine, theirs in zip(remote["ranks"], ranked)]
    if err > REMOTE_LOSS_RTOL or any(a != b for a, b in launches) or (
            not tiny and not all(a["layernorm"] and a["layernorm_backward"]
                                 for a, _ in launches)):
        raise AssertionError(f"(k) against (e): losses {remote['ranks']} and "
                             f"{ranked}, max rel err {err}")
    return {"loss_max_rel_err_vs_e": err,
            "losses_bitwise_equal_e": all(
                mine["losses"] == theirs["losses"]
                for mine, theirs in zip(remote["ranks"], ranked)),
            "launches_equal_e": True}


def tp_config(torch, tt, tiny: bool):
    """(g)'s decoder: Llama-3-8B widths at SERVE_LAYERS layers, LoRA rank
    16, flash and fused norms, unrolled; `tiny`: phase 4's small f32 LoRA
    decoder (head_dim 64, 4 heads over 2 kv heads)."""
    if tiny:
        return tt.TransformerConfig(
            vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=512, max_seq_len=128, dtype=torch.float32,
            attention_impl="flash", fused_norms=True, scan_layers=False,
            remat=True, lora_rank=8)
    return dataclasses.replace(tt.TransformerConfig.llama3_8b(
        lora_rank=16, attention_impl="flash", fused_norms=True,
        scan_layers=False), n_layers=SERVE_LAYERS)


def record_flash_heads() -> None:
    """Wrap `ops.flash_attention.flash_attention` (once a process) to
    record the (query heads, kv heads) of each call in _FLASH_HEADS and
    its (query heads, kv heads, sequence) in _FLASH_SHAPES."""
    from tf_yarn_tpu_torch.ops import flash_attention

    inner = flash_attention.flash_attention
    if getattr(inner, "records_heads", False):
        return

    def recording(q, k, v, *args, **kwargs):
        _FLASH_HEADS.add((q.shape[2], k.shape[2]))
        _FLASH_SHAPES.add((q.shape[2], k.shape[2], q.shape[1]))
        return inner(q, k, v, *args, **kwargs)

    recording.records_heads = True
    recording.inner = inner
    flash_attention.flash_attention = recording


def tp_record_path(out_dir, rank: int, tag: str = "tp") -> Path:
    return Path(out_dir) / f"{tag}-{rank}.json"


def tp_experiment(out_dir: str, tiny: bool = False, tp: int = TP_RANKS,
                  model_dir=None, keep: bool = False, tag: str = "tp",
                  mesh=None, impl=None, gpipe: int = 0, shape=None):
    """The experiment fn of (g)'s launched ranks, phase 4's spawned ranks,
    (h)'s and (i)'s spawned ranks and their one-rank references:
    `tp_config`'s decoder through `make_experiment` (batch 1 x 2048;
    tiny 2 x 128; or `shape` (batch, seq)), TP_STEPS steps, over
    ``MeshSpec(**mesh)`` or else ``MeshSpec(tp=tp)`` when tp > 1, with
    the attention backend `impl` and ``gpipe_microbatches=gpipe`` (which
    scans: ``scan_layers=True``) where given, random weights from seed 0
    and a nonzero lora_b from seed 3 (so every adapter gets a gradient),
    the losses logged every step, a checkpoint at the end when
    `model_dir` is given. Each rank writes <out_dir>/<tag>-<rank>.json
    after its last step: its losses, the training kernels' launches in
    this process, the flash calls' heads and shapes, its backend and
    device, whether its frozen base is bitwise what it held before its
    first step, its parameters' local shapes, the digest of the leaves
    every pipeline stage holds, its peak memory on the card, and its
    adapters to <tag>-<rank>.pt. `keep`: keep the model in _TP_MODELS
    (the in-process reference) and its adapters at init in _TP_INIT and
    <tag>-init.pt."""
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.ops import flash_attention, rmsnorm
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    record_flash_heads()
    cfg = tp_config(torch, tt, tiny)
    if impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=impl)
    if gpipe:
        cfg = dataclasses.replace(cfg, scan_layers=True,
                                  gpipe_microbatches=gpipe)
    if shape is not None:
        shape = dict(batch_size=shape[0], seq_len=shape[1])
    else:
        shape = (dict(batch_size=2, seq_len=128) if tiny
                 else dict(batch_size=1, seq_len=2048))
    spec = (MeshSpec(**mesh) if mesh is not None
            else MeshSpec(tp=tp) if tp > 1 else None)
    exp = tt.make_experiment(
        cfg, model_dir=model_dir, train_steps=TP_STEPS, learning_rate=1e-3,
        log_every_steps=1, mesh_spec=spec, **shape)
    counted = (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd_dx,
               flash_attention.flash_fwd, flash_attention.flash_dq,
               flash_attention.flash_dkv)
    init, loss_fn, make_optimizer = exp.init_fn, exp.loss_fn, exp.optimizer
    losses, base = [], {}

    def init_fn(device, seed):
        model = init(device, seed)
        gen = torch.Generator(device=model.device).manual_seed(SEED + 3)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if name.endswith("lora_b"):
                    param.normal_(0.0, 0.05, generator=gen)
        if keep:
            _TP_MODELS.append(model)
            _TP_INIT.clear()
            _TP_INIT.update({name: param.detach().cpu().clone()
                             for name, param in model.named_parameters()
                             if tt.is_lora_param(name)})
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            torch.save(_TP_INIT, Path(out_dir) / f"{tag}-init.pt")
        return model

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(loss.detach())
        return loss, aux

    def optimizer(model):
        # Called on the rank's shards, before the first step (under pp
        # once before on the whole model too, for the optimizer's
        # one-device numbering: the last call's base is the rank's).
        base.clear()
        base.update({name: param.detach().clone()
                     for name, param in model.named_parameters()
                     if not tt.is_lora_param(name)})
        opt = make_optimizer(model)

        def after_step(opt, args, kwargs):
            if len(losses) != TP_STEPS:
                return
            grouped = dist.is_available() and dist.is_initialized()
            rank = dist.get_rank() if grouped else 0
            params = dict(model.named_parameters())
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            torch.save({name: p.detach().cpu() for name, p in params.items()
                        if tt.is_lora_param(name)},
                       Path(out_dir) / f"{tag}-{rank}.pt")
            device = next(iter(params.values())).device
            tp_record_path(out_dir, rank, tag).write_text(json.dumps({
                "losses": [float(x) for x in losses],
                "launches": {fn.__name__: fn.launches for fn in counted},
                "flash_heads": sorted(_FLASH_HEADS),
                "flash_shapes": sorted(_FLASH_SHAPES),
                "replicated_sha256": params_digest(
                    {n: p for n, p in params.items()
                     if not n.startswith("layers.")}),
                "layers": sorted({int(n.split(".")[1]) for n in params
                                  if n.startswith("layers.")}),
                "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None),
                "rank": rank,
                "world": dist.get_world_size() if grouped else 1,
                "backend": dist.get_backend() if grouped else None,
                "device": str(next(iter(params.values())).device),
                "base_unchanged": all(torch.equal(params[n], v)
                                      for n, v in base.items()),
                "shapes": {n: list(p.shape) for n, p in params.items()
                           if n.startswith("layers.0.") or "." not in n},
            }))

        opt.register_step_post_hook(after_step)
        return opt

    exp.init_fn, exp.loss_fn, exp.optimizer = (init_fn, recording_loss,
                                               optimizer)
    return exp


def zero_training_counts() -> None:
    """The training kernels' launch counts and the flash calls' records
    set to 0 and emptied."""
    from tf_yarn_tpu_torch.ops import flash_attention, rmsnorm

    for fn in (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd_dx,
               flash_attention.flash_fwd, flash_attention.flash_dq,
               flash_attention.flash_dkv):
        fn.launches = 0
    _FLASH_HEADS.clear()
    _FLASH_SHAPES.clear()


def tp_reference(torch, training, experiment, out_dir, dev, tiny: bool,
                 tag: str = "tp", **kwargs):
    """The tp experiment (with `kwargs`: `tp_experiment`'s impl, gpipe,
    shape) at one rank in this process, the training kernels' counts set
    to 0 just before it: its record (`tp_experiment`) and seconds; its
    model stays in _TP_MODELS."""
    from tf_yarn_tpu_torch.ops import flash_attention

    zero_training_counts()
    started = time.perf_counter()
    try:
        training.train_and_evaluate(experiment.as_core_experiment(
            tp_experiment(str(out_dir), tiny, tp=1, keep=True, tag=tag,
                          **kwargs)), device=dev)
    finally:
        flash_attention.flash_attention = getattr(
            flash_attention.flash_attention, "inner",
            flash_attention.flash_attention)
    seconds = time.perf_counter() - started
    record = json.loads(tp_record_path(out_dir, 0, tag).read_text())
    return dict(record, seconds=seconds, tag=tag, dir=str(out_dir))


# Phase 4's tiny ranks start with the smoke and train once the phase writes
# this file in their directory (within TP_GO_TIMEOUT_S).
TP_GO = "go"
TP_GO_TIMEOUT_S = 900.0


# The runs of phase 4's tiny ranks, in order: tp (the tp check), then
# sequence parallelism by ring and by Ulysses with flash inside, then the
# GPipe schedule (xla attention, as JAX's GPipe requires), then the small
# MoE decoder's experts over ep (`moe_experiment`), each with its record
# tag; and (h)'s and (i)'s runs at Llama-3-8B widths.
TINY_RUNS = (dict(tag="tp"),
             dict(tag="sp_ring", mesh={"sp": 2}, impl="ring"),
             dict(tag="sp_ulysses_flash", mesh={"sp": 2},
                  impl="ulysses_flash"),
             dict(tag="pp", mesh={"pp": 2}, impl="xla", gpipe=2),
             dict(tag="moe_ep", moe=True, ep=2, optimizer="adamw",
                  steps=TP_STEPS))
PP_SHAPE = (2, 2048)
H_RUNS = (dict(tag="h_ulysses_flash", mesh={"sp": 2}, impl="ulysses_flash",
               shape=(1, SP_SEQ)),
          dict(tag="h_ring", mesh={"sp": 2}, impl="ring", shape=(1, SP_SEQ)))
I_RUNS = (dict(tag="i_gpipe", mesh={"pp": 2}, impl="xla", gpipe=2,
               shape=PP_SHAPE),)


def _parallel_rank(rank: int, world: int, port: int, out_dir: str,
                   device: str, runs, tiny: bool, go: bool) -> None:
    """A spawned rank of phase 4's tiny runs (`tiny`, once <out_dir>/go
    exists when `go`) or of (h) and (i): each of `runs` (`tp_experiment`'s
    keywords) over gloo on `device`, in order, its kernel counts set to 0
    just before it, its spans exported to <out_dir>/<tag>_trace and, at
    full size, its checkpoint written to <out_dir>/<tag>_model."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from tf_yarn_tpu_torch import experiment, telemetry, training

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        # One thread: the CPU's accumulating index_put (the embedding's
        # gradient) sums repeated ids in thread order, which would leave
        # a rehearsal's replicated leaves a last bit apart.
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if go:
            flag, waited = Path(out_dir) / TP_GO, time.perf_counter()
            while not flag.exists():
                if time.perf_counter() - waited > TP_GO_TIMEOUT_S:
                    raise TimeoutError(f"no {flag} after {TP_GO_TIMEOUT_S} s")
                time.sleep(0.05)
        for run in runs:
            zero_training_counts()
            telemetry.get_tracer().clear()
            os.environ["TPU_YARN_TRACE"] = str(Path(out_dir) /
                                               f"{run['tag']}_trace")
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            run = dict(run)
            if run.pop("moe", False):  # the MoE runs write no checkpoint
                exp = moe_experiment(out_dir, tiny=tiny, **run)
            else:
                model_dir = (None if tiny else
                             str(Path(out_dir) / f"{run['tag']}_model"))
                exp = tp_experiment(out_dir, tiny=tiny, tp=world,
                                    model_dir=model_dir, **run)
            training.train_and_evaluate(experiment.as_core_experiment(exp),
                                        device=device)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def parallel_ranks_start(torch, out_dir: str, device: str, runs,
                         tiny: bool, go: bool):
    """Spawn two `_parallel_rank`s now. Returns a fn that (with `go`
    first writes the go file) waits for them and gives their wall from
    the call. A rank still running when this process exits is
    terminated."""
    ranks = torch.multiprocessing.spawn(
        _parallel_rank, args=(TP_RANKS, free_port(), out_dir, device,
                              runs, tiny, go),
        nprocs=TP_RANKS, join=False)

    def stop():
        for process in ranks.processes:
            if process.is_alive():
                process.terminate()

    atexit.register(stop)

    def wait() -> float:
        started = time.perf_counter()
        if go:
            (Path(out_dir) / TP_GO).touch()
        while not ranks.join():
            pass
        return time.perf_counter() - started

    return wait


def tp_ranks_start(torch, out_dir: str, device: str):
    """Spawn phase 4's two tiny ranks now (`TINY_RUNS`): each imports,
    takes the card and joins its gloo group, then waits for <out_dir>/go,
    so the smoke's build and phase 3 hide their start. Returns a fn that
    writes go, waits for the ranks and gives their wall from it."""
    return parallel_ranks_start(torch, out_dir, device, TINY_RUNS,
                                tiny=True, go=True)


def tp_tiny_check(torch, out_dir, reference, ranks_wall):
    """Phase 4: the spawned tiny ranks (tp=2, gloo, on the card) against
    `reference`, the tiny experiment at one rank in this process
    (`tp_reference`): each rank's losses within TP_TINY_TOL relative and
    its adapters within TP_TINY_TOL absolute of the one rank's, the
    ranks' adapters bitwise equal, the base unchanged, each rank's flash
    calls on 2 query heads and 1 kv head."""
    ranks = [json.loads(tp_record_path(out_dir, r).read_text())
             for r in range(TP_RANKS)]
    adapters = [torch.load(Path(out_dir) / f"tp-{r}.pt")
                for r in range(TP_RANKS)]
    one = torch.load(Path(reference["dir"]) / f"{reference['tag']}-0.pt")
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], reference["losses"]))
    lora_err = max(float((a[n] - one[n]).abs().max())
                   for a in adapters for n in one)
    if (any((r["world"], r["backend"], r["base_unchanged"],
             r["flash_heads"]) != (TP_RANKS, "gloo", True, [[2, 1]])
            for r in ranks)
            or sorted(adapters[0]) != sorted(one)
            or not all(torch.equal(adapters[0][n], adapters[1][n])
                       for n in one)
            or loss_err > TP_TINY_TOL or lora_err > TP_TINY_TOL):
        raise AssertionError(f"tiny tp=2 against one rank: ranks {ranks}, "
                             f"one rank {reference}, adapter max abs err "
                             f"{lora_err}")
    return {"losses": [r["losses"] for r in ranks],
            "reference_losses": reference["losses"],
            "loss_max_rel_err": loss_err, "adapter_max_abs_err": lora_err,
            "adapters_bitwise_equal_across_ranks": True,
            "flash_heads": ranks[0]["flash_heads"],
            "reference_flash_heads": reference["flash_heads"],
            "ranks_wall_s": ranks_wall}


# (h)'s and (i)'s losses against the one-rank run, relative, set before
# the first card run (PERF.md §6): Ulysses runs the same flash
# kernels on the rank's heads over the whole sequence and the pipeline
# the same layers on half the rows, so only GEMM tilings and the loss's
# sums change (as (g)'s 1.03e-4); the ring's plain block rounds P to bf16
# where flash does too, but sums the blocks in another order. The one
# rank's own movement over the 3 steps must exceed twice the bound: it
# moved 2.5e-3 on the card, so the ring's first bound, 2e-3, could not
# tell trained adapters from untrained ones, and it is 5e-4 as the
# others (the card measured 4.0e-5).
SP_LOSS_RTOL = {"ulysses_flash": 5e-4, "ring": 5e-4}
PP_LOSS_RTOL = 5e-4
# Their adapters' change from init against the one rank's, as (g)'s.
PARALLEL_ADAPTER_RTOL = 0.3


def _collective_steps(trace_path: Path, span: str) -> list:
    """A rank's steps from its exported trace: each step's seconds (its
    dispatch span through its device wait) and, within its dispatch, the
    count, seconds and bytes of `span` (forward and backward) and of the
    gradient sums over sp or pp (``train/grad_allreduce`` with ``axis``)."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = lambda name: sorted((e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6,
                                 e.get("args", {})) for e in events
                                if e["name"] == name)
    dispatch, waits = spans("train/step_dispatch"), spans("train/device_wait")
    moved = spans(span)
    sums = [x for x in spans("train/grad_allreduce") if "axis" in x[2]]
    steps = []
    for (start, end, _), (_, wait_end, _) in zip(dispatch, waits):
        inside = [(s, e, a) for s, e, a in moved if start <= s < end]
        summed = [(s, e, a) for s, e, a in sums if start <= s < end]
        steps.append({
            "step_s": wait_end - start, "n": len(inside),
            "s": sum(e - s for s, e, _ in inside),
            "bytes": sum(a["bytes"] for _, _, a in inside),
            "grad_sum_s": sum(e - s for s, e, _ in summed),
            "grad_sum_bytes": sum(a["bytes"] for _, _, a in summed)})
    return steps


def stage_norm_launches(n_layers: int, layers, micro: int) -> dict:
    """The RMSNorm launches of TP_STEPS steps of the LoRA decoder (remat on,
    the chunked or plain loss) on a rank that holds `layers` of
    `n_layers` and runs them on `micro` microbatches (1 and every layer:
    one rank): each layer's two norms forward and again in its recompute
    on each microbatch, the final norm once; backward the same two a
    layer but the first layer's attention norm (its input, the frozen
    embedding's rows, needs no gradient), and the final norm."""
    held = len(layers)
    return {"rmsnorm": TP_STEPS * (micro * 2 * held * 2 + 1),
            "rmsnorm_bwd_dx": TP_STEPS * (
                micro * (2 * held - (1 if 0 in layers else 0)) + 1)}


def parallel_check(torch, tt, ckpt, out_dir, tag, reference, tiny,
                   impl=None, pipelined=0):
    """Phase 4's tiny sp and pp checks and (h)'s and (i)'s: the two ranks'
    records of run `tag` against `reference` (`tp_reference`: one rank in
    this process, on the same tokens and weights; its adapters at init
    and at the end in its directory). Each rank: world 2 over gloo, its
    base unchanged, its losses within the bound of the one rank's
    (TP_TINY_TOL; at full size SP_LOSS_RTOL of `impl`, or PP_LOSS_RTOL
    when `pipelined` — the microbatch count — which the one rank's
    movement must exceed twice), its RMSNorm forward and dx launched as
    often as the one rank's (pipelined: as its stage's layers on its
    microbatches make them, `stage_norm_launches`, which the one rank's
    counts must equal at its layers), flash as
    often as the one rank under Ulysses (each call on half the heads over
    the whole sequence) and never under the ring or the pipeline. Under
    sp the ranks' adapters are bitwise equal; under pp each holds its
    stage's layers and they cover the one rank's. Both: the leaves every
    stage holds bitwise equal, the adapters within TP_TINY_TOL absolute
    (tiny) or their change from init within PARALLEL_ADAPTER_RTOL of the
    one rank's; at full size rank 0's checkpoint holds every rank's
    adapters and loads into the one-rank model. Each step's seconds and
    its collectives from rank 0's trace."""
    out_dir = Path(out_dir)
    ranks = [json.loads(tp_record_path(out_dir, r, tag).read_text())
             for r in range(TP_RANKS)]
    adapters = [torch.load(out_dir / f"{tag}-{r}.pt")
                for r in range(TP_RANKS)]
    ref_dir = Path(reference["dir"])
    one = torch.load(ref_dir / f"{reference['tag']}-0.pt")
    init = torch.load(ref_dir / f"{reference['tag']}-init.pt")
    merged = {}
    for got in adapters:
        merged.update(got)
    want = reference["losses"]
    bound = (TP_TINY_TOL if tiny else PP_LOSS_RTOL if pipelined
             else SP_LOSS_RTOL[impl])
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], want))
    moved = max(abs(a - want[0]) / abs(want[0]) for a in want[1:])
    if tiny:
        adapter_err = max(float((merged[n] - one[n]).abs().max())
                          for n in one)
    else:
        change = lambda got, n: got.float() - init[n]
        diff = sum(float((change(merged[n], n) - change(one[n], n)).norm())
                   ** 2 for n in one)
        norm = sum(float(change(one[n], n).norm()) ** 2 for n in one)
        adapter_err = (diff / norm) ** 0.5 if norm else float("inf")
    launches = reference["launches"]
    norms = {k: v for k, v in launches.items() if k.startswith("rmsnorm")}
    flash = {k: v for k, v in launches.items() if k.startswith("flash")}
    micro = pipelined or 1  # the microbatches of a pipelined run
    # A pipelined rank's norms follow its stage (none counted on the CPU,
    # where the plain versions run).
    staged = bool(pipelined) and any(norms.values())
    heads = (reference["flash_shapes"][0] if reference["flash_shapes"]
             else None)
    problems = []
    for r in ranks:
        got = r["launches"]
        want_flash = (flash if impl == "ulysses_flash"
                      else {k: 0 for k in flash})
        shapes = ([[heads[0] // 2, heads[1] // 2, heads[2]]]
                  if impl == "ulysses_flash" else [])
        want_norms = (stage_norm_launches(len(reference["layers"]),
                                          r["layers"], micro)
                      if staged else norms)
        if ((r["world"], r["backend"], r["base_unchanged"])
                != (TP_RANKS, "gloo", True)
                or {k: got[k] for k in norms} != want_norms
                or {k: got[k] for k in flash} != want_flash
                or r["flash_shapes"] != shapes
                or (not tiny and min(norms.values()) <= 0)
                # Phase 3 checked the kernels at the shape (h) runs.
                or (not tiny and impl == "ulysses_flash" and shapes != [[
                    SP_FLASH_SHAPE[2], SP_FLASH_SHAPE[3], SP_FLASH_SHAPE[1]]])):
            problems.append(r)
    if staged and {k: launches[k] for k in norms} != stage_norm_launches(
            len(reference["layers"]), reference["layers"], 1):
        problems.append(reference)
    if pipelined:
        layers = [set(r["layers"]) for r in ranks]
        split = (not layers[0] & layers[1]
                 and sorted(layers[0] | layers[1])
                 == sorted({int(n.split(".")[1]) for n in one}))
        same = split and sorted(merged) == sorted(one)
    else:
        same = sorted(adapters[0]) == sorted(one) and all(
            torch.equal(adapters[0][n], adapters[1][n]) for n in one)
    replicated = len({r["replicated_sha256"] for r in ranks}) == 1
    checkpoint = None
    if not tiny:
        model_dir = str(out_dir / f"{tag}_model")
        steps = ckpt.list_checkpoint_steps(model_dir)
        ckpt.verify_checkpoint(ckpt.checkpoint_path(model_dir, TP_STEPS))
        restored = ckpt.restore_checkpoint(model_dir, TP_STEPS,
                                           map_location="cpu")["params"]
        lora_equal = all(torch.equal(restored[n], merged[n]) for n in merged)
        _TP_MODELS[-1].load_state_dict(restored)
        checkpoint = {"steps": steps, "adapters_are_the_ranks": lora_equal}
        del restored
    bad_ckpt = checkpoint is not None and (
        checkpoint["steps"] != [TP_STEPS]
        or not checkpoint["adapters_are_the_ranks"])
    if (problems or loss_err > bound or (not tiny and moved <= 2 * bound)
            or adapter_err > (TP_TINY_TOL if tiny
                              else PARALLEL_ADAPTER_RTOL)
            or not same or not replicated or bad_ckpt):
        raise AssertionError(
            f"{tag}: ranks {ranks}, one rank {reference}, loss err "
            f"{loss_err} (bound {bound}), the one rank's movement {moved}, "
            f"adapter err {adapter_err}, adapters consistent {same}, "
            f"replicated leaves equal {replicated}, checkpoint {checkpoint}")
    span = "train/pp_send" if pipelined else "train/sp_collective"
    trace = out_dir / f"{tag}_trace" / "trace_train.json"
    return {
        "ranks": [{key: r[key] for key in (
            "rank", "world", "backend", "device", "launches", "losses",
            "flash_shapes", "layers", "peak_gb")} for r in ranks],
        "reference": {key: reference[key] for key in (
            "losses", "launches", "flash_shapes", "seconds", "peak_gb")},
        "loss_max_rel_err": loss_err, "loss_bound": bound,
        "reference_loss_movement": moved,
        "adapter_err": adapter_err,
        "replicated_leaves_bitwise_equal": True,
        "checkpoint": checkpoint,
        "steps_rank0": (_collective_steps(trace, span) if trace.exists()
                        else None),
    }


def sequence_pipeline_part(torch, tt, ckpt, training, experiment, dev,
                           tmp: Path) -> dict:
    """Phase 9 (h) and (i), spawned from this process: (h) two ranks at
    ``MeshSpec(sp=2)`` train `tp_config`'s decoder on 1 x 8192 tokens 3
    steps with Ulysses and flash inside, then 3 with the ring, while one
    rank in this process trains it with flash on the same tokens and
    weights; (i) two ranks at ``MeshSpec(pp=2)`` train it (2 layers a
    stage, GPipe with 2 microbatches, xla attention) on 2 x 2048 tokens
    against one rank in this process. Each held by `parallel_check`; the
    checkpoints load into the one-rank model. {part: result, and
    seconds}."""
    out = {}
    # Rehearsed on the CPU at phase 4's tiny size and shapes.
    tiny = dev.type != "cuda"
    for name, runs, kwargs in (
            ("h", H_RUNS, dict(shape=(1, SP_SEQ))),
            ("i", I_RUNS, dict(impl="xla", gpipe=2, shape=PP_SHAPE))):
        if tiny:
            runs = [dict(run, shape=None) for run in runs]
            kwargs = dict(kwargs, shape=None)
        started = time.perf_counter()
        wait = parallel_ranks_start(torch, str(tmp), dev.type, runs,
                                    tiny=tiny, go=False)
        one = tp_reference(torch, training, experiment, tmp / f"{name}_one",
                           dev, tiny=tiny, tag=name, **kwargs)
        ranks_wall = wait()
        for run in runs:
            out[run["tag"]] = parallel_check(
                torch, tt, ckpt, tmp, run["tag"], one, tiny=tiny,
                impl=run["impl"], pipelined=run.get("gpipe", 0))
            shutil.rmtree(tmp / f"{run['tag']}_model", ignore_errors=True)
        _TP_MODELS.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[f"{name}_s"] = time.perf_counter() - started
        out[f"{name}_ranks_wall_s"] = ranks_wall
    return out


def _tp_trace(trace_path: Path) -> dict:
    """A rank's steps from its exported trace: each step's seconds (its
    dispatch span through its device wait) and, within its dispatch, the
    tp all-reduces' seconds and bytes, all of them and by op."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = lambda name: sorted((e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6,
                                 e.get("args", {})) for e in events
                                if e["name"] == name)
    dispatch, waits = spans("train/step_dispatch"), spans("train/device_wait")
    reduces = spans("train/tp_allreduce")
    steps = []
    for (start, end, _), (_, wait_end, _) in zip(dispatch, waits):
        inside = [(s, e, a) for s, e, a in reduces if start <= s < end]
        by_op = {}
        for s, e, a in inside:
            entry = by_op.setdefault(a["op"], {"n": 0, "s": 0.0, "bytes": 0})
            entry["n"] += 1
            entry["s"] += e - s
            entry["bytes"] += a["bytes"]
        steps.append({"step_s": wait_end - start,
                      "tp_allreduce_n": len(inside),
                      "tp_allreduce_s": sum(e - s for s, e, _ in inside),
                      "tp_allreduce_bytes": sum(a["bytes"]
                                                for _, _, a in inside),
                      "logits_gather_s": by_op.get("gather", {}).get("s", 0.0),
                      "by_op": by_op})
    return {"steps": steps, "tp_allreduce_total": len(reduces)}


def tp_launch(client, topologies, tmp, base_env, env, tiny):
    """Phase 9 (g)'s run: `run_on_gpu` of `allreduce_topology`'s chief and
    one worker trains `tp_experiment` at ``MeshSpec(tp=2)``, both ranks
    on the one card over gloo, a checkpoint at the end. Returns (its
    start on this process's perf_counter, which the tasks' traces share,
    its wall)."""
    spec = topologies.allreduce_topology(nb_workers=1, chips_per_host=1)
    started = time.perf_counter()
    client.run_on_gpu(
        client.get_safe_experiment_fn(
            "chip_smoke.tp_experiment", str(tmp / "tp"), tiny, TP_RANKS,
            str(tmp / "tp_model")),
        spec, env=dict(base_env, TPU_YARN_TRACE=str(tmp / "tp_trace"),
                       **(env or {})),
        poll_every_secs=0.5, dead_task_secs=120)
    return started, time.perf_counter() - started


def tp_check(torch, tt, ckpt, tmp, reference, tiny, run):
    """Phase 9 (g)'s checks of `tp_launch`'s run against the one-rank
    `reference` (`tp_reference`, its model and init adapters kept): each
    rank launched the training kernels as often as the one rank did, its
    flash calls on 16 query heads and 4 kv heads (tiny: 2 and 1), its
    base bitwise unchanged; the ranks' adapters bitwise equal; each
    rank's losses within TP_LOSS_RTOL of the reference's, which move by
    more than twice that; rank 0's adapters' change from init within
    TP_ADAPTER_RTOL of the one rank's; rank 0 alone submitted the
    checkpoint, whose base is bitwise the one rank's and whose adapters
    are rank 0's, and which loads into the one-rank model. Each step's
    seconds and its tp all-reduce and logits-gather seconds from the
    ranks' traces, and each span's. `run` is `tp_launch`'s return."""
    launched, wall = run
    out_dir, model_dir = tmp / "tp", tmp / "tp_model"
    trace_dir = tmp / "tp_trace"
    ranks = [json.loads(tp_record_path(out_dir, r).read_text())
             for r in range(TP_RANKS)]
    adapters = [torch.load(out_dir / f"tp-{r}.pt") for r in range(TP_RANKS)]
    traces = {task: _tp_trace(trace_dir / f"trace_{task.replace(':', '-')}"
                              ".json") for task in RANK_TASKS}
    spans = {task: _trace_spans(
        trace_dir / f"trace_{task.replace(':', '-')}.json")
        for task in RANK_TASKS}
    saves = {task: len(spans[task].get("checkpoint/save_submit", []))
             for task in RANK_TASKS}
    heads = [[2, 1]] if tiny else [[16, 4]]
    want = reference["losses"]
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], want))
    moved = max(abs(a - want[0]) / abs(want[0]) for a in want[1:])
    one = _TP_MODELS[-1]
    one_params = dict(one.named_parameters())
    change = lambda got, name: got.float() - _TP_INIT[name]
    diff = sum(float((change(adapters[0][n], n) - change(
        one_params[n].detach().cpu(), n)).norm()) ** 2 for n in _TP_INIT)
    norm = sum(float(change(one_params[n].detach().cpu(), n).norm()) ** 2
               for n in _TP_INIT)
    adapter_err = (diff / norm) ** 0.5 if norm else float("inf")
    checked = time.perf_counter()
    steps = ckpt.list_checkpoint_steps(str(model_dir))
    # Verified beside the restore and the comparisons, and waited for
    # before the checkpoint counts as loaded.
    verified = concurrently_started({"verify": lambda: ckpt.verify_checkpoint(
        ckpt.checkpoint_path(str(model_dir), TP_STEPS))})
    restored = ckpt.restore_checkpoint(str(model_dir), TP_STEPS,
                                       map_location="cpu")["params"]
    base_equal = all(
        torch.equal(restored[n], p.detach().cpu()) for n, p in
        one_params.items() if not tt.is_lora_param(n))
    lora_equal = sorted(adapters[0]) == sorted(_TP_INIT) and all(
        torch.equal(restored[n], adapters[0][n]) for n in adapters[0])
    verified()
    # It loads into a one-rank model: the reference's, its run done.
    one.load_state_dict(restored)
    del restored, one, one_params
    checked = time.perf_counter() - checked
    problems = [
        r for r in ranks
        if (r["world"], r["backend"], r["base_unchanged"], r["flash_heads"])
        != (TP_RANKS, "gloo", True, heads)
        or r["launches"] != reference["launches"]
        or (not tiny and min(r["launches"].values()) <= 0)
        or not r["device"].startswith("cpu" if tiny else "cuda")]
    if (problems or loss_err > TP_LOSS_RTOL or moved <= 2 * TP_LOSS_RTOL
            or adapter_err > TP_ADAPTER_RTOL
            or not all(torch.equal(adapters[0][n], adapters[1][n])
                       for n in adapters[0])
            or saves != {"chief:0": 1, "worker:0": 0}
            or steps != [TP_STEPS] or not base_equal or not lora_equal):
        raise AssertionError(
            f"tp=2 ranks: records {ranks}, one rank {reference}, loss err "
            f"{loss_err}, the one rank's movement {moved}, adapter err "
            f"{adapter_err}, checkpoint saves {saves}, steps {steps}, base "
            f"equal {base_equal}, adapters equal {lora_equal}\n"
            f"{task_log_tails()}")
    return {
        "ranks": [{key: r[key] for key in ("rank", "world", "backend",
                                           "device", "launches", "losses",
                                           "flash_heads")} for r in ranks],
        "rank0_shapes": ranks[0]["shapes"],
        "reference": {key: reference[key] for key in (
            "losses", "launches", "flash_heads", "seconds")},
        "loss_max_rel_err": loss_err,
        "reference_loss_movement": moved,
        "adapter_change_rel_err": adapter_err,
        "adapters_bitwise_equal_across_ranks": True,
        "base_bitwise_unchanged": True,
        "checkpoint_save_submits": saves,
        "ckpt_loads_into_one_rank": True,
        "ckpt_check_s": checked,
        "steps_rank0": traces["chief:0"]["steps"],
        "steps_rank1_s": [s["step_s"] for s in traces["worker:0"]["steps"]],
        # Each span's seconds in all, by rank, and the first span's start
        # and the last one's end from the launch.
        "rank_spans_s": {task: {name: sum(end - start for start, end in got)
                                for name, got in sorted(task_spans.items())}
                         for task, task_spans in spans.items()},
        "rank_span_window_s": {task: [
            min(s for got in task_spans.values() for s, _ in got) - launched,
            max(e for got in task_spans.values() for _, e in got) - launched]
            for task, task_spans in spans.items()},
        "wall_s": wall,
    }


# Phase 10: the launched serving fleet, one `run_on_gpu` of a mixed fleet on
# the one card: two decode replicas, a prefill replica, a ranking replica
# and the CPU router in front of them. As in phase 9 the experiment fn is
# module-level and sent by name.
FLEET_PROMPTS = (17, 64, 300)
FLEET_NEW = 16
# Prompts of at least this many tokens ship to the prefill replica: here
# the 64- and the 300-token ones; the 17-token one prefills locally.
FLEET_THRESHOLD = 64
# The fused paged grid of phase 5 (a).
FLEET_GRID = dict(max_slots=4, block_size=16, kv_layout="paged",
                  decode_attention="fused")
# The router's knobs: round robin over the decode replicas, a /healthz
# probe every 0.2 s, and an autoscaler that holds the generate pool at two
# replicas (no scale-in), so a drained replica is a below_min event. No
# warm start: phase 5 (g) puts the block wire on the card.
FLEET_ROUTER = dict(router_host="127.0.0.1", router_policy="round_robin",
                    router_probe_interval_s=0.2,
                    autoscale={"generate": {"min_replicas": 2,
                                            "max_replicas": 2,
                                            "scale_in_load": None}},
                    autoscale_warm_start=False)
# The endpoints the driver logs for the fleet, by label, and the healthy
# replicas the router counts by kind once all are up.
FLEET_ENDPOINTS = {"serving endpoint": 2, "prefill endpoint": 1,
                   "rank endpoint": 1, "router endpoint": 1}
FLEET_KINDS = {"generate": 2, "prefill": 1, "rank": 1}
FLEET_TASKS = ["prefill:0", "rank:0", "router:0", "serving:0", "serving:1"]
# An upper bound on each task's serving time; the driver ends them sooner
# through FLEET_STOP (all tasks) or FLEET_STOP-<type>-<id> (one task).
FLEET_SERVE_SECONDS = 600.0
FLEET_STOP = "stop"
# The small f32 model of phase 4 with room for a 300-token prompt and 16
# new tokens: the CPU rehearsal's and the card test's replicas.
TINY_FLEET = dict(TINY_SERVE, max_seq_len=512)
# Each replica's spans before it serves, as its record keeps them.
FLEET_SPANS = ("serving/restore_params", "prefill/restore_params",
               "ranking/init_params", "ranking/warmup", "checkpoint/verify",
               "checkpoint/restore", "checkpoint/load_state_dict")
# The served scores against the driver's own forward of the same seeded
# DLRM, one request (one tick) at a time.
FLEET_RANK_TOL = 1e-5


def fleet_config(torch, tt, tiny: bool):
    """Phase 5's decoder (`serving_config`: Llama-3-8B widths at
    SERVE_LAYERS layers, bf16, int8 KV), or the small f32 one of
    TINY_FLEET."""
    if tiny:
        return tt.TransformerConfig(dtype=torch.float32, kv_cache_dtype="int8",
                                    **TINY_FLEET)
    return serving_config(torch, tt)


def rank_model_config(dlrm, torch, tiny: bool):
    """Phase 8's ranker (DLRMConfig.criteo()) or the tiny f32 one."""
    return (dlrm.DLRMConfig.tiny(dtype=torch.float32) if tiny
            else dlrm.DLRMConfig.criteo())


def stop_file(task: str) -> str:
    """The file that ends one task of the fleet (FLEET_STOP ends all)."""
    return f"{FLEET_STOP}-{task.replace(':', '-')}"


def _replica_record(out_dir: str, counted):
    """In a launched task: stop serving once the driver writes
    <out_dir>/FLEET_STOP or <out_dir>/`stop_file(task)` (the preemption
    notice's drain), and at exit write <out_dir>/fleet_<type>-<id>.json
    with the launches of the `counted` wrappers in this process, whether
    it initialised CUDA, built or loaded the kernel library, its peak
    device memory and its FLEET_SPANS' seconds."""
    import atexit

    import torch

    from tf_yarn_tpu_torch import constants, preemption, telemetry
    from tf_yarn_tpu_torch.ops import _build

    task = os.environ[constants.ENV_TASK_KEY]
    spans = {}

    def keep(span):
        if span.name in FLEET_SPANS:
            spans.setdefault(span.name, []).append(span.duration)

    telemetry.get_tracer().add_sink(keep)

    def record():
        cuda = torch.cuda.is_initialized()
        Path(out_dir, f"fleet_{task.replace(':', '-')}.json").write_text(
            json.dumps({
                "task": task,
                "launches": {fn.__name__: fn.launches for fn in counted},
                "cuda_initialized": cuda,
                "built_kernels_here": _build.build_seconds is not None,
                "kernel_library_loaded": _build._library is not None,
                "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                   if cuda else None),
                "spans_s": spans}))

    atexit.register(record)
    stops = (Path(out_dir) / FLEET_STOP, Path(out_dir) / stop_file(task))

    def watch():
        while not any(path.exists() for path in stops):
            time.sleep(0.05)
        preemption.request()

    threading.Thread(target=watch, name="fleet-stop", daemon=True).start()
    return task


def fleet_experiment(model_dir: str, out_dir: str, serving_port: int,
                     tiny: bool = False):
    """Phase 10's experiment fn, called in every task of the fleet; it
    branches on the task's type. ``rank``: phase 8's ranker on the task's
    device from the seeded init (seed 0, no checkpoint), max_batch 256,
    max_wait_ms 2. The others (``serving``, ``prefill``, ``router``): a
    ServingExperiment of phase 5's model on the task's device (the meta
    device in the router, which builds shapes only) over the checkpoint
    in `model_dir`, grid (a) (4 slots, blocks of 16, paged, fused), a
    prefill tier that takes prompts of FLEET_THRESHOLD tokens and more,
    and the router's FLEET_ROUTER knobs. ``serving:0`` listens on
    `serving_port`; every other task on a free port it advertises."""
    import torch

    from tf_yarn_tpu_torch import constants
    from tf_yarn_tpu_torch._device import task_device
    from tf_yarn_tpu_torch.experiment import (
        RankingExperiment,
        ServingExperiment,
    )

    task = os.environ[constants.ENV_TASK_KEY]
    if task.startswith("rank:"):
        from tf_yarn_tpu_torch.models import dlrm

        _replica_record(out_dir, ())
        return RankingExperiment(
            dlrm.DLRM(rank_model_config(dlrm, torch, tiny),
                      device=task_device()),
            model_dir=None, init_seed=SEED, max_batch=RANK_MAX_BATCH,
            max_wait_ms=2.0, host="127.0.0.1",
            serve_seconds=FLEET_SERVE_SECONDS)
    from tf_yarn_tpu_torch.models import transformer as tt

    counted = ()
    if not task.startswith("router:"):
        from tf_yarn_tpu_torch.ops import decode_attention, quantize, rmsnorm

        counted = (rmsnorm.rmsnorm, quantize.quantize_int8,
                   decode_attention.paged_int8_window_attention)
    _replica_record(out_dir, counted)
    return ServingExperiment(
        tt.Transformer(fleet_config(torch, tt, tiny), device=task_device()),
        model_dir, host="127.0.0.1",
        port=serving_port if task == "serving:0" else 0,
        prefill_tier={"offload_threshold": FLEET_THRESHOLD},
        serve_seconds=FLEET_SERVE_SECONDS, **FLEET_GRID, **FLEET_ROUTER)


def mixed_fleet(topologies):
    """Phase 10's topology: `mixed_fleet_topology(nb_serving=2,
    nb_rank=1)` (two decode replicas, a ranking replica, the CPU router)
    and `disaggregated_topology`'s prefill replica."""
    specs = topologies.mixed_fleet_topology(nb_serving=2, nb_rank=1)
    specs["prefill"] = topologies.disaggregated_topology(
        n_prefill=1, n_decode=1)["prefill"]
    topologies.check_topology(specs)
    return specs


_PORTS_GIVEN: set = set()


def free_port() -> int:
    """A free port below the kernel's ephemeral range, never the same
    twice in this process. A port from `bind(("", 0))` comes from that
    range, and between its release and the server's own bind an outgoing
    connection or another autobound socket (gloo's, the launcher's) may
    take it: phase 10's tp replica once failed its bind that way
    ("Address already in use"). Below the range only an explicit bind
    can take it."""
    import random
    import socket

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                  .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    for _ in range(1000):
        port = random.randrange(max(1024, low // 2), low)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
    raise RuntimeError(f"no free port below {low}")


class endpoint_log:
    """The driver's endpoint log lines ("serving endpoint host:port") for
    the duration of the block, by label, with the perf_counter second
    each was logged; lines ending with one of `ignore` (another run's
    endpoint) are left out."""

    def __init__(self, ignore=()):
        self.lines = []
        self._logger = logging.getLogger("tf_yarn_tpu_torch.utils.metrics")
        lines = self.lines

        class Handler(logging.Handler):
            def emit(self, record):
                message = record.getMessage()
                if not message.endswith(tuple(ignore)):
                    lines.append((time.perf_counter(), message))

        self._handler = Handler(logging.INFO)

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)
        return False

    def endpoints(self, label: str):
        return [line[len(label) + 1:] for _at, line in self.lines
                if line.startswith(label + " ")]

    def logged_at(self, label: str) -> float:
        return min(at for at, line in self.lines
                   if line.startswith(label + " "))

    def port(self, label: str, exclude=()) -> int:
        """The port of the one endpoint logged under `label` that is not
        in `exclude`."""
        found = [int(endpoint.rsplit(":", 1)[1])
                 for endpoint in self.endpoints(label)]
        found = [port for port in found if port not in exclude]
        if len(found) != 1:
            raise AssertionError(f"{label}: {self.endpoints(label)}")
        return found[0]


def launch_in_background(client, *args, **kwargs):
    """`client.run_on_gpu(*args, **kwargs)` on a thread; returns the thread
    and a dict that gets the Metrics (``metrics``) or the exception
    (``error``)."""
    outcome = {}

    def run():
        try:
            outcome["metrics"] = client.run_on_gpu(*args, **kwargs)
        except BaseException as exc:  # re-raised by the caller
            outcome["error"] = exc

    thread = threading.Thread(target=run, name="run_on_gpu", daemon=True)
    thread.start()
    return thread, outcome


def task_log_tails(lines: int = 40, runs: int = 1,
                   name: str = "gpu_yarn") -> str:
    """The last `lines` lines of each task log of the newest `runs`
    `run_on_gpu` runs named `name` (their log directories under the
    temporary directory)."""
    import glob
    import tempfile

    dirs = sorted(glob.glob(os.path.join(tempfile.gettempdir(),
                                         f"{name}-logs-*")),
                  key=os.path.getmtime)[-runs:]
    tails = []
    for path in sorted(path for run in dirs
                       for path in glob.glob(os.path.join(run, "*.log"))):
        with open(path, errors="replace") as fh:
            tail = fh.readlines()[-lines:]
        tails.append(f"---- {path} ----\n{''.join(tail)}")
    return "\n".join(tails)


def wait_for_endpoints(log, counts, thread, outcome, timeout_s=300.0):
    """Wait until the driver has logged `counts[label]` endpoints for each
    label; raise if the run ends first or one is still missing after
    `timeout_s` (its task may have failed while another serves on), with
    the tasks' log tails."""
    def missing():
        return {label: n - len(log.endpoints(label))
                for label, n in counts.items()
                if len(log.endpoints(label)) < n}

    deadline = time.monotonic() + timeout_s
    while missing():
        if not thread.is_alive():
            raise AssertionError(f"the run ended before its endpoints were "
                                 f"logged: {outcome}\n{task_log_tails()}")
        if time.monotonic() > deadline:
            raise AssertionError(f"endpoints still missing after "
                                 f"{timeout_s:.0f} s: {missing()}\n"
                                 f"{task_log_tails()}")
        time.sleep(0.05)


def poll_until(read, done, what: str, timeout_s: float = 120.0):
    """`read()` every 0.1 s until `done(value)`; returns the value, or
    raises with the last one after `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = read()
        if done(value):
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}: {value}")
        time.sleep(0.1)


def drain_replicas(out_dir, thread, timeout_s=300.0) -> None:
    """Ask the tasks launched into `out_dir` to drain (FLEET_STOP) and
    wait up to `timeout_s` for their run to end."""
    (Path(out_dir) / FLEET_STOP).write_text("")
    thread.join(timeout=timeout_s)


def stop_replicas(out_dir, thread, outcome, timeout_s=300.0):
    """Drain the launched tasks and return the run's Metrics."""
    drain_replicas(out_dir, thread, timeout_s)
    if thread.is_alive():
        raise AssertionError("the launched replicas did not stop")
    if "error" in outcome:
        raise outcome["error"]
    return outcome["metrics"]


def call(port: int, method: str, path: str, body=None):
    """One request, any status: (status, headers, parsed JSON body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        reply = conn.getresponse()
        return reply.status, dict(reply.getheaders()), json.loads(
            reply.read() or b"{}")
    finally:
        conn.close()


def serve_one_at_a_time(port: int, prompts, new_tokens: int):
    replies = []
    for prompt in prompts:
        status, body = post(port, {"prompt": prompt,
                                   "max_new_tokens": new_tokens})
        if status != 200 or len(body["tokens"]) != new_tokens:
            raise AssertionError(f"bad reply {status}: {body}")
        replies.append(body)
    return replies


def fleet_reference(torch, tt, engine_mod, sched_mod, server_mod, ckpt, dev,
                    prompts, model_dir, tiny=False):
    """Phase 10 (a): phase 5's model (seed 0) on grid (a) behind
    ServingServer, the prompts one at a time; then the weights saved as
    ckpt-1 in `model_dir` and the model freed."""
    cfg = fleet_config(torch, tt, tiny)
    started = time.perf_counter()
    model = tt.make_model(cfg, seed=SEED, device=dev)
    build_s = time.perf_counter() - started
    scheduler = sched_mod.SlotScheduler(engine_mod.DecodeEngine(model),
                                        **FLEET_GRID)
    server = server_mod.ServingServer(scheduler, "127.0.0.1", 0)
    scheduler.start()
    server.start()
    try:
        replies = serve_one_at_a_time(server.port, prompts, FLEET_NEW)
    finally:
        server.stop()
        scheduler.close()
        del scheduler, server
    started = time.perf_counter()
    ckpt.save_checkpoint(model_dir, 1, {"params": model.state_dict(),
                                        "optimizer": {}, "step": 1})
    save_s = time.perf_counter() - started
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "streams": [body["tokens"] for body in replies],
        "ttft_s": [body["ttft_s"] for body in replies],
        "model_build_s": build_s, "checkpoint_write_s": save_s,
        "checkpoint_bytes": sum(
            f.stat().st_size for f in (Path(model_dir) / "ckpt-1").iterdir()),
    }


def fleet_prompts(torch, cfg):
    gen = torch.Generator().manual_seed(SEED + 10)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in FLEET_PROMPTS]


def _records(out_dir: Path) -> dict:
    return {json.loads(path.read_text())["task"]: json.loads(path.read_text())
            for path in sorted(out_dir.glob("fleet_*.json"))}


def fleet_slice(torch, tt, engine_mod, sched_mod, server_mod, ckpt, client,
                topologies, dlrm, dev, tiny=False, env=None,
                before_launch=None, beside=None):
    """Phase 10. (a) `fleet_reference`. Then one `run_on_gpu(mixed_fleet)`
    of `fleet_experiment` over (a)'s checkpoint: ``serving:0`` and
    ``serving:1`` (decode), ``prefill:0``, ``rank:0`` and the CPU
    ``router:0``; the driver logs each endpoint once.

    (b) On ``serving:0``'s own endpoint, `fleet_decode`: the prompts one
    at a time stream bitwise equal to (a)'s (the 64- and 300-token ones
    shipped to the prefill replica: 2 ships, 0 fallbacks), and a burst of
    the three is served to length. (c) On ``rank:0``'s own endpoint,
    `fleet_rank`. (d) Through the router, `fleet_routed`. (e) `serving:1`
    drained, `fleet_failover`. Then every task drained: the run ends with
    the five tasks in the Metrics; on the card the decode tasks launched
    rmsnorm, quantize and the paged kernel, the prefill task rmsnorm and
    quantize and no paged kernel; no task rebuilt the kernel library; the
    router neither initialised CUDA nor loaded the library; each task's
    peak memory and restore seconds; the seconds of each part. `env` adds
    to the tasks' environment (the CPU rehearsal's TPU_YARN_PLATFORM=cpu).
    `before_launch`, when given, is called between (a) and the launch
    (`main` ends phase 9 (g), which ran beside (a), there). `beside`, when
    given, is called with (a)'s checkpoint directory just before the
    launch, and returns (a fn that waits for what it started, a port
    whose endpoint lines the fleet's log leaves out): the tensor-parallel
    replica, whose result lands under ``tp_serving``."""
    import tempfile

    cfg = fleet_config(torch, tt, tiny)
    prompts = fleet_prompts(torch, cfg)
    result, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model_dir, out_dir = tmp / "model", tmp / "out"
        out_dir.mkdir()
        started = time.perf_counter()
        reference = fleet_reference(torch, tt, engine_mod, sched_mod,
                                    server_mod, ckpt, dev, prompts,
                                    str(model_dir), tiny)
        result["a_in_process"] = dict(reference,
                                      wall_s=time.perf_counter() - started)
        if before_launch is not None:
            before_launch()
        beside_wait, ignore = None, ()
        if beside is not None:
            beside_wait, beside_port = beside(str(model_dir))
            ignore = (f":{beside_port}",)
        if dev.type == "cuda":
            used = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip()
            print(f"phase 10 launches with the driver holding "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
                  f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved); "
                  f"card memory used {used}", flush=True)
        port = free_port()
        started = time.perf_counter()
        with endpoint_log(ignore) as log:
            thread, outcome = launch_in_background(
                client, client.get_safe_experiment_fn(
                    "chip_smoke.fleet_experiment", str(model_dir),
                    str(out_dir), port, tiny),
                mixed_fleet(topologies),
                env=dict({"PYTHONPATH": str(REPO)}, **(env or {})),
                poll_every_secs=0.5, dead_task_secs=300,
                timeout_secs=FLEET_SERVE_SECONDS + 300)
            try:
                wait_for_endpoints(log, FLEET_ENDPOINTS, thread, outcome)
                seconds["launch_to_router_endpoint"] = (
                    log.logged_at("router endpoint") - started)
                seconds["launch_to_all_endpoints"] = (
                    time.perf_counter() - started)
                ports = {
                    "serving:0": port,
                    "serving:1": log.port("serving endpoint", (port,)),
                    "rank:0": log.port("rank endpoint"),
                    "router:0": log.port("router endpoint")}
                result["b_launched"] = fleet_decode(
                    ports["serving:0"], prompts, reference["streams"])
                result["c_ranking"] = fleet_rank(
                    torch, dlrm, dev, ports["rank:0"], tiny)
                part = time.perf_counter()
                result["d_routed"] = fleet_routed(
                    ports, prompts, reference["streams"],
                    result["c_ranking"].pop("scores"),
                    rank_model_config(dlrm, torch, tiny))
                seconds["d_routed"] = time.perf_counter() - part
                part = time.perf_counter()
                result["e_failover"] = fleet_failover(
                    ports, out_dir, prompts, reference["streams"])
                seconds["e_failover"] = time.perf_counter() - part
            except BaseException:
                # A failed phase leaves no task running.
                drain_replicas(out_dir, thread, 120.0)
                if beside_wait is not None:
                    try:
                        beside_wait()
                    except BaseException as exc:  # the first failure wins
                        print(f"beside the failed fleet: {exc!r}",
                              flush=True)
                raise
            part = time.perf_counter()
            metrics = stop_replicas(out_dir, thread, outcome)
            seconds["drain"] = time.perf_counter() - part
            endpoints = {label: log.endpoints(label)
                         for label in FLEET_ENDPOINTS}
        seconds["launched_run"] = time.perf_counter() - started
        if beside_wait is not None:
            part = time.perf_counter()
            result["tp_serving"] = beside_wait()
            seconds["tp_serving_after_fleet"] = time.perf_counter() - part
        records = _records(out_dir)
    if {label: len(found) for label, found in endpoints.items()} \
            != FLEET_ENDPOINTS \
            or f"127.0.0.1:{port}" not in endpoints["serving endpoint"]:
        raise AssertionError(f"the driver logged {endpoints}")
    if sorted(metrics.container_duration) != FLEET_TASKS \
            or sorted(records) != FLEET_TASKS:
        raise AssertionError(f"metrics {metrics}, records {sorted(records)}")
    paged = "paged_int8_window_attention"
    decode = [records["serving:0"], records["serving:1"]]
    prefill, router = records["prefill:0"], records["router:0"]
    # (On the CPU the wrappers run their plain versions and count
    # nothing.)
    if dev.type == "cuda" and (
            min(min(task["launches"].values()) for task in decode) <= 0
            or prefill["launches"][paged] != 0
            or min(prefill["launches"]["rmsnorm"],
                   prefill["launches"]["quantize_int8"]) <= 0):
        raise AssertionError(f"launches: decode {decode}, prefill {prefill}")
    if any(task["built_kernels_here"] for task in records.values()):
        raise AssertionError("a launched task rebuilt the kernels")
    if router["cuda_initialized"] or router["kernel_library_loaded"]:
        raise AssertionError(f"the router touched the card: {router}")
    result["b_launched"].update({
        "endpoints": endpoints,
        "container_duration_s": metrics.container_duration,
        "decode_task": records["serving:0"],
        "serving_1_task": records["serving:1"],
        "prefill_task": prefill})
    result["c_ranking"]["task"] = records["rank:0"]
    result["d_routed"]["router_task"] = router
    result["seconds"] = seconds
    return result


def fleet_decode(port: int, prompts, streams) -> dict:
    """Phase 10 (b) on ``serving:0``'s own endpoint."""
    started = time.perf_counter()
    replies = serve_one_at_a_time(port, prompts, FLEET_NEW)
    offload = get(port, "/stats")[1]["prefill_offload"]
    results, wall = burst(port, prompts, FLEET_NEW)
    for status, body in results:
        if status != 200 or len(body["tokens"]) != FLEET_NEW:
            raise AssertionError(f"bad burst reply {status}: {body}")
    got = [body["tokens"] for body in replies]
    if got != streams:
        raise AssertionError(f"launched streams {got} != in-process "
                             f"{streams}")
    if offload["ships"] != 2 or offload["local_fallbacks"] != 0:
        raise AssertionError(f"prefill_offload {offload}")
    return {
        "wall_s": time.perf_counter() - started,
        "streams_equal_in_process": True, "streams": got,
        "ttft_s": [body["ttft_s"] for body in replies],
        "prefill_offload": offload,
        "burst": {"wall_s": wall,
                  "tokens_per_s": FLEET_NEW * len(prompts) / wall,
                  "ttft_s": [body["ttft_s"] for _st, body in results]},
        "ticks": get(port, "/stats")[1]["ticks"]}


def fleet_rank(torch, dlrm, dev, port: int, tiny=False) -> dict:
    """Phase 10 (c) on ``rank:0``'s own endpoint: 1-, 32- and 256-row
    POSTs one at a time score within FLEET_RANK_TOL of
    `dlrm.make_model(cfg, 0)` in the driver on the same rows (and whether
    bitwise), then phase 8's bursts for rows/s."""
    cfg = rank_model_config(dlrm, torch, tiny)
    started = time.perf_counter()
    model = dlrm.make_model(cfg, seed=SEED, device=dev)
    errors, bitwise, scores = {}, True, {}
    for i, (rows, _requests) in enumerate(RANK_BURSTS):
        bodies, cat, dense = rank_bodies(cfg, (rows,), seed=300 + i)
        status, body = post(port, bodies[0], "/v1/rank")
        with torch.inference_mode():
            ref = model(torch.from_numpy(cat).to(dev),
                        torch.from_numpy(dense).to(dev)
                        ).float().squeeze(-1).cpu()
        got = torch.tensor(body["scores"])
        if status != 200 or got.shape != ref.shape:
            raise AssertionError(f"/v1/rank {status}: {body}")
        errors[rows] = float((got - ref).abs().max())
        bitwise = bitwise and torch.equal(got, ref)
        scores[rows] = body["scores"]
    del model
    bursts = {}
    for i, (rows, requests) in enumerate(RANK_BURSTS):
        bodies, _cat, _dense = rank_bodies(cfg, (rows,) * requests,
                                           seed=400 + i)
        threads, replies, begun = post_all(port, bodies, "/v1/rank")
        join_all(threads, replies)
        wall = time.perf_counter() - begun
        bursts[rows] = {"requests": requests, "wall_s": wall,
                        "rows_per_s": rows * requests / wall}
    if max(errors.values()) > FLEET_RANK_TOL:
        raise AssertionError(f"served scores against the driver's forward: "
                             f"{errors}")
    return {"wall_s": time.perf_counter() - started,
            "max_abs_err": errors, "bitwise_equal": bitwise,
            "bursts": bursts, "scores": scores}


def signal_count(port: int, key: str) -> int:
    """The count of histogram `key` in a server's /stats signals."""
    signal = get(port, "/stats")[1]["signals"]["histograms"].get(key)
    return 0 if signal is None else signal["count"]


def fleet_routed(ports, prompts, streams, scores, rank_cfg) -> dict:
    """Phase 10 (d) through the router: its /healthz counts the healthy
    replicas by kind (FLEET_KINDS); the prompts one at a time, twice,
    stream bitwise equal to (a)'s, three ok routes on each decode replica
    under round robin; a burst of the three served to length (TTFT,
    tokens/s); the ranking sizes of (c) score bitwise as POSTed to
    ``rank:0`` directly (`scores`, by rows); the router's fleet aggregate is ok with no stale
    replica, its merged ``serving/ttft_seconds`` count the sum of the
    decode replicas' own; an unknown path is a 404."""
    router = ports["router:0"]
    started = time.perf_counter()
    health = poll_until(lambda: get(router, "/healthz")[1],
                        lambda h: h["healthy_by_kind"] == FLEET_KINDS,
                        "every replica healthy at the router", 300.0)
    ready_s = time.perf_counter() - started
    replies = [serve_one_at_a_time(router, prompts, FLEET_NEW)
               for _ in range(2)]
    got = [[body["tokens"] for body in run] for run in replies]
    if got != [streams, streams]:
        raise AssertionError(f"routed streams {got} != in-process {streams}")
    routed = get(router, "/stats")[1]["routed_requests"]
    if {task: routed.get(task) for task in ("serving:0", "serving:1")} \
            != {"serving:0": {"ok": 3}, "serving:1": {"ok": 3}}:
        raise AssertionError(f"round robin routed {routed}")
    results, wall = burst(router, prompts, FLEET_NEW)
    for status, body in results:
        if status != 200 or len(body["tokens"]) != FLEET_NEW:
            raise AssertionError(f"bad routed burst reply {status}: {body}")
    rank_equal = {}
    for i, (rows, _requests) in enumerate(RANK_BURSTS):
        bodies, _cat, _dense = rank_bodies(rank_cfg, (rows,), seed=300 + i)
        status, body = post(router, bodies[0], "/v1/rank")
        rank_equal[rows] = status == 200 and body["scores"] == scores[rows]
    if not all(rank_equal.values()):
        raise AssertionError(f"routed scores against rank:0's: {rank_equal}")
    aggregate, counts = fleet_aggregate(ports)
    unknown = call(router, "POST", "/v1/unknown", {})[0]
    if unknown != 404:
        raise AssertionError(f"an unknown path at the router: {unknown}")
    stats = get(router, "/stats")[1]
    return {"healthy_by_kind": health["healthy_by_kind"],
            "ready_s": ready_s, "streams_equal_in_process": True,
            "ttft_s": [[body["ttft_s"] for body in run] for run in replies],
            "routed_one_at_a_time": routed,
            "burst": {"wall_s": wall,
                      "tokens_per_s": FLEET_NEW * len(prompts) / wall,
                      "ttft_s": [body["ttft_s"] for _st, body in results]},
            "rank_scores_equal_direct": rank_equal,
            "fleet": {"status": aggregate["status"],
                      "stale_replicas": aggregate["stale_replicas"],
                      "contributing_replicas":
                          aggregate["contributing_replicas"],
                      "ttft": aggregate["histograms"]["serving/ttft_seconds"],
                      "replica_ttft_counts": counts},
            "unknown_path_status": unknown,
            "routed_requests": stats["routed_requests"],
            "scale_events": stats["autoscaler"]["scale_events"]}


def fleet_aggregate(ports, attempts: int = 20):
    """The router's fleet aggregate from a monitor cycle that began after
    the decode replicas' own ``serving/ttft_seconds`` counts were read,
    with those counts unchanged after it: its status ok, no stale replica
    and the merged count their sum. Retried while a window's slice
    expires between the reads."""
    key = "serving/ttft_seconds"
    router = ports["router:0"]
    for _ in range(attempts):
        counts = {task: signal_count(ports[task], key)
                  for task in ("serving:0", "serving:1")}
        cycle = get(router, "/stats")[1]["fleet"].get("cycle", 0)
        fleet = poll_until(lambda: get(router, "/stats")[1]["fleet"],
                           lambda f: f.get("cycle", 0) >= cycle + 2,
                           "two monitor cycles", 60.0)
        after = {task: signal_count(ports[task], key)
                 for task in ("serving:0", "serving:1")}
        if after == counts:
            break
    else:
        raise AssertionError(f"the decode replicas' {key} counts kept "
                             f"moving: {counts} -> {after}")
    merged = (fleet.get("histograms") or {}).get(key, {}).get("count")
    if fleet["status"] != "ok" or fleet["stale_replicas"] != 0 \
            or merged != sum(counts.values()):
        raise AssertionError(f"fleet aggregate {fleet} against the "
                             f"replicas' {key} counts {counts}")
    return fleet, counts


def fleet_failover(ports, out_dir: Path, prompts, streams) -> dict:
    """Phase 10 (e): ``serving:1`` drained through its stop file. Its
    /healthz turns "draining" and the router's registry ejects it
    (draining, or unreachable once its socket closed); the prompts
    through the router then all land on ``serving:0`` with (a)'s streams;
    /healthz counts one generate replica; the autoscaler records a
    below_min generate event back to two."""
    router = ports["router:0"]
    stats = get(router, "/stats")[1]
    before = stats["routed_requests"]["serving:0"]["ok"]
    # The autoscaler's first cycle can run before the registry's first
    # refresh and record a below_min event from 0: only later ones count.
    earlier = len(stats["autoscaler"]["scale_events"])
    started = time.perf_counter()
    (out_dir / stop_file("serving:1")).write_text("")
    replica = poll_until(
        lambda: get(router, "/stats")[1]["replicas"]["serving:1"],
        lambda r: r["state"] != "healthy", "serving:1 out of rotation")
    ejected_s = time.perf_counter() - started
    if replica["ejections"] < 1 \
            or replica["eject_reason"] not in ("draining", "unreachable"):
        raise AssertionError(f"serving:1 left rotation as {replica}")
    replies = serve_one_at_a_time(router, prompts, FLEET_NEW)
    got = [body["tokens"] for body in replies]
    if got != streams:
        raise AssertionError(f"failover streams {got} != {streams}")
    stats = get(router, "/stats")[1]
    if stats["routed_requests"]["serving:0"]["ok"] != before + len(prompts):
        raise AssertionError(f"after failover {stats['routed_requests']}")
    health = get(router, "/healthz")[1]["healthy_by_kind"]
    if health != dict(FLEET_KINDS, generate=1):
        raise AssertionError(f"healthy after failover: {health}")
    event = poll_until(
        lambda: [e for e in get(router, "/stats")[1]["autoscaler"][
            "scale_events"][earlier:] if e["reason"] == "below_min"],
        lambda events: events, "a below_min scale event", 60.0)[0]
    if (event["kind"], event["from_replicas"], event["to_replicas"]) \
            != ("generate", 1, 2):
        raise AssertionError(f"scale event {event}")
    return {"ejected_s": ejected_s, "serving_1": replica,
            "scale_events_before": stats["autoscaler"]["scale_events"][
                :earlier],
            "streams_equal_in_process": True,
            "routed_requests": stats["routed_requests"],
            "healthy_by_kind": health, "scale_event": event}


# Phase 10's tensor-parallel replica, launched beside the fleet: phase 5's
# decoder restored from (a)'s ckpt-1 over two ranks on the card
# (serving_topology(chips_per_host=2), MeshSpec(tp=2): the task starts
# its follower), on phase 5 (b)'s grid, the paged gather mode.
TP_GRID = dict(max_slots=4, block_size=16, kv_layout="paged",
               decode_attention="gather")
# The near-greedy check: a tp=2 replica and one device sum their bf16
# products in other orders, so a greedy token may flip at a near-tie of
# the random-init logits. Every token the replica emits must have, in the
# one-device model teacher-forced on the replica's own prefix, a logit
# within TP_DELTA of that position's largest (logits ~N(0, 1.3) here: a
# wrong token sits ~5 below the largest).
TP_DELTA = 0.25
# The leader's spans the smoke reads: each tick, its engine step, the tp
# group's collectives and the headers it sends the follower (per-tick
# attribution), and the start.
TP_TICK_SPANS = ("serving/tick", "decode_engine/paged_step",
                 "serving/tp_allreduce", "serving/tp_header")
TP_START_SPANS = ("serving/build_mesh", "serving/restore_params",
                  "serving/shard_params")


def _tp_record(out_dir: str) -> None:
    """In the launched tp leader: keep TP_TICK_SPANS (name, start,
    seconds) and TP_START_SPANS; on <out_dir>/snapshot-<n> write
    tp_ranks-<n>.json (every rank's `rank_report`, launches zeroed after,
    and the spans since the last snapshot); on <out_dir>/FLEET_STOP drain
    (the preemption notice); at exit write tp_task.json (the ranks'
    reports at close, the follower's exit code, whether this process
    rebuilt the kernels, the start spans)."""
    import atexit

    import torch

    from tf_yarn_tpu_torch import preemption, telemetry
    from tf_yarn_tpu_torch.ops import _build
    from tf_yarn_tpu_torch.serving import tp_replica

    spans, started, held = [], {}, {}

    def keep(span):
        if span.name in TP_TICK_SPANS:
            spans.append((span.name, span.start, span.duration,
                          span.args.get("bytes")))
        elif span.name in TP_START_SPANS:
            started[span.name] = span.duration

    telemetry.get_tracer().add_sink(keep)
    out = Path(out_dir)

    def watch():
        n = 1
        while not (out / FLEET_STOP).exists():
            if (out / f"snapshot-{n}").exists():
                replica = held.setdefault("replica",
                                          next(iter(tp_replica._LIVE)))
                reports = replica.engine.rank_report(reset_launches=True)
                taken = spans[:]
                del spans[:len(taken)]
                (out / f"tp_ranks-{n}.json").write_text(json.dumps(
                    {"ranks": reports, "spans": taken}))
                n += 1
            time.sleep(0.05)
        preemption.request()

    threading.Thread(target=watch, name="tp-record", daemon=True).start()

    def record():
        replica = held.get("replica")
        (out / "tp_task.json").write_text(json.dumps({
            "reports_at_close": getattr(replica, "reports", None),
            "followers_exit": [p.exitcode for p in replica.processes]
            if replica is not None else None,
            "cuda_initialized": torch.cuda.is_initialized(),
            "built_kernels_here": _build.build_seconds is not None,
            "start_spans_s": started}))

    atexit.register(record)


def tp_serving_experiment(model_dir: str, out_dir: str, port: int,
                          tiny: bool = False):
    """The tp replica's experiment fn: phase 5's model (built on the meta
    device: each rank restores its own shards) over `model_dir`'s
    checkpoint at MeshSpec(tp=2) on TP_GRID, listening on `port`."""
    import torch

    from tf_yarn_tpu_torch.experiment import ServingExperiment
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    _tp_record(out_dir)
    return ServingExperiment(
        tt.Transformer(fleet_config(torch, tt, tiny), device="meta"),
        model_dir, host="127.0.0.1", port=port,
        serve_seconds=FLEET_SERVE_SECONDS,
        mesh_spec=MeshSpec(tp=TP_RANKS_SERVING), **TP_GRID)


def tp_snapshot(out_dir: Path, n: int) -> dict:
    """Ask the launched leader for snapshot `n` (`_tp_record`)."""
    (out_dir / f"snapshot-{n}").write_text("")
    path = out_dir / f"tp_ranks-{n}.json"
    poll_until(path.exists, bool, f"tp snapshot {n}", 120.0)
    return json.loads(path.read_text())


def tp_kernel_launches(n_layers: int, calls: dict) -> dict:
    """The serving path's kernel launches of the gather grid's engine
    calls: a prefill or a one-token step runs two RMSNorms a layer and the
    final one, and quantizes K and V a layer; a step attends once a
    layer."""
    forward = calls["prefill_calls"] + calls["paged_step_calls"]
    return {"rmsnorm": (2 * n_layers + 1) * forward,
            "quantize_int8": 2 * n_layers * forward,
            "int8_decode_attention": n_layers * calls["paged_step_calls"]}


def tp_ticks(spans) -> dict:
    """Each decode step of the leader's trace with the tp collectives
    inside it, and each tick that ran one: their mean seconds, the
    collectives' mean seconds and count a step, and the headers the
    leader sent in those ticks (the control protocol's own cost): their
    mean seconds, count and bytes a tick, and their share of the tick."""
    steps = [(s, d) for name, s, d, _ in spans
             if name == "decode_engine/paged_step"]
    ticks = [(s, d) for name, s, d, _ in spans if name == "serving/tick"
             and any(s <= t < s + d for t, _ in steps)]
    reduces = [(s, d) for name, s, d, _ in spans
               if name == "serving/tp_allreduce"]
    header_spans = [span for span in spans if span[0] == "serving/tp_header"]
    inside = [[d for s, d in reduces if t <= s < t + w] for t, w in steps]
    headers = [[(d, a) for name, s, d, a in header_spans if t <= s < t + w]
               for t, w in ticks]
    n = max(1, len(steps))
    n_ticks = max(1, len(ticks))
    header_s = sum(d for tick in headers for d, _ in tick)
    return {"steps": len(steps),
            "step_s_mean": sum(d for _, d in steps) / n,
            "tick_s_mean": sum(d for _, d in ticks) / max(1, len(ticks)),
            "allreduce_s_per_step": sum(map(sum, inside)) / n,
            "collectives_per_step": sum(map(len, inside)) / n,
            "allreduce_share_of_step": (sum(map(sum, inside))
                                        / max(1e-12, sum(d for _, d in steps))),
            "header_s_per_tick": header_s / n_ticks,
            "headers_per_tick": sum(map(len, headers)) / n_ticks,
            "header_bytes_per_tick": sum(a for tick in headers
                                         for _, a in tick) / n_ticks,
            "header_share_of_tick": (header_s / max(
                1e-12, sum(d for _, d in ticks)))}


def near_greedy(torch, engine, prompts, streams) -> dict:
    """Teacher-force each stream on the one-device `engine` through the
    serving path's own cache (the prompt's bucketed prefill into an int8
    cache, then one window over the rest of the prompt and the stream):
    each emitted token's logit against its position's largest. Returns
    the largest gap and the count of tokens that are the one-device
    argmax."""
    model = engine.model
    gaps, argmax = [], 0
    for prompt, stream in zip(prompts, streams):
        prefill = engine.slot_prefill_len(len(prompt))
        rows, _ = engine.prefill([prompt[:prefill]])
        cache = model.make_cache(1, len(prompt) + len(stream))
        cache.insert(rows)
        window = torch.tensor([prompt[prefill:] + stream[:-1]],
                              device=engine.device)
        logits = model.decode(window, cache)[0]
        first = len(prompt) - prefill - 1
        logits = logits[first:first + len(stream)]
        chosen = logits.gather(1, torch.tensor(
            stream, device=logits.device)[:, None])[:, 0]
        best = logits.max(dim=1)
        gaps += (best.values - chosen).tolist()
        argmax += int((best.indices == torch.tensor(
            stream, device=logits.device)).sum())
        del rows, cache, logits
    return {"max_gap": max(gaps), "delta": TP_DELTA, "tokens": len(gaps),
            "one_device_argmax": argmax}


def tp_healthy(port: int, thread) -> bool:
    if not thread.is_alive():
        raise AssertionError(f"the tp run ended before it served\n"
                             f"{task_log_tails(runs=2)}")
    try:
        return get(port, "/healthz")[1]["status"] == "ok"
    except OSError:
        return False


def tp_serving_part(torch, tt, engine_mod, sched_mod, server_mod, client,
                    topologies, dev, model_dir: str, out_dir: Path,
                    port: int, reference: dict, tiny: bool = False,
                    env=None) -> dict:
    """Phase 10's tp replica (launched, `tp_serving_experiment`), beside
    the fleet. Phase 5 (b)'s prompts (`reference`: its prompts, streams,
    launches, engine calls and peak memory) as one burst: served to
    length, each rank's launches those of the leader's engine calls and
    each rank's as the other's (on the card), the launches of phase 5
    (b)'s calls the same function of them, every token near-greedy
    (`near_greedy`, within TP_DELTA) and the count equal to (b)'s; the
    burst again bitwise equal; GET /v1/blocks POSTed to a one-device
    grid and hit as a prefix; the ranks' peak memory, the step's wall
    and collectives from the leader's trace; the replica drained, its
    follower exited 0."""
    cfg = fleet_config(torch, tt, tiny)
    seconds = {}
    started = time.perf_counter()
    thread, outcome = launch_in_background(
        client, client.get_safe_experiment_fn(
            "chip_smoke.tp_serving_experiment", model_dir, str(out_dir),
            port, tiny),
        topologies.serving_topology(chips_per_host=TP_RANKS_SERVING),
        env=dict({"PYTHONPATH": str(REPO)}, **(env or {})),
        poll_every_secs=0.5, dead_task_secs=300,
        timeout_secs=FLEET_SERVE_SECONDS + 300)
    prompts, want = reference["prompts"], reference["streams"]
    try:
        # The one-device model of the near-greedy check and the receiving
        # grid, built while the ranks start.
        engine = engine_mod.DecodeEngine(tt.make_model(cfg, seed=SEED,
                                                       device=dev))
        poll_until(lambda: tp_healthy(port, thread), bool,
                   "the tp replica's /healthz", 300.0)
        seconds["launch_to_healthy"] = time.perf_counter() - started
        results, wall = burst(port, prompts, BURST_NEW)
        for status, body in results:
            if status != 200 or len(body["tokens"]) != BURST_NEW:
                raise AssertionError(f"bad tp reply {status}: {body}")
        streams = [body["tokens"] for _status, body in results]
        first = tp_snapshot(out_dir, 1)
        stats = get(port, "/stats")[1]
        again, wall_again = burst(port, prompts, BURST_NEW)
        if [body["tokens"] for _status, body in again] != streams:
            raise AssertionError("the tp replica served the burst twice "
                                 "with other streams")
        status, wire = get(port, "/v1/blocks")
        if status != 200 or not wire["n_blocks"]:
            raise AssertionError(f"GET /v1/blocks: {status}")
        part = time.perf_counter()
        greedy = near_greedy(torch, engine, prompts, streams)
        receiver = sched_mod.SlotScheduler(engine, **TP_GRID)
        server = server_mod.ServingServer(receiver, "127.0.0.1", 0)
        receiver.start()
        server.start()
        try:
            imported = post(server.port, wire, "/v1/blocks")
            reply = post(server.port, {"prompt": prompts[-1],
                                       "max_new_tokens": BURST_NEW})
            hits = get(server.port, "/stats")[1]["prefix_cache"]["hits"]
        finally:
            server.stop()
            receiver.close()
        seconds["one_device_checks"] = time.perf_counter() - part
    finally:
        part = time.perf_counter()
        (out_dir / FLEET_STOP).write_text("")
        thread.join(timeout=300)
        seconds["drain"] = time.perf_counter() - part
    if thread.is_alive() or "error" in outcome:
        raise AssertionError(f"the tp run: {outcome}\n"
                             f"{task_log_tails(runs=2)}")
    task = json.loads((out_dir / "tp_task.json").read_text())
    if task["followers_exit"] != [0] or task["built_kernels_here"]:
        raise AssertionError(f"the tp task: {task}")
    if greedy["max_gap"] > TP_DELTA:
        raise AssertionError(f"a tp token is {greedy['max_gap']} below its "
                             f"position's largest one-device logit")
    equal = sum(a == b for got, ref in zip(streams, want)
                for a, b in zip(got, ref))
    if imported[0] != 200 or reply[0] != 200 or hits < 1:
        raise AssertionError(f"the tp replica's blocks on one device: "
                             f"{imported}, {reply[0]}, {hits} hits")
    calls = {key: stats["decode_engine"][key]
             for key in ("prefill_calls", "paged_step_calls")}
    expected = tp_kernel_launches(cfg.n_layers, calls)
    launches = [{name: rank["launches"][name] for name in TP_SERVE_KERNELS}
                for rank in first["ranks"]]
    phase5 = {name: reference["launches"][name] for name in TP_SERVE_KERNELS}
    if dev.type == "cuda" and (
            any(rank != expected for rank in launches)
            or phase5 != tp_kernel_launches(cfg.n_layers,
                                            reference["engine_calls"])):
        raise AssertionError(f"the ranks launched {launches}; their calls "
                             f"{calls} make {expected}; phase 5 (b) "
                             f"launched {phase5} for "
                             f"{reference['engine_calls']}")
    seconds["total"] = time.perf_counter() - started
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "grid": TP_GRID, "tp": stats["tp_degree"],
        "layers": cfg.n_layers, "prompt_tokens": [len(p) for p in prompts],
        "new_tokens": BURST_NEW, "wall_s": wall, "again_wall_s": wall_again,
        "tokens_per_s": BURST_NEW * len(prompts) / wall,
        "ttft_s": sorted(body["ttft_s"] for _st, body in results),
        "streams_again_bitwise_equal": True,
        "near_greedy": greedy, "tokens_equal_phase5_b": equal,
        "engine_calls": calls, "phase5_b_engine_calls":
            reference["engine_calls"],
        "rank_launches": launches, "phase5_b_launches": phase5,
        "launches_of_the_calls": expected,
        "rank_peak_memory_gb": [
            None if rank["peak_memory_bytes"] is None
            else rank["peak_memory_bytes"] / 1e9 for rank in first["ranks"]],
        "phase5_b_peak_memory_gb": reference["peak_memory_gb"],
        "kv_cache_bytes": stats["kv_cache_hbm_bytes"],
        "kv_cache_bytes_per_device": stats["kv_cache_hbm_bytes_per_device"],
        "trace": tp_ticks(first["spans"]),
        "blocks_on_one_device": {"imported": imported[1], "prefix_hits": hits},
        "start_spans_s": task["start_spans_s"], "seconds": seconds}


# The MoE decoder (phases 4 and 6b). Phase 4's small f32 one (head_dim 64,
# the flash f32 kernels) at capacity factor 1.0, so tokens are dropped;
# phase 6b's has Llama-3-8B's widths and 8 experts each of its MLP's
# shape, at one layer of its 32 (full-parameter training must fit the
# card), trained at TRAIN_BATCH x TRAIN_SEQ: capacity int(1.25 * 2048 / 8)
# = 320 slots an expert.
MOE_EXPERTS = 8
MOE_STEPS = 4
MOE_EP = 2
MOE_EP_STEPS = 3
# Learning rates of the tiny card-vs-CPU runs: AdamW's, and adafactor's
# (a step relative to each leaf's RMS). Phase 6b uses make_experiment's.
MOE_TINY_LR = {"adamw": 1e-4, "adafactor": 1e-2}
# Card (kernels) against the CPU (plain f32 versions), f32: the losses and
# aux losses differ by sums in another order, 1e-4 relative. AdamW's step
# is m / sqrt(v): an element whose gradient is rounding noise may step
# the other way, by up to lr, each step, so its parameters are held to
# 2 x steps x lr; adafactor scales each step by the leaf's factored
# moments and has no such sign step, so 1e-5.
MOE_TINY_LOSS_RTOL = 1e-4
MOE_TINY_ADAFACTOR_ATOL = 1e-5
# The smallest top-1 router margin a routed comparison accepts at its
# initial weights: a near-tie could route the other way on another
# device, and must fail loudly rather than pass by luck. The router's f32
# inputs differ between the card's kernels and the CPU's plain versions
# by sums in another order (~1e-7 of probabilities near 1/4); 1e-5 is 100
# times that.
MOE_ROUTE_MARGIN = 1e-5
# ep=2 on the card against one rank on the card, the tiny f32 decoder:
# same kernels, same card; the ep sum adds exact zeros.
MOE_EP_TINY_TOL = 1e-4
# Phase 6b's ep=2 ranks against the one-device adafactor run, bf16, its
# first MOE_EP_STEPS losses (relative). Each token's combine adds exact
# zeros and its dispatch gradient's sum over ep adds exact zeros, and
# every other computation is the one-device one on the same card, so
# the two runs differ only where cuBLAS picks another algorithm for a
# batched product of 4 experts than of 8. One bf16 rounding is 2^-8
# relative; averaged over 2048 tokens' losses and carried through 3
# steps it stays orders under this bound, set before the first card run.
MOE_EP_WIDE_RTOL = 1e-3
# The linear classifier at BASELINE.json config 2's size (2^20 buckets,
# 39 features), batch 4096, 60 adagrad steps (JAX test_models.py:387-394
# asks for accuracy > 0.6).
LINEAR_BATCH = 4096
LINEAR_STEPS = 60


def moe_config(torch, tt, tiny: bool):
    if tiny:
        return tt.TransformerConfig(
            vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=512, max_seq_len=128, dtype=torch.float32,
            attention_impl="flash", fused_norms=True, remat=True,
            moe_experts=4, moe_capacity_factor=1.0)
    return dataclasses.replace(tt.TransformerConfig.llama3_8b(
        moe_experts=MOE_EXPERTS, attention_impl="flash", fused_norms=True),
        n_layers=1)


def moe_drops(torch, model, sink) -> None:
    """Hook each MoE layer of `model` to append, at each forward outside a
    backward (not a remat recompute), the share of its tokens dropped at
    the capacity, as a 0-d tensor (no host read)."""
    from tf_yarn_tpu_torch.models import moe

    def hook(module, args, _):
        if torch._C._current_graph_task_id() != -1:
            return
        with torch.no_grad():
            x = args[0].reshape(-1, args[0].shape[-1])
            experts = torch.softmax(x.float() @ module.router.float(),
                                    -1).argmax(-1)
            counts = torch.bincount(experts,
                                    minlength=module.config.moe_experts)
            kept = counts.clamp(max=moe.capacity(module.config, x.shape[0]))
            sink.append(1.0 - kept.sum() / x.shape[0])

    for module in model.modules():
        if isinstance(module, moe.MoEMlp):
            module.register_forward_hook(hook)


def route_margin(torch, model, tokens) -> float:
    """The smallest top-1 router margin over `tokens`' forward, every MoE
    layer."""
    from tf_yarn_tpu_torch.models import moe

    margins = []

    def hook(module, args, _):
        x = args[0].reshape(-1, args[0].shape[-1])
        top = torch.softmax(x.float() @ module.router.float(),
                            -1).topk(2, dim=-1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, moe.MoEMlp)]
    with torch.no_grad():
        model(tokens)
    for handle in handles:
        handle.remove()
    return min(margins)


def device_fingerprint(torch, params) -> list:
    """A bitwise fingerprint of `params`, in name order: each tensor's bits
    summed as int64 on its device (a flipped bit moves the sum by its
    place value). Equal tensors give equal sums."""
    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = [params[name].detach().reshape(-1).view(
        views[params[name].element_size()]).sum(dtype=torch.int64)
        for name in sorted(params)]
    return torch.stack(sums).tolist() if sums else []


# In-process MoE runs' models, by tag (the profiled step reads them).
_MOE_MODELS = {}


def moe_record_path(out_dir, rank: int, tag: str) -> Path:
    return Path(out_dir) / f"moe-{tag}-{rank}.json"


def moe_experiment(out_dir: str, tiny: bool = False, tag: str = "moe",
                   ep: int = 1, optimizer: str = "adamw",
                   steps: int = MOE_STEPS, keep: bool = False):
    """The MoE decoder's experiment (`moe_config`) through make_experiment:
    `optimizer`, batch 2 x 128 (tiny, the tiny learning rates) or
    TRAIN_BATCH x TRAIN_SEQ, `steps` steps, ``MeshSpec(ep=ep)`` when ep >
    1, random weights from seed 0, the losses logged every step. Each
    rank writes <out_dir>/moe-<tag>-<rank>.json after its last step: its
    losses, aux losses and dropped shares, the training kernels'
    launches in this process, its peak memory, its expert shapes and the
    fingerprint of the parameters it holds whole (`device_fingerprint`:
    read on the card, so the last step's time does not carry a host copy
    of them); tiny, its parameters to
    moe-<tag>-<rank>.pt. `keep`: the model stays in _MOE_MODELS[tag],
    with snapshots of its router and a corner of each expert weight."""
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.ops import flash_attention, rmsnorm
    from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

    cfg = moe_config(torch, tt, tiny)
    shape = (dict(batch_size=2, seq_len=128, learning_rate=MOE_TINY_LR[
        optimizer]) if tiny else dict(batch_size=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ))
    exp = tt.make_experiment(cfg, train_steps=steps, log_every_steps=1,
                             mesh_spec=MeshSpec(ep=ep) if ep > 1 else None,
                             optimizer=optimizer, **shape)
    counted = (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd_dx,
               flash_attention.flash_fwd, flash_attention.flash_dq,
               flash_attention.flash_dkv)
    init, loss_fn, make_optimizer = exp.init_fn, exp.loss_fn, exp.optimizer
    losses, auxes, drops = [], [], []
    experts = ("w_gate", "w_up", "w_down")

    def init_fn(device, seed):
        model = init(device, seed)
        moe_drops(torch, model, drops)
        if keep:
            layer = model.layers[0].moe
            _MOE_MODELS[tag] = {"model": model, "before": {
                "router": layer.router.detach().clone(),
                **{name: getattr(layer, name)[:, :64, :64].detach().clone()
                   for name in experts}}}
        return model

    def recording_loss(model, batch, train=True):
        loss, aux = loss_fn(model, batch, train=train)
        if train:
            losses.append(loss.detach())
            auxes.append(aux["moe_aux_loss"])
        return loss, aux

    def optimizer_fn(model):
        opt = make_optimizer(model)

        def after_step(opt, args, kwargs):
            if len(losses) != steps:
                return
            grouped = dist.is_available() and dist.is_initialized()
            rank = dist.get_rank() if grouped else 0
            params = dict(model.named_parameters())
            device = next(iter(params.values())).device
            whole = {n: p for n, p in params.items()
                     if not n.endswith(experts)}
            if tiny:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                torch.save({n: p.detach().cpu() for n, p in params.items()},
                           Path(out_dir) / f"moe-{tag}-{rank}.pt")
            moe_record_path(out_dir, rank, tag).write_text(json.dumps({
                "losses": [float(x) for x in losses],
                "moe_aux_loss": [float(x) for x in auxes],
                "dropped_share": [float(x) for x in drops[:steps
                                                          * cfg.n_layers]],
                "launches": {fn.__name__: fn.launches for fn in counted},
                "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None),
                "rank": rank,
                "world": dist.get_world_size() if grouped else 1,
                "backend": dist.get_backend() if grouped else None,
                "device": str(device),
                "expert_shapes": {n: list(p.shape) for n, p in params.items()
                                  if n.endswith(experts)},
                "whole_fingerprint": device_fingerprint(torch, whole),
            }))

        opt.register_step_post_hook(after_step)
        return opt

    exp.init_fn, exp.loss_fn, exp.optimizer = (init_fn, recording_loss,
                                               optimizer_fn)
    return exp


def moe_tiny_reference(torch, tt, common, training, dev):
    """Phase 4: the small f32 MoE decoder trained 3 steps on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batches, once with AdamW and once with adafactor (d_model 256:
    its leaves factor); then the linear classifier 3 adagrad steps on
    both."""
    from tf_yarn_tpu_torch.models import adafactor, linear

    cfg = moe_config(torch, tt, True)
    cpu = torch.device("cpu")
    base = tt.make_model(cfg, seed=SEED, device="cpu", trainable=True)
    batches = common.synthetic_token_iter(2, 128, cfg.vocab_size, seed=SEED)
    tokens = [torch.as_tensor(next(batches)["tokens"]).long()
              for _ in range(TP_STEPS)]
    margin = route_margin(torch, base, tokens[0])
    if margin <= MOE_ROUTE_MARGIN:
        raise AssertionError(f"tiny MoE router margin {margin}")
    makers = {"adamw": common.adamw_with_decay_mask(MOE_TINY_LR["adamw"]),
              "adafactor": adafactor.adafactor(MOE_TINY_LR["adafactor"])}
    result = {"route_margin": margin}
    for name, make in makers.items():
        runs = []
        for device in (dev, cpu):
            model = tt.Transformer(cfg, device=device, trainable=True)
            model.load_state_dict(base.state_dict())
            optimizer = make(model)
            step = training.build_train_step(model, common.lm_loss, optimizer)
            state = training.TrainState(0, model, optimizer)
            losses, auxes = [], []
            for batch in tokens:
                state, metrics = step(state, {"tokens": batch.to(device)})
                losses.append(float(metrics["loss"]))
                auxes.append(float(metrics["moe_aux_loss"]))
            runs.append((losses, auxes, {n: p.detach().cpu() for n, p
                                         in model.named_parameters()}))
        (card, card_aux, card_p), (ref, ref_aux, ref_p) = runs
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card + card_aux,
                                                             ref + ref_aux))
        param_err = max(float((card_p[n] - ref_p[n]).abs().max())
                        for n in ref_p)
        bound = (2 * TP_STEPS * MOE_TINY_LR["adamw"] if name == "adamw"
                 else MOE_TINY_ADAFACTOR_ATOL)
        moved = min(float((ref_p[n] - base.state_dict()[n]).abs().max())
                    for n in ref_p)
        if (not all(abs(x) < 1e9 and x == x for x in card)
                or loss_err > MOE_TINY_LOSS_RTOL or param_err > bound
                or moved <= 0):
            raise AssertionError(
                f"tiny MoE {name}, card vs CPU: losses {card} vs {ref}, aux "
                f"{card_aux} vs {ref_aux}, parameter max abs err "
                f"{param_err} (bound {bound}), least leaf move {moved}")
        result[name] = {"losses_card": card, "losses_cpu": ref,
                        "moe_aux_card": card_aux, "moe_aux_cpu": ref_aux,
                        "loss_max_rel_err": loss_err,
                        "param_max_abs_err": param_err, "param_bound": bound}
    lin_cfg = linear.LinearConfig(n_buckets=4096)
    stream = linear.synthetic_stream(lin_cfg, 256)
    lin_batches = [next(stream) for _ in range(TP_STEPS)]
    runs = []
    for device in (dev, cpu):
        model = linear.HashedLinearClassifier(lin_cfg, device)
        optimizer = common.adagrad(0.05)(model)
        step = training.build_train_step(model, common.binary_logistic_loss,
                                         optimizer)
        state = training.TrainState(0, model, optimizer)
        losses = []
        for batch in lin_batches:
            state, metrics = step(state, training.to_device(batch, device))
            losses.append(float(metrics["loss"]))
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in model.named_parameters()}))
    (card, card_p), (ref, ref_p) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card, ref))
    param_err = max(float((card_p[n] - ref_p[n]).abs().max()) for n in ref_p)
    if loss_err > 1e-5 or param_err > 1e-6:
        raise AssertionError(f"linear classifier card vs CPU: losses {card} "
                             f"vs {ref}, parameter max abs err {param_err}")
    result["linear"] = {"losses_card": card, "losses_cpu": ref,
                        "loss_max_rel_err": loss_err,
                        "param_max_abs_err": param_err}
    return result


def moe_reference(torch, training, experiment, out_dir, dev, tiny: bool,
                  tag: str, **kwargs):
    """`moe_experiment` at one rank in this process, the training kernels'
    counts set to 0 just before it: its record and seconds; its model
    stays in _MOE_MODELS[tag]."""
    zero_training_counts()
    started = time.perf_counter()
    training.train_and_evaluate(experiment.as_core_experiment(
        moe_experiment(str(out_dir), tiny, tag=tag, keep=True, **kwargs)),
        device=dev)
    seconds = time.perf_counter() - started
    record = json.loads(moe_record_path(out_dir, 0, tag).read_text())
    return dict(record, seconds=seconds, tag=tag, dir=str(out_dir))


def moe_ep_check(torch, out_dir, tag, reference, tiny: bool, ranks_wall):
    """The spawned ep=2 ranks of run `tag` against `reference`, the same
    experiment at one rank (`moe_reference`): each rank's losses within
    the tolerance of the one rank's (tiny: MOE_EP_TINY_TOL absolute on
    the losses and every parameter; full width: MOE_EP_WIDE_RTOL relative
    on the losses, the one rank's first ones), the ranks' whole
    parameters bitwise equal, each rank holding E / ep experts; with the
    ranks' peak memory and their ep collectives' seconds a step from
    their traces."""
    ranks = [json.loads(moe_record_path(out_dir, r, tag).read_text())
             for r in range(MOE_EP)]
    n = len(ranks[0]["losses"])
    want = reference["losses"][:n]
    if tiny:
        loss_err = max(abs(a - b) for r in ranks
                       for a, b in zip(r["losses"], want))
        one = torch.load(Path(reference["dir"]) / f"moe-{tag}-0.pt")
        states = [torch.load(Path(out_dir) / f"moe-{tag}-{r}.pt")
                  for r in range(MOE_EP)]
        param_err = 0.0
        for r, state in enumerate(states):
            for name, value in state.items():
                ref = one[name]
                if name.endswith(("w_gate", "w_up", "w_down")):
                    share = ref.shape[0] // MOE_EP
                    ref = ref[r * share:(r + 1) * share]
                param_err = max(param_err, float((value - ref).abs().max()))
        bad = loss_err > MOE_EP_TINY_TOL or param_err > MOE_EP_TINY_TOL
    else:
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], want))
        param_err = None
        bad = loss_err > MOE_EP_WIDE_RTOL
    experts = reference["expert_shapes"]
    shapes_ok = all(
        r["expert_shapes"][name] == [shape[0] // MOE_EP] + shape[1:]
        for r in ranks for name, shape in experts.items())
    if (bad or not shapes_ok or n != len(want)
            or ranks[0]["whole_fingerprint"] != ranks[1]["whole_fingerprint"]
            or any((r["world"], r["backend"]) != (MOE_EP, "gloo")
                   for r in ranks)):
        raise AssertionError(f"MoE at ep={MOE_EP} against one rank: ranks "
                             f"{ranks}, one rank {reference}, loss err "
                             f"{loss_err}, parameter err {param_err}")
    ep_s = []
    for r in range(MOE_EP):
        trace = Path(out_dir) / f"{tag}_trace" / (
            "trace_train.json" if r == 0 else f"trace_train-{r}.json")
        ep_s.append(_collective_steps(trace, "train/ep_allreduce")
                    if trace.exists() else None)
    return {"losses": [r["losses"] for r in ranks],
            "reference_losses": want,
            "moe_aux_loss": [r["moe_aux_loss"] for r in ranks],
            "loss_max_err": loss_err, "param_max_abs_err": param_err,
            "whole_params_bitwise_equal_across_ranks": True,
            "expert_shapes": ranks[0]["expert_shapes"],
            "launches": [r["launches"] for r in ranks],
            "peak_gb": [r["peak_gb"] for r in ranks],
            "ep_allreduce_s_by_step": ep_s,
            "ranks_wall_s": ranks_wall}


def moe_slice(torch, training, experiment, telemetry, counted, dev, out_dir,
              tiny: bool = False):
    """Phase 6b (`tiny`: its rehearsal at phase 4's small decoder): the
    full-width MoE decoder (`moe_config`) through
    train_and_evaluate, MOE_STEPS steps with AdamW, then with adafactor;
    each with the training kernels' counts set to 0 just before it,
    checked to launch, its losses and aux losses finite, its router and
    experts moved, its dropped share, its steady step (steps 2-4), peak
    memory and one profiled step."""
    results = {}
    for optimizer in ("adamw", "adafactor"):
        tag = f"wide_{optimizer}"
        tracer = telemetry.get_tracer()
        tracer.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        record = moe_reference(torch, training, experiment, out_dir, dev,
                               tiny, tag, optimizer=optimizer)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {fn.__name__: fn.launches for fn in counted}
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{name} never launched on the MoE "
                                     f"path ({optimizer})")
        losses = record["losses"]
        if len(losses) != MOE_STEPS or not all(
                abs(x) < 1e9 and x == x
                for x in losses + record["moe_aux_loss"]):
            raise AssertionError(f"MoE {optimizer}: losses {losses}, aux "
                                 f"{record['moe_aux_loss']}")
        kept = _MOE_MODELS.pop(tag)
        model, before = kept["model"], kept["before"]
        layer = model.layers[0].moe
        moved = {name: float((getattr(layer, name)[:, :64, :64]
                              if name != "router" else layer.router)
                             .detach().sub(value).abs().max())
                 for name, value in before.items()}
        if min(moved.values()) <= 0:
            raise AssertionError(f"MoE {optimizer}: a weight did not move: "
                                 f"{moved}")
        spans = tracer.records()
        step_s = [a.duration + b.duration for a, b in zip(
            [r for r in spans if r.name == "train/step_dispatch"],
            [r for r in spans if r.name == "train/device_wait"])]
        steady = sum(step_s[1:]) / len(step_s[1:])
        shape = (2, 128) if tiny else (TRAIN_BATCH, TRAIN_SEQ)
        tokens = torch.randint(0, model.config.vocab_size, shape, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(SEED))
        from tf_yarn_tpu_torch.models import transformer as tt

        exp = tt.make_experiment(model.config, optimizer=optimizer)
        result = dict(record, launches=launches, peak_memory_gb=peak,
                      step_s=step_s, steady_step_s=steady,
                      steady_step_spread_s=[min(step_s[1:]),
                                            max(step_s[1:])],
                      tokens_per_s=shape[0] * shape[1] / steady,
                      weights_moved_max_abs=moved,
                      params=sum(p.numel() for p in model.parameters()))
        result.pop("dir")
        result.update(profile_step(torch, training, model, exp.loss_fn,
                                   exp.optimizer(model), {"tokens": tokens},
                                   steady))
        del model, kept, layer, exp
        results[optimizer] = result
    return results


def linear_slice(torch, training, experiment, linear, dev, config=None):
    """Phase 6b: the linear classifier at BASELINE.json config 2's size
    (`LinearConfig()`: 2^20 buckets, 39 features) through
    train_and_evaluate, LINEAR_STEPS adagrad steps at batch LINEAR_BATCH:
    accuracy > 0.6 (JAX test_models.py:394) and steps/s."""
    from tf_yarn_tpu_torch import telemetry

    exp = linear.make_experiment(config or linear.LinearConfig(),
                                 train_steps=LINEAR_STEPS,
                                 batch_size=LINEAR_BATCH)
    telemetry.get_tracer().clear()
    started = time.perf_counter()
    metrics = training.train_and_evaluate(experiment.as_core_experiment(exp),
                                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    spans = telemetry.get_tracer().records()
    dispatch = [r.duration for r in spans if r.name == "train/step_dispatch"]
    if not metrics["accuracy"] > 0.6 or metrics["loss"] != metrics["loss"]:
        raise AssertionError(f"linear classifier: {metrics}")
    return {"accuracy": metrics["accuracy"], "loss": metrics["loss"],
            "steps": LINEAR_STEPS, "batch": LINEAR_BATCH, "wall_s": wall,
            "loop_steps_per_s": telemetry.get_registry().gauge(
                "train/steps_per_sec").value,
            "dispatch_s_mean": sum(dispatch) / len(dispatch)}


# Phase 6c: the LoRA fine-tune fed by text files through
# `data.text.TextDataset` at Llama-3-8B's widths, cut to TEXT_LAYERS of its
# 32 layers for the smoke's time. The corpus is TEXT_LINES lines of
# seeded pseudo-words, tokenized by a stdlib word hash.
TEXT_LAYERS = 2
TEXT_STEPS = 4
TEXT_LINES = 20_000
TEXT_WORDS = 5_000


def text_corpus(out_dir: Path, lines: int = TEXT_LINES, seed: int = SEED):
    """Write `lines` lines of 1-24 pseudo-words (from TEXT_WORDS, seeded)
    to <out_dir>/corpus.txt; returns its path."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.asarray(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.randint(2, 10)))
             for _ in range(TEXT_WORDS)]
    path = out_dir / "corpus.txt"
    with open(path, "w") as fh:
        for _ in range(lines):
            fh.write(" ".join(words[i] for i in rng.randint(
                0, TEXT_WORDS, rng.randint(1, 25))) + "\n")
    return path


def token_digest(tokens) -> str:
    """sha256 of a [B, S] token batch as int32 bytes."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(tokens, np.int32)).tobytes()).hexdigest()


def text_lora_slice(torch, tt, training, experiment, telemetry, text,
                    counted, dev, tiny: bool = False):
    """Phase 6c: `make_experiment(llama3_8b(lora_rank=16, flash, fused
    norms, unrolled))` at TEXT_LAYERS of 32 layers (widths unchanged), 1 x
    2048 tokens, TEXT_STEPS steps through `train_and_evaluate`, its
    `input_fn` a `TextDataset` over the seeded corpus; `tiny`: a small
    f32 decoder at 1 x 128 on a short corpus. The training kernels'
    counts set to 0 just before: every one launched, losses finite, the
    adapters moved, the base bit-unchanged, and the token batches the
    loss saw bitwise the same `TextDataset` iterated on the CPU (sha256
    of each). The steady step (the mean of steps 2-4) and tokens/s beside
    the dataset's own packing rate on the host."""
    import tempfile
    import zlib

    if tiny:
        cfg = tt.TransformerConfig(
            vocab_size=512, d_model=256, n_layers=TEXT_LAYERS, n_heads=4,
            n_kv_heads=2, d_ff=512, max_seq_len=128, dtype=torch.float32,
            attention_impl="flash", fused_norms=True, scan_layers=False,
            lora_rank=8)
        seq, lines = 128, 400
    else:
        cfg = dataclasses.replace(tt.TransformerConfig.llama3_8b(
            lora_rank=16, attention_impl="flash", fused_norms=True,
            scan_layers=False), n_layers=TEXT_LAYERS)
        seq, lines = TRAIN_SEQ, TEXT_LINES
    batch = TRAIN_BATCH
    with tempfile.TemporaryDirectory(prefix="text_lora") as tmp:
        started = time.perf_counter()
        corpus = str(text_corpus(Path(tmp), lines))
        corpus_s = time.perf_counter() - started

        def tokenize(line):  # a stdlib word hash
            return [zlib.crc32(word.encode()) % cfg.vocab_size
                    for word in line.split()]

        def dataset(repeat=True):
            return text.TextDataset(corpus, tokenize, batch, seq,
                                    repeat=repeat)

        # The pipeline's own rate on the host: one pass over the corpus.
        started = time.perf_counter()
        windows = sum(1 for _ in dataset(repeat=False))
        pack_s = time.perf_counter() - started
        want = [token_digest(b["tokens"]) for b, _ in zip(
            dataset(), range(TEXT_STEPS))]
        exp = tt.make_experiment(cfg, batch_size=batch, seq_len=seq,
                                 train_steps=TEXT_STEPS, log_every_steps=1,
                                 input_fn=lambda: iter(dataset()))
        built = {}
        init = exp.init_fn

        def init_fn(device, seed):
            model = init(device, seed)
            with torch.no_grad():
                built["before"] = {n: p.detach().clone()
                                   for n, p in model.named_parameters()}
            built["model"] = model
            return model

        recorded, digests = [], []
        loss_fn = exp.loss_fn

        def recording_loss(model, batch_, train=True):
            loss, aux = loss_fn(model, batch_, train=train)
            if train:
                recorded.append(loss.detach())
                digests.append(token_digest(batch_["tokens"].cpu().numpy()))
                if batch_["tokens"].dtype != torch.int64:
                    raise AssertionError(
                        f"tokens reached the loss as {batch_['tokens'].dtype}")
            return loss, aux

        exp.init_fn, exp.loss_fn = init_fn, recording_loss
        tracer = telemetry.get_tracer()
        tracer.clear()
        _zero(counted)
        started = time.perf_counter()
        training.train_and_evaluate(experiment.as_core_experiment(exp),
                                    device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - started
        launches = _launches(counted)
    if not tiny and min(launches.values()) <= 0:
        raise AssertionError(f"a training kernel never launched: {launches}")
    losses = [float(x) for x in recorded]
    if len(losses) != TEXT_STEPS or not all(abs(x) < 1e9 for x in losses):
        raise AssertionError(f"text-fed training losses {losses}")
    if digests != want:
        raise AssertionError(f"the loop's token batches {digests} differ from "
                             f"the CPU's TextDataset {want}")
    model, before = built.pop("model"), built.pop("before")
    moved = changed = 0
    for name, param in model.named_parameters():
        same = torch.equal(param.detach(), before[name])
        if "lora" in name:
            moved += not same
        elif not same:
            changed += 1
    n_lora = sum("lora" in n for n, _ in model.named_parameters())
    del before, model
    if changed or moved != n_lora:
        raise AssertionError(f"{changed} base params changed, {moved} of "
                             f"{n_lora} adapters moved")
    spans = tracer.records()
    step_s = [a.duration + b.duration for a, b in zip(
        [r for r in spans if r.name == "train/step_dispatch"],
        [r for r in spans if r.name == "train/device_wait"])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    pack_tokens_per_s = windows * seq / pack_s
    step_tokens_per_s = batch * seq / steady
    return {
        "layers": cfg.n_layers, "tokens_per_step": batch * seq,
        "corpus_lines": lines, "corpus_write_s": corpus_s,
        "corpus_windows": windows, "losses": losses, "step_s": step_s,
        "steady_step_s": steady,
        "steady_step_spread_s": [min(step_s[1:]), max(step_s[1:])],
        "step_tokens_per_s": step_tokens_per_s,
        "text_pack_s": pack_s, "text_pack_tokens_per_s": pack_tokens_per_s,
        "pipeline_over_step_rate": pack_tokens_per_s / step_tokens_per_s,
        "batches_bitwise_cpu_text_dataset": True, "token_sha256": digests,
        "wall_s": wall, "launches": launches, "adapters_moved": moved,
        "base_params_changed": changed,
    }


# Phase 9 (l): two pytorch workers read a seeded Parquet file through
# `TorchParquetDataset`, each with PARQUET_LOADER_WORKERS DataLoader
# workers: 4 effective shards.
PARQUET_ROWS = 4096
PARQUET_BATCH = 64
PARQUET_GROUP = 500
PARQUET_LOADER_WORKERS = 2


def parquet_file(out_dir: Path, rows: int = PARQUET_ROWS) -> str:
    """A seeded Parquet file of `rows` rows: an int64 ``id`` (the row's
    index), f32 ``x0``-``x3`` and an int32 label ``y``, in row groups of
    PARQUET_GROUP."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.RandomState(SEED)
    columns = {"id": np.arange(rows, dtype=np.int64)}
    for i in range(4):
        columns[f"x{i}"] = rng.randn(rows).astype(np.float32)
    columns["y"] = rng.randint(0, 2, rows).astype(np.int32)
    path = str(out_dir / "rows.parquet")
    pq.write_table(pa.table(columns), path, row_group_size=PARQUET_GROUP)
    return path


def parquet_experiment(data_path: str, out_dir: str):
    """Phase 9 (l)'s experiment fn, called in each launched pytorch
    worker: a `TorchParquetDataset` over `data_path`, read through the
    worker's DataLoader (PARQUET_LOADER_WORKERS workers); the `main_fn`
    writes each batch's ids and feature sums, in the loader's order, its
    rows/s, device and backend to parquet-<rank>.json."""
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch import pytorch
    from tf_yarn_tpu_torch._device import task_device
    from tf_yarn_tpu_torch.data.parquet import ParquetDataset
    from tf_yarn_tpu_torch.data.torch_adapter import TorchParquetDataset

    dataset = TorchParquetDataset(ParquetDataset(data_path, PARQUET_BATCH))

    def main_fn(model, loader, device, rank, tb_writer):
        started = time.perf_counter()
        batches = []
        for batch in loader:
            x = torch.stack([batch[f"x{i}"] for i in range(4)], -1).to(device)
            batches.append({"id": batch["id"].tolist(),
                            "x_sum": float(x.double().sum()),
                            "y": batch["y"].tolist()})
        seconds = time.perf_counter() - started
        rows = sum(len(b["id"]) for b in batches)
        Path(out_dir, f"parquet-{rank}.json").write_text(json.dumps({
            "rank": rank, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "device": str(device),
            "batches": batches, "rows": rows, "seconds": seconds,
            "rows_per_s": rows / seconds}))

    return pytorch.PytorchExperiment(
        model=torch.nn.Linear(4, 1, device=task_device()), main_fn=main_fn,
        train_dataset=dataset,
        dataloader_args=pytorch.DataLoaderArgs(
            num_workers=PARQUET_LOADER_WORKERS),
        # Both ranks share the one card: NCCL refuses that.
        backend="gloo")


def parquet_part(client, topologies, tmp, base_env, env, tiny=False):
    """Phase 9 (l): `pytorch.run_on_gpu` of two pytorch workers running
    `parquet_experiment` over a seeded PARQUET_ROWS-row file: each row
    read exactly once across ranks x loader workers, the ranks' batch
    counts equal, and each loader worker's batches (the loader takes them
    from its workers in turn) bitwise the port's `ParquetDataset` on the
    CPU at that effective shard; the rows/s each worker's loop read."""
    import numpy as np

    from tf_yarn_tpu_torch import pytorch
    from tf_yarn_tpu_torch.data.parquet import ParquetDataset

    out = tmp / "parquet"
    out.mkdir()
    data_path = parquet_file(out)
    started = time.perf_counter()
    pytorch.run_on_gpu(
        client.get_safe_experiment_fn("chip_smoke.parquet_experiment",
                                      data_path, str(out)),
        {"worker": topologies.TaskSpec(instances=LAUNCHER_RANKS,
                                       chips_per_host=1,
                                       label=topologies.NodeLabel.GPU)},
        name="parquet", env=dict(base_env, **(env or {})),
        poll_every_secs=0.5, dead_task_secs=120)
    wall = time.perf_counter() - started
    ranks = [json.loads((out / f"parquet-{r}.json").read_text())
             for r in range(LAUNCHER_RANKS)]
    world = LAUNCHER_RANKS * PARQUET_LOADER_WORKERS
    want_device = "cpu" if tiny else "cuda"
    seen = []
    for rank in ranks:
        shards = [list(ParquetDataset(data_path, PARQUET_BATCH,
                                      rank=rank["rank"] * PARQUET_LOADER_WORKERS
                                      + worker, world_size=world))
                  for worker in range(PARQUET_LOADER_WORKERS)]
        expected = [b for group in zip(*shards) for b in group]
        got = rank["batches"]
        bad = (len(got) != len(expected) or rank["world"] != LAUNCHER_RANKS
               or rank["backend"] != "gloo"
               or not rank["device"].startswith(want_device))
        for have, want in zip(got, expected):
            x = np.stack([want[f"x{i}"] for i in range(4)], -1)
            bad |= (have["id"] != want["id"].tolist()
                    or have["y"] != want["y"].tolist()
                    or have["x_sum"] != float(x.astype(np.float64).sum()))
        if bad:
            raise AssertionError(
                f"parquet rank {rank['rank']}: {len(got)} batches against "
                f"{len(expected)} of the CPU's shards\n"
                f"{task_log_tails(runs=1, name='parquet')}")
        seen.extend(i for b in got for i in b["id"])
    per_rank = (PARQUET_ROWS // world) // PARQUET_BATCH * PARQUET_BATCH \
        * PARQUET_LOADER_WORKERS
    if (sorted(seen) != sorted(set(seen))
            or len({len(r["batches"]) for r in ranks}) != 1
            or len(seen) != per_rank * LAUNCHER_RANKS):
        raise AssertionError(f"parquet rows: {len(seen)} seen, "
                             f"{len(set(seen))} distinct, batch counts "
                             f"{[len(r['batches']) for r in ranks]}")
    return {"rows": PARQUET_ROWS, "batch": PARQUET_BATCH,
            "loader_workers": PARQUET_LOADER_WORKERS,
            "rows_read": len(seen), "each_row_once": True,
            "batches_per_rank": len(ranks[0]["batches"]),
            "bitwise_cpu_shards": True,
            "rows_per_s": [r["rows_per_s"] for r in ranks],
            "loop_s": [r["seconds"] for r in ranks],
            "devices": [r["device"] for r in ranks], "wall_s": wall}


# Phase 9 (m): the environment check, and (n): the generate example, each
# run as a user runs it, in a subprocess from the checkout's root.
CHECK_LINE = re.compile(r"^\s+(check_\w+): ([\d.]+) s$")
LAUNCH_LINE = "kernel launches: "
# Runs an example as `python examples_torch/<name>.py`, then prints every
# kernel wrapper's launch count.
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "from tf_yarn_tpu_torch.ops import decode_attention, flash_attention, "
    "groupnorm, layernorm, quantize, rmsnorm\n"
    "sys.argv = [sys.argv[1]]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "counts = {fn.__name__: fn.launches for module in (decode_attention, "
    "flash_attention, groupnorm, layernorm, quantize, rmsnorm) "
    "for fn in vars(module).values() "
    "if isinstance(getattr(fn, 'launches', None), int)}\n"
    f"print({LAUNCH_LINE!r} + json.dumps(counts))\n")


def _subprocess_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_YARN_PLATFORM", "EXAMPLE_PLATFORM")}
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


def check_env_part(tiny: bool = False):
    """Phase 9 (m): ``python -m tf_yarn_tpu_torch.bin.check_gpu_env`` (with
    ``TPU_YARN_PLATFORM=cpu`` when `tiny`): exit 0, an OK line for each of
    its five checks and no FAIL, the device check's RMSNorm kernel
    launched once; each check's seconds."""
    started = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "tf_yarn_tpu_torch.bin.check_gpu_env"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=_subprocess_env(**({"TPU_YARN_PLATFORM": "cpu"} if tiny else {})))
    wall = time.perf_counter() - started
    lines = run.stdout.splitlines()
    oks = [line for line in lines if line.startswith("OK ")]
    seconds = {m.group(1): float(m.group(2))
               for m in map(CHECK_LINE.match, lines) if m}
    launched = "rmsnorm kernel launched 1x" in run.stdout
    if (run.returncode != 0 or len(oks) != 5 or "FAIL" in run.stdout
            or len(seconds) != 5 or not (tiny or launched)):
        raise AssertionError(f"check_gpu_env exited {run.returncode}:\n"
                             f"{run.stdout}\n{run.stderr[-3000:]}")
    return {"exit": run.returncode, "ok_lines": oks, "check_s": seconds,
            "launches": {"rmsnorm": 1} if launched else {}, "wall_s": wall}


def generate_example_part(tiny: bool = False):
    """Phase 9 (n): examples_torch/generate_example.py on the card and
    with ``EXAMPLE_PLATFORM=cpu``, at once, each in a temporary directory
    of its own: both exit 0 with equal greedy continuations; the kernels
    the card's run launched (its TransformerConfig.tiny selects none in
    JAX's example, so no count is required)."""
    import tempfile

    def run(platform):
        with tempfile.TemporaryDirectory(prefix="gen_example") as tmp:
            extra = {"TMPDIR": tmp}
            if platform:
                # Two threads: the host's cores are shared with phase 9's
                # launched workers, and more threads than cores make the
                # tiny model's CPU steps many times slower.
                extra.update(EXAMPLE_PLATFORM=platform, OMP_NUM_THREADS="2")
            started = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-c", EXAMPLE_RUNNER,
                 str(REPO / "examples_torch" / "generate_example.py")],
                cwd=REPO, capture_output=True, text=True, timeout=600,
                env=_subprocess_env(**extra))
            wall = time.perf_counter() - started
        lines = done.stdout.splitlines()
        found = [line.split(": ", 1)[1] for line in lines
                 if line.startswith("greedy continuation of [1,2,3,4]: ")]
        counts = [json.loads(line[len(LAUNCH_LINE):]) for line in lines
                  if line.startswith(LAUNCH_LINE)]
        if done.returncode != 0 or len(found) != 1 or len(counts) != 1:
            raise AssertionError(
                f"generate_example ({platform or 'card'}) exited "
                f"{done.returncode}:\n{done.stdout[-3000:]}\n"
                f"{done.stderr[-3000:]}")
        return {"continuation": json.loads(found[0]), "launches": counts[0],
                "wall_s": wall}

    runs = concurrently({"card": lambda: run("cpu" if tiny else None),
                         "cpu": lambda: run("cpu")})
    card, cpu = runs["card"][0], runs["cpu"][0]
    if card["continuation"] != cpu["continuation"]:
        raise AssertionError(f"generate_example: the card's continuation "
                             f"{card['continuation']}, the CPU's "
                             f"{cpu['continuation']}")
    return {"continuation": card["continuation"], "equal_to_cpu": True,
            "launched": {k: v for k, v in card["launches"].items() if v},
            "card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"]}


def front_door_parts(client, topologies, tmp, env=None, tiny=False):
    """Phase 9 (l), (m) and (n) at once, beside (a)-(f): {part: (result,
    seconds)}."""
    return concurrently({
        "l_parquet": lambda: parquet_part(client, topologies, tmp,
                                          {"PYTHONPATH": str(REPO)}, env,
                                          tiny),
        "m_check_env": lambda: check_env_part(tiny),
        "n_generate": lambda: generate_example_part(tiny),
    })


def main() -> int:
    smoke_started = time.perf_counter()
    marks = [("start", smoke_started)]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "tf_yarn_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # The kernels build, and phase 4's tiny tp ranks start, while the rest
    # of the port imports; the ranks wait for phase 4 to train.
    from tf_yarn_tpu_torch.ops import _build

    build_wait = concurrently_started({"build": _build.load_library})
    tp_tiny_dir = Path(tempfile.mkdtemp(prefix="tp_tiny"))
    tp_tiny_go = tp_ranks_start(torch, str(tp_tiny_dir), "cuda")
    from tf_yarn_tpu_torch import checkpoint as ckpt
    from tf_yarn_tpu_torch import experiment, inference, telemetry, training
    from tf_yarn_tpu_torch.models import common
    from tf_yarn_tpu_torch.models import decode_engine as engine_mod
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.models import bert, resnet, vit
    from tf_yarn_tpu_torch.ops import (decode_attention, flash_attention,
                                       groupnorm, layernorm, quantize,
                                       rmsnorm)
    from tf_yarn_tpu_torch.utils import flops as flops_lib
    from tf_yarn_tpu_torch.serving import scheduler as sched_mod
    from tf_yarn_tpu_torch.serving import server as server_mod
    from tf_yarn_tpu_torch import ranking
    from tf_yarn_tpu_torch.models import dlrm, linear, rank_engine, weights
    from tf_yarn_tpu_torch import backends, client, fs, topologies
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
    from tf_yarn_tpu_torch.serving import tp_replica
    from tf_yarn_tpu_torch.data import text as text_data

    # Phase 4's tiny tp=2 serving replica starts beside the build and
    # phase 3, which use no process group; it is closed in phase 4 before
    # the training references: its leader is this process, and
    # train_and_evaluate trains over the default process group.
    tp_serve_wait = concurrently_started({"replica": lambda: tiny_tp_replica(
        torch, tt, engine_mod, tp_replica, mesh_lib)})

    class ops:  # one namespace for the kernel modules
        pass

    ops.rmsnorm, ops.quantize, ops.decode_attention = (
        rmsnorm, quantize, decode_attention)
    ops.flash_attention = flash_attention
    ops.layernorm, ops.groupnorm = layernorm, groupnorm

    class zoo:  # the model zoo's modules
        pass

    zoo.bert, zoo.vit, zoo.resnet = bert, vit, resnet

    class ranker:  # the ranker's modules
        pass

    ranker.dlrm, ranker.weights, ranker.engine = dlrm, weights, rank_engine
    ranker.MicroBatchScheduler = ranking.MicroBatchScheduler
    ranker.RankServer = ranking.RankServer
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
    build_s = build_wait()["build"][1]
    log(f"build: {build_s:.1f} s, {time.perf_counter() - started:.1f} s of "
        f"it after the imports (nvcc "
        f"{_build.build_seconds and round(_build.build_seconds, 1)} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    mark("1-2 environment and build")
    paged_row = check_attention(torch, ops, dev)
    rows = [check_rmsnorm(torch, ops, dev), check_quantize(torch, ops, dev),
            paged_row,
            check_dense_attention(torch, ops, dev,
                                  paged_row["shape"]["lengths"]),
            check_rmsnorm_dx(torch, ops, dev), *check_flash(torch, ops, dev),
            *check_layernorm(torch, ops, dev), *check_groupnorm(torch, ops, dev)]
    for row in rows:
        library = row["library_ms"]
        log(f"kernel {row['name']}: max_abs_err {row['max_abs_err']:.3g}, "
            f"{row['ms'] * 1e3:.2f} us cold, {row['warm_ms'] * 1e3:.2f} us warm "
            f"(plain {row['plain_ms'] * 1e3:.2f} us, library "
            f"{'none' if library is None else f'{library * 1e3:.2f} us'}, "
            f"bound {row['bound_ms'] * 1e3:.2f} us by {row['bound_by']})"
            + (f" {row['kernel_us_per_call']}" if "kernel_us_per_call" in row
               else "")
            + (f"; serving shape {json.dumps(row['shape_serving'])}"
               if "shape_serving" in row else "")
            + (f"; chunk shape {json.dumps(row['shape_chunk'])}"
               if "shape_chunk" in row else "")
            + (f"; tp rank shape {json.dumps(row['shape_tp_rank'])}"
               if "shape_tp_rank" in row else "")
            + (f"; per-block scales {json.dumps(row['per_block'])}"
               if "per_block" in row else ""))
    gc.collect()
    torch.cuda.empty_cache()
    mark("3 kernels")

    # Phase 4's tiny tp=2 ranks, started with the smoke, train now beside
    # the references below and are checked at the phase's end.
    tp_tiny = concurrently_started({"ranks": tp_tiny_go})
    reference = serve_tiny_reference(torch, tt, engine_mod, sched_mod,
                                     server_mod, dev)
    log(f"serving reference: card vs CPU prefill logits max err "
        f"{reference['prefill_logits_max_abs_err']:.3g}; greedy outputs "
        f"equal on the fused, dense and gather grids (spec_k 0 and 2), the "
        f"chunked fused grid, generate, the fused swap grid (equal to its "
        f"requests served alone) and the warm start (the importer's stream "
        f"equal to the donor's): {json.dumps(reference)}")
    (tp_serve_replica, tp_serve_logits), tp_serve_start = \
        tp_serve_wait()["replica"]
    tp_serve_tiny = tiny_tp_check(torch, sched_mod, tp_serve_replica,
                                  tp_serve_logits, reference["streams"],
                                  tp_serve_start)
    del tp_serve_replica
    log(f"tp serving reference: the small f32 model at tp=2, two gloo ranks "
        f"on the card, against one device on the CPU: "
        f"{json.dumps(tp_serve_tiny)}")
    infer_reference = inference_reference(torch, tt, engine_mod, training,
                                          experiment, ckpt, inference, dev)
    log(f"inference reference: run_inference records equal generate: "
        f"{json.dumps(infer_reference)}")
    train_reference = train_tiny_reference(torch, tt, common, training,
                                           experiment, ckpt, dev)
    log(f"training reference: {json.dumps(train_reference)}")
    started = time.perf_counter()
    moe_tiny = moe_tiny_reference(torch, tt, common, training, dev)
    log(f"MoE and linear references ({time.perf_counter() - started:.1f} "
        f"s): the small f32 MoE decoder (4 experts, capacity factor 1.0) "
        f"3 steps with AdamW and with adafactor, and the linear classifier "
        f"3 adagrad steps, on the card against the CPU: "
        f"{json.dumps(moe_tiny)}")
    zoo_reference = train_zoo_reference(torch, zoo, training, experiment,
                                        ckpt, dev)
    log(f"zoo training reference: {json.dumps(zoo_reference)}")
    started = time.perf_counter()
    rank_reference = rank_tiny_reference(torch, ranker, training, experiment,
                                         dev)
    log(f"ranker reference ({time.perf_counter() - started:.1f} s): "
        f"{json.dumps(rank_reference)}")
    started = time.perf_counter()
    tp_tiny_one = tp_reference(torch, training, experiment,
                               tp_tiny_dir / "one", dev, tiny=True)
    pp_tiny_one = tp_reference(torch, training, experiment,
                               tp_tiny_dir / "one_pp", dev, tiny=True,
                               tag="pp", impl="xla", gpipe=2)
    moe_ep_one = moe_reference(torch, training, experiment,
                               tp_tiny_dir / "one_moe", dev, tiny=True,
                               tag="moe_ep", optimizer="adamw",
                               steps=TP_STEPS)
    _MOE_MODELS.clear()
    ranks_wall = tp_tiny()["ranks"][0]
    tp_tiny_result = tp_tiny_check(torch, tp_tiny_dir, tp_tiny_one,
                                   ranks_wall)
    sp_pp_tiny = {run["tag"]: parallel_check(
        torch, tt, ckpt, tp_tiny_dir, run["tag"],
        pp_tiny_one if "gpipe" in run else tp_tiny_one, tiny=True,
        impl=run["impl"], pipelined=run.get("gpipe", 0))
        for run in TINY_RUNS[1:] if not run.get("moe")}
    moe_ep_tiny = moe_ep_check(torch, tp_tiny_dir, "moe_ep", moe_ep_one,
                               True, ranks_wall)
    _TP_MODELS.clear()
    shutil.rmtree(tp_tiny_dir, ignore_errors=True)
    log(f"tp reference ({time.perf_counter() - started:.1f} s after the "
        f"others): tiny f32 LoRA decoder at tp=2 on the card against one "
        f"rank: {json.dumps(tp_tiny_result)}")
    log("sp and pp references: the same decoder at sp=2 (ring; Ulysses "
        "with flash) against the one rank, and at pp=2 (GPipe, 2 "
        "microbatches, xla) against one rank of the same config: "
        + json.dumps(sp_pp_tiny))
    log(f"ep reference: the small f32 MoE decoder at ep={MOE_EP}, two gloo "
        f"ranks on the card, against one rank: {json.dumps(moe_ep_tiny)}")
    mark("4 references")

    serving_counted = (rmsnorm.rmsnorm, quantize.quantize_int8,
                       decode_attention.paged_int8_window_attention,
                       decode_attention.int8_decode_attention)
    slice_result, serve_seconds = serve_slice(
        torch, tt, engine_mod, sched_mod, server_mod, telemetry,
        serving_counted, dev)
    # Phase 10's tp replica serves (b)'s prompts: its prompts, streams,
    # launches, engine calls and peak memory.
    gather_burst = slice_result["gather_burst"]
    tp_serving_reference = {
        "prompts": gather_burst["prompts"], "streams": gather_burst["streams"],
        "launches": gather_burst["launches"],
        "engine_calls": gather_burst["engine_calls"],
        "peak_memory_gb": gather_burst["peak_memory_gb"]}
    for result in slice_result.values():
        result.pop("prompts", None)
        result.pop("streams", None)
    for path, result in slice_result.items():
        log(f"serving slice, {path}: {json.dumps(result)} on {card}")
    log("serving phase parts: " + json.dumps(
        {part: round(t, 1) for part, t in serve_seconds.items()}))
    gc.collect()
    torch.cuda.empty_cache()
    mark("5 serving slice")

    training_counted = (rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd_dx,
                        flash_attention.flash_fwd, flash_attention.flash_dq,
                        flash_attention.flash_dkv)
    torch.cuda.reset_peak_memory_stats()
    train_result = train_slice(torch, tt, training, experiment, telemetry,
                               training_counted, dev)
    log(f"training slice: {json.dumps(train_result)} on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    mark("6 training slice")

    # Phase 6b: the MoE decoder at Llama-3-8B widths (one layer, 8
    # experts) with AdamW and with adafactor, the linear classifier at
    # BASELINE.json config 2's size, then the MoE decoder at ep=2 (two
    # ranks spawned now, which wait until the one-device runs end).
    started = time.perf_counter()
    moe_dir = Path(tempfile.mkdtemp(prefix="moe"))
    moe_go = parallel_ranks_start(
        torch, str(moe_dir), "cuda", (dict(
            tag="wide_ep", moe=True, ep=MOE_EP, optimizer="adafactor",
            steps=MOE_EP_STEPS),), tiny=False, go=True)
    try:
        moe_result = moe_slice(torch, training, experiment, telemetry,
                               training_counted, dev, moe_dir)
        moe_one_s = time.perf_counter() - started
        for name, result in moe_result.items():
            log(f"MoE slice, {name}: {json.dumps(result)} on {card}")
        linear_result = linear_slice(torch, training, experiment, linear, dev)
        log(f"linear slice: {json.dumps(linear_result)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()
        ep_started = time.perf_counter()
        moe_ep_wide = moe_ep_check(torch, moe_dir, "wide_ep",
                                   moe_result["adafactor"], False, moe_go())
        moe_ep_s = time.perf_counter() - ep_started
    finally:
        shutil.rmtree(moe_dir, ignore_errors=True)
    log(f"MoE ep slice: Llama-3-8B widths, 1 layer, {MOE_EXPERTS} experts, "
        f"adafactor at ep={MOE_EP} over two gloo ranks on the card, against "
        f"the one-device adafactor run: {json.dumps(moe_ep_wide)} on {card}")
    log(f"MoE phase: {time.perf_counter() - started:.1f} s (one-device runs "
        f"{moe_one_s:.1f} s, linear {linear_result['wall_s']:.1f} s, ep "
        f"{moe_ep_s:.1f} s after the go)")
    gc.collect()
    torch.cuda.empty_cache()
    mark("6b MoE and linear slice")

    # Phase 6c: the LoRA fine-tune at Llama-3-8B widths (TEXT_LAYERS of 32
    # layers) fed by TextDataset over a seeded corpus.
    text_result = text_lora_slice(torch, tt, training, experiment, telemetry,
                                  text_data, training_counted, dev)
    log(f"text slice: Llama-3-8B widths, {TEXT_LAYERS} of 32 layers, fed by "
        f"TextDataset: {json.dumps(text_result)} on {card}")
    log(f"text slice: steady step {text_result['steady_step_s']:.4f} s "
        f"({text_result['step_tokens_per_s']:.0f} tokens/s); TextDataset "
        f"packs {text_result['text_pack_tokens_per_s']:.0f} tokens/s on the "
        f"host, {text_result['pipeline_over_step_rate']:.1f}x the step's")
    gc.collect()
    torch.cuda.empty_cache()
    mark("6c text-fed LoRA slice")

    norm_counted = (layernorm.layernorm, layernorm.layernorm_backward,
                    groupnorm.groupnorm, groupnorm.groupnorm_backward)
    zoo_results = {}
    for name, (module, cfg, kwargs) in _zoo_cases(zoo, torch, False).items():
        needed = norm_counted[2:] if module is resnet else norm_counted[:2]
        zoo_results[name] = zoo_slice(
            torch, module, cfg, kwargs, training, experiment, telemetry,
            flops_lib, norm_counted, needed, dev,
            node="_GroupNormBackward" if module is resnet
            else "_LayerNormBackward")
        log(f"zoo slice, {name}: {json.dumps(zoo_results[name])} on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    mark("7 zoo slice")

    started = time.perf_counter()
    # The tp=2 ranker's follower starts beside the one-device ranker; its
    # group is closed before the ranker trains (train_and_evaluate would
    # train over it).
    rank_counted = serving_counted + training_counted + norm_counted
    rank_tp_wait = concurrently_started({"replica": lambda: rank_tp_replica(
        ranker, tp_replica, mesh_lib, dlrm.DLRMConfig.criteo())})
    try:
        rank_result = rank_slice(torch, ranker, telemetry, rank_counted, dev)
        log(f"ranker slice: {json.dumps(rank_result)} on {card}")
        rank_tp, rank_tp_start_s = rank_tp_wait()["replica"]
        rank_tp_result = rank_tp_slice(torch, ranker, telemetry, rank_counted,
                                       dev, rank_tp, rank_result)
    finally:
        try:
            rank_tp_wait()
        finally:
            tp_replica.close_all()
    if [p.exitcode for p in rank_tp.processes] != [0]:
        raise AssertionError(f"the tp ranker's follower exited with "
                             f"{[p.exitcode for p in rank_tp.processes]}")
    rank_tp_result["start_s"] = rank_tp_start_s
    log(f"ranker tp slice: criteo at tp=2, two gloo ranks on the card, "
        f"against the one-device ranker: {json.dumps(rank_tp_result)} on "
        f"{card}")
    del rank_tp
    rank_train = rank_train_slice(torch, ranker, training, experiment,
                                  telemetry, dev)
    log(f"ranker training slice: {json.dumps(rank_train)} on {card}")
    log(f"ranker phase: {time.perf_counter() - started:.1f} s")
    # The launched worker needs the card's memory: drop what this process
    # holds before it starts.
    del rank_result, rank_tp_result, rank_train
    gc.collect()
    torch.cuda.empty_cache()
    mark("8 ranker slice")

    # Phase 9 (h) and (i): sequence and pipeline parallelism at Llama-3-8B
    # widths, their ranks spawned from here, train beside (a)-(f), whose
    # launched workers leave the card mostly idle.
    # Phase 9 (k)'s placement check sets the environment for a moment:
    # before any part of the phase starts.
    remote_refusal = remote_preflight()
    sp_pp_tmp = Path(tempfile.mkdtemp(prefix="sp_pp"))
    sp_pp_wait = concurrently_started({"h_i": lambda: sequence_pipeline_part(
        torch, tt, ckpt, training, experiment, dev, sp_pp_tmp)})
    bert_launches = zoo_results["bert_base"]["launches"]
    # Phase 9 (j), the elastic shrink, launches and is checked beside
    # (a)-(f) too: its driver waits on its workers, as theirs do.
    elastic_wait = concurrently_started({"j": lambda: elastic_part(
        torch, client, topologies, training, experiment, norm_counted[:2],
        {name: bert_launches[name]
         for name in ("layernorm", "layernorm_backward")}, dev)})
    # Phase 9 (k), remote hosts and a remote model_dir, beside them too.
    remote_wait = concurrently_started({"k": lambda: remote_part(
        torch, client, topologies, backends, fs, ckpt, remote_refusal)})
    # Phase 9 (l), (m) and (n), the host-bound front door, beside them too.
    front_tmp = Path(tempfile.mkdtemp(prefix="front"))
    front_wait = concurrently_started({"l_n": lambda: front_door_parts(
        client, topologies, front_tmp)})
    started = time.perf_counter()
    launcher_result = launcher_slice(
        torch, client, topologies, zoo_results["bert_base"]["losses"],
        {name: bert_launches[name]
         for name in ("layernorm", "layernorm_backward")})
    log(f"launcher slice: {json.dumps(launcher_result)} on {card}")
    log(f"launcher phase: {time.perf_counter() - started:.1f} s; its parts: "
        + json.dumps({part: round(t, 1) for part, t
                      in launcher_result["seconds"].items()}))
    gc.collect()
    torch.cuda.empty_cache()
    mark("9 launcher slice (a)-(f)")
    try:
        elastic_result, elastic_s = elastic_wait()["j"]
    finally:
        try:
            sp_pp_result = sp_pp_wait()["h_i"][0]
        finally:
            try:
                remote_result, remote_s = remote_wait()["k"]
            finally:
                try:
                    front_result, front_s = front_wait()["l_n"]
                finally:
                    shutil.rmtree(sp_pp_tmp, ignore_errors=True)
                    shutil.rmtree(front_tmp, ignore_errors=True)
    front = {part: result for part, (result, _) in front_result.items()}
    log(f"parquet part (phase 9 (l)): {json.dumps(front['l_parquet'])} on "
        f"{card}")
    log(f"check_gpu_env part (phase 9 (m)): {json.dumps(front['m_check_env'])}"
        f" on {card}")
    log(f"generate example part (phase 9 (n)): "
        f"{json.dumps(front['n_generate'])} on {card}")
    log(f"front-door parts: {front_s:.1f} s beside (a)-(f); " + json.dumps(
        {part: round(t, 1) for part, (_, t) in front_result.items()}))
    remote_result.update(remote_check(remote_result,
                                      launcher_result["e_ranks"]["ranks"]))
    log(f"remote slice (phase 9 (k)): {json.dumps(remote_result)} on {card}")
    log(f"remote part: {remote_s:.1f} s beside (a)-(f); the wall to return "
        f"{remote_result['wall_s']:.1f} s, each worker's launch to its first "
        "step " + ", ".join(f"{t:.1f}" for t in
                            remote_result["launch_to_first_step_s"])
        + " s (its experiment call to its first step "
        + ", ".join(f"{t:.1f}" for t in remote_result["call_to_first_step_s"])
        + " s), each worker's kernel build "
        + ", ".join(f"{r['build_seconds']:.1f}" for r in remote_result["ranks"])
        + " s, checkpoint/seconds{op=staged_write} "
        + ", ".join(f"{t:.2f}" for t in remote_result["staged_write_s"])
        + " s for " + ", ".join(str(n) for n in
                                remote_result["staged_write_bytes"])
        + f" bytes uploaded, on {card}")
    log(f"elastic slice (phase 9 (j)): {json.dumps(elastic_result)} on "
        f"{card}")
    log(f"elastic part: {elastic_s:.1f} s beside (a)-(f); the kill to "
        f"LOST_TASK {elastic_result['kill_to_lost_task_s']:.1f} s, the "
        f"relaunch to its first step "
        f"{elastic_result['relaunch_to_first_step_s']:.1f} s")
    for tag in ("h_ulysses_flash", "h_ring", "i_gpipe"):
        log(f"{'sp' if tag.startswith('h') else 'pp'} slice (phase 9 "
            f"({tag[0]}), {tag[2:]}): {json.dumps(sp_pp_result[tag])} on "
            f"{card}")
    log("sp/pp part: " + json.dumps({k: round(v, 1) for k, v in
                                     sp_pp_result.items()
                                     if k.endswith("_s")}))
    gc.collect()
    torch.cuda.empty_cache()
    mark("9 (h), (i), (j), (k), (l), (m), (n) beside (a)-(f)")

    # Phase 9 (g) beside phase 10 (a): the tp ranks are launched now, the
    # one-rank reference trains in this process while they start, and the
    # ranks train and are checked while (a) serves and writes its
    # checkpoint here; the fleet launches once (g) has ended.
    started = time.perf_counter()
    tp_tmp = Path(tempfile.mkdtemp(prefix="tp_g"))
    reference_done = threading.Event()
    tp_one = {}

    def tp_part():
        run = tp_launch(client, topologies, tp_tmp,
                        {"PYTHONPATH": str(REPO)}, None, False)
        reference_done.wait()
        if not tp_one:
            raise AssertionError("(g)'s one-rank reference failed")
        return tp_check(torch, tt, ckpt, tp_tmp, tp_one, False, run)

    tp_wait = concurrently_started({"g_tp": tp_part})
    try:
        tp_one.update(tp_reference(torch, training, experiment,
                                   tp_tmp / "one", dev, tiny=False))
    finally:
        reference_done.set()
    log(f"tp one-rank reference: {json.dumps(tp_one)}")
    tp_result = {}

    def end_tp():
        tp_result.update(tp_wait()["g_tp"][0])
        _TP_MODELS.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"tp slice (phase 9 (g)): {json.dumps(tp_result)} on {card}")
        log(f"tp part: {time.perf_counter() - started:.1f} s after its "
            f"launch, the ranks' run {tp_result['wall_s']:.1f} s")

    tp_serve_dir = Path(tempfile.mkdtemp(prefix="tp_serve"))

    def tp_serving_beside(model_dir):
        """Phase 10's tp replica, launched beside the fleet."""
        port = free_port()
        wait = concurrently_started({"tp": lambda: tp_serving_part(
            torch, tt, engine_mod, sched_mod, server_mod, client,
            topologies, dev, model_dir, tp_serve_dir, port,
            tp_serving_reference)})
        return (lambda: wait()["tp"][0]), port

    try:
        fleet_result = fleet_slice(torch, tt, engine_mod, sched_mod,
                                   server_mod, ckpt, client, topologies,
                                   dlrm, dev, before_launch=end_tp,
                                   beside=tp_serving_beside)
    finally:
        if not tp_result:  # (a) failed: (g) still ends before the exit
            tp_wait()
        shutil.rmtree(tp_tmp, ignore_errors=True)
        shutil.rmtree(tp_serve_dir, ignore_errors=True)
    tp_serving = fleet_result.pop("tp_serving")
    log(f"tp serving slice (phase 10, beside the fleet): Llama-3-8B widths, "
        f"{SERVE_LAYERS} layers, tp=2 over two gloo ranks on the card, "
        f"launched: {json.dumps(tp_serving)} on {card}")
    log(f"fleet slice: {json.dumps(fleet_result)} on {card}")
    log(f"fleet phase: {time.perf_counter() - started:.1f} s with 9 (g) "
        "beside its (a); its parts: "
        + json.dumps({part: round(t, 1)
                      for part, t in fleet_result["seconds"].items()}))
    mark("10 fleet slice and its tp replica, and 9 (g) beside its (a)")
    launched = fleet_result["b_launched"]
    fleet_launches = {
        "launched serving": launched["decode_task"]["launches"],
        "launched serving:1": launched["serving_1_task"]["launches"],
        "launched prefill": launched["prefill_task"]["launches"]}

    # Each kernel's launches on every main path it runs in; `launches` is
    # the count of the path named in `launches_path`.
    primary = {"paged_int8_window_attention": "serving fused_burst",
               "int8_decode_attention": "serving gather_burst",
               "layernorm": "zoo bert_base",
               "layernorm_backward": "zoo bert_base",
               "groupnorm": "zoo resnet50",
               "groupnorm_backward": "zoo resnet50"}
    for row in rows:
        by_path = {f"serving {path}": result["launches"][row["name"]]
                   for path, result in slice_result.items()
                   if result["launches"].get(row["name"])}
        if row["name"] in train_result["launches"]:
            by_path["training"] = train_result["launches"][row["name"]]
        if row["name"] in text_result["launches"]:
            by_path["text lora"] = text_result["launches"][row["name"]]
        if row["name"] in front["m_check_env"]["launches"]:
            by_path["check_gpu_env"] = \
                front["m_check_env"]["launches"][row["name"]]
        if front["n_generate"]["launched"].get(row["name"]):
            by_path["generate example"] = \
                front["n_generate"]["launched"][row["name"]]
        for name, result in moe_result.items():
            if row["name"] in result["launches"]:
                by_path[f"moe {name}"] = result["launches"][row["name"]]
        for rank, launched in enumerate(moe_ep_wide["launches"]):
            if row["name"] in launched:
                by_path[f"moe ep rank {rank}"] = launched[row["name"]]
        by_path.update({f"zoo {path}": result["launches"][row["name"]]
                        for path, result in zoo_results.items()
                        if result["launches"].get(row["name"])})
        launched = launcher_result["a_train"]["launches"]
        if row["name"] in launched:
            by_path["launcher bert_base"] = launched[row["name"]]
        launched = launcher_result["a_train"]["evaluator"]["launches"]
        if launched.get(row["name"]):
            by_path["launcher evaluator"] = launched[row["name"]]
        for rank in launcher_result["e_ranks"]["ranks"]:
            if row["name"] in rank["launches"]:
                by_path[f"launcher rank {rank['rank']}"] = \
                    rank["launches"][row["name"]]
        for worker in launcher_result["f_pytorch"]["workers"]:
            if row["name"] in worker["launches"]:
                by_path[f"pytorch worker {worker['rank']}"] = \
                    worker["launches"][row["name"]]
        for rank in elastic_result["attempt_0"]:
            if row["name"] in rank["launches"]:
                by_path[f"elastic attempt 0 rank {rank['rank']}"] = \
                    rank["launches"][row["name"]]
        if row["name"] in elastic_result["attempt_1"]["launches"]:
            by_path["elastic attempt 1"] = \
                elastic_result["attempt_1"]["launches"][row["name"]]
        for rank in remote_result["ranks"]:
            if row["name"] in rank["launches"]:
                by_path[f"remote rank {rank['rank']}"] = \
                    rank["launches"][row["name"]]
        for rank in tp_result["ranks"]:
            if row["name"] in rank["launches"]:
                by_path[f"tp rank {rank['rank']}"] = \
                    rank["launches"][row["name"]]
        for rank, launched in enumerate(tp_serving["rank_launches"]):
            if row["name"] in launched:
                by_path[f"tp serving rank {rank}"] = launched[row["name"]]
        for tag in ("h_ulysses_flash", "h_ring", "i_gpipe"):
            for rank in sp_pp_result[tag]["ranks"]:
                if row["name"] in rank["launches"]:
                    by_path[f"{tag} rank {rank['rank']}"] = \
                        rank["launches"][row["name"]]
        by_path.update({path: launched[row["name"]]
                        for path, launched in fleet_launches.items()
                        if row["name"] in launched})
        row["launches_path"] = primary.get(
            row["name"], "serving fused_burst" if "serving fused_burst"
            in by_path else "training")
        row["launches"] = by_path[row["launches_path"]]
        row["launches_by_path"] = by_path
    log(f"smoke: {time.perf_counter() - smoke_started:.1f} s; by phase: "
        + json.dumps({phase: round(t - t0, 1) for (_, t0), (phase, t)
                      in zip(marks, marks[1:])}))
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
