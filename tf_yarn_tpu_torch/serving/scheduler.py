"""Continuous-batching slot scheduler — counterpart of
tf_yarn_tpu/serving/scheduler.py.

A fixed grid of ``max_slots`` decode slots over one of two KV layouts:

* ``kv_layout="dense"`` (the default): one `DenseKVCache` row of
  ``max_seq_len`` positions per slot, each at its own index. Admission
  prefills into the slot (`insert_slot`) or, when the whole prompt
  replays, zeroes it (`evict_slot`).
* ``kv_layout="paged"``: ONE global pool of KV blocks plus per-slot block
  tables. Admission reserves every block the request can need (prompt +
  max_new - 1 tokens) up front, sharing a cached prompt prefix when one
  matches (the prefix cache); a request the pool cannot cover yet is
  HELD until retirements free blocks. ``decode_attention`` picks how a
  tick reads the pool: ``"gather"`` (the default) gathers each slot's
  dense view and runs the dense decode, ``"fused"`` (int8 only) attends
  straight off the pool with the paged kernel.

Every tick:

1. **retire** active slots whose per-request deadline passed;
2. **admit** queued requests into free slots: prefill the prompt through
   the engine's bucketed prefill (`slot_prefill_len` leaves the last
   prompt token to replay) and splice it into the slot — or, with
   chunked prefill (``prefill_chunk``), prefill nothing: the whole
   prompt (past a prefix-cache hit) queues as replay;
3. **step** every slot in ONE engine call: replaying slots feed their
   next prompt token, decoding slots their last emission, free slots
   ride along masked off. The exact tick (`engine.step` /
   `engine.paged_step`) advances each slot one token; the windowed tick
   (`engine.spec_step` / `engine.paged_spec_step`, when ``spec_k > 0``,
   the fused mode or chunked prefill) feeds each slot a window of its
   replay prefix or its last token plus up to ``spec_k`` drafts from the
   n-gram self-drafter, and keeps the prefix the target itself emits.
   The window is max(spec_k + 1, prefill_chunk) wide, so a chunking slot
   consumes up to a chunk of its prompt a tick beside the decoding
   slots; ``prefill_budget_per_tick`` caps the prompt tokens a tick
   consumes (a chunking slot whose window would pass it is masked off
   for the tick, and which slot claims the budget first rotates
   round-robin), and decoding slots are never paused. On the paged
   layout each chunk's completed whole blocks are offered to the prefix
   cache as they fill;
4. **retire** slots that emitted their eos or hit max_new_tokens.

The host swap tier (``kv_host_blocks`` > 0, paged layout only): when the
pool cannot cover an admission, the lowest-tier active stream below the
request's tier (the youngest within a tier) is SUSPENDED instead of the
request being held: its valid blocks are gathered (`engine.
extract_blocks`, exactly the valid ones), copied to a `HostBlockStore`,
and its block references, slot and sampling generator released or
parked. Parked streams resume, highest tier first and FIFO within a
tier, never ahead of a higher-tier admission, once a slot and the
blocks are free: blocks still shared through the prefix cache
re-attach through the lookup (capped at the parked length), the rest
are written back (`engine.inject_blocks`), and the slot comes back as
it was — pending replay, length, generator — so the stream is the one
an uncontended run gives.

The prefix warm start (`export_hot_prefixes`/`import_prefixes`, the
block wire of ``GET``/``POST /v1/blocks``) runs on the scheduler thread
through a queue of control ops serviced at the top of each tick.

Per-slot sampling state is a `torch.Generator` seeded with the request's
seed at admission (the JAX package's per-slot PRNGKey rows).

Tensor parallelism rides inside the engine (`DecodeEngine(mesh=)`, the
leader of a `serving.tp_replica` group): the tick logic is unchanged,
``tp_degree`` is the engine's, the KV gauges and ``/stats`` count the
whole cache (``kv_cache_hbm_bytes``) and one rank's share
(``kv_cache_hbm_bytes_per_device``) as the JAX grid does, and
``decode_attention="fused"`` is refused at tp > 1 with the JAX
scheduler's message (scheduler.py:283-289).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.models.decode_engine import DECODE_ATTENTION_MODES
from tf_yarn_tpu_torch.models.spec import make_drafter, plan_window
from tf_yarn_tpu_torch.models.transformer import PagedKVPool
from tf_yarn_tpu_torch.serving.paging import (
    TRASH_BLOCK,
    BlockPool,
    HostBlockStore,
    PrefixCache,
)
from tf_yarn_tpu_torch.serving.request import (
    DEFAULT_TIER,
    FINISH_DEADLINE,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_SHUTDOWN,
    AdmissionQueue,
    QueueFull,
    Request,
    Response,
    RetryAfterEstimator,
    SamplingParams,
    tier_rank,
)

_logger = logging.getLogger(__name__)

IDLE_POLL_S = 0.05


KV_LAYOUTS = ("dense", "paged")


class _Slot:
    """Host-side state of one occupied decode slot; a non-empty
    ``pending`` deque means the slot is still replaying its prompt.
    ``prompt_filled`` counts the prompt tokens with valid KV (prefilled,
    hit or replayed so far) and ``registered_blocks`` the whole prompt
    blocks already offered to the prefix cache (the chunked paged path's
    incremental registration)."""

    __slots__ = ("request", "response", "pending", "last_token", "emitted",
                 "blocks", "context", "prompt_filled", "registered_blocks",
                 "last_emit_at")

    def __init__(self, request: Request, response: Response,
                 pending: List[int], blocks: Optional[List[int]] = None):
        self.request = request
        self.response = response
        self.pending: Deque[int] = collections.deque(pending)
        self.last_token = 0
        self.emitted = 0
        self.blocks = blocks or []
        self.context: List[int] = list(request.prompt)
        self.prompt_filled = len(request.prompt) - len(self.pending)
        self.registered_blocks = 0
        self.last_emit_at: Optional[float] = None


class _Suspended:
    """A stream parked on the host tier: its `_Slot` state (pending
    replay, emissions, drafter context) and what a resume restores as it
    was — the slot's generator (never reseeded) and the valid KV length.
    The payload is in the HostBlockStore under the request id, with the
    count of blocks it covers."""

    __slots__ = ("state", "generator", "length")

    def __init__(self, state: _Slot, generator: Optional[torch.Generator],
                 length: int):
        self.state = state
        self.generator = generator
        self.length = length

    @property
    def request(self) -> Request:
        return self.state.request


class _ControlOp:
    """One cross-thread call into the scheduler thread (prefix export or
    import). The caller waits on `done`; the tick services the queue at
    its top, so the paging classes stay scheduler-thread-only."""

    __slots__ = ("kind", "arg", "done", "result", "error")

    def __init__(self, kind: str, arg):
        self.kind = kind
        self.arg = arg
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class SlotScheduler:
    """Continuous batching over a fixed slot grid (module docstring).

    `temperature`/`top_k`/`top_p` configure the grid; requests whose
    SamplingParams disagree are rejected at submit (the HTTP 400).
    Paged layout: ``block_size`` tokens per KV block; ``num_blocks``
    physical blocks (default: the dense-equivalent ``max_slots *
    max_seq_len / block_size + 1``); ``prefix_cache_capacity``
    shared-prefix entries (0 disables sharing). ``spec_k`` drafts per
    slot per tick from ``spec_draft`` ("ngram", a callable ``(context,
    k) -> tokens``, or None). ``prefill_chunk`` (an int >= 1, "auto" —
    the largest of the engine's prompt buckets — or 0/None for blocking
    admission) admits prompts in windows of that many tokens a tick;
    ``prefill_budget_per_tick`` caps the prompt tokens a tick consumes.
    The context limit shrinks by the window width less one.
    ``kv_host_blocks`` > 0 (paged only) backs the pool with that many
    host-RAM blocks for suspended streams; ``tier_caps`` maps a tier to
    its most requests in the system (queued, active and suspended)."""

    def __init__(
        self,
        engine,
        max_slots: int = 8,
        *,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        queue_capacity: int = 64,
        retry_after_s: float = 1.0,
        trace_len: int = 4096,
        kv_layout: str = "dense",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefix_cache_capacity: int = 256,
        max_seq_len: Optional[int] = None,
        spec_k: int = 0,
        spec_draft="ngram",
        decode_attention: str = "gather",
        prefill_chunk=None,
        prefill_budget_per_tick: Optional[int] = None,
        kv_host_blocks: int = 0,
        tier_caps: Optional[Dict[str, int]] = None,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(
                f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if decode_attention not in DECODE_ATTENTION_MODES:
            raise ValueError(
                f"decode_attention must be one of {DECODE_ATTENTION_MODES}, "
                f"got {decode_attention!r}")
        if decode_attention == "fused" and kv_layout != "paged":
            raise ValueError(
                "decode_attention='fused' streams the paged block pool "
                "directly; it requires kv_layout='paged'")
        self.tp_degree = int(getattr(engine, "tp_degree", 1) or 1)
        if decode_attention == "fused" and self.tp_degree > 1:
            raise ValueError(
                "decode_attention='fused' cannot run tensor-parallel "
                f"(engine tp={self.tp_degree}): the paged-int8 pallas "
                "kernel cannot read a sharded block pool yet; use "
                "decode_attention='gather' or tp=1")
        self.engine = engine
        self.max_slots = max_slots
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.kv_layout = kv_layout
        self.spec_k = int(spec_k)
        self.decode_attention = decode_attention
        # The windowed tick: the last token (or replay prefix) + spec_k
        # drafts; it also carries the fused mode at width 1, and chunked
        # prefill at the chunk's width.
        spec_width = self.spec_k + 1
        if prefill_chunk in (None, 0):
            chunk = 0
        elif prefill_chunk == "auto":
            buckets = getattr(engine, "prompt_buckets", None) or ()
            chunk = max([spec_width] + [int(b) for b in buckets])
        else:
            chunk = int(prefill_chunk)
            if chunk < 1:
                raise ValueError(
                    "prefill_chunk must be >= 1, 'auto', or 0/None "
                    f"(blocking admission), got {prefill_chunk!r}")
        self.prefill_chunk = chunk
        self._chunked = chunk > 0
        self._window_width = max(spec_width, chunk)
        self._windowed = (self.spec_k > 0 or decode_attention == "fused"
                          or self._chunked)
        if prefill_budget_per_tick is not None:
            if not self._chunked:
                raise ValueError(
                    "prefill_budget_per_tick needs chunked prefill "
                    "(prefill_chunk >= 1 or 'auto'); with blocking "
                    "admission there is no per-tick prefill to budget")
            prefill_budget_per_tick = int(prefill_budget_per_tick)
            if prefill_budget_per_tick < self._window_width:
                raise ValueError(
                    f"prefill_budget_per_tick ({prefill_budget_per_tick}) "
                    f"must be >= the window width ({self._window_width}, "
                    "i.e. max(prefill_chunk, spec_k + 1)) or no chunking "
                    "slot could ever advance")
        self.prefill_budget_per_tick = prefill_budget_per_tick
        self._drafter = make_drafter(spec_draft) if self.spec_k > 0 else None
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._prefill_tokens = 0
        self._decode_tokens = 0
        kv_host_blocks = int(kv_host_blocks or 0)
        if kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {kv_host_blocks}")
        if kv_host_blocks and kv_layout != "paged":
            raise ValueError(
                "kv_host_blocks (the host swap tier) requires "
                "kv_layout='paged' — dense slots have no block pool "
                "to oversubscribe")
        self.kv_host_blocks = kv_host_blocks
        self.tier_caps: Dict[str, int] = {}
        for name, cap in dict(tier_caps or {}).items():
            tier_rank(name)
            if int(cap) < 0:
                raise ValueError(f"tier_caps[{name!r}] must be >= 0, got {cap}")
            self.tier_caps[name] = int(cap)
        self._estimator = RetryAfterEstimator(floor_s=retry_after_s)
        self.queue = AdmissionQueue(
            queue_capacity, retry_after_s, estimator=self._estimator)
        self._tier_lock = threading.Lock()
        self._tier_inflight: Dict[str, int] = {}
        # Streams parked on the host tier, in suspension order.
        self._suspended: List[_Suspended] = []
        self._suspends = 0
        self._resumes = 0
        self._swap_out_blocks = 0
        self._swap_in_blocks = 0
        self._control: Deque[_ControlOp] = collections.deque()
        self._control_lock = threading.Lock()
        self._generators: List[Optional[torch.Generator]] = [None] * max_slots
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._free: Deque[int] = collections.deque(range(max_slots))
        self._used_before = [False] * max_slots
        self.trace: Deque[Dict] = collections.deque(maxlen=trace_len)
        self._trace_ids: Dict[int, str] = {}
        self._trace_id_lock = threading.Lock()
        self._ticks = 0
        self._peak_streams = 0
        self._draining = False
        self._work = threading.Event()
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._registry = telemetry.get_registry()
        if max_seq_len is None:
            max_seq_len = engine.model.config.max_seq_len
        self._max_seq_len = int(max_seq_len)
        self._held: Optional[Tuple[Request, Response]] = None
        if kv_layout == "paged":
            if self._max_seq_len % block_size:
                raise ValueError(
                    f"block_size={block_size} must divide "
                    f"max_seq_len={self._max_seq_len}"
                )
            self._block_size = int(block_size)
            self._blocks_per_slot = self._max_seq_len // self._block_size
            if num_blocks is None:
                num_blocks = max_slots * self._blocks_per_slot + 1
            self._pool = engine.make_paged_pool(num_blocks, self._block_size)
            self._blocks = BlockPool(num_blocks, self._block_size)
            self._prefix = PrefixCache(self._blocks, prefix_cache_capacity)
            self._host_store = (HostBlockStore(kv_host_blocks, self._block_size)
                                if kv_host_blocks else None)
            self._tables = np.zeros((max_slots, self._blocks_per_slot),
                                    np.int32)
            self._lengths = np.zeros((max_slots,), np.int32)
            self._cache = None
        else:
            self._cache = engine.make_slot_cache(max_slots)
            self._pool = self._blocks = self._prefix = None
            self._host_store = None
            self._block_size = None
        # The whole cache, and the share one device holds: a tp rank's
        # grid holds 1/tp of the heads (the index leaves replicate).
        kv = self._pool if kv_layout == "paged" else self._cache
        self._kv_bytes = kv.nbytes(self.tp_degree)
        self._kv_bytes_per_device = kv.nbytes()
        self._registry.gauge("serving/kv_cache_hbm_bytes",
                             layout=kv_layout).set(self._kv_bytes)
        self._registry.gauge("serving/kv_cache_hbm_bytes_per_device",
                             layout=kv_layout).set(self._kv_bytes_per_device)
        self._registry.gauge("serving/tp_degree").set(self.tp_degree)

    # -- submission (any thread) -------------------------------------------

    @property
    def context_limit(self) -> int:
        """Max prompt + max_new_tokens this grid can serve: the windowed
        paths keep ``window - 1`` positions of headroom, since a window
        writes all its rows before acceptance is known (window =
        max(spec_k + 1, prefill_chunk))."""
        return self._max_seq_len - (self._window_width - 1)

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               priority: int = 0, timeout_s: Optional[float] = None,
               tier: str = DEFAULT_TIER, trace_id: Optional[str] = None
               ) -> Response:
        """Admit one request; returns its streaming Response. Raises
        ValueError for requests this grid cannot serve and QueueFull when
        the queue — or the request's tier cap — is full."""
        params = params or SamplingParams(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
        if (params.temperature, params.top_k, params.top_p) != (
                self.temperature, self.top_k, self.top_p):
            raise ValueError(
                "this serving grid runs temperature="
                f"{self.temperature}, top_k={self.top_k}, "
                f"top_p={self.top_p}; per-request sampling overrides are "
                "not supported"
            )
        request = Request(prompt=tuple(prompt), params=params,
                          priority=priority, timeout_s=timeout_s, tier=tier,
                          trace_id=trace_id)
        if len(request.prompt) + params.max_new_tokens > self.context_limit:
            headroom = (f" minus the {self._window_width - 1}-token window "
                        "headroom (max(spec_k, prefill_chunk - 1))"
                        if self._window_width > 1 else "")
            raise ValueError(
                f"prompt ({len(request.prompt)}) + max_new_tokens "
                f"({params.max_new_tokens}) exceeds the model's max_seq_len "
                f"({self._max_seq_len}){headroom} — the slot KV size"
            )
        if self.kv_layout == "paged":
            need = self._blocks_needed(request)
            if need > self._blocks.num_blocks - 1:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self._blocks.num_blocks - 1} — it can never be "
                    "admitted; raise num_blocks or shorten the request"
                )
        try:
            with self._tier_lock:
                cap = self.tier_caps.get(request.tier)
                inflight = self._tier_inflight.get(request.tier, 0)
                if cap is not None and inflight >= cap:
                    raise QueueFull(inflight, self.queue.retry_hint(request))
                response = self.queue.submit(request)
                self._tier_inflight[request.tier] = inflight + 1
        except Exception:
            self._registry.counter("serving/requests_rejected_total").inc()
            raise
        if trace_id is not None:
            with self._trace_id_lock:
                self._trace_ids[request.id] = trace_id
        self._registry.counter("serving/requests_total").inc()
        self._registry.gauge("serving/queue_depth").set(self.queue.depth)
        self._work.set()
        return response

    def _blocks_needed(self, request: Request) -> int:
        total = len(request.prompt) + request.params.max_new_tokens - 1
        return -(-total // self._block_size)

    # -- the tick (scheduler thread) ----------------------------------------

    def tick(self) -> bool:
        """One scheduling round; returns whether any work happened."""
        self._run_control_ops()
        now = time.monotonic()
        admitted: List[int] = []
        retired: List = []
        with telemetry.span("serving/tick") as tick_span:
            with telemetry.span("serving/retire"):
                self._retire_deadlines(now, retired)
            if self._suspended:
                with telemetry.span("serving/resume"):
                    self._resume_suspended(admitted)
            with telemetry.span("serving/admit"):
                self._admit(now, admitted)
            active = [s for s in range(self.max_slots) if self._slots[s]]
            accepts = None
            if active:
                with telemetry.span("serving/step", active=len(active)):
                    if self._windowed:
                        accepts = self._step_spec(active, retired)
                    else:
                        self._step(active, retired)
        worked = bool(active or admitted or retired)
        self._peak_streams = max(
            self._peak_streams,
            len([s for s in self._slots if s is not None])
            + len(self._suspended))
        if worked:
            self._ticks += 1
            self._registry.histogram("serving/tick_seconds").observe(
                tick_span.duration)
            self._registry.counter("serving/ticks_total").inc()
            entry = {
                "tick": self._ticks,
                "admitted": admitted,
                "retired": [(rid, reason) for rid, reason in retired],
                "active": len([s for s in self._slots if s is not None]),
                "queued": self.queue.depth,
            }
            if accepts is not None:
                entry["accepted"] = accepts
            touched = set(admitted)
            touched.update(rid for rid, _ in retired)
            if touched:
                with self._trace_id_lock:
                    trace_map = {rid: self._trace_ids[rid]
                                 for rid in touched if rid in self._trace_ids}
                    for rid, _ in retired:
                        self._trace_ids.pop(rid, None)
                if trace_map:
                    entry["trace"] = trace_map
            self.trace.append(entry)
        self._registry.gauge("serving/active_slots").set(
            len([s for s in self._slots if s is not None]))
        self._registry.gauge("serving/free_slots").set(len(self._free))
        self._registry.gauge("serving/queue_depth").set(self.queue.depth)
        if self.kv_layout == "paged":
            self._registry.gauge("serving/block_pool_used_blocks").set(
                self._blocks.used_blocks)
            self._registry.gauge("serving/block_pool_free_blocks").set(
                self._blocks.free_blocks)
            self._registry.gauge("serving/prefix_cache_entries").set(
                self._prefix.entries)
            self._registry.gauge("serving/prefix_cache_blocks").set(
                self._prefix.cached_blocks)
            self._registry.gauge("serving/prefix_cache_hit_rate").set(
                self._prefix.hit_rate)
            if self._host_store is not None:
                self._registry.gauge("serving/host_blocks_used").set(
                    self._host_store.used_blocks)
                self._registry.gauge("serving/host_blocks_free").set(
                    self._host_store.free_blocks)
                counts = self._suspended_by_tier()
                for tier in (*self.tier_caps, DEFAULT_TIER):
                    counts.setdefault(tier, 0)
                for tier, count in counts.items():
                    self._registry.gauge("serving/suspended_streams",
                                         tier=tier).set(count)
        return worked

    def _suspended_by_tier(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for entry in self._suspended:
            counts[entry.request.tier] = counts.get(entry.request.tier, 0) + 1
        return counts

    def _retire_deadlines(self, now: float, retired: List) -> None:
        for slot in range(self.max_slots):
            state = self._slots[slot]
            if state is not None and state.request.expired(now):
                self._retire(slot, FINISH_DEADLINE, retired)
        for entry in [e for e in self._suspended if e.request.expired(now)]:
            self._finish_suspended(entry, FINISH_DEADLINE, retired)

    def _finish_unadmitted(self, response: Response, reason: str) -> None:
        self._tier_dec(response.request)
        response._finish(reason)
        self._registry.counter(
            "serving/requests_completed_total", reason=reason).inc()

    def _tier_dec(self, request: Request) -> None:
        with self._tier_lock:
            count = self._tier_inflight.get(request.tier, 0)
            if count > 0:
                self._tier_inflight[request.tier] = count - 1

    def _finish_suspended(self, entry: _Suspended, reason: str,
                          retired: List) -> None:
        """A stream that dies while parked: drop its payload (freeing host
        capacity) and finish it; it holds no slot and no device block."""
        self._suspended.remove(entry)
        if entry.request.id in self._host_store:
            self._host_store.pop(entry.request.id)
        self._tier_dec(entry.request)
        entry.state.response._finish(reason)
        retired.append((entry.request.id, reason))
        self._registry.counter(
            "serving/requests_completed_total", reason=reason).inc()
        self._registry.histogram("serving/request_seconds").observe(
            time.monotonic() - entry.request.submitted_at)

    def _admit(self, now: float, admitted: List[int]) -> None:
        while self._free:
            if self._held is not None:
                item, self._held = self._held, None
            else:
                item = self.queue.pop()
            if item is None:
                break
            request, response = item
            if request.expired(now):
                self._finish_unadmitted(response, FINISH_DEADLINE)
                continue
            if self.kv_layout == "dense":
                self._admit_dense(request, response, now, admitted)
                continue
            ok = self._admit_paged(request, response, now, admitted)
            # The pool is full: with a host tier, park lower-tier streams
            # until the request fits or no victim is left.
            while not ok and self._suspend_victim_below(request):
                ok = self._admit_paged(request, response, now, admitted)
            if not ok:
                # Hold the FIFO head until retirements free blocks.
                self._held = (request, response)
                break

    def _record_admission(self, slot: int, request: Request, now: float,
                          admitted: List[int]) -> None:
        self._registry.histogram("serving/queue_wait_seconds").observe(
            now - request.submitted_at)
        if self._used_before[slot]:
            self._registry.counter("serving/slot_reuse_total").inc()
        self._used_before[slot] = True
        generator = torch.Generator(device=self.engine.device)
        generator.manual_seed(int(request.params.seed))
        self._generators[slot] = generator
        admitted.append(request.id)
        self._registry.counter("serving/requests_admitted_total").inc()

    def _admit_dense(self, request: Request, response: Response,
                     now: float, admitted: List[int]) -> None:
        slot = self._free.popleft()
        if self._chunked:
            # No prefill: a zeroed slot, and the whole prompt replays a
            # chunk a tick.
            self._cache = self.engine.evict_slot(self._cache, slot)
            self._slots[slot] = _Slot(request, response, list(request.prompt))
            self._record_admission(slot, request, now, admitted)
            return
        prefill_len = self.engine.slot_prefill_len(len(request.prompt))
        with telemetry.span("serving/prefill", request=request.id,
                            prefill=prefill_len):
            if prefill_len > 0:
                row_cache, _logits = self.engine.prefill(
                    np.asarray(request.prompt[:prefill_len], np.int32)[None, :])
                self._cache = self.engine.insert_slot(self._cache, slot,
                                                      row_cache)
            else:
                # The whole prompt replays: start from a zeroed slot, not
                # what the previous occupant left.
                self._cache = self.engine.evict_slot(self._cache, slot)
        self._slots[slot] = _Slot(request, response,
                                  list(request.prompt[prefill_len:]))
        self._record_admission(slot, request, now, admitted)

    def _admit_paged(self, request: Request, response: Response,
                     now: float, admitted: List[int]) -> bool:
        """Reserve blocks (sharing a cached prefix when one matches),
        prefill-or-replay, and install the block table. False — without
        consuming a slot — when the pool cannot cover the request yet."""
        prompt = request.prompt
        n_total = self._blocks_needed(request)
        hit_tokens, hit_ids = self._prefix.lookup(prompt, len(prompt) - 1)
        if hit_ids:
            self._blocks.retain(hit_ids)
        need = n_total - len(hit_ids)
        if need > self._blocks.free_blocks:
            self._prefix.evict_for(need)
        owned = self._blocks.allocate(need)
        if owned is None:
            if hit_ids:
                self._blocks.release(hit_ids)
            return False
        blocks = hit_ids + owned
        slot = self._free.popleft()
        if hit_tokens:
            prefill_len = hit_tokens
            self._registry.counter("serving/prefix_cache_hits_total").inc()
        elif self._chunked:
            # No prefill: the blocks are reserved, the whole prompt replays
            # a chunk a tick, and each completed block is registered.
            prefill_len = 0
        else:
            prefill_len = self.engine.slot_prefill_len(len(prompt))
            with telemetry.span("serving/prefill", request=request.id,
                                prefill=prefill_len):
                if prefill_len > 0:
                    row_cache, _logits = self.engine.prefill(
                        np.asarray(prompt[:prefill_len], np.int32)[None, :])
                    n_pack = -(-prefill_len // self._block_size)
                    self._pool = self.engine.pack_prefill(
                        self._pool, np.asarray(blocks[:n_pack], np.int32),
                        row_cache, prefill_len, self._block_size)
                    self._prefix.register(prompt, prefill_len, blocks)
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = prefill_len
        state = _Slot(request, response, list(prompt[prefill_len:]), blocks)
        # Whole blocks already covered (a hit, or the blocking prefill's
        # registration): the chunked registration starts past them.
        state.registered_blocks = prefill_len // self._block_size
        self._slots[slot] = state
        self._record_admission(slot, request, now, admitted)
        return True

    # -- host-tier swap: suspend / resume ------------------------------------

    def _suspend_victim_below(self, request: Request) -> bool:
        """Park one active stream of a tier strictly below `request`'s:
        the lowest tier first, the youngest within a tier. False when
        there is no host tier, no such stream, or no room on the host for
        any candidate's valid blocks."""
        if self._host_store is None:
            return False
        rank = request.tier_rank
        candidates = [slot for slot in range(self.max_slots)
                      if self._slots[slot] is not None
                      and self._slots[slot].request.tier_rank < rank]
        candidates.sort(key=lambda slot: (
            self._slots[slot].request.tier_rank,
            -self._slots[slot].request.submitted_at))
        for slot in candidates:
            n_valid = -(-int(self._lengths[slot]) // self._block_size)
            if self._host_store.can_hold(n_valid):
                self._suspend_slot(slot)
                return True
        return False

    def _suspend_slot(self, slot: int) -> None:
        """Swap one active slot out: gather its valid blocks and copy them
        to the host store, release all its block references (blocks the
        prefix cache shares survive on the cache's own reference) and
        free the slot. The generator is parked as it is."""
        state = self._slots[slot]
        length = int(self._lengths[slot])
        n_valid = -(-length // self._block_size)
        started = time.monotonic()
        payload = None
        if n_valid:
            payload = _to_host(self.engine.extract_blocks(
                self._pool, state.blocks[:n_valid], self._block_size))
        self._host_store.put(state.request.id, n_valid, payload)
        self._blocks.release(state.blocks)
        state.blocks = []
        self._slots[slot] = None
        self._free.append(slot)
        self._tables[slot, :] = 0
        self._lengths[slot] = 0
        self._suspended.append(_Suspended(state, self._generators[slot],
                                          length))
        self._generators[slot] = None
        self._suspends += 1
        self._swap_out_blocks += n_valid
        self._registry.counter("serving/suspends_total",
                               tier=state.request.tier).inc()
        if n_valid:
            self._registry.counter("serving/swap_out_blocks_total").inc(
                n_valid)
            self._registry.histogram("serving/swap_seconds").observe(
                time.monotonic() - started)

    def _pending_rank(self) -> Optional[int]:
        """Highest tier rank waiting for admission (held or queued), or
        None: a resume never jumps a higher-tier admission, which would
        only suspend it again."""
        ranks = [] if self._held is None else [self._held[0].tier_rank]
        queued = self.queue.peek_rank()
        if queued is not None:
            ranks.append(queued)
        return max(ranks) if ranks else None

    def _resume_suspended(self, admitted: List[int]) -> None:
        """Bring parked streams back while slots and blocks allow: the
        highest tier first, FIFO within a tier."""
        while self._free and self._suspended:
            best = None
            for entry in self._suspended:
                if best is None or \
                        entry.request.tier_rank > best.request.tier_rank:
                    best = entry
            barrier = self._pending_rank()
            if barrier is not None and best.request.tier_rank < barrier:
                return
            if not self._try_resume(best, admitted):
                return

    def _try_resume(self, entry: _Suspended, admitted: List[int]) -> bool:
        """Re-reserve the stream's whole block budget, write its parked
        blocks back and reinstall the slot as it was. Blocks the prefix
        cache still shares re-attach through the lookup, capped at the
        parked length: a longer cached prefix would put shared blocks
        where this slot writes. False (the stream stays parked) when the
        pool cannot cover it yet."""
        request = entry.request
        state = entry.state
        prompt = request.prompt
        n_total = self._blocks_needed(request)
        _hit_tokens, hit_ids = self._prefix.lookup(
            prompt, min(len(prompt) - 1, entry.length))
        if hit_ids:
            self._blocks.retain(hit_ids)
        need = n_total - len(hit_ids)
        if need > self._blocks.free_blocks:
            # A parked stream retries every tick: evict only when that
            # covers the deficit, or the eviction frees nothing and strips
            # prefixes a later lookup could share.
            if need > (self._blocks.free_blocks
                       + self._prefix.evictable_blocks()):
                if hit_ids:
                    self._blocks.release(hit_ids)
                return False
            self._prefix.evict_for(need)
        owned = self._blocks.allocate(need)
        if owned is None:
            if hit_ids:
                self._blocks.release(hit_ids)
            return False
        blocks = hit_ids + owned
        slot = self._free.popleft()
        started = time.monotonic()
        n_valid, payload = self._host_store.pop(request.id)
        k_hit = len(hit_ids)
        inject_n = max(0, n_valid - k_hit)
        if inject_n:
            # Rows [k_hit, n_valid) go to their new blocks; the hit rows
            # are resident and shared.
            self._pool = self.engine.inject_blocks(
                self._pool, blocks[k_hit:n_valid],
                _payload_rows(payload, range(k_hit, n_valid)),
                self._block_size)
        self._suspended.remove(entry)
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = entry.length
        self._generators[slot] = entry.generator
        state.blocks = blocks
        self._slots[slot] = state
        if self._used_before[slot]:
            self._registry.counter("serving/slot_reuse_total").inc()
        self._used_before[slot] = True
        admitted.append(request.id)
        self._resumes += 1
        self._swap_in_blocks += inject_n
        self._registry.counter("serving/resumes_total",
                               tier=request.tier).inc()
        if inject_n:
            self._registry.counter("serving/swap_in_blocks_total").inc(
                inject_n)
            self._registry.histogram("serving/swap_seconds").observe(
                time.monotonic() - started)
        return True

    # -- prefix warm start (the block wire) -----------------------------------

    def export_hot_prefixes(self, limit: Optional[int] = None,
                            timeout_s: float = 30.0) -> Dict:
        """The hottest prefix-cache entries with their KV blocks, in the
        JAX package's wire form: ``{schema_version, block_size,
        group_width, n_blocks, entries: [{key (hex), blocks: [index into
        the shipped blocks]}], groups: [{n_blocks, leaves}]}``. Each
        group's leaves are the JAX scanned-layer pool's flat leaves
        (``[None, key, key_scale, value, value_scale]``, ``[L, 1,
        group_width, bs, Hkv, *]`` host tensors; no scales for a bf16
        pool). Blocks shared by entries ship once; ``group_width`` is
        min(blocks per slot, blocks shipped), so the wire carries no
        padding rows but the last group's. Runs on the scheduler thread;
        any thread may call it."""
        return self._control_call("export", limit, timeout_s)

    def import_prefixes(self, wire: Dict, timeout_s: float = 30.0) -> Dict:
        """Install a peer's export (from the port or the JAX package, its
        leaves in either JAX layer layout): allocate blocks (evicting LRU
        prefix entries, never an active slot's), write the payload rows
        and register each entry under its content key. The hottest
        entries win when the pool cannot hold them all. Returns
        ``{imported_blocks, registered_entries, skipped_entries}``;
        raises ValueError on a wire this pool cannot take."""
        return self._control_call("import", wire, timeout_s)

    def _control_call(self, kind: str, arg, timeout_s: float):
        if self.kv_layout != "paged":
            raise ValueError(
                "prefix warm start needs kv_layout='paged' — the dense "
                "layout has no block pool or prefix cache to transfer")
        op = _ControlOp(kind, arg)
        with self._control_lock:
            self._control.append(op)
        self._work.set()
        with self._lifecycle:
            loop_running = self._thread is not None
        if not loop_running:
            # No loop thread (a hand-driven grid): the caller is the
            # scheduler thread.
            self._run_control_ops()
        if not op.done.wait(timeout_s):
            raise TimeoutError(
                f"scheduler did not service {kind} within {timeout_s}s")
        if op.error is not None:
            raise op.error
        return op.result

    def _run_control_ops(self) -> None:
        while True:
            with self._control_lock:
                if not self._control:
                    return
                op = self._control.popleft()
            try:
                if op.kind == "export":
                    op.result = self._export_prefixes_now(op.arg)
                elif op.kind == "import":
                    op.result = self._import_prefixes_now(op.arg)
                else:
                    raise ValueError(f"unknown control op {op.kind!r}")
            except BaseException as exc:  # delivered to the caller
                op.error = exc
            op.done.set()

    def _export_prefixes_now(self, limit: Optional[int]) -> Dict:
        # Entries whose blocks were already freed are dropped, and every
        # shipped block is retained over the extract, so none can be
        # reallocated and overwritten under its old content key.
        entries = [(key, ids) for key, ids in self._prefix.export_entries(limit)
                   if all(self._blocks.refcount(block) > 0 for block in ids)]
        donor_ids: List[int] = []
        index: Dict[int, int] = {}
        wire_entries: List[Dict] = []
        for key, ids in entries:
            for block in ids:
                if block not in index:
                    index[block] = len(donor_ids)
                    donor_ids.append(block)
            wire_entries.append({"key": key.hex(),
                                 "blocks": [index[block] for block in ids]})
        width = max(1, min(self._blocks_per_slot, len(donor_ids)))
        groups: List[Dict] = []
        self._blocks.retain(donor_ids)
        try:
            for start in range(0, len(donor_ids), width):
                chunk = donor_ids[start:start + width]
                payload = _to_host(self.engine.extract_blocks(
                    self._pool, chunk + [TRASH_BLOCK] * (width - len(chunk)),
                    self._block_size))
                groups.append({"n_blocks": len(chunk),
                               "leaves": _wire_leaves(payload)})
        finally:
            self._blocks.release(donor_ids)
        if donor_ids:
            self._registry.counter("serving/prefix_export_blocks_total").inc(
                len(donor_ids))
        return {"schema_version": 1, "block_size": self._block_size,
                "group_width": width, "n_blocks": len(donor_ids),
                "entries": wire_entries, "groups": groups}

    def _import_prefixes_now(self, wire: Dict) -> Dict:
        block_size = int(wire.get("block_size") or 0)
        if block_size != self._block_size:
            raise ValueError(
                f"peer block_size {block_size} != local "
                f"{self._block_size}; refusing to import KV blocks")
        n_blocks = int(wire.get("n_blocks") or 0)
        entries = list(wire.get("entries") or [])
        groups = list(wire.get("groups") or [])
        width = int(wire.get("group_width") or 0)
        empty = {"imported_blocks": 0, "registered_entries": 0,
                 "skipped_entries": len(entries)}
        if not n_blocks or not entries or not groups or width < 1:
            return empty
        # Every group is read against this pool before a block moves, so
        # a wire it cannot take is refused with nothing allocated.
        payloads = [_payload_from_wire(group["leaves"], self._pool,
                                       int(group["n_blocks"]), self.tp_degree)
                    for group in groups]
        # The hottest entries first, as far as free plus evictable blocks
        # reach; active slots are never raided.
        coverable = self._blocks.free_blocks + self._prefix.evictable_blocks()
        needed: Dict[int, None] = {}
        selected: List[Dict] = []
        for entry in entries:
            fresh = [i for i in entry["blocks"] if i not in needed]
            if len(needed) + len(fresh) > coverable:
                break
            for i in fresh:
                needed[i] = None
            selected.append(entry)
        if not selected:
            return empty
        self._prefix.evict_for(len(needed))
        owned = self._blocks.allocate(len(needed))
        if owned is None:
            return empty
        mapping = dict(zip(needed, owned))
        for g, (group, payload) in enumerate(zip(groups, payloads)):
            rows = [j for j in range(int(group["n_blocks"]))
                    if g * width + j in mapping]
            if rows:
                self._pool = self.engine.inject_blocks(
                    self._pool, [mapping[g * width + j] for j in rows],
                    _payload_rows(payload, rows), self._block_size)
        registered = 0
        # Cold to hot, so the donor's hottest entries land at the MRU end.
        for entry in reversed(selected):
            if self._prefix.register_imported(
                    bytes.fromhex(entry["key"]),
                    [mapping[i] for i in entry["blocks"]]):
                registered += 1
        # The entries hold their own references now; the allocation's go.
        self._blocks.release(owned)
        self._registry.counter("serving/prefix_import_blocks_total").inc(
            len(owned))
        return {"imported_blocks": len(owned),
                "registered_entries": registered,
                "skipped_entries": len(entries) - len(selected)}

    def _observe_ttft(self, state: _Slot) -> None:
        ttft = state.response.ttft_s
        self._registry.histogram("serving/ttft_seconds").observe(ttft)
        self._registry.histogram(
            "serving/ttft_seconds", tier=state.request.tier).observe(ttft)

    def _step(self, active: List[int], retired: List) -> None:
        """The exact tick: ONE engine step advances every slot one token
        (a replayed prompt token, or the fed-back last emission)."""
        tokens = np.zeros((self.max_slots,), np.int32)
        mask = np.zeros((self.max_slots,), bool)
        for slot in active:
            state = self._slots[slot]
            if state.pending:
                tokens[slot] = state.pending[0]
                mask[slot] = len(state.pending) == 1
            else:
                tokens[slot] = state.last_token
                mask[slot] = True
        sampling = dict(temperature=self.temperature, top_k=self.top_k,
                        top_p=self.top_p)
        if self.kv_layout == "paged":
            self._pool, emitted, self._generators = self.engine.paged_step(
                self._pool, self._tables, self._lengths, tokens,
                self._generators, mask, block_size=self._block_size,
                **sampling)
        else:
            self._cache, emitted, self._generators = self.engine.step(
                self._cache, tokens, self._generators, mask, **sampling)
        now = time.monotonic()
        prefill_tokens = 0
        decode_tokens = 0
        for slot in active:
            state = self._slots[slot]
            if self.kv_layout == "paged":
                # The slot wrote its K/V row at the old length.
                self._lengths[slot] += 1
            if state.pending:
                state.pending.popleft()
                prefill_tokens += 1
            if not mask[slot]:
                continue
            decode_tokens += 1
            self._emit(slot, int(emitted[slot]), now, retired)
        self._account_tokens(prefill_tokens, decode_tokens)

    def _emit(self, slot: int, token: int, now: float, retired: List) -> bool:
        """Deliver one emitted token; True when it retired the slot."""
        state = self._slots[slot]
        state.last_token = token
        state.emitted += 1
        state.context.append(token)
        first = state.response.first_token_at is None
        state.response._push(token)
        if first:
            self._observe_ttft(state)
        elif state.last_emit_at is not None:
            self._registry.histogram("serving/inter_token_latency_ms").observe(
                (now - state.last_emit_at) * 1e3)
        state.last_emit_at = now
        self._registry.counter("serving/tokens_generated_total").inc()
        eos = state.request.params.eos_token
        if eos is not None and token == eos:
            self._retire(slot, FINISH_EOS, retired)
            return True
        if state.emitted >= state.request.params.max_new_tokens:
            self._retire(slot, FINISH_LENGTH, retired)
            return True
        return False

    def _step_spec(self, active: List[int], retired: List) -> Dict[int, int]:
        """The windowed tick: ONE engine step advances every slot a
        variable number of tokens — a replaying (chunking) slot up to the
        window of teacher-forced prompt tokens, a decoding slot 1 up to
        spec_k + 1 (its drafts kept while the target agrees). With
        ``prefill_budget_per_tick``, a replaying slot whose window would
        pass the tick's budget is masked off (it consumes and emits
        nothing; its garbage window rows land past its valid length and
        are overwritten when it resumes); who claims the budget first
        rotates each tick. Decoding slots are never paused. Returns
        {request id: tokens emitted} for the trace ring."""
        width = self._window_width
        tokens = np.full((self.max_slots, width), -1, np.int32)
        n_known = np.zeros((self.max_slots,), np.int32)
        eos_ids = np.full((self.max_slots,), -1, np.int32)
        mask = np.zeros((self.max_slots,), bool)
        consumed: Dict[int, int] = {}
        proposed: Dict[int, int] = {}
        budget = self.prefill_budget_per_tick
        order = active
        if budget is not None and len(active) > 1:
            pivot = self._ticks % len(active)
            order = active[pivot:] + active[:pivot]
        for slot in order:
            state = self._slots[slot]
            need = min(len(state.pending), width)
            if budget is not None and need > 0:
                if need > budget:
                    consumed[slot] = 0
                    proposed[slot] = 0
                    continue
                budget -= need
            max_emit = state.request.params.max_new_tokens - state.emitted
            window, known, n_prop = plan_window(
                state.pending, state.last_token, width, max_emit,
                state.context, self._drafter, max_drafts=self.spec_k)
            tokens[slot] = window
            n_known[slot] = known
            eos = state.request.params.eos_token
            eos_ids[slot] = -1 if eos is None else eos
            mask[slot] = True
            consumed[slot] = need
            proposed[slot] = n_prop
        sampling = dict(temperature=self.temperature, top_k=self.top_k,
                        top_p=self.top_p)
        if self.kv_layout == "paged":
            self._pool, emitted, counts, self._generators = \
                self.engine.paged_spec_step(
                    self._pool, self._tables, self._lengths, tokens, n_known,
                    eos_ids, self._generators, mask,
                    block_size=self._block_size,
                    decode_attention=self.decode_attention, **sampling)
        else:
            self._cache, emitted, counts, self._generators = \
                self.engine.spec_step(self._cache, tokens, n_known, eos_ids,
                                      self._generators, mask, **sampling)
        now = time.monotonic()
        prefill_tokens = 0
        decode_tokens = 0
        accepts: Dict[int, int] = {}
        for slot in active:
            state = self._slots[slot]
            for _ in range(consumed[slot]):
                state.pending.popleft()
            state.prompt_filled += consumed[slot]
            prefill_tokens += consumed[slot]
            n = int(counts[slot])
            decode_tokens += n
            if self.kv_layout == "paged":
                # Valid rows this tick: the replayed prefix + the
                # emissions; rejected window rows beyond stay dead.
                self._lengths[slot] += int(n_known[slot]) + n
                if self._chunked and consumed[slot]:
                    self._register_chunk_prefix(state)
            if proposed[slot]:
                accepted_drafts = min(max(n - 1, 0), proposed[slot])
                self._spec_proposed += proposed[slot]
                self._spec_accepted += accepted_drafts
                self._registry.counter(
                    "serving/spec_proposed_tokens_total").inc(proposed[slot])
                if accepted_drafts:
                    self._registry.counter(
                        "serving/spec_accepted_tokens_total").inc(
                            accepted_drafts)
            if n:
                accepts[state.request.id] = n
                self._registry.histogram(
                    "serving/accepted_tokens_per_step").observe(n)
            for j in range(n):
                if self._emit(slot, int(emitted[slot, j]), now, retired):
                    break
        if self._spec_proposed:
            self._registry.gauge("serving/spec_accept_rate").set(
                self._spec_accepted / self._spec_proposed)
        self._account_tokens(prefill_tokens, decode_tokens)
        return accepts

    def _register_chunk_prefix(self, state: _Slot) -> None:
        """Offer every prompt block a chunk just completed to the prefix
        cache. `PrefixCache.register` is idempotent per prefix and takes
        its own reference on each newly shared block, so the slot's one
        reference (released at retire) is never counted twice: a slot
        evicted mid-prefill releases exactly its own references, and the
        cached blocks survive for the next hit."""
        whole = state.prompt_filled // self._block_size
        if whole > state.registered_blocks:
            self._prefix.register(state.request.prompt, state.prompt_filled,
                                  state.blocks)
            state.registered_blocks = whole

    def _account_tokens(self, prefill_tokens: int, decode_tokens: int) -> None:
        """Per-tick token split: prompt tokens consumed (prefill/replay)
        against tokens emitted (decode)."""
        self._prefill_tokens += prefill_tokens
        self._decode_tokens += decode_tokens
        if prefill_tokens:
            self._registry.counter("serving/prefill_tokens_total").inc(
                prefill_tokens)
        if decode_tokens:
            self._registry.counter("serving/decode_tokens_total").inc(
                decode_tokens)

    def _retire(self, slot: int, reason: str, retired: List) -> None:
        state = self._slots[slot]
        self._slots[slot] = None
        self._free.append(slot)
        self._generators[slot] = None
        if self.kv_layout == "paged":
            # O(blocks) bookkeeping: shared prefix blocks survive on the
            # cache's own reference; stale pool rows need no zeroing.
            self._blocks.release(state.blocks)
            self._tables[slot, :] = 0
            self._lengths[slot] = 0
        self._tier_dec(state.request)
        self._estimator.record_retire(state.request.tier)
        state.response._finish(reason)
        retired.append((state.request.id, reason))
        self._registry.counter(
            "serving/requests_completed_total", reason=reason).inc()
        self._registry.histogram("serving/request_seconds").observe(
            time.monotonic() - state.request.submitted_at)

    # -- loop ---------------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is not None:
                raise RuntimeError("scheduler already started")
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="serving-scheduler", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                worked = self.tick()
            except Exception:
                # A tick must never kill the serving loop: fail the
                # in-flight work visibly and keep serving.
                _logger.exception(
                    "scheduler tick failed; failing in-flight requests")
                self._registry.counter("serving/tick_errors_total").inc()
                self._fail_inflight(FINISH_ERROR)
                continue
            if not worked:
                self._work.wait(IDLE_POLL_S)
                self._work.clear()

    def _fail_inflight(self, reason: str) -> None:
        if self._held is not None:
            _request, response = self._held
            self._held = None
            self._finish_unadmitted(response, reason)
        for _request, response in self.queue.drain():
            self._finish_unadmitted(response, reason)
        retired: List = []
        for entry in list(self._suspended):
            self._finish_suspended(entry, reason, retired)
        for slot in range(self.max_slots):
            if self._slots[slot] is not None:
                self._retire(slot, reason, retired)

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Mark the grid as draining (surfaced in /healthz and /stats);
        scheduling continues until `close()`."""
        self._draining = True

    def close(self) -> None:
        """Stop the loop; fail queued and in-flight requests as
        `shutdown` so no client blocks forever on a dead grid."""
        self._draining = True
        self._stop.set()
        self._work.set()
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30.0)
        self._fail_inflight(FINISH_SHUTDOWN)

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict:
        """Host-side snapshot for /stats."""
        with self._tier_lock:
            tier_inflight = {tier: count for tier, count
                             in self._tier_inflight.items() if count}
        snap = {
            "max_slots": self.max_slots,
            "active_slots": len([s for s in self._slots if s is not None]),
            "free_slots": len(self._free),
            "queue_depth": self.queue.depth,
            "queue_capacity": self.queue.capacity,
            "ticks": self._ticks,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "kv_layout": self.kv_layout,
            "kv_cache_hbm_bytes": self._kv_bytes,
            "kv_cache_hbm_bytes_per_device": self._kv_bytes_per_device,
            "tp_degree": self.tp_degree,
            "draining": self._draining,
            "spec_k": self.spec_k,
            "decode_attention": self.decode_attention,
            "prefill_chunk": self.prefill_chunk,
            "prefill_budget_per_tick": self.prefill_budget_per_tick,
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "peak_streams": self._peak_streams,
            "retire_rate_per_s": round(self._estimator.retire_rate(), 4),
            "tiers": {"inflight": tier_inflight, "caps": dict(self.tier_caps)},
        }
        if self._windowed:
            snap["spec"] = {
                "proposed_tokens": self._spec_proposed,
                "accepted_tokens": self._spec_accepted,
                "accept_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None,
            }
        if self.kv_layout == "paged":
            snap["block_size"] = self._block_size
            snap["block_pool"] = {
                "num_blocks": self._blocks.num_blocks,
                "used_blocks": self._blocks.used_blocks,
                "free_blocks": self._blocks.free_blocks,
            }
            snap["prefix_cache"] = {
                "entries": self._prefix.entries,
                "cached_blocks": self._prefix.cached_blocks,
                "hits": self._prefix.hits,
                "misses": self._prefix.misses,
                "hit_rate": round(self._prefix.hit_rate, 4),
            }
            if self._host_store is not None:
                snap["host_block_store"] = {
                    "capacity_blocks": self._host_store.capacity_blocks,
                    "used_blocks": self._host_store.used_blocks,
                    "free_blocks": self._host_store.free_blocks,
                    "entries": self._host_store.entries,
                }
                snap["suspended_streams"] = self._suspended_by_tier()
                snap["swap"] = {
                    "suspends": self._suspends,
                    "resumes": self._resumes,
                    "swap_out_blocks": self._swap_out_blocks,
                    "swap_in_blocks": self._swap_in_blocks,
                }
        snap["decode_engine"] = dict(self.engine.stats)
        return snap


# The JAX pool's leaves a layer, in its flattening order (cache_index,
# then the cached_* leaves sorted by name); the port's `PagedKVPool`
# names them without the prefix.
_WIRE_ORDER = ("key", "key_scale", "value", "value_scale")


def _to_host(payload: PagedKVPool) -> PagedKVPool:
    """A swap or export payload copied to the host: one device-to-host
    copy a leaf (four for an int8 pool)."""
    return PagedKVPool(**{name: None if leaf is None else leaf.cpu()
                          for name, leaf in vars(payload).items()})


def _payload_rows(payload: PagedKVPool, rows) -> PagedKVPool:
    """The payload's blocks `rows` (host tensors)."""
    rows = torch.as_tensor(list(rows), dtype=torch.long)
    return PagedKVPool(**{
        name: None if leaf is None else leaf.index_select(1, rows)
        for name, leaf in vars(payload).items()})


def _wire_leaves(payload: PagedKVPool) -> List:
    """A payload as the JAX scanned-layer pool's flat leaves: the
    cache_index None, then ``[L, 1, W, bs, Hkv, *]`` views of the stacked
    leaves (the unit axis is the JAX pool's batch axis)."""
    return [None] + [getattr(payload, name).unsqueeze(1)
                     for name in _WIRE_ORDER
                     if getattr(payload, name) is not None]


def _payload_from_wire(leaves: List, pool: PagedKVPool,
                       n_blocks: int, tp: int = 1) -> PagedKVPool:
    """A wire group's flat leaves as a payload for `pool` (a tp rank's
    pool, holding 1/`tp` of the heads the wire carries whole). The JAX
    package flattens a scanned-layer pool to one set of leaves, ``[L, 1,
    W, bs, Hkv, *]``, and an unscanned one to a set a layer, ``[1, W,
    bs, Hkv, *]``, its layers in the lexicographic order of their names
    (layer_0, layer_1, layer_10, ...). Raises ValueError on any other
    leaf count or shape."""
    names = [name for name in _WIRE_ORDER if getattr(pool, name) is not None]
    per_layer = 1 + len(names)
    n_layers = pool.key.shape[0]
    leaves = [None if leaf is None else torch.as_tensor(leaf)
              for leaf in leaves]
    tensors = [leaf for leaf in leaves if leaf is not None]
    scanned = len(leaves) == per_layer and all(t.ndim == 6 for t in tensors)
    if not scanned and len(leaves) != per_layer * n_layers:
        raise ValueError(
            f"block wire group has {len(leaves)} leaves; this pool takes "
            f"{per_layer} (scanned layers) or {per_layer * n_layers} (one "
            f"set a layer, {n_layers} layers)")
    sets = [leaves] if scanned else [
        leaves[i * per_layer:(i + 1) * per_layer] for i in range(n_layers)]
    for leaf_set in sets:
        if leaf_set[0] is not None or any(leaf is None
                                          for leaf in leaf_set[1:]):
            raise ValueError(
                "block wire leaves do not match this pool's layout: each "
                f"set is None then {len(names)} tensors ({', '.join(names)})")
    if scanned:
        stacked = {name: sets[0][1 + i].squeeze(1)
                   for i, name in enumerate(names)}
    else:
        order = sorted(range(n_layers), key=lambda layer: f"layer_{layer}")
        by_layer = dict(zip(order, sets))
        stacked = {name: torch.cat([by_layer[layer][1 + i]
                                    for layer in range(n_layers)])
                   for i, name in enumerate(names)}
    for name, leaf in stacked.items():
        want = getattr(pool, name)
        block, heads, rest = want.shape[2], want.shape[3] * tp, want.shape[4:]
        tail = (block, heads, *rest)
        if leaf.ndim != want.ndim or leaf.shape[0] != want.shape[0] \
                or tuple(leaf.shape[2:]) != tail or leaf.shape[1] < n_blocks:
            raise ValueError(
                f"block wire leaf {name} has shape {tuple(leaf.shape)}; this "
                f"pool takes ({want.shape[0]}, >= {n_blocks}) + {tail}")
    return PagedKVPool(**{name: stacked.get(name) for name in
                          ("key", "value", "key_scale", "value_scale")})
