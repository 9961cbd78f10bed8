"""Disaggregated prefill — counterpart of tf_yarn_tpu/serving/prefill.py,
the ``prefill`` task tier.

Prefill is compute-bound and bursty, decode memory-bound and steady; the
tier runs them in separate replicas joined by the block wire of
``/v1/blocks`` (`server.encode_block_wire`):

* :class:`PrefillWorker` — the engine and a PRIVATE paged pool and prefix
  cache that run only bucketed prefill: `prefill_prompt` is the
  scheduler's blocking-admission prefill (`DecodeEngine.prefill` +
  `pack_prefill`), and returns the prompt's whole-block span as a wire
  dict, one entry a prefix length, longest first. An int8 pool's blocks
  travel as int8 codes with their f32 scales.
* :class:`PrefillServer` — ``POST /v1/prefill`` plus ``/healthz``,
  ``/stats`` and ``/metrics``.
* :class:`PrefillClient` — the decode side: `/v1/generate` still lands on
  a decode replica, which first ships a long prompt to the tier, installs
  the returned blocks with `SlotScheduler.import_prefixes` and lets
  admission's prefix hit skip the shipped span. Every failure (no
  replica advertised, a replica gone mid-ship, a bad wire, an import
  refused) falls back to local prefill, never to an error; the shipped
  blocks hold the KV local prefill computes, so the streams are the same.
* :func:`run_prefill` — the ``prefill`` task's body (tasks/prefill.py);
  under a tp ``mesh_spec`` a replica of N ranks (`serving.tp_replica`),
  whose exports carry whole heads, so its wire is the one-device wire.

Where it differs from the JAX package: the engine holds the weights (no
``params``), and a wire group is ``min(blocks per slot, blocks shipped)``
blocks wide — exactly the valid blocks — where the JAX worker pads every
group to the slot's block-table width with the trash block (~512 MB a
group at Llama-3-8B width). Both packages read either width.

Locking: `serving/paging.py` has none (one thread drives a scheduler's),
so the worker guards its pool and cache with ONE lock: requests arrive on
per-connection HTTP threads and the prefill runs under it. The client
guards its memo, quarantine and counters with its own lock and keeps the
HTTP round trip outside it. On the decode replica the client runs on the
frontend's handler threads and does no device work: the wire decodes to
host tensors and the import runs on the scheduler's thread (its control
queue).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np

from tf_yarn_tpu_torch import preemption, telemetry
from tf_yarn_tpu_torch.serving.paging import (
    TRASH_BLOCK,
    BlockPool,
    PrefixCache,
    prefix_keys,
)
from tf_yarn_tpu_torch.serving.scheduler import _to_host, _wire_leaves
from tf_yarn_tpu_torch.serving.server import (
    advertised_endpoint,
    decode_block_wire,
    encode_block_wire,
    finish_replica,
    load_engine,
    replica_poll,
    serve_until_stopped,
    task_name,
)

_logger = logging.getLogger(__name__)

# Below this many prompt tokens a local prefill is cheaper than the hop
# (one HTTP round trip plus one import on the scheduler's thread).
DEFAULT_OFFLOAD_THRESHOLD = 64

# The client's memo of shipped content keys is bounded; on overflow it
# resets (at worst a prefix ships once more).
_SHIPPED_MEMO_CAP = 4096


@dataclasses.dataclass(frozen=True)
class PrefillTierConfig:
    """`ServingExperiment(prefill_tier=...)` knobs."""

    # Prompts shorter than this many tokens never pay the hop.
    offload_threshold: int = DEFAULT_OFFLOAD_THRESHOLD
    # A fixed prefill endpoint ("host:port"); None discovers the tier
    # through the `{task}/prefill_endpoint` KV advertisements.
    endpoint: Optional[str] = None
    # Each ship's HTTP budget; a slower replica counts as down.
    timeout_s: float = 10.0
    # After a failed ship the tier is quarantined this long: requests in
    # the window prefill locally without dialing.
    backoff_s: float = 5.0
    # How long a KV resolution (including "none advertised") is trusted.
    resolve_ttl_s: float = 2.0
    # The prefill replica's pool (run_prefill); None derives one from the
    # block-table width.
    num_blocks: Optional[int] = None

    def __post_init__(self):
        if self.offload_threshold < 1:
            raise ValueError(
                f"offload_threshold must be >= 1, got "
                f"{self.offload_threshold}")
        for knob in ("timeout_s", "backoff_s", "resolve_ttl_s"):
            if not float(getattr(self, knob)) > 0:
                raise ValueError(
                    f"{knob} must be > 0, got {getattr(self, knob)}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2, got {self.num_blocks}")


def parse_prefill_tier(spec) -> PrefillTierConfig:
    """Validate a ``prefill_tier=`` knob (a dict of `PrefillTierConfig`
    fields, or a config). Raises ValueError naming the key at fault."""
    if isinstance(spec, PrefillTierConfig):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(
            "prefill_tier must be a dict of PrefillTierConfig fields "
            f"(or a PrefillTierConfig), got {spec!r}")
    try:
        return PrefillTierConfig(**spec)
    except TypeError as exc:
        raise ValueError(str(exc)) from None


# -- the prefill replica: worker, HTTP frontend, task body --------------------

class PrefillWorker:
    """Bucketed prefill into a private paged pool, exported as wire. One
    lock serializes every pool and cache change; a repeated prompt (or a
    shared prefix) hits the worker's own prefix cache and exports without
    a prefill."""

    def __init__(self, engine, *, block_size: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache_capacity: int = 256):
        self.engine = engine
        self._block_size = int(block_size)
        self._max_seq_len = int(engine.model.config.max_seq_len)
        # ValueError unless block_size divides max_seq_len.
        self._blocks_per_slot = engine.max_blocks_per_slot(self._block_size)
        if num_blocks is None:
            # A few distinct longest prompts on top of the trash block; the
            # prefix cache recycles the rest under LRU pressure.
            num_blocks = 4 * self._blocks_per_slot + 1
        self._lock = threading.Lock()
        self._pool = engine.make_paged_pool(num_blocks, self._block_size)
        self._blocks = BlockPool(num_blocks, self._block_size)
        self._prefix = PrefixCache(self._blocks, prefix_cache_capacity)
        self._registry = telemetry.get_registry()
        self._requests = 0
        self._cache_hits = 0
        self._exported_blocks = 0
        self._draining = False

    def prefill_prompt(self, prompt) -> Dict:
        """Prefill `prompt` and return the block wire of its whole-block
        span: empty when its bucket leaves no whole block or the pool
        cannot cover it (the decode side then prefills locally). The
        wire's leaves are host tensors."""
        prompt = [int(token) for token in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self._max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) exceeds this prefill "
                f"replica's max_seq_len ({self._max_seq_len})")
        start = time.monotonic()
        with self._lock:
            wire, outcome = self._prefill_locked(prompt)
        self._registry.counter("serving/prefill_requests_total",
                               outcome=outcome).inc()
        self._registry.histogram("serving/prefill_build_seconds").observe(
            time.monotonic() - start)
        return wire

    def _prefill_locked(self, prompt):
        self._requests += 1
        prefill_len = int(self.engine.slot_prefill_len(len(prompt)))
        whole = prefill_len // self._block_size
        if whole < 1:
            return self._empty_wire(), "short"
        covered, hit_ids = self._prefix.lookup(prompt,
                                               whole * self._block_size)
        if covered == whole * self._block_size:
            # lookup does not retain: hold the blocks over the export.
            ids = list(hit_ids)
            self._blocks.retain(ids)
            self._cache_hits += 1
            outcome = "cached"
        else:
            ids = self._compute_blocks(prompt, prefill_len)
            if ids is None:
                return self._empty_wire(), "pool_full"
            outcome = "computed"
        try:
            wire = self._export(prompt, whole, ids[:whole])
        finally:
            # This request's references go; the prefix cache keeps the
            # whole blocks for the next sharer, a partial tail frees now.
            self._blocks.release(ids)
        self._exported_blocks += wire["n_blocks"]
        return wire, outcome

    def _compute_blocks(self, prompt, prefill_len: int):
        n_pack = -(-prefill_len // self._block_size)
        if n_pack > self._blocks.free_blocks:
            self._prefix.evict_for(n_pack)
        ids = self._blocks.allocate(n_pack)
        if ids is None:
            return None
        # The scheduler's blocking-admission prefill, so the blocks hold
        # the KV a local prefill computes.
        row_cache, _logits = self.engine.prefill(
            np.asarray(prompt[:prefill_len], np.int32)[None, :])
        self._pool = self.engine.pack_prefill(
            self._pool, np.asarray(ids, np.int32), row_cache, prefill_len,
            self._block_size)
        self._prefix.register(prompt, prefill_len, ids)
        return ids

    def _export(self, prompt, whole: int, ids) -> Dict:
        """The wire of one prompt's whole-block prefix: an entry a prefix
        length, LONGEST FIRST, so a receiver that clips hot-first under
        pool pressure keeps the whole span."""
        keys = prefix_keys(prompt, self._block_size, whole)
        index = {block: j for j, block in enumerate(ids)}
        entries = [{"key": keys[k - 1].hex(),
                    "blocks": [index[block] for block in ids[:k]]}
                   for k in range(whole, 0, -1)]
        width = max(1, min(self._blocks_per_slot, len(ids)))
        groups: List[Dict] = []
        for start in range(0, len(ids), width):
            chunk = list(ids[start:start + width])
            payload = _to_host(self.engine.extract_blocks(
                self._pool, chunk + [TRASH_BLOCK] * (width - len(chunk)),
                self._block_size))
            groups.append({"n_blocks": len(chunk),
                           "leaves": _wire_leaves(payload)})
        return {"schema_version": 1, "block_size": self._block_size,
                "group_width": width, "n_blocks": len(ids),
                "entries": entries, "groups": groups}

    def _empty_wire(self) -> Dict:
        return {"schema_version": 1, "block_size": self._block_size,
                "group_width": self._blocks_per_slot, "n_blocks": 0,
                "entries": [], "groups": []}

    def drain(self) -> None:
        with self._lock:
            self._draining = True

    def stats(self) -> Dict:
        with self._lock:
            snap = {
                "kind": "prefill",
                "draining": self._draining,
                "prefill_requests": self._requests,
                "prefill_cache_hits": self._cache_hits,
                "exported_blocks": self._exported_blocks,
                "block_size": self._block_size,
                "block_pool": {
                    "num_blocks": self._blocks.num_blocks,
                    "free_blocks": self._blocks.free_blocks,
                    "used_blocks": self._blocks.used_blocks,
                },
                "prefix_cache": {
                    "entries": self._prefix.entries,
                    "cached_blocks": self._prefix.cached_blocks,
                    "hits": self._prefix.hits,
                    "misses": self._prefix.misses,
                },
            }
        engine_stats = getattr(self.engine, "stats", None)
        if isinstance(engine_stats, dict):
            snap["decode_engine"] = dict(engine_stats)
        return snap


class PrefillServer:
    """The HTTP frontend over one PrefillWorker; one thread a connection,
    so a decode replica pulling a large wire never blocks another ship."""

    def __init__(self, worker: PrefillWorker, host: str = "127.0.0.1",
                 port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_prefill_handler(worker))
        self._httpd.daemon_threads = True
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.worker = worker

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        return f"{self._httpd.server_address[0]}:{self.port}"

    def start(self) -> str:
        with self._lifecycle:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever, name="prefill-http",
                    daemon=True)
                self._thread.start()
        _logger.info("prefill frontend listening on %s", self.endpoint)
        return self.endpoint

    def stop(self) -> None:
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            # shutdown() blocks forever unless serve_forever is running.
            self._httpd.shutdown()
            thread.join(timeout=10.0)
        self._httpd.server_close()


def _make_prefill_handler(worker: PrefillWorker):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _logger.debug("http %s", fmt % args)

        def _json(self, status: int, payload: dict) -> None:
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                snap = worker.stats()
                draining = bool(snap["draining"]) or preemption.requested()
                # queue_depth and active_slots keep a fleet registry's
                # load accounting uniform; a prefill replica has neither.
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    "status": "draining" if draining else "ok",
                    "kind": "prefill",
                    "queue_depth": 0,
                    "active_slots": 0,
                })
            elif self.path == "/stats":
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    **worker.stats(),
                    "signals": telemetry.signals_block(
                        prefixes=("serving/", "slo/", "telemetry/")),
                })
            elif self.path == "/metrics":
                body = telemetry.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 telemetry.PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/prefill":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = [int(token) for token in body["prompt"]]
            except (KeyError, TypeError, ValueError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            try:
                wire = worker.prefill_prompt(prompt)
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
                return
            self._json(200, encode_block_wire(wire))

    return Handler


def run_prefill(experiment, runtime=None) -> dict:
    """Task body of the ``prefill`` task type (JAX prefill.py:450-543):
    restore -> engine -> PrefillWorker -> frontend -> advertise
    ``{task}/prefill_endpoint`` -> serve until the preemption notice or
    ``serve_seconds``. Reads the same `ServingExperiment` as the decode
    replicas (model, checkpoint, paged block geometry, ``mesh_spec``: a
    tp replica's group is built and its shards restored as
    `run_serving`'s, JAX prefill.py:471-491). Returns the final stats
    (``endpoint``, ``ckpt_step`` and the worker's stats)."""
    from tf_yarn_tpu_torch import event

    if experiment.kv_layout != "paged":
        raise ValueError(
            "the prefill tier ships KV blocks; it needs "
            f"kv_layout='paged', got {experiment.kv_layout!r}")
    tier = parse_prefill_tier(experiment.prefill_tier or {})
    telemetry_task = task_name(runtime, "prefill")
    telemetry.enable_env_jsonl(telemetry_task)
    engine, step, replica = load_engine(experiment, "prefill")
    try:
        worker = PrefillWorker(
            engine, block_size=experiment.block_size,
            num_blocks=tier.num_blocks or experiment.num_blocks,
            prefix_cache_capacity=experiment.prefix_cache_capacity)
        server = PrefillServer(worker, experiment.host, experiment.port)
        endpoint = server.start()
        advertised = advertised_endpoint(experiment.host, server.port)
        if runtime is not None:
            event.prefill_endpoint_event(runtime.kv, runtime.task, advertised)
        _logger.info("prefill ckpt-%d on %s (advertised %s): block_size=%d",
                     step, endpoint, advertised, experiment.block_size)
        try:
            serve_until_stopped("prefill", experiment.serve_seconds,
                                worker.drain, poll=replica_poll(replica))
        finally:
            server.stop()
            stats = {"endpoint": advertised, "ckpt_step": step,
                     **worker.stats()}
            _logger.info("prefill done: %s", stats)
    finally:
        if replica is not None:
            replica.close()
        finish_replica(runtime, telemetry_task)
    return stats


# -- the decode side ----------------------------------------------------------

def _http_post_prefill(endpoint: str, prompt: List[int],
                       timeout_s: float) -> bytes:
    """POST the prompt to a prefill replica: the raw body on a 200, a
    ConnectionError otherwise. The default transport of `PrefillClient`
    (``post=`` takes another)."""
    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("POST", "/v1/prefill", json.dumps({"prompt": prompt}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise ConnectionError(
                f"/v1/prefill on {endpoint} answered {resp.status}")
        return payload
    finally:
        conn.close()


def kv_prefill_resolver(kv) -> Callable[[], Optional[str]]:
    """Discover the prefill replicas in the run's KV store — the
    ``*/prefill_endpoint`` advertisements of tasks that have not stopped
    (no stop event, no heartbeat tombstone) — and hand them out round
    robin."""
    from tf_yarn_tpu_torch import event

    state = {"next": 0}
    suffix = f"/{event.PREFILL_ENDPOINT}"

    def resolve() -> Optional[str]:
        try:
            keys = sorted(key for key in kv.keys("") if key.endswith(suffix))
        except Exception:
            return None
        endpoints = []
        for key in keys:
            task = key[:-len(suffix)]
            try:
                stopped = (
                    kv.get_str(f"{task}/{event.HEARTBEAT_STOPPED}") is not None
                    or kv.get_str(f"{task}/{event.STOP}") is not None)
                endpoint = None if stopped else kv.get_str(key)
            except Exception:
                _logger.debug("skipping unreadable prefill advertisement %s",
                              key, exc_info=True)
                continue
            if endpoint:
                endpoints.append(endpoint)
        if not endpoints:
            return None
        pick = endpoints[state["next"] % len(endpoints)]
        state["next"] += 1
        return pick

    return resolve


class PrefillClient:
    """Two-stage dispatch from a decode replica: ship a long prompt to the
    prefill tier, install the returned blocks, and let admission's prefix
    hit skip the shipped span.

    `maybe_ship` never raises and never blocks the scheduler's tick: it
    runs on the frontend's handler thread before `scheduler.submit`, and
    the import rides the scheduler's control queue. Below the threshold
    there is no hop; with no replica advertised, after a failed ship or
    import, or for an empty wire, the request prefills locally (a failed
    ship also quarantines the tier for ``backoff_s``). The stream is the
    same either way."""

    def __init__(self, config: PrefillTierConfig, scheduler, *,
                 block_size: int, kv=None, resolver=None,
                 clock=time.monotonic, post=None):
        self._config = config
        self._scheduler = scheduler
        self._block_size = int(block_size)
        self._resolver = resolver
        if self._resolver is None and kv is not None:
            self._resolver = kv_prefill_resolver(kv)
        self._clock = clock
        self._post = post or _http_post_prefill
        self._lock = threading.Lock()
        self._shipped_keys: set = set()
        self._quarantine_until = 0.0
        self._resolved: Optional[str] = None
        self._resolved_at: Optional[float] = None
        self._ships = 0
        self._shipped_blocks = 0
        self._shipped_wire_bytes = 0
        self._local_fallbacks = 0
        self._registry = telemetry.get_registry()

    def maybe_ship(self, prompt) -> str:
        """Offer one request's prompt to the tier; returns the outcome
        (the ``outcome`` label of ``serving/prefill_offload_total``).
        Never raises."""
        try:
            return self._ship([int(token) for token in prompt])
        except Exception:
            _logger.warning(
                "prefill offload failed unexpectedly; prefilling locally",
                exc_info=True)
            self._count("error", fallback=True)
            return "error"

    def _ship(self, prompt: List[int]) -> str:
        config = self._config
        max_k = max(0, (len(prompt) - 1) // self._block_size)
        if len(prompt) < config.offload_threshold or max_k < 1:
            # Not a candidate, and not counted: short prompts are the
            # common case and would drown the outcome signal.
            return "below_threshold"
        # The content key of the longest whole-block prefix this prompt
        # could ship (the caches' own chain): once shipped, later requests
        # hit the local prefix cache and the hop is waste.
        key = prefix_keys(prompt, self._block_size, max_k)[-1]
        now = self._clock()
        with self._lock:
            if key in self._shipped_keys:
                skip = "already_shipped"
            elif now < self._quarantine_until:
                skip = "backoff"
            else:
                skip = None
        if skip is not None:
            self._count(skip, fallback=(skip == "backoff"))
            return skip
        endpoint = self._resolve(now)
        if endpoint is None:
            # A tier scaled to zero: prefill locally at once, never a 503.
            self._count("no_replica", fallback=True)
            return "no_replica"
        started = self._clock()
        try:
            payload = self._post(endpoint, prompt, config.timeout_s)
            wire = decode_block_wire(json.loads(payload))
        except Exception as exc:
            _logger.info("prefill replica %s failed (%s); prefilling locally",
                         endpoint, exc)
            with self._lock:
                self._quarantine_until = self._clock() + config.backoff_s
                self._resolved = None
                self._resolved_at = None
            self._count("ship_failed", fallback=True)
            return "ship_failed"
        if not wire.get("n_blocks"):
            # The replica could not help (no whole block, pool full): a
            # local prefill, and no quarantine — the tier is healthy.
            self._count("empty_wire", fallback=True)
            return "empty_wire"
        try:
            result = self._scheduler.import_prefixes(wire)
        except Exception as exc:
            _logger.warning(
                "shipped prefix import refused (%s); prefilling locally", exc)
            self._count("import_failed", fallback=True)
            return "import_failed"
        elapsed = self._clock() - started
        imported = int(result.get("imported_blocks", 0))
        with self._lock:
            if len(self._shipped_keys) >= _SHIPPED_MEMO_CAP:
                self._shipped_keys.clear()
            self._shipped_keys.add(key)
            self._ships += 1
            self._shipped_blocks += imported
            self._shipped_wire_bytes += len(payload)
        self._registry.counter("serving/shipped_blocks_total").inc(imported)
        self._registry.counter("serving/shipped_wire_bytes_total").inc(
            len(payload))
        self._registry.histogram("serving/prefill_ship_seconds").observe(
            max(0.0, elapsed))
        self._count("shipped")
        return "shipped"

    def _resolve(self, now: float) -> Optional[str]:
        config = self._config
        if config.endpoint:
            return config.endpoint
        if self._resolver is None:
            return None
        with self._lock:
            if (self._resolved_at is not None
                    and now - self._resolved_at < config.resolve_ttl_s):
                return self._resolved
        try:
            endpoint = self._resolver()
        except Exception:
            endpoint = None
        with self._lock:
            self._resolved = endpoint
            self._resolved_at = now
        return endpoint

    def _count(self, outcome: str, fallback: bool = False) -> None:
        self._registry.counter("serving/prefill_offload_total",
                               outcome=outcome).inc()
        if fallback:
            with self._lock:
                self._local_fallbacks += 1

    def stats(self) -> Dict:
        with self._lock:
            return {
                "offload_threshold": self._config.offload_threshold,
                "ships": self._ships,
                "shipped_blocks": self._shipped_blocks,
                "shipped_wire_bytes": self._shipped_wire_bytes,
                "local_fallbacks": self._local_fallbacks,
            }
