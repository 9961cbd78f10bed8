"""Threaded HTTP JSON frontend — counterpart of
tf_yarn_tpu/serving/server.py (`ServingServer`).

Stdlib only (`http.server`), the same wire protocol as the JAX package:

* ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new_tokens": N,
  "seed": S, "eos_token": E, "priority": P, "timeout_s": T, "tier":
  "interactive"|"standard"|"batch", "stream": bool}``. Non-streamed: one
  JSON reply with the token list. ``"stream": true``: chunked, one JSON
  line per token, closed by a ``{"done": true, ...}`` line. A full
  admission queue (or tier cap) answers 429 with ``Retry-After``; an
  unservable request answers 400.
* ``GET /healthz`` — liveness: ``draining`` once the scheduler drains or
  the preemption notice fires (`preemption.requested()`), else ``ok``.
* ``GET /stats`` — the scheduler snapshot plus the telemetry signals.
* ``GET /metrics`` — Prometheus text exposition.
* ``GET /v1/blocks[?limit=N]`` / ``POST /v1/blocks`` — the prefix warm
  start: GET exports the hottest prefix-cache entries with their KV
  blocks (`encode_block_wire`: content keys, base64 leaves, an int8
  pool's bytes as int8), POST installs a peer's export. 400 on a bad
  limit or a wire that does not decode; 409 on a dense replica or a
  wire whose block size or pool layout this replica cannot take. The
  wire is the JAX package's, so replicas of either package trade blocks.

With a `serving.prefill.PrefillClient` (``prefill_client=``),
``/v1/generate`` first offers a long prompt to the prefill tier
(`maybe_ship`, on the handler thread: HTTP and wire decoding only, the
import rides the scheduler's control queue) and ``/stats`` carries its
``prefill_offload`` counters.

`run_serving` is the ``serving`` task's body (tasks/serving.py): restore
the checkpoint into the experiment's model, build the engine, the slot
grid and the frontend, advertise ``{task}/serving_endpoint`` through the
KV store and serve until the preemption notice or ``serve_seconds``.
With ``mesh_spec=MeshSpec(tp=N)`` it first starts the replica's N-1
followers (`serving.tp_replica`), and each rank restores only its shards
(`load_engine`); the frontend and the scheduler run on rank 0, and the
followers stop with it.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from tf_yarn_tpu_torch import preemption, telemetry
from tf_yarn_tpu_torch.resilience import chaos
from tf_yarn_tpu_torch.serving.request import (
    DEFAULT_TIER,
    QueueFull,
    SamplingParams,
)
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

_logger = logging.getLogger(__name__)

# The dtypes a pool's leaves take, under numpy's names (as the JAX package
# writes them). numpy has no bfloat16: a bf16 leaf travels as its bits.
_WIRE_DTYPES = {"int8": torch.int8, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "float32": torch.float32}
_WIRE_NAMES = {dtype: name for name, dtype in _WIRE_DTYPES.items()}


def encode_block_wire(wire: dict) -> dict:
    """JSON-ready copy of a `SlotScheduler.export_hot_prefixes` snapshot:
    each payload leaf becomes ``{"dtype", "shape", "b64"}`` (None leaves
    stay null), byte for byte what the JAX package writes for the same
    values."""
    out = dict(wire)
    groups = []
    for group in wire.get("groups") or []:
        leaves = []
        for leaf in group["leaves"]:
            if leaf is None:
                leaves.append(None)
                continue
            leaf = leaf.detach().cpu().contiguous()
            bits = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 \
                else leaf
            leaves.append({"dtype": _WIRE_NAMES[leaf.dtype],
                           "shape": list(leaf.shape),
                           "b64": base64.b64encode(
                               bits.numpy().tobytes()).decode("ascii")})
        groups.append({"n_blocks": int(group["n_blocks"]), "leaves": leaves})
    out["groups"] = groups
    return out


def decode_block_wire(wire: dict) -> dict:
    """Inverse of `encode_block_wire`: CPU tensor leaves for
    `SlotScheduler.import_prefixes`. Raises on an unknown dtype or a
    byte count that does not fill the shape."""
    out = dict(wire)
    groups = []
    for group in wire.get("groups") or []:
        leaves = []
        for leaf in group["leaves"]:
            if leaf is None:
                leaves.append(None)
                continue
            name = leaf["dtype"]
            if name not in _WIRE_DTYPES:
                raise ValueError(f"unknown block wire dtype {name!r}")
            dtype = _WIRE_DTYPES[name]
            raw = bytearray(base64.b64decode(leaf["b64"]))
            bits = torch.int16 if dtype == torch.bfloat16 else dtype
            leaves.append(torch.frombuffer(raw, dtype=bits).view(dtype)
                          .reshape([int(n) for n in leaf["shape"]]))
        groups.append({"n_blocks": int(group["n_blocks"]), "leaves": leaves})
    out["groups"] = groups
    return out


class ServingServer:
    """The HTTP frontend over one SlotScheduler; one thread per
    connection, so a slow streaming client never blocks admissions."""

    def __init__(self, scheduler: SlotScheduler, host: str = "127.0.0.1",
                 port: int = 0, *, slo_evaluator=None, prefill_client=None):
        self._httpd = ThreadingHTTPServer(
            (host, port),
            _make_handler(scheduler, slo_evaluator, prefill_client))
        self._httpd.daemon_threads = True
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.scheduler = scheduler
        self.slo_evaluator = slo_evaluator
        self.prefill_client = prefill_client

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
                    target=self._httpd.serve_forever, name="serving-http",
                    daemon=True)
                self._thread.start()
        _logger.info("serving frontend listening on %s", self.endpoint)
        return self.endpoint

    def stop(self) -> None:
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            # shutdown() blocks forever unless serve_forever is running.
            self._httpd.shutdown()
            thread.join(timeout=10.0)
        self._httpd.server_close()


def _make_handler(scheduler: SlotScheduler, slo_evaluator=None,
                  prefill_client=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _logger.debug("http %s", fmt % args)

        def _json(self, status: int, payload: dict, headers=()) -> None:
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, payload: dict) -> None:
            data = (json.dumps(payload) + "\n").encode()
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/v1/blocks":
                try:
                    params = urllib.parse.parse_qs(query)
                    limit = (int(params["limit"][0])
                             if "limit" in params else None)
                except (TypeError, ValueError) as exc:
                    self._json(400, {"error": f"bad limit: {exc}"})
                    return
                try:
                    wire = scheduler.export_hot_prefixes(limit)
                except ValueError as exc:
                    # A dense replica (or a negative limit), as the JAX
                    # server answers it.
                    self._json(409, {"error": str(exc)})
                    return
                self._json(200, encode_block_wire(wire))
                return
            if self.path == "/healthz":
                snap = scheduler.stats()
                # "draining" the instant the preemption notice lands, not
                # only once a poll has drained the scheduler: a load
                # balancer must stop sending to a replica about to vanish
                # (JAX server.py:212-231).
                draining = bool(snap["draining"]) or preemption.requested()
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    "status": "draining" if draining else "ok",
                    "active_slots": snap["active_slots"],
                    "queue_depth": snap["queue_depth"],
                })
            elif self.path == "/stats":
                payload = {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    **scheduler.stats(),
                    "signals": telemetry.signals_block(
                        prefixes=("serving/", "slo/", "telemetry/")),
                }
                if slo_evaluator is not None:
                    payload["slo"] = slo_evaluator.report()
                if prefill_client is not None:
                    payload["prefill_offload"] = prefill_client.stats()
                self._json(200, payload)
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
            if self.path == "/v1/blocks":
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    wire = decode_block_wire(
                        json.loads(self.rfile.read(length) or b"{}"))
                except Exception as exc:
                    self._json(400, {"error": f"bad block wire: {exc}"})
                    return
                try:
                    result = scheduler.import_prefixes(wire)
                except Exception as exc:
                    # A dense replica, another block size or pool layout:
                    # refused, and the replica keeps serving.
                    self._json(409, {"error": str(exc)})
                    return
                self._json(200, result)
                return
            if self.path != "/v1/generate":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = body["prompt"]
                params = SamplingParams(
                    max_new_tokens=int(body.get("max_new_tokens", 128)),
                    temperature=float(
                        body.get("temperature", scheduler.temperature)),
                    top_k=body.get("top_k", scheduler.top_k),
                    top_p=body.get("top_p", scheduler.top_p),
                    seed=int(body.get("seed", 0)),
                    eos_token=body.get("eos_token"),
                )
            except (KeyError, TypeError, ValueError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            limit = scheduler.context_limit
            if len(prompt) + params.max_new_tokens > limit:
                self._json(400, {"error": (
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({params.max_new_tokens}) exceeds this server's "
                    f"context limit ({limit})")})
                return
            timeout_s = body.get("timeout_s")
            # Two-stage dispatch: the prompt's blocks come from the
            # prefill tier before the submit, so admission's prefix hit
            # skips the shipped span. Never raises: every failure
            # prefills locally.
            if prefill_client is not None:
                prefill_client.maybe_ship(prompt)
            trace_id = self.headers.get("X-Request-Id") or None
            try:
                with telemetry.span("serving/submit", request_id=trace_id,
                                    prompt_tokens=len(prompt)):
                    response = scheduler.submit(
                        prompt, params,
                        priority=int(body.get("priority", 0)),
                        timeout_s=timeout_s,
                        tier=str(body.get("tier", DEFAULT_TIER)),
                        trace_id=trace_id,
                    )
            except QueueFull as exc:
                self._json(
                    429, {"error": str(exc), "retry_after_s": exc.retry_after_s},
                    headers=(("Retry-After",
                              str(max(1, int(exc.retry_after_s)))),))
                return
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
                return

            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                if trace_id:
                    self.send_header("X-Request-Id", trace_id)
                self.end_headers()
                try:
                    for token in response.tokens():
                        self._chunk({"token": token})
                    self._chunk({
                        "done": True,
                        "finish_reason": response.finish_reason,
                        "request_id": response.request.id,
                        "n_tokens": len(response.result(timeout=0.0)),
                    })
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    _logger.info("client dropped streaming request %d",
                                 response.request.id)
                return

            wait = timeout_s + 5.0 if timeout_s else None
            try:
                tokens = response.result(timeout=wait)
            except TimeoutError as exc:
                self._json(504, {"error": str(exc)})
                return
            self._json(200, {
                "tokens": tokens,
                "finish_reason": response.finish_reason,
                "request_id": response.request.id,
                "ttft_s": response.ttft_s,
            }, headers=((("X-Request-Id", trace_id),) if trace_id else ()))

    return Handler


def _routable_host() -> str:
    """This machine's address as other hosts see it: the source address
    of a UDP socket connected to a public address (no packet is sent),
    or the FQDN where there is no route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.connect(("8.8.8.8", 80))
            return sock.getsockname()[0]
    except OSError:
        return socket.getfqdn()


def advertised_endpoint(bind_host: str, port: int) -> str:
    """The address peers dial for a frontend bound on `bind_host:port`:
    a wildcard bind advertises a routable interface instead."""
    if bind_host in ("0.0.0.0", "", "::"):
        return f"{_routable_host()}:{port}"
    return f"{bind_host}:{port}"


def task_name(runtime, default: str) -> str:
    """The telemetry task name of a task body: the runtime's ``task``
    (``type:id``), or `default` in process."""
    if runtime is None:
        return default
    return getattr(runtime, "task",
                   f"{runtime.task_key.type}:{runtime.task_key.id}")


def serve_until_stopped(name: str, serve_seconds: Optional[float], drain,
                        poll=None, task: Optional[str] = None) -> None:
    """The replicas' poll loop: return on the preemption notice (after
    `drain()`, which `/healthz` reports) or once `serve_seconds` have
    passed; `poll()` runs every round. Given the replica's `task` (the
    decode and prefill replicas', JAX server.py:528-536 and
    prefill.py:515-521), each round asks `chaos.on_replica_poll` too,
    whose injected notice (``TPU_YARN_FAULT`` preempt_replica_at) takes
    the real notice's drain path."""
    deadline = (time.monotonic() + serve_seconds
                if serve_seconds is not None else None)
    serve_began = time.monotonic()
    while True:
        if task is not None and chaos.on_replica_poll(
                task, time.monotonic() - serve_began):
            preemption.request()
        if preemption.requested():
            _logger.info("%s task draining on preemption notice", name)
            drain()
            return
        if deadline is not None and time.monotonic() >= deadline:
            _logger.info("serve_seconds=%.1f elapsed; shutting down",
                         serve_seconds)
            return
        if poll is not None:
            poll()
        time.sleep(0.2)


def finish_replica(runtime, telemetry_task: str) -> None:
    """A replica's way out: the registry to the log and ``{task}/metrics``
    (in a launched task), and the spans to ``TPU_YARN_TRACE``."""
    telemetry.flush_metrics(
        telemetry.get_registry(), kv=getattr(runtime, "kv", None),
        task=telemetry_task if runtime is not None else None)
    telemetry.export_trace(telemetry_task)


def load_engine(experiment, prefix: str):
    """(engine, checkpoint step, tp replica or None) of a replica task
    (`prefix` "serving" or "prefill" names its spans). One device: the
    checkpoint restored into ``experiment.model`` (`prefix`/
    restore_params). ``mesh_spec`` with more than one device (JAX
    server.py:434-463): the step verified first (`prefix`/
    restore_params: a digest of every byte, before any follower exists
    to wait on it under the group's timeout), then the group
    (`prefix`/build_mesh — the followers spawned), then every rank's
    shards of a model built on the meta device (`prefix`/
    shard_params)."""
    from tf_yarn_tpu_torch import inference
    from tf_yarn_tpu_torch.models.decode_engine import get_engine

    spec = getattr(experiment, "mesh_spec", None)
    if spec is None or spec.total_devices <= 1:
        with telemetry.span(f"{prefix}/restore_params"):
            step = inference._restore_params(
                experiment.model, experiment.model_dir, experiment.step)
        return get_engine(experiment.model), step, None
    from tf_yarn_tpu_torch.serving import tp_replica

    with telemetry.span(f"{prefix}/restore_params"):
        step = inference.verified_step(experiment.model_dir, experiment.step)
    with telemetry.span(f"{prefix}/build_mesh", devices=spec.total_devices):
        replica = tp_replica.start(spec)
    _logger.info("%s tensor-parallel: tp=%d over %d devices", prefix,
                 spec.tp, spec.total_devices)
    try:
        with telemetry.span(f"{prefix}/shard_params"):
            engine = replica.load(experiment.model.config,
                                  model_dir=experiment.model_dir, step=step)
    except BaseException:
        replica.close()
        raise
    return engine, step, replica


def replica_poll(replica, slo_evaluator=None):
    """The poll of a replica's serve loop: a lost tp rank raises
    (`tensor_parallel.TPGroupError`), and the SLOs are evaluated; None when
    there is nothing to poll."""
    if replica is None and slo_evaluator is None:
        return None

    def poll() -> None:
        if replica is not None:
            replica.check()
        if slo_evaluator is not None:
            slo_evaluator.maybe_evaluate()

    return poll


def run_serving(experiment, runtime=None) -> dict:
    """Task body for a `ServingExperiment` (JAX server.py:420-561):
    restore -> engine -> scheduler -> frontend -> advertise -> serve.
    Returns the final stats snapshot (``endpoint``, ``ckpt_step`` and the
    scheduler's stats).

    The checkpoint is restored into ``experiment.model`` on its device
    (`inference._restore_params`), or under a tp ``mesh_spec`` sharded
    over the replica's ranks (`load_engine`), whose followers stop on
    every way out. With ``prefill_tier`` on the paged
    layout, a `PrefillClient` pulls long prompts' blocks from the
    ``prefill`` tier it finds in the run's KV store. The poll loop asks
    `chaos.on_replica_poll` for an injected preemption notice. The
    model_dir placement check for remote filesystems waits for fs.py
    (ROADMAP.md Queue 1 item 5.4): model_dir is a local path."""
    telemetry_task = task_name(runtime, "serving")
    telemetry.enable_env_jsonl(telemetry_task)
    engine, step, replica = load_engine(experiment, "serving")
    try:
        return _serve(experiment, runtime, engine, step, replica,
                      telemetry_task)
    finally:
        if replica is not None:
            replica.close()
        finish_replica(runtime, telemetry_task)


def _serve(experiment, runtime, engine, step, replica,
           telemetry_task: str) -> dict:
    from tf_yarn_tpu_torch import event

    scheduler = SlotScheduler(
        engine,
        max_slots=experiment.max_slots,
        temperature=experiment.temperature,
        top_k=experiment.top_k,
        top_p=experiment.top_p,
        queue_capacity=experiment.queue_capacity,
        retry_after_s=experiment.retry_after_s,
        kv_layout=experiment.kv_layout,
        block_size=experiment.block_size,
        num_blocks=experiment.num_blocks,
        prefix_cache_capacity=experiment.prefix_cache_capacity,
        spec_k=experiment.spec_k,
        spec_draft=experiment.spec_draft,
        decode_attention=experiment.decode_attention,
        prefill_chunk=experiment.prefill_chunk,
        prefill_budget_per_tick=experiment.prefill_budget_per_tick,
        kv_host_blocks=experiment.kv_host_blocks,
        tier_caps=experiment.tier_caps,
    )
    slo_evaluator = None
    if experiment.slo:
        slo_evaluator = telemetry.SloEvaluator(
            telemetry.parse_slo(experiment.slo))
    prefill_client = None
    if experiment.prefill_tier is not None \
            and experiment.kv_layout == "paged":
        from tf_yarn_tpu_torch.serving.prefill import (
            PrefillClient,
            parse_prefill_tier,
        )

        prefill_client = PrefillClient(
            parse_prefill_tier(experiment.prefill_tier), scheduler,
            block_size=experiment.block_size,
            kv=getattr(runtime, "kv", None))
    server = ServingServer(scheduler, experiment.host, experiment.port,
                           slo_evaluator=slo_evaluator,
                           prefill_client=prefill_client)
    scheduler.start()
    endpoint = server.start()
    advertised = advertised_endpoint(experiment.host, server.port)
    if runtime is not None:
        event.serving_endpoint_event(runtime.kv, runtime.task, advertised)
    _logger.info(
        "serving ckpt-%d on %s (advertised %s): max_slots=%d, queue=%d",
        step, endpoint, advertised, experiment.max_slots,
        experiment.queue_capacity)
    try:
        serve_until_stopped("serving", experiment.serve_seconds,
                            scheduler.drain,
                            poll=replica_poll(replica, slo_evaluator),
                            task=telemetry_task)
    finally:
        server.stop()
        scheduler.close()
        stats = {"endpoint": advertised, "ckpt_step": step,
                 **scheduler.stats()}
        _logger.info("serving done: %s", stats)
    return stats
