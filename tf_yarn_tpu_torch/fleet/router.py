"""Router HTTP task: one endpoint in front of N replicas — a copy of
tf_yarn_tpu/fleet/router.py.

The router exposes the same ``/v1/generate`` / ``/healthz`` / ``/stats``
surface as one replica (serving/server.py), while it owns replica
discovery, placement and failover. It relays bytes only: no model, no
device work (the router task's model is on the meta device).

Dispatch is path-aware: ``/v1/generate`` goes to generate replicas and
``/v1/rank`` to rank replicas, as declared by the KV suffix each replica
advertised under, and the policy picks only from
``registry.healthy(kind=...)``. Per request:

1. pick a healthy replica of the path's kind through the policy;
2. forward. Connect errors and 429s fail over to another replica within
   a :class:`~tf_yarn_tpu_torch.resilience.retry.RetryPolicy` budget (an
   upstream ``Retry-After`` is the backoff floor once every replica has
   been tried); a replica seen failing is ejected at once
   (``registry.report_failure``);
3. streaming passthrough: upstream token lines are re-chunked to the
   client as they arrive. A replica that dies mid-stream cannot be
   retried (the 200 is on the wire): the stream ends with a classified
   error line (``{"error": ..., "failure_kind": ...}``);
4. no healthy replica (or the budget spent): 503 with a ``Retry-After``
   header — the autoscaler's launch ETA when the kind's pool is empty.

A replica's deterministic 4xx (400, 404, 413) passes through verbatim:
retrying a user error elsewhere reproduces it.

`run_router` is the ``router`` task's body (tasks/router.py): a registry
over the cluster's serving, rank and prefill tasks, refreshed on a poll
loop, the monitor, the autoscaler when ``autoscale`` is set, and
``{task}/router_endpoint`` advertised; it serves until the preemption
notice or ``serve_seconds``.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.fleet.policy import make_policy
from tf_yarn_tpu_torch.fleet.registry import (
    KIND_GENERATE,
    KIND_RANK,
    Replica,
    ReplicaRegistry,
)
from tf_yarn_tpu_torch.resilience.retry import RetryPolicy
from tf_yarn_tpu_torch.resilience.taxonomy import FailureKind, classify_exception

_logger = logging.getLogger(__name__)

# Cap on any single failover backoff sleep: a router request handler
# must never hold its connection hostage to a long jitter tail.
MAX_FAILOVER_SLEEP_S = 5.0

# How long the router poll loop sleeps between registry refreshes; the
# refresh itself rate-limits per-replica probes by probe_interval_s.
POLL_S = 0.2

# Request path -> replica capability kind. The path IS the dispatch
# key: anything else 404s, and the policy only sees replicas whose
# advertised kind matches.
PATH_KINDS = {
    "/v1/generate": KIND_GENERATE,
    "/v1/rank": KIND_RANK,
}


class _UpstreamUnreachable(Exception):
    """Connect/read failure BEFORE any byte reached the client: safe to
    fail over to another replica."""

    def __init__(self, replica: Replica, cause: BaseException):
        super().__init__(f"replica {replica.task} unreachable: {cause}")
        self.replica = replica
        self.cause = cause


class _UpstreamBusy(Exception):
    """Upstream 429: that replica's admission queue is full; try
    another, carrying the Retry-After hint."""

    def __init__(self, replica: Replica, retry_after_s: float):
        super().__init__(f"replica {replica.task} busy")
        self.replica = replica
        self.retry_after_s = retry_after_s


class RouterServer:
    """The fleet frontend over one ReplicaRegistry (module docstring)."""

    def __init__(
        self,
        registry: ReplicaRegistry,
        policy=None,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        retries: int = 2,
        retry_after_s: float = 1.0,
        upstream_timeout_s: float = 600.0,
        monitor=None,
        autoscaler=None,
    ):
        self.registry = registry
        self.policy = policy if policy is not None else make_policy(
            "least_loaded"
        )
        self.retries = int(retries)
        self.retry_after_s = float(retry_after_s)
        self.upstream_timeout_s = float(upstream_timeout_s)
        # Optional fleet.FleetMonitor: when attached, its merged
        # aggregate rides /stats (the autoscaler input) and its
        # fleet/* gauges ride /metrics. Lifecycle belongs to the
        # caller (run_router starts/stops it around the serve loop).
        self.monitor = monitor
        # Optional fleet.FleetAutoscaler side-car: when attached, its
        # decision history rides /stats and an EMPTY pool's 503 carries
        # the (clamped) launch ETA as Retry-After — scale-from-zero
        # clients back off for as long as capacity actually takes to
        # arrive, not a fixed second. Lifecycle belongs to the caller.
        self.autoscaler = autoscaler
        self._metrics = telemetry.get_registry()
        self._routed: Dict[str, Dict[str, int]] = {}
        self._routed_lock = threading.Lock()
        self._seq_lock = threading.Lock()
        self._seq = 0
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        host = self._httpd.server_address[0]
        return f"{host}:{self.port}"

    def start(self) -> str:
        with self._lifecycle:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever, name="router-http",
                    daemon=True,
                )
                self._thread.start()
        _logger.info("router frontend listening on %s", self.endpoint)
        return self.endpoint

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        # Snapshot-under-lock: concurrent stop() calls each either own
        # the thread (and join it) or see None; join outside the lock.
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)

    # -- accounting ---------------------------------------------------------

    def _count(self, replica_task: str, outcome: str) -> None:
        with self._routed_lock:
            per = self._routed.setdefault(replica_task, {})
            per[outcome] = per.get(outcome, 0) + 1
        self._metrics.counter(
            "fleet/routed_requests_total",
            replica=replica_task, outcome=outcome,
        ).inc()

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def stats(self) -> dict:
        """Router snapshot for /stats and the task's flushed metrics."""
        with self._routed_lock:
            routed = {
                task: dict(outcomes)
                for task, outcomes in sorted(self._routed.items())
            }
        out = {
            "schema_version": telemetry.STATS_SCHEMA_VERSION,
            "role": "router",
            "policy": self.policy.name,
            "retries": self.retries,
            "routed_requests": routed,
            **self.registry.snapshot(),
            "signals": telemetry.signals_block(
                prefixes=("fleet/", "slo/", "telemetry/"),
            ),
        }
        if self.monitor is not None:
            out["fleet"] = self.monitor.aggregate()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out


def _make_handler(router: RouterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _logger.debug("router http %s", fmt % args)

        # -- helpers (same wire shapes as serving/server.py) -------------

        def _json(self, status: int, payload: dict, headers=()) -> None:
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def _raw(self, status: int, body: bytes,
                 content_type: str = "application/json",
                 headers=()) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def _chunk_raw(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def _end_chunks(self) -> None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        # -- routes ------------------------------------------------------

        def do_GET(self):
            if self.path == "/healthz":
                from tf_yarn_tpu_torch import preemption

                healthy = router.registry.healthy()
                draining = preemption.requested()
                by_kind: Dict[str, int] = {}
                for replica in healthy:
                    by_kind[replica.kind] = by_kind.get(
                        replica.kind, 0
                    ) + 1
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    "status": "draining" if draining else "ok",
                    "role": "router",
                    "healthy_replicas": len(healthy),
                    "healthy_by_kind": by_kind,
                })
            elif self.path == "/stats":
                self._json(200, router.stats())
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
            kind = PATH_KINDS.get(self.path)
            if kind is None:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw_body = self.rfile.read(length) or b"{}"
                body = json.loads(raw_body)
            except (TypeError, ValueError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            stream = bool(body.get("stream"))
            # Cross-task request id: honor a caller-supplied
            # X-Request-Id, mint one otherwise; forwarded to the
            # replica so both sides' spans (and the replica's
            # scheduler trace ring) carry the same id.
            trace_id = (self.headers.get("X-Request-Id")
                        or f"req-{uuid.uuid4().hex[:16]}")
            began = time.monotonic()
            outcome = "client_dropped"
            try:
                with telemetry.span("router/route", request_id=trace_id,
                                    path=self.path):
                    outcome = self._route(
                        raw_body, stream, self.path, kind, trace_id
                    )
            except (BrokenPipeError, ConnectionResetError):
                _logger.info("client dropped routed request")
            finally:
                # The router times what it routes, by path and
                # outcome.
                router._metrics.histogram(
                    "fleet/routed_request_seconds",
                    path=self.path, outcome=outcome,
                ).observe(time.monotonic() - began)

        # -- the routing loop --------------------------------------------

        def _route(self, raw_body: bytes, stream: bool,
                   path: str, kind: str, trace_id: str) -> str:
            # Per-request failover budget: connect errors and 429s each
            # consume from their kind's budget; deterministic jitter per
            # request sequence number.
            retry_policy = RetryPolicy.from_nb_retries(
                router.retries, seed=router._next_seq()
            )
            tried: set = set()
            busy_hint = 0.0
            last_error = "no healthy replica"
            while True:
                replica = router.policy.pick(
                    router.registry.healthy(kind=kind), exclude=tried
                )
                if replica is None:
                    if not tried:
                        # Maybe the view is just stale (all ejected, or
                        # never refreshed): one forced pass before 503.
                        router.registry.refresh(force=True)
                        if router.registry.healthy(kind=kind):
                            continue
                        self._no_replica(busy_hint, last_error, kind)
                        return "no_replica"
                    # Every healthy replica tried this pass: another
                    # round costs one TRANSIENT retry, backing off with
                    # jitter but never below the upstream Retry-After.
                    delay = retry_policy.next_delay(FailureKind.TRANSIENT)
                    if delay is None:
                        self._no_replica(busy_hint, last_error, kind)
                        return "no_replica"
                    time.sleep(
                        min(max(delay, busy_hint), MAX_FAILOVER_SLEEP_S)
                    )
                    tried.clear()
                    router.registry.refresh(force=True)
                    continue
                try:
                    outcome = self._forward(
                        replica, raw_body, stream, path, trace_id
                    )
                except _UpstreamUnreachable as exc:
                    router._count(replica.task, "connect_error")
                    router.registry.report_failure(replica.task, exc.cause)
                    tried.add(replica.task)
                    last_error = str(exc)
                    failure_kind = classify_exception(exc.cause)
                    if retry_policy.next_delay(failure_kind) is None:
                        self._no_replica(busy_hint, last_error, kind)
                        return "no_replica"
                    continue  # fail over immediately: different replica
                except _UpstreamBusy as exc:
                    router._count(replica.task, "busy")
                    tried.add(replica.task)
                    busy_hint = max(busy_hint, exc.retry_after_s)
                    last_error = (
                        f"replica {replica.task} backpressured (429)"
                    )
                    if retry_policy.next_delay(
                        FailureKind.TRANSIENT
                    ) is None:
                        self._no_replica(busy_hint, last_error, kind)
                        return "no_replica"
                    continue
                _logger.debug("routed request: %s", outcome)
                return outcome

        def _no_replica(self, busy_hint: float, last_error: str,
                        kind: str) -> None:
            # Counted BEFORE the response bytes go out: /stats read right
            # after a reply must already include it.
            router._count("-", "no_replica")
            retry_after = max(router.retry_after_s, busy_hint)
            body = {"retry_after_s": retry_after}
            if (
                router.autoscaler is not None
                and not router.registry.healthy(kind=kind)
            ):
                # Scale-from-zero: the kind's pool is EMPTY (not just
                # busy), so the honest Retry-After is the autoscaler's
                # launch ETA — how long a scaled-out replica takes to
                # become routable — not the fixed shed hint.
                eta = router.autoscaler.launch_eta_hint()
                retry_after = max(retry_after, eta)
                body["scale_out_eta_s"] = eta
            body["retry_after_s"] = retry_after
            body["error"] = (
                f"no {kind} replica available: "
                f"{last_error}; retry in ~{retry_after:.1f}s"
            )
            self._json(
                503,
                body,
                headers=(("Retry-After",
                          str(max(1, int(retry_after)))),),
            )

        def _forward(self, replica: Replica, raw_body: bytes,
                     stream: bool, path: str, trace_id: str) -> str:
            host, _, port = (replica.endpoint or "").rpartition(":")
            conn = http.client.HTTPConnection(
                host, int(port), timeout=router.upstream_timeout_s
            )
            router.registry.note_inflight(replica.task, +1)
            try:
                try:
                    conn.request(
                        "POST", path, raw_body,
                        {"Content-Type": "application/json",
                         "X-Request-Id": trace_id},
                    )
                    resp = conn.getresponse()
                except (OSError, http.client.HTTPException) as exc:
                    raise _UpstreamUnreachable(replica, exc) from exc
                if resp.status == 429:
                    try:
                        retry_after = float(
                            resp.getheader("Retry-After") or 1.0
                        )
                    except ValueError:
                        retry_after = 1.0
                    resp.read()
                    raise _UpstreamBusy(replica, retry_after)
                if not stream or resp.status != 200:
                    try:
                        payload = resp.read()
                    except (OSError, http.client.HTTPException) as exc:
                        # Died mid-body but nothing reached the client
                        # yet: still safe to fail over.
                        raise _UpstreamUnreachable(replica, exc) from exc
                    outcome = (
                        "ok" if resp.status == 200
                        else f"upstream_{resp.status}"
                    )
                    router._count(replica.task, outcome)
                    self._raw(
                        resp.status, payload,
                        resp.getheader("Content-Type")
                        or "application/json",
                        headers=(("X-Request-Id", trace_id),),
                    )
                    return outcome
                return self._forward_stream(replica, resp)
            finally:
                router.registry.note_inflight(replica.task, -1)
                conn.close()

        def _forward_stream(self, replica: Replica, resp) -> str:
            """Chunked passthrough: each upstream token line re-chunks
            to the client as it arrives (TTFT is the replica's plus one
            hop). Mid-stream upstream death cannot fail over — the 200
            is already on the wire — so the stream closes with a
            classified error line and the replica is ejected."""
            self.send_response(resp.status)
            self.send_header(
                "Content-Type",
                resp.getheader("Content-Type") or "application/jsonl",
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                saw_done = False
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    self._chunk_raw(line)
                    try:
                        saw_done = bool(json.loads(line).get("done"))
                    except ValueError:
                        saw_done = False
                if not saw_done:
                    # Premature EOF reads as a CLEAN end through
                    # http.client (readline's peek swallows
                    # IncompleteRead) — the protocol's closing
                    # {"done": true} line is the real termination
                    # signal, so its absence IS the mid-stream death.
                    raise ConnectionResetError(
                        "stream ended without its done line"
                    )
                router._count(replica.task, "ok")
                self._end_chunks()
                return "ok"
            except (OSError, http.client.HTTPException) as exc:
                kind = classify_exception(exc)
                _logger.warning(
                    "replica %s failed mid-stream (%s): %s",
                    replica.task, kind.value, exc,
                )
                router.registry.report_failure(replica.task, exc)
                router._count(replica.task, "stream_error")
                self._chunk_raw((json.dumps({
                    "error": (
                        f"replica {replica.task} failed mid-stream: {exc}"
                    ),
                    "failure_kind": kind.value,
                    "done": True,
                    "finish_reason": "error",
                }) + "\n").encode())
                self._end_chunks()
                return "stream_error"

    return Handler


def run_router(experiment, runtime) -> dict:
    """Task body for the ``router`` task type (JAX router.py:540-651):
    registry over the cluster's serving, rank and prefill tasks → policy
    → frontend → advertise → refresh loop. Returns the final router
    stats snapshot. It reads the experiment's ``router_*``,
    ``autoscale*``, ``slo``, ``retry_after_s`` and ``serve_seconds``,
    never its model."""
    from tf_yarn_tpu_torch import event, preemption
    from tf_yarn_tpu_torch.resilience.watchdog import dead_task_secs_from_env
    from tf_yarn_tpu_torch.serving.server import advertised_endpoint

    telemetry_task = getattr(
        runtime, "task",
        f"{runtime.task_key.type}:{runtime.task_key.id}",
    )
    telemetry.enable_env_jsonl(telemetry_task)
    serving_tasks = [
        instance.key.to_kv_str()
        for instance in getattr(runtime, "cluster_tasks", [])
        # prefill replicas never receive routed requests (PATH_KINDS is
        # the dispatch key and /v1/generate pulls from the tier), but
        # the registry tracks their health so the monitor merges their
        # signals and the autoscaler can size the tier.
        if instance.key.type in ("serving", "rank", "prefill")
    ] or None  # None -> discover by KV scan
    registry = ReplicaRegistry(
        runtime.kv,
        tasks=serving_tasks,
        probe_interval_s=experiment.router_probe_interval_s,
        dead_heartbeat_s=dead_task_secs_from_env(),
    )
    from tf_yarn_tpu_torch.fleet.monitor import FleetMonitor

    monitor = FleetMonitor(
        registry, slo=getattr(experiment, "slo", None),
    )
    autoscaler = None
    autoscale_spec = getattr(experiment, "autoscale", None)
    if autoscale_spec:
        from tf_yarn_tpu_torch.fleet.autoscaler import FleetAutoscaler

        def _advertise_desired(kind: str, current: int, target: int,
                               reason: str) -> bool:
            # The cluster actuator: publish the desired per-kind count
            # in the coordination KV, for the driver's elastic relaunch
            # (not in the port's driver yet: ROADMAP.md Queue 1 item
            # 5.1) or an operator to act on; the decision plane and the
            # actuator compose through re-admission, not a private RPC.
            event.fleet_desired_event(
                runtime.kv, runtime.task, kind, target, reason,
            )
            return True

        autoscaler = FleetAutoscaler(
            registry,
            monitor,
            autoscale_spec,
            actuate=_advertise_desired,
            launch_eta_s=getattr(
                experiment, "autoscale_launch_eta_s", None,
            ) or 15.0,
            warm_start=getattr(experiment, "autoscale_warm_start", True),
        )
    server = RouterServer(
        registry,
        make_policy(experiment.router_policy),
        experiment.router_host,
        experiment.router_port,
        retries=experiment.router_retries,
        retry_after_s=experiment.retry_after_s,
        monitor=monitor,
        autoscaler=autoscaler,
    )
    monitor.start()
    if autoscaler is not None:
        autoscaler.start()
    endpoint = server.start()
    advertised = advertised_endpoint(experiment.router_host, server.port)
    event.router_endpoint_event(runtime.kv, runtime.task, advertised)
    _logger.info(
        "router on %s (advertised %s): policy=%s over %s",
        endpoint, advertised, experiment.router_policy,
        serving_tasks or "KV-discovered replicas",
    )
    deadline = (
        time.monotonic() + experiment.serve_seconds
        if experiment.serve_seconds is not None else None
    )
    try:
        while True:
            if preemption.requested():
                _logger.info("router draining on preemption notice")
                break
            if deadline is not None and time.monotonic() >= deadline:
                _logger.info(
                    "serve_seconds=%.1f elapsed; router shutting down",
                    experiment.serve_seconds,
                )
                break
            registry.refresh()
            time.sleep(POLL_S)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        monitor.stop()
        server.stop()
        stats = {"endpoint": advertised, **server.stats()}
        _logger.info("router done: %s", stats)
        telemetry.flush_metrics(
            telemetry.get_registry(),
            kv=getattr(runtime, "kv", None),
            task=telemetry_task,
        )
        telemetry.export_trace(telemetry_task)
    return stats
