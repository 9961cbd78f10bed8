"""Threaded HTTP JSON frontend of the ranker — counterpart of
`RankServer` in tf_yarn_tpu/ranking/server.py.

Same stdlib-only conventions as serving/server.py, different protocol:

* ``POST /v1/rank`` — body ``{"cat": [[ids...]], "dense": [[f...]],
  "priority": P, "timeout_s": T}``: one int id per categorical table
  and one float per dense feature, per row. Reply ``{"scores": [...],
  "request_id", "finish_reason"}`` — one float32 score per row, in row
  order. Wrong feature arity (or a batch beyond ``max_batch``) answers
  400 AT ADMISSION; a full admission queue answers 429 with
  ``Retry-After`` (backpressure, not buffering).
* ``GET /healthz`` — liveness: ``draining`` once the scheduler drains or
  the preemption notice fires (`preemption.requested()`), else ``ok``.
* ``GET /stats`` — scheduler snapshot + rank-engine stats and the
  telemetry signals.
* ``GET /metrics`` — Prometheus text exposition.

`run_ranking` is the ``rank`` task's body (tasks/rank.py): restore the
checkpoint into the experiment's model (or draw the seeded init), warm
up, start the scheduler and frontend, advertise ``{task}/rank_endpoint``
and serve until the preemption notice or ``serve_seconds``. Under
``mesh_spec=MeshSpec(tp=N)`` it first starts the replica's N-1
followers (`serving.tp_replica`), and each rank holds its rows of the
table.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tf_yarn_tpu_torch import preemption, telemetry
from tf_yarn_tpu_torch.ranking.scheduler import MicroBatchScheduler
from tf_yarn_tpu_torch.serving.request import QueueFull

_logger = logging.getLogger(__name__)


class _HTTPServer(ThreadingHTTPServer):
    # A listen backlog for a burst of concurrent callers: the stdlib's 5
    # drops the connections past it, and their clients retry a second
    # later (or see a reset) however idle the scheduler is.
    request_queue_size = 128


class RankServer:
    """The HTTP frontend over one MicroBatchScheduler; per-connection
    threaded so a slow client never blocks admissions."""

    def __init__(self, scheduler: MicroBatchScheduler,
                 host: str = "127.0.0.1", port: int = 0):
        handler = _make_handler(scheduler)
        self._httpd = _HTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.scheduler = scheduler

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
                    target=self._httpd.serve_forever, name="ranking-http",
                    daemon=True,
                )
                self._thread.start()
        _logger.info("ranking frontend listening on %s", self.endpoint)
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


def _make_handler(scheduler: MicroBatchScheduler):
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

        def do_GET(self):
            if self.path == "/healthz":
                snap = scheduler.stats()
                # As serving's /healthz: the preemption flag itself, not
                # only the drain a poll sets later (JAX ranking/server.py:
                # 101-118).
                draining = bool(snap["draining"]) or preemption.requested()
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    "status": "draining" if draining else "ok",
                    "queue_depth": snap["queue_depth"],
                    "queued_rows": snap["queued_rows"],
                })
            elif self.path == "/stats":
                self._json(200, {
                    "schema_version": telemetry.STATS_SCHEMA_VERSION,
                    **scheduler.stats(),
                    "signals": telemetry.signals_block(
                        prefixes=("ranking/", "rank_engine/",
                                  "slo/", "telemetry/"),
                    ),
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
            if self.path != "/v1/rank":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                cat = body["cat"]
                dense = body.get("dense")
                priority = int(body.get("priority", 0))
                timeout_s = body.get("timeout_s")
            except (KeyError, TypeError, ValueError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            trace_id = self.headers.get("X-Request-Id") or None
            try:
                with telemetry.span("ranking/submit", request_id=trace_id):
                    response = scheduler.submit(
                        cat, dense, priority=priority, timeout_s=timeout_s
                    )
            except QueueFull as exc:
                self._json(
                    429,
                    {"error": str(exc), "retry_after_s": exc.retry_after_s},
                    headers=(("Retry-After",
                              str(max(1, int(exc.retry_after_s)))),),
                )
                return
            except (TypeError, ValueError) as exc:
                # Feature-arity (and any malformed-array) rejection at
                # admission — the scheduler loop never sees the request.
                self._json(400, {"error": str(exc)})
                return
            wait = timeout_s + 5.0 if timeout_s else None
            try:
                scores = response.result(timeout=wait)
            except TimeoutError as exc:
                self._json(504, {"error": str(exc)})
                return
            self._json(200, {
                "scores": scores,
                "finish_reason": response.finish_reason,
                "request_id": response.request.id,
            }, headers=(
                (("X-Request-Id", trace_id),) if trace_id else ()
            ))

    return Handler


def run_ranking(experiment, runtime=None) -> dict:
    """Task body for a `RankingExperiment` (JAX ranking/server.py:189-315):
    params -> engine -> scheduler -> warmup -> frontend -> advertise ->
    serve. Returns the final stats snapshot (``endpoint``, ``ckpt_step``
    and the scheduler's stats).

    With ``model_dir`` the port checkpoint is restored into
    ``experiment.model`` (`inference._restore_params`). With
    ``model_dir=None`` the weights are the seeded init,
    ``model.init_weights(torch.Generator(device=model.device)
    .manual_seed(init_seed))`` as `models.dlrm.make_model` draws them,
    and the step is -1: every port replica with the same model and seed
    serves the same weights bit for bit. They are not the JAX package's
    weights for that seed — a torch generator cannot draw what
    ``jax.random`` draws — so a replica of each package agrees only over
    a checkpoint (`models.weights.dlrm_from_flax`).

    A ``mesh_spec`` over more than one device (JAX ranking/server.py:
    209-225): the replica's group first (``ranking/build_mesh``, the
    followers spawned; "ranking tensor-parallel: tp=N over N devices"),
    then every rank's rows of the table (``ranking/restore_params``: the
    step verified, each rank reading only its rows; or
    ``ranking/init_params``: the seeded init drawn whole on each rank, so
    the replica serves the one-device replica's weights bit for bit), by
    `serving.tp_replica.ranker_shard`. A lost follower ends the serve
    loop with `TPGroupError` (LOST_TASK), and the followers stop on
    every way out."""
    from tf_yarn_tpu_torch.serving.server import (
        finish_replica,
        replica_poll,
        task_name,
    )

    telemetry_task = task_name(runtime, "rank")
    telemetry.enable_env_jsonl(telemetry_task)
    engine, step, replica = _load_engine(experiment)
    try:
        return _serve(experiment, runtime, engine, step,
                      replica_poll(replica))
    finally:
        if replica is not None:
            replica.close()
        finish_replica(runtime, telemetry_task)


def _load_engine(experiment):
    """(engine, checkpoint step or -1, tp replica or None) of
    `run_ranking`."""
    import torch

    from tf_yarn_tpu_torch import inference
    from tf_yarn_tpu_torch.models.rank_engine import (
        DEFAULT_BATCH_BUCKETS,
        RankEngine,
    )

    from tf_yarn_tpu_torch import fs as fs_lib

    buckets = experiment.batch_buckets or DEFAULT_BATCH_BUCKETS
    spec = experiment.mesh_spec
    if experiment.model_dir is not None:
        # Restores from any fs URI; a task launched by a remote backend
        # refuses a host-local model_dir.
        fs_lib.check_model_dir_placement(experiment.model_dir)
    if spec is not None and spec.total_devices > 1:
        from tf_yarn_tpu_torch.serving import tp_replica

        with telemetry.span("ranking/build_mesh",
                            devices=spec.total_devices):
            replica = tp_replica.start(spec)
        _logger.info("ranking tensor-parallel: tp=%d over %d devices",
                     spec.tp, spec.total_devices)
        try:
            step = -1
            if experiment.model_dir is not None:
                with telemetry.span("ranking/restore_params"):
                    step = inference.verified_step(experiment.model_dir,
                                                   experiment.step)
                    engine = replica.load(
                        experiment.model.config,
                        builder=tp_replica.ranker_shard,
                        model_dir=experiment.model_dir, step=step,
                        batch_buckets=buckets)
            else:
                with telemetry.span("ranking/init_params",
                                    seed=experiment.init_seed):
                    engine = replica.load(
                        experiment.model.config,
                        builder=tp_replica.ranker_shard,
                        init_seed=experiment.init_seed, batch_buckets=buckets)
        except BaseException:
            replica.close()
            raise
        return engine, step, replica
    model = experiment.model
    if experiment.model_dir is not None:
        with telemetry.span("ranking/restore_params"):
            step = inference._restore_params(model, experiment.model_dir,
                                             experiment.step)
    else:
        with telemetry.span("ranking/init_params", seed=experiment.init_seed):
            model.init_weights(torch.Generator(device=model.device)
                               .manual_seed(int(experiment.init_seed)))
        step = -1
    return RankEngine(model, batch_buckets=buckets), step, None


def _serve(experiment, runtime, engine, step, poll) -> dict:
    from tf_yarn_tpu_torch import event
    from tf_yarn_tpu_torch.serving.server import (
        advertised_endpoint,
        serve_until_stopped,
    )

    scheduler = MicroBatchScheduler(
        engine,
        max_batch=experiment.max_batch,
        max_wait_ms=experiment.max_wait_ms,
        queue_capacity=experiment.queue_capacity,
        retry_after_s=experiment.retry_after_s,
    )
    if experiment.warmup:
        with telemetry.span("ranking/warmup"):
            warmed = engine.warmup(max_batch=experiment.max_batch)
        _logger.info("ranking warmup ran %d buckets", warmed)
    server = RankServer(scheduler, experiment.host, experiment.port)
    scheduler.start()
    endpoint = server.start()
    advertised = advertised_endpoint(experiment.host, server.port)
    if runtime is not None:
        event.rank_endpoint_event(runtime.kv, runtime.task, advertised)
    _logger.info(
        "ranking ckpt-%d on %s (advertised %s): max_batch=%d, "
        "max_wait_ms=%.1f, queue=%d", step, endpoint, advertised,
        experiment.max_batch, experiment.max_wait_ms,
        experiment.queue_capacity)
    try:
        serve_until_stopped("ranking", experiment.serve_seconds,
                            scheduler.drain, poll=poll)
    finally:
        server.stop()
        scheduler.close()
        stats = {"endpoint": advertised, "ckpt_step": step,
                 **scheduler.stats()}
        _logger.info("ranking done: %s", stats)
    return stats
