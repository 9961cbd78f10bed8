"""Deterministic fault injection, the substrate of the kill/recover tests
— a copy of tf_yarn_tpu/resilience/chaos.py.

Real failure handling can only be trusted if tests actually kill
things. This module plants seeded, deterministic faults at the
boundaries where production failures arrive — the train loop's host
boundary, the coordination KV wrapper, the checkpoint commit and the
serving replicas' poll loop — so end-to-end recovery tests run on the
CPU, reproducibly.

Spec grammar (``TPU_YARN_FAULT``, ``;``-separated clauses)::

    crash_at_step=N       raise InjectedFault (classified TRANSIENT) at
                          the train loop's host boundary of step N
    sigterm_at_step=N     deliver SIGTERM to this process at step N
                          (exercises the preemption drain path)
    lose_host_at_step=N   SIGKILL this process at step N — no stop
                          event, no drain: the driver sees a primary
                          task killed without a lifecycle close and
                          classifies the attempt LOST_TASK (the
                          elastic resize trigger). Optionally
                          task-qualified (``lose_host_at_step=5@worker:1``)
                          so exactly one host of a multi-host run dies
    kv_delay=P,SECS       before each KV client op, sleep SECS with
                          probability P (seeded RNG — deterministic
                          per process)
    truncate_ckpt=latest  after the next checkpoint commit, truncate its
                          largest payload file (the manifest then fails
                          verification on restore)
    preempt_replica_at=SECS[@TASK]
                          SECS after a serving replica's poll loop
                          starts, deliver it the preemption notice
                          (drain → /healthz "draining" → router
                          ejection — the fleet self-healing trigger).
                          ``@serving:1`` targets one replica; without a
                          task every replica sharing the process drains
    rate_step=SECS,FACTOR traffic shaping for trace generators: declare
                          that request arrival rate multiplies by
                          FACTOR at SECS into the trace (read through
                          `rate_step_plan()`, not an in-process hook)

``TPU_YARN_FAULT_SEED`` seeds the probabilistic clauses (default 0).

Injections are **armed only on attempt 0** (``TPU_YARN_N_TRY == 0``) and
each one-shot clause fires at most once per process — so a retried
attempt runs clean and a kill/recover test converges instead of
re-crashing forever. Production code paths call the ``on_*`` hooks
unconditionally; without ``TPU_YARN_FAULT`` they are a cached
None-check.

`truncate_checkpoint_payload` truncates a checkpoint tree on any
filesystem `fs` resolves, as the JAX one does through its `fs`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal
import threading
import time
from typing import Optional, Tuple

from tf_yarn_tpu_torch.constants import ENV_N_TRY, ENV_TASK_KEY

_logger = logging.getLogger(__name__)

ENV_FAULT = "TPU_YARN_FAULT"
ENV_FAULT_SEED = "TPU_YARN_FAULT_SEED"


class InjectedFault(RuntimeError):
    """A chaos-injected crash. Pre-classified TRANSIENT: it stands in for
    infra failures (hardware loss, runtime aborts), which the retry
    policy must back off on and relaunch through."""

    tpu_yarn_failure_kind = "TRANSIENT"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A parsed ``TPU_YARN_FAULT`` spec."""

    crash_at_step: Optional[int] = None
    sigterm_at_step: Optional[int] = None
    lose_host_at_step: Optional[int] = None
    lose_host_task: Optional[str] = None  # "type:id"; None = every task
    kv_delay: Optional[Tuple[float, float]] = None  # (probability, seconds)
    truncate_ckpt: Optional[str] = None  # "latest"
    preempt_replica_at: Optional[float] = None  # seconds into serving
    preempt_replica_task: Optional[str] = None  # "type:id"; None = every
    rate_step: Optional[Tuple[float, float]] = None  # (seconds, factor)
    seed: int = 0

    def any(self) -> bool:
        return any((
            self.crash_at_step is not None,
            self.sigterm_at_step is not None,
            self.lose_host_at_step is not None,
            self.kv_delay is not None,
            self.truncate_ckpt is not None,
            self.preempt_replica_at is not None,
            self.rate_step is not None,
        ))


def parse_fault_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the ``TPU_YARN_FAULT`` grammar; raises ValueError on clauses
    it doesn't understand (a typoed fault spec silently injecting nothing
    would make a chaos test vacuously green)."""
    fields = {"seed": seed}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        key, sep, value = clause.partition("=")
        key, value = key.strip(), value.strip()
        if not sep or not value:
            raise ValueError(f"malformed {ENV_FAULT} clause {clause!r}")
        try:
            if key in ("crash_at_step", "sigterm_at_step"):
                fields[key] = int(value)
            elif key == "lose_host_at_step":
                step_str, _, task = value.partition("@")
                fields[key] = int(step_str)
                if task:
                    fields["lose_host_task"] = task
            elif key == "kv_delay":
                prob, _, secs = value.partition(",")
                fields[key] = (float(prob), float(secs))
            elif key == "preempt_replica_at":
                secs_str, _, task = value.partition("@")
                fields[key] = float(secs_str)
                if fields[key] < 0:
                    raise ValueError(value)
                if task:
                    fields["preempt_replica_task"] = task
            elif key == "rate_step":
                secs_str, _, factor_str = value.partition(",")
                if not factor_str:
                    raise ValueError(value)
                secs, factor = float(secs_str), float(factor_str)
                if secs < 0 or factor <= 0:
                    raise ValueError(value)
                fields[key] = (secs, factor)
            elif key == "truncate_ckpt":
                if value != "latest":
                    raise ValueError(value)
                fields[key] = value
            else:
                raise ValueError(key)
        except ValueError as exc:
            raise ValueError(
                f"malformed {ENV_FAULT} clause {clause!r}: {exc}"
            ) from None
    return FaultPlan(**fields)


class _Injector:
    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.fired: set = set()


_lock = threading.Lock()
_injector_cache: Optional[_Injector] = None
_loaded = False


def _from_env() -> Optional[_Injector]:
    spec = os.environ.get(ENV_FAULT, "")
    if not spec:
        return None
    try:
        n_try = int(os.environ.get(ENV_N_TRY, "0") or 0)
    except ValueError:
        n_try = 0
    if n_try != 0:
        _logger.info(
            "%s set but attempt n_try=%d: faults armed on attempt 0 only",
            ENV_FAULT, n_try,
        )
        return None
    try:
        seed = int(os.environ.get(ENV_FAULT_SEED, "0") or 0)
    except ValueError:
        seed = 0
    plan = parse_fault_spec(spec, seed=seed)
    _logger.warning("chaos armed: %s", plan)
    return _Injector(plan)


def _active() -> Optional[_Injector]:
    global _injector_cache, _loaded
    if not _loaded:
        with _lock:
            if not _loaded:
                _injector_cache = _from_env()
                _loaded = True
    return _injector_cache


def configure(spec: str, seed: int = 0, n_try: int = 0) -> Optional[FaultPlan]:
    """Arm a fault plan explicitly (tests; cron-style chaos drivers).
    Mirrors the env gating: a non-zero `n_try` disarms."""
    global _injector_cache, _loaded
    with _lock:
        if n_try != 0:
            _injector_cache = None
        else:
            _injector_cache = _Injector(parse_fault_spec(spec, seed=seed))
        _loaded = True
    return _injector_cache.plan if _injector_cache else None


def reset() -> None:
    """Disarm and forget (between tests; the env is re-read lazily on the
    next hook call)."""
    global _injector_cache, _loaded
    with _lock:
        _injector_cache = None
        _loaded = False


def active() -> bool:
    return _active() is not None


# ---------------------------------------------------------------------------
# Injection points (called unconditionally from production code)
# ---------------------------------------------------------------------------


def on_train_step(step: int) -> None:
    """Train-loop host boundary: one call per completed step (or chunk of
    steps). May deliver SIGTERM (drain path) or raise InjectedFault."""
    inj = _active()
    if inj is None:
        return
    plan = inj.plan
    if plan.sigterm_at_step == step and "sigterm" not in inj.fired:
        inj.fired.add("sigterm")
        _logger.warning("chaos: delivering SIGTERM at step %d", step)
        os.kill(os.getpid(), signal.SIGTERM)
    if (
        plan.lose_host_at_step == step
        and "lose_host" not in inj.fired
        and (
            plan.lose_host_task is None
            or os.environ.get(ENV_TASK_KEY) == plan.lose_host_task
        )
    ):
        inj.fired.add("lose_host")
        _logger.warning(
            "chaos: losing this host (SIGKILL, no stop event) at step %d",
            step,
        )
        # SIGKILL on purpose: a lost host writes no stop event and runs
        # no drain — the exact signature the LOST_TASK classification
        # (and the elastic resize path) must be provoked by.
        os.kill(os.getpid(), signal.SIGKILL)
    if plan.crash_at_step == step and "crash" not in inj.fired:
        inj.fired.add("crash")
        raise InjectedFault(f"chaos: injected crash at step {step}")


def on_kv_op(op: str) -> None:
    """KV client wrapper: probabilistic latency injection per request."""
    inj = _active()
    if inj is None or inj.plan.kv_delay is None:
        return
    prob, secs = inj.plan.kv_delay
    if inj.rng.random() < prob:
        _logger.debug("chaos: delaying kv %s by %.3fs", op, secs)
        time.sleep(secs)


def on_replica_poll(task: str, elapsed_s: float) -> bool:
    """Serving poll-loop boundary: called once per loop iteration with
    the replica's task name and seconds since serving began. Returns
    True exactly ONCE (per matching task) when the plan's
    ``preempt_replica_at`` deadline has elapsed — the caller treats it
    as the preemption notice and drains (the same path a real notice
    takes), so the router ejects the replica before its socket dies."""
    inj = _active()
    if inj is None or inj.plan.preempt_replica_at is None:
        return False
    plan = inj.plan
    if plan.preempt_replica_task is not None \
            and plan.preempt_replica_task != task:
        return False
    if elapsed_s < plan.preempt_replica_at:
        return False
    key = f"preempt_replica:{task}"
    if key in inj.fired:
        return False
    inj.fired.add(key)
    _logger.warning(
        "chaos: injecting preemption notice for %s at %.2fs",
        task, elapsed_s,
    )
    return True


def rate_step_plan() -> Optional[Tuple[float, float]]:
    """The armed plan's ``rate_step`` clause (seconds, factor), or None.
    Trace generators (fleet load harnesses) consult this when
    synthesizing arrivals — pure read, nothing fires."""
    inj = _active()
    if inj is None:
        return None
    return inj.plan.rate_step


def on_checkpoint_commit(ckpt_uri: str) -> None:
    """Checkpoint commit boundary: called with the committed ckpt-<step>
    URI right after its manifest lands. ``truncate_ckpt=latest`` corrupts
    the largest payload file once — the manifest then disagrees with the
    bytes, which is exactly what a torn upload looks like."""
    inj = _active()
    if inj is None or inj.plan.truncate_ckpt != "latest":
        return
    if "truncate" in inj.fired:
        return
    inj.fired.add("truncate")
    truncate_checkpoint_payload(ckpt_uri)


def truncate_checkpoint_payload(ckpt_uri: str) -> Optional[str]:
    """Truncate the largest non-manifest file under `ckpt_uri` (a path or
    any URI `fs` resolves) to half its size (also used directly by
    corruption tests). Returns the relative path truncated, or None when
    the tree has no payload files."""
    from tf_yarn_tpu_torch import fs as fs_lib

    victim, victim_size = None, 0
    for rel, kind, size in sorted(fs_lib.tree(ckpt_uri)):
        if kind != fs_lib.FileType.File or os.path.basename(rel) \
                == "MANIFEST.json":
            continue
        if victim is None or size > victim_size:
            victim, victim_size = rel, size
    if victim is None or not victim_size:
        _logger.warning("chaos: nothing to truncate under %s", ckpt_uri)
        return None
    keep = victim_size // 2
    uri = fs_lib.join(ckpt_uri, victim)
    with fs_lib.open_input(uri) as stream:
        head = stream.read(keep)
    with fs_lib.open_output(uri) as stream:
        stream.write(head)
    _logger.warning(
        "chaos: truncated %s (%d -> %d bytes) under %s",
        victim, victim_size, keep, ckpt_uri,
    )
    return victim
