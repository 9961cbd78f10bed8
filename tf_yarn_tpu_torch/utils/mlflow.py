"""Optional MLflow integration — a copy of tf_yarn_tpu/utils/mlflow.py.

If mlflow is importable and a tracking URI is configured (or
``TPU_YARN_USE_MLFLOW`` forces it), log for real; otherwise every
operation is a no-op — as on the card's machine, which has no mlflow.
Connection errors never fail a run. Detection is memoized in
`use_mlflow()`.
"""

from __future__ import annotations

import functools
import logging
import os
import tempfile
import typing

_logger = logging.getLogger(__name__)

_USE_MLFLOW: typing.Optional[bool] = None


def _detect_mlflow() -> bool:
    """Env override first, then importability + tracking-URI check
    (reference: mlflow.py:27-46)."""
    forced = os.environ.get("TPU_YARN_USE_MLFLOW", "")
    if forced.lower() in ("false", "0", "no"):
        return False
    try:
        import mlflow  # noqa: F401
        from mlflow.exceptions import MlflowException  # noqa: F401
    except ImportError:
        if forced.lower() in ("true", "1", "yes"):
            _logger.warning("TPU_YARN_USE_MLFLOW set but mlflow is not installed")
        return False
    if forced.lower() in ("true", "1", "yes"):
        return True
    try:
        import mlflow.tracking

        return mlflow.tracking.is_tracking_uri_set()
    except Exception:
        return False


def use_mlflow() -> bool:
    global _USE_MLFLOW
    if _USE_MLFLOW is None:
        _USE_MLFLOW = _detect_mlflow()
    return _USE_MLFLOW


def optional_mlflow(return_default: typing.Any = None):
    """Decorator: run the body only when mlflow is active, and swallow
    connection errors (reference: mlflow.py:57-69)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not use_mlflow():
                return return_default
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                _logger.warning("mlflow call failed: %s", exc)
                return return_default

        return wrapper

    return decorator


@optional_mlflow(return_default="")
def active_run_id() -> str:
    import mlflow

    active = mlflow.active_run()
    if active is None:
        active = mlflow.start_run()
    return active.info.run_id


@optional_mlflow()
def get_tracking_uri() -> str:
    import mlflow

    return mlflow.get_tracking_uri()


@optional_mlflow()
def set_tag(key: str, value: typing.Any) -> None:
    import mlflow

    mlflow.set_tag(format_key(key), value)


@optional_mlflow()
def log_param(key: str, value: typing.Any) -> None:
    import mlflow

    mlflow.log_param(format_key(key), value)


@optional_mlflow()
def log_metric(key: str, value: float, step: typing.Optional[int] = None) -> None:
    import mlflow

    mlflow.log_metric(format_key(key), value, step)


def format_key(key: str) -> str:
    """MLflow forbids some characters in keys (reference: mlflow.py:126-131)."""
    return key.replace(":", "_").replace("/", "_") if key else ""


@optional_mlflow()
def save_text_to_mlflow(content: str, filename: str) -> None:
    """Upload text as an artifact via a temp file (reference: mlflow.py:133-144)."""
    import mlflow

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, filename)
        with open(path, "w") as handle:
            handle.write(content)
        mlflow.log_artifact(path)
