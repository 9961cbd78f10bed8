"""TensorBoard helpers for the tensorboard task — a copy of
tf_yarn_tpu/utils/tensorboard_utils.py: launch a TensorBoard server on
the run's model_dir, advertise its URL through the ``{task}/url`` event
the driver logs once, and bound the linger after training.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from tf_yarn_tpu_torch import event
from tf_yarn_tpu_torch.coordination.kv import KVStore

_logger = logging.getLogger(__name__)

DEFAULT_TERMINATION_TIMEOUT_SECONDS = 30


def get_termination_timeout() -> int:
    """Linger time after training stops: ``TB_TERMINATION_TIMEOUT_SECONDS``,
    the default where it is unset, negative or not an integer."""
    raw = os.environ.get("TB_TERMINATION_TIMEOUT_SECONDS")
    try:
        timeout = int(raw) if raw is not None else -1
    except ValueError:
        timeout = -1
    return timeout if timeout >= 0 else DEFAULT_TERMINATION_TIMEOUT_SECONDS


def url_event_name(task: str) -> str:
    return f"{task}/{event.URL}"


def start_tf_board(kv: KVStore, task: str, model_dir: str) -> Optional[object]:
    """Start `tensorboard.program.TensorBoard` on a free port and broadcast
    its URL. Returns the board, or None where tensorboard does not import
    or start (the run goes on without it)."""
    # The C++ protobuf backend parses events faster; only where it imports.
    try:
        from google.protobuf.pyext import _message  # noqa: F401

        os.environ.setdefault("PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION", "cpp")
    except ImportError:
        pass
    try:
        from tensorboard.program import TensorBoard

        board = TensorBoard()
        argv = ["tensorboard", "--logdir", model_dir, "--port", "0", "--bind_all"]
        extra = os.environ.get("TB_EXTRA_ARGS")
        if extra:
            argv.extend(extra.split())
        board.configure(argv)
        url = board.launch()
        event.url_event(kv, task, url)
        _logger.info("tensorboard serving %s at %s", model_dir, url)
        return board
    except Exception as exc:
        _logger.warning("could not start tensorboard: %s", exc)
        return None
