"""Start the run's coordination server — counterpart of
tf_yarn_tpu/coordination/server_factory.py, Python only.

The JAX package prefers its native ``coordd`` when the binary is built
and falls back to :class:`~tf_yarn_tpu_torch.coordination.kv.KVServer`.
The port never probes for ``coordd`` (ROADMAP.md Queue 1 item 5): it
starts the Python server, which speaks the same wire.
"""

from __future__ import annotations

from tf_yarn_tpu_torch.coordination.kv import KVServer


def start_best_server(host: str = "127.0.0.1") -> KVServer:
    return KVServer(host).start()
