"""The coordination service (KV store, blocking waits, event log) —
counterpart of tf_yarn_tpu/coordination/."""

from tf_yarn_tpu_torch.coordination.kv import (
    InProcessKV,
    KVClient,
    KVServer,
    KVStore,
    KVTimeoutError,
)

__all__ = [
    "InProcessKV",
    "KVClient",
    "KVServer",
    "KVStore",
    "KVTimeoutError",
]
