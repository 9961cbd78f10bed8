"""Decode engine — the subset of tf_yarn_tpu/models/decode_engine.py that
the paged, fused serving scheduler calls.

PyTorch runs eagerly, so the JAX engine's compile cache has no
counterpart: the engine holds the model, the bucket grids and counters.
What it keeps, and where it differs:

* **Prompt bucketing.** `slot_prefill_len` floor-buckets a prompt over
  `DEFAULT_PROMPT_BUCKETS`, leaving at least the last prompt token to
  replay through width-1 ticks (it samples the first generated token).
* **The paged int8 pool** (`make_paged_pool`): values ``[L, NB, bs, Hkv,
  D]`` int8 plus per-row f32 scales ``[L, NB, bs, Hkv, 1]``; block 0 is
  the trash block. `pack_prefill` splices prefill rows ``[0,
  prefill_len)`` into a slot's blocks and `paged_spec_step` writes the
  window's rows — both IN PLACE, where the JAX engine donates the pool
  and returns the new one (they return the same pool object so callers
  read like the JAX ones).
* **Host-side acceptance** in `paged_spec_step`: one forward, then
  `verify_window` per active slot, each reading its slot's tokens back
  to the host (one sync per active slot; the JAX engine keeps the
  accept/reject on the device).

The dense slot grid (`make_slot_cache`/`insert_slot`/`evict_slot`/
`step`), `spec_step`, `paged_step`, the gather attention mode,
`generate`, `extract_blocks`/`inject_blocks` and tensor-parallel decode
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.models.spec import verify_window
from tf_yarn_tpu_torch.models.transformer import PagedKVPool, Transformer

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
DEFAULT_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

_DECODE_ITEM = "ROADMAP.md Queue 1, decode engine"


def _floor_bucket(value: int, buckets: Sequence[int]) -> Optional[int]:
    best = None
    for b in sorted(buckets):
        if b <= value:
            best = b
    return best


def _ceil_bucket(value: int, buckets: Sequence[int]) -> Optional[int]:
    for b in sorted(buckets):
        if b >= value:
            return b
    return None


class DecodeEngine:
    """Serving-side decode for one `Transformer` (module docstring)."""

    def __init__(self, model: Transformer,
                 batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
                 prompt_buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel decode is still to port (ROADMAP.md "
                "Queue 1, parallelism)"
            )
        self.model = model
        self.tp_degree = 1
        self.batch_buckets = tuple(sorted(set(batch_buckets)))
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))
        gaps = [b2 - b1 for b1, b2 in zip(self.prompt_buckets,
                                          self.prompt_buckets[1:])]
        self._rest_width = max(gaps) if gaps else 1
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "prefill_calls": 0,
            "pack_calls": 0,
            "paged_spec_step_calls": 0,
        }

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    # -- buckets -----------------------------------------------------------

    def select_buckets(self, batch: int, prompt_len: int) -> Tuple[int, int]:
        """(padded batch, prefill length) for a [B, P] batch: batch pads
        up, the prompt floors down (the remainder replays)."""
        b_bucket = _ceil_bucket(batch, self.batch_buckets) or batch
        p_bucket = _floor_bucket(prompt_len, self.prompt_buckets) or prompt_len
        if prompt_len - p_bucket > self._rest_width:
            p_bucket = prompt_len
        return b_bucket, p_bucket

    def slot_prefill_len(self, prompt_len: int) -> int:
        """The largest prompt bucket that leaves >= 1 prompt token to
        replay; 0 = no prefill (the whole prompt replays)."""
        if prompt_len <= 1:
            return 0
        return _floor_bucket(prompt_len - 1, self.prompt_buckets) or 0

    # -- prefill -----------------------------------------------------------

    def prefill(self, prompt) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """[B, F] prompt -> (int8 row cache, last-position logits [B, V])
        (`Transformer.prefill`)."""
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=self.device)
        self._count("prefill_calls")
        with telemetry.span("decode_engine/prefill", batch=tokens.shape[0],
                            prompt=tokens.shape[1]):
            logits, cache = self.model.prefill(tokens)
        return cache, logits

    # -- paged pool ----------------------------------------------------------

    def make_paged_pool(self, num_blocks: int, block_size: int) -> PagedKVPool:
        """Zeroed int8 block pool; block 0 is the reserved trash block."""
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), got {num_blocks}"
            )
        self.max_blocks_per_slot(block_size)
        cfg = self.model.config
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads)
        values = shape + (cfg.head_dim,)
        scales = shape + (1,)
        dev = self.device
        return PagedKVPool(
            key=torch.zeros(values, dtype=torch.int8, device=dev),
            value=torch.zeros(values, dtype=torch.int8, device=dev),
            key_scale=torch.zeros(scales, dtype=torch.float32, device=dev),
            value_scale=torch.zeros(scales, dtype=torch.float32, device=dev),
        )

    def max_blocks_per_slot(self, block_size: int) -> int:
        max_seq_len = self.model.config.max_seq_len
        if max_seq_len % block_size:
            raise ValueError(
                f"block_size={block_size} must divide max_seq_len={max_seq_len}"
            )
        return max_seq_len // block_size

    @torch.no_grad()
    def pack_prefill(self, pool: PagedKVPool, block_ids, row_cache,
                     prefill_len: int, block_size: int) -> PagedKVPool:
        """Splice positions [0, prefill_len) of a batch-1 prefill cache
        into `block_ids` (ceil(prefill_len / block_size) ids), IN PLACE.
        The tail of a partial last block is zero-filled, as the JAX
        package's padded splice leaves it."""
        n_pack = -(-prefill_len // block_size)
        ids = torch.as_tensor(np.asarray(block_ids), dtype=torch.long,
                              device=self.device)
        if tuple(ids.shape) != (n_pack,):
            raise ValueError(
                f"pack_prefill needs {n_pack} block ids for "
                f"prefill_len={prefill_len}, got shape {tuple(ids.shape)}"
            )
        self._count("pack_calls")
        pad = n_pack * block_size - prefill_len
        for name in ("key", "value", "key_scale", "value_scale"):
            rows = row_cache[name][:, 0, :prefill_len]  # [L, F, Hkv, *]
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
            rows = rows.reshape(rows.shape[0], n_pack, block_size,
                                *rows.shape[2:])
            getattr(pool, name)[:, ids] = rows
        return pool

    @torch.no_grad()
    def paged_spec_step(
        self, pool: PagedKVPool, tables, lengths, tokens, n_known, eos_ids,
        generators: List[Optional[torch.Generator]], active,
        block_size: int, temperature: float = 0.0,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        decode_attention: str = "fused",
    ):
        """Advance every slot over its W = tokens.shape[1] window against
        the block pool: one forward (`Transformer.paged_decode`, which
        writes the window's K/V rows into the pool in place), then the
        host-side accept/reject per slot. Returns (pool, emitted
        [S, W] int32, counts [S] int32, generators); each generator
        advanced once per emitted token."""
        if decode_attention != "fused":
            raise NotImplementedError(
                f"decode_attention={decode_attention!r}: the gather mode is "
                f"still to port ({_DECODE_ITEM}); the port runs 'fused'"
            )
        if pool.block_size != block_size:
            raise ValueError(
                f"block_size={block_size} does not match the pool's "
                f"{pool.block_size}"
            )
        dev = self.device
        tokens_np = np.asarray(tokens, np.int64)
        tables_t = torch.as_tensor(np.asarray(tables, np.int32), device=dev)
        lengths_t = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        slots, width = tokens_np.shape
        self._count("paged_spec_step_calls")
        with telemetry.span("decode_engine/paged_spec_step", slots=slots,
                            width=width):
            logits = self.model.paged_decode(
                torch.as_tensor(tokens_np, device=dev), pool, tables_t,
                lengths_t)
            emitted = np.zeros((slots, width), np.int32)
            counts = np.zeros((slots,), np.int32)
            for s in range(slots):
                if not active[s]:
                    continue
                row, counts[s] = verify_window(
                    logits[s], tokens_np[s].tolist(), int(n_known[s]),
                    int(eos_ids[s]), generators[s], True, temperature,
                    top_k, top_p,
                )
                emitted[s] = row
        return pool, emitted, counts, generators

    # -- not ported yet ------------------------------------------------------

    def _not_ported(self, name: str, item: str = _DECODE_ITEM):
        raise NotImplementedError(f"DecodeEngine.{name} is still to port ({item})")

    def make_slot_cache(self, *args, **kwargs):
        self._not_ported("make_slot_cache (dense KV layout)")

    def insert_slot(self, *args, **kwargs):
        self._not_ported("insert_slot (dense KV layout)")

    def evict_slot(self, *args, **kwargs):
        self._not_ported("evict_slot (dense KV layout)")

    def step(self, *args, **kwargs):
        self._not_ported("step (dense KV layout)")

    def spec_step(self, *args, **kwargs):
        self._not_ported("spec_step (dense KV layout)")

    def paged_step(self, *args, **kwargs):
        self._not_ported("paged_step (gather attention)")

    def generate(self, *args, **kwargs):
        self._not_ported("generate")

    def extract_blocks(self, *args, **kwargs):
        self._not_ported("extract_blocks", "ROADMAP.md Queue 1, serving")

    def inject_blocks(self, *args, **kwargs):
        self._not_ported("inject_blocks", "ROADMAP.md Queue 1, serving")


_ENGINES: Dict[int, DecodeEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(model: Transformer, mesh=None) -> DecodeEngine:
    """The shared engine for `model` (keyed by identity: torch modules
    hold their weights, so two models are two engines)."""
    with _ENGINES_LOCK:
        engine = _ENGINES.get(id(model))
        if engine is None or engine.model is not model:
            engine = _ENGINES[id(model)] = DecodeEngine(model, mesh=mesh)
        return engine
