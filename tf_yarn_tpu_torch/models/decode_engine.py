"""Decode engine — counterpart of tf_yarn_tpu/models/decode_engine.py.

PyTorch runs eagerly, so the JAX engine's compile cache (compiled
programs, fingerprints, program keys, the token bucket) has no
counterpart: the engine holds the model, the bucket grids and call
counters (`stats`). What it keeps, and where it differs:

* **`generate`** (decode_engine.py:1708-1838): the batch pads up to a
  bucket by repeating its last row, oversized batches go through the
  largest bucket in chunks, the prompt prefills at its floor bucket and
  its remainder replays one teacher-forced token at a time (no random
  draw before the last replay step), then the token loop of
  `models.generate.sample_tokens` runs on the host with the eos early
  exit. The dense cache is sized to prompt + max_new_tokens positions
  (the JAX cache holds max_seq_len; the positions past a row's index
  carry zero weight either way).
* **The dense slot grid** (`make_slot_cache`/`insert_slot`/`evict_slot`/
  `step`/`spec_step`): a `DenseKVCache` of ``max_slots`` rows, each at
  its own index. `step` advances every slot one token in one
  `Transformer.decode`; masked slots pass their token through and draw
  no random numbers.
* **The paged pool** (`make_paged_pool`): values ``[L, NB, bs, Hkv, D]``
  (int8 with f32 per-row scales, or the compute dtype); block 0 is the
  trash block. `pack_prefill` splices prefill rows into a slot's blocks
  IN PLACE, where the JAX engine donates the pool and returns the new
  one (the methods return the same pool object so callers read like the
  JAX ones). Two attention modes read it:

  - ``"gather"`` (`paged_step`, `paged_spec_step`): each slot's dense
    view is gathered through its table row, layer by layer and only up
    to the longest slot's end (`_GatheredView`), the same dense decode
    runs over it, and the window's rows are written back at
    ``table[pos // bs]``, offset ``pos % bs`` (past the table: the
    trash block);
  - ``"fused"`` (`paged_spec_step`, int8 only): `Transformer.
    paged_decode` attends straight off the pool.

* **Host-side acceptance and sampling.** After the one forward of a
  tick, `verify_window` (or the slot's sample) runs per active slot on
  the host, reading the slot's logits (the JAX engine keeps the
  accept/reject on the device). Each slot samples from its own
  `torch.Generator`, advanced once per emitted token.

* **Block moves** (`extract_blocks`/`inject_blocks`, the host swap tier
  and the block wire): the JAX engine pads both to the block-table width
  so that one compiled program serves every call; eager PyTorch has no
  compile key to keep, so they move exactly the ids they are given, one
  `index_select` (or `index_copy_`) over each stacked leaf.

* **Tensor-parallel decode** (``mesh=``, a mesh with a ``tp`` dim over
  a process group of ranks; JAX decode_engine.py:37-51, 929-982): the
  model's parameters are cut to the rank's heads, MLP columns and
  vocabulary rows (`parallel.tensor_parallel`), the slot grid and the
  block pool hold the rank's ``n_kv_heads / tp`` kv heads, and the
  row-parallel and vocabulary all-reduces and the logits gather run
  over the tp group, so every rank gets the whole logits. The engine
  on tp rank 0, the leader, announces each replicated op to the
  followers before running it (`parallel.tensor_parallel.Leader`); the
  followers (`follow`) run it on their heads and skip the host part
  (sampling, acceptance).
  `extract_blocks` returns the leader the whole heads, on its host,
  and `inject_blocks` takes them whole, so the block wire is the
  one-device wire. Both head counts must divide tp, with the JAX
  package's message, and ``decode_attention="fused"`` is refused at
  tp > 1, as the JAX engine refuses it (decode_engine.py:1611-1619).
  `generate` stays a one-device path (ROADMAP.md Queue 1 item 7e).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.models.generate import (
    _sample,
    as_prompt,
    check_length,
    sample_tokens,
)
from tf_yarn_tpu_torch.models.spec import verify_window
from tf_yarn_tpu_torch.models.transformer import (
    KV_NAMES,
    DenseKVCache,
    PagedKVPool,
    Transformer,
    pool_rows,
    require_int8_pool,
    zeroed_kv,
)
from tf_yarn_tpu_torch.parallel.tensor_parallel import (
    ReplicaEngine,
    replicated,
)

_logger = logging.getLogger(__name__)

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
DEFAULT_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

DECODE_ATTENTION_MODES = ("gather", "fused")


class KVRows(dict):
    """A prefill's cache rows (`Transformer.prefill`'s dict), as a type a
    tp leader can track: the followers free their rows when the leader's
    are dropped."""


# The heads axis of a block payload ``[L, n, bs, Hkv, *]``.
HEAD_AXIS = 3


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


class DecodeEngine(ReplicaEngine):
    """Serving-side decode for one `Transformer` (module docstring)."""

    def __init__(self, model: Transformer,
                 batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
                 prompt_buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
                 mesh=None):
        if getattr(getattr(model, "config", None), "moe_experts", 0):
            model.require_dense("DecodeEngine")
        self.mesh = mesh
        self.tp_degree = 1
        self.tp_rank = 0
        if mesh is not None:
            self._place(model, mesh)
        self.model = model
        self.batch_buckets = tuple(sorted(set(batch_buckets)))
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))
        gaps = [b2 - b1 for b1, b2 in zip(self.prompt_buckets,
                                          self.prompt_buckets[1:])]
        self._rest_width = max(gaps) if gaps else 1
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "calls": 0,
            "prefill_calls": 0,
            "step_calls": 0,
            "spec_step_calls": 0,
            "paged_step_calls": 0,
            "pack_calls": 0,
            "paged_spec_step_calls": 0,
            "extract_calls": 0,
            "inject_calls": 0,
            "unbucketed_shapes": 0,
            "oversize_batch_chunks": 0,
        }

    def _place(self, model, mesh) -> None:
        """Validate the model against the mesh as the JAX engine does
        (decode_engine.py:944-961, its messages), then cut a whole model
        to the rank's shards and join the group's control channel."""
        from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

        config = getattr(model, "config", None)
        if config is None or not hasattr(config, "max_seq_len"):
            raise ValueError(
                "DecodeEngine(mesh=...) needs a model with "
                "config.max_seq_len — the KV sharding rule anchors "
                "on the cache's sequence axis"
            )
        self.tp_degree = int(mesh_lib.mesh_axis_size(mesh, mesh_lib.AXIS_TP))
        for name in ("n_heads", "n_kv_heads"):
            value = getattr(config, name, None)
            if value is not None and value % self.tp_degree:
                raise ValueError(
                    f"model config {name}={value} does not divide "
                    f"over tp={self.tp_degree} — tensor-parallel "
                    "decode shards attention (and the KV cache) by "
                    "heads; pick a tp that divides both head counts"
                )
        if self.tp_degree == 1:
            return
        from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib

        if model.tp is None:
            tp_lib.shard(model, tp_lib.TensorParallel.of(mesh, mesh_lib.AXIS_TP))
        elif model.tp.size != self.tp_degree:
            raise ValueError(f"the model is cut over tp={model.tp.size}, the "
                             f"mesh has tp={self.tp_degree}")
        model.tp.trace = "serving/tp_allreduce"
        self.tp_rank = model.tp.rank
        self.join_replica(mesh, self.tp_rank, "serving/tp_header",
                          unsent=(PagedKVPool,))

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

    @replicated(keep=lambda result: result[0])
    def prefill(self, prompt) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """[B, F] prompt -> (row cache, last-position logits [B, V])
        (`Transformer.prefill`)."""
        tokens = as_prompt(prompt, self.device)
        self._count("prefill_calls")
        with telemetry.span("decode_engine/prefill", batch=tokens.shape[0],
                            prompt=tokens.shape[1]):
            logits, cache = self.model.prefill(tokens)
        return KVRows(cache), logits

    # -- generate ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 eos_token: Optional[int] = None) -> torch.Tensor:
        """Drop-in `generate`: [B, P] -> [B, P + max_new_tokens] int32 on
        the model's device (module docstring)."""
        if self.channel is not None:
            raise NotImplementedError(
                "DecodeEngine.generate runs on one device; a tensor-parallel "
                "replica serves through SlotScheduler (ROADMAP.md Queue 1 "
                "item 7e)")
        prompt = as_prompt(prompt_tokens, self.device)
        batch, prompt_len = prompt.shape
        check_length(self.model, prompt_len, max_new_tokens)
        if max_new_tokens == 0:
            return prompt.int()
        max_batch = self.batch_buckets[-1] if self.batch_buckets else None
        if max_batch is not None and batch > max_batch:
            # Through the largest bucket in chunks; each chunk draws from
            # its own seed-`seed` chain, as a direct call on it would.
            self._count("oversize_batch_chunks")
            telemetry.get_registry().counter(
                "decode_engine/oversize_batch_chunks").inc()
            _logger.info("decode-engine: batch %d exceeds largest bucket %d "
                         "— chunking into %d calls", batch, max_batch,
                         -(-batch // max_batch))
            return torch.cat([
                self.generate(prompt[i:i + max_batch], max_new_tokens,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed, eos_token=eos_token)
                for i in range(0, batch, max_batch)], dim=0)
        self._count("calls")
        telemetry.get_registry().counter("decode_engine/calls").inc()
        b_bucket, prefill_len = self.select_buckets(batch, prompt_len)
        if b_bucket != (_ceil_bucket(batch, self.batch_buckets) or -1) \
                or prefill_len != (_floor_bucket(prompt_len,
                                                 self.prompt_buckets) or -1):
            self._count("unbucketed_shapes")
            telemetry.get_registry().counter(
                "decode_engine/unbucketed_shapes").inc()
        padded = prompt
        if b_bucket > batch:
            # Pad rows repeat the last real row, so they take the same
            # numeric path as genuine inputs; they are sliced away.
            padded = torch.cat(
                [prompt, prompt[-1:].expand(b_bucket - batch, prompt_len)])
        rows, logits = self.prefill(padded[:, :prefill_len])
        cache = self.model.make_cache(b_bucket, prompt_len + max_new_tokens)
        cache.insert(rows)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        with telemetry.span("decode_engine/decode", batch=b_bucket):
            # Teacher-forced replay of the remainder: K/V appended, no
            # draw before the last step, whose logits sample the first
            # generated token (generate_legacy's prefill sample).
            for t in range(prefill_len, prompt_len):
                logits = self.model.decode(padded[:, t:t + 1], cache)[:, -1]
            first = _sample(logits, generator, temperature, top_k, top_p)
            out = sample_tokens(self.model, cache, first, max_new_tokens,
                                generator, temperature, top_k, top_p,
                                eos_token)
        return torch.cat([prompt, out[:batch]], dim=1).int()

    # -- sampling a tick's slots ---------------------------------------------

    def _sample_slots(self, logits: torch.Tensor, tokens: np.ndarray,
                      generators: List[Optional[torch.Generator]], mask,
                      temperature: float, top_k, top_p) -> np.ndarray:
        """One token per slot from logits [S, V]: sampled where `mask`,
        else the slot's input token passed through (no draw)."""
        emitted = np.asarray(tokens, np.int32).copy()
        mask = np.asarray(mask, bool)
        if temperature == 0.0:
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
            emitted[mask] = greedy[mask]
            return emitted
        for s in np.flatnonzero(mask):
            emitted[s] = int(_sample(logits[s:s + 1], generators[s],
                                     temperature, top_k, top_p)[0])
        return emitted

    def _verify_slots(self, logits: torch.Tensor, tokens: np.ndarray,
                      n_known, eos_ids, generators, active,
                      temperature: float, top_k, top_p):
        """`verify_window` per active slot over logits [S, W, V]:
        (emitted [S, W] int32, counts [S] int32)."""
        slots, width = tokens.shape
        emitted = np.zeros((slots, width), np.int32)
        counts = np.zeros((slots,), np.int32)
        for s in range(slots):
            if not active[s]:
                continue
            row, counts[s] = verify_window(
                logits[s], tokens[s].tolist(), int(n_known[s]),
                int(eos_ids[s]), generators[s], True, temperature, top_k,
                top_p)
            emitted[s] = row
        return emitted, counts

    # -- dense slot grid -------------------------------------------------------

    @replicated(keep=lambda result: result)
    def make_slot_cache(self, max_slots: int) -> DenseKVCache:
        """Zeroed per-slot KV grid: ``max_slots`` rows of ``max_seq_len``
        positions, each row at its own index (at the rank's kv heads)."""
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        return self.model.make_cache(max_slots)

    @replicated
    @torch.no_grad()
    def insert_slot(self, slot_cache: DenseKVCache, slot: int,
                    row_cache) -> DenseKVCache:
        """Splice a batch-1 prefill cache into slot `slot`, index
        included, IN PLACE (returns the grid)."""
        slot_cache.insert(row_cache, slot)
        return slot_cache

    @replicated
    @torch.no_grad()
    def evict_slot(self, slot_cache: DenseKVCache, slot: int) -> DenseKVCache:
        """Zero slot `slot` (KV content and index), IN PLACE."""
        slot_cache.evict(slot)
        return slot_cache

    @replicated
    @torch.no_grad()
    def step(self, slot_cache: DenseKVCache, tokens,
             generators: List[Optional[torch.Generator]], sample_mask,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None):
        """Advance every slot one token in one `Transformer.decode`.
        Returns (slot_cache, emitted [S] int32, generators); masked slots
        pass their input token through and draw nothing."""
        tokens = np.asarray(tokens, np.int64)
        self._count("step_calls")
        with telemetry.span("decode_engine/step", slots=len(tokens)):
            logits = self.model.decode(
                torch.as_tensor(tokens, device=self.device)[:, None],
                slot_cache)[:, -1]
            if self.follows:
                return slot_cache, None, None
            emitted = self._sample_slots(logits, tokens, generators,
                                         sample_mask, temperature, top_k,
                                         top_p)
        return slot_cache, emitted, generators

    @replicated
    @torch.no_grad()
    def spec_step(self, slot_cache: DenseKVCache, tokens, n_known, eos_ids,
                  generators: List[Optional[torch.Generator]], active,
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
        """Advance every slot up to W = tokens.shape[1] tokens: one
        windowed `Transformer.decode`, `verify_window` per active slot,
        then each active slot's index rewritten to its accepted length
        (old index + n_known + emitted); inactive slots keep theirs.
        Returns (slot_cache, emitted [S, W], counts [S], generators)."""
        tokens = np.asarray(tokens, np.int64)
        slots, width = tokens.shape
        self._count("spec_step_calls")
        with telemetry.span("decode_engine/spec_step", slots=slots,
                            width=width):
            index = slot_cache.index
            logits = self.model.decode(
                torch.as_tensor(tokens, device=self.device), slot_cache)
            slot_cache.index = index
            if self.follows:
                # The leader's next header advances each slot by its
                # accepted length (`tensor_parallel.Leader.defer`).
                return slot_cache, None, None, None
            emitted, counts = self._verify_slots(
                logits, tokens, n_known, eos_ids, generators, active,
                temperature, top_k, top_p)
            valid = np.where(np.asarray(active, bool),
                             np.asarray(n_known, np.int32) + counts, 0)
            valid = valid.astype(np.int32).tolist()
            slot_cache.advance(valid)
            if self.leader is not None:
                self.leader.defer(slot_cache, "advance", valid)
        return slot_cache, emitted, counts, generators

    # -- paged pool ------------------------------------------------------------

    @replicated(keep=lambda result: result)
    def make_paged_pool(self, num_blocks: int, block_size: int) -> PagedKVPool:
        """Zeroed block pool in the cache's dtype (int8 values with f32
        scales, or the compute dtype) at the rank's kv heads; block 0 is
        the reserved trash block."""
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), got {num_blocks}"
            )
        self.max_blocks_per_slot(block_size)
        cfg = self.model.config
        return PagedKVPool(**zeroed_kv(
            cfg, (cfg.n_layers, num_blocks, block_size), self.device,
            self.model.kv_heads))

    def max_blocks_per_slot(self, block_size: int) -> int:
        max_seq_len = self.model.config.max_seq_len
        if max_seq_len % block_size:
            raise ValueError(
                f"block_size={block_size} must divide max_seq_len={max_seq_len}"
            )
        return max_seq_len // block_size

    @replicated
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
        for name in KV_NAMES:
            leaf = getattr(pool, name)
            if leaf is None:
                continue
            rows = row_cache[name][:, 0, :prefill_len]  # [L, F, Hkv, *]
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
            leaf[:, ids] = rows.reshape(rows.shape[0], n_pack, block_size,
                                        *rows.shape[2:])
        return pool

    def _check_pool(self, pool: PagedKVPool, block_size: int) -> None:
        if pool.block_size != block_size:
            raise ValueError(
                f"block_size={block_size} does not match the pool's "
                f"{pool.block_size}"
            )

    @replicated
    @torch.no_grad()
    def paged_step(self, pool: PagedKVPool, tables, lengths, tokens,
                   generators: List[Optional[torch.Generator]], sample_mask,
                   block_size: int, temperature: float = 0.0,
                   top_k: Optional[int] = None, top_p: Optional[float] = None):
        """Advance every slot one token against the pool in the gather
        mode: the dense decode over each slot's gathered view, the new
        row written at ``table[length // bs]``, offset ``length % bs``
        (inactive slots carry table 0 and length 0: the trash block).
        Returns (pool, emitted [S] int32, generators)."""
        self._check_pool(pool, block_size)
        tokens = np.asarray(tokens, np.int64)
        self._count("paged_step_calls")
        with telemetry.span("decode_engine/paged_step", slots=len(tokens)):
            view = _GatheredView(pool, tables, lengths, 1, self.device)
            logits = self.model.decode(
                torch.as_tensor(tokens, device=self.device)[:, None],
                view)[:, -1]
            if self.follows:
                return pool, None, None
            emitted = self._sample_slots(logits, tokens, generators,
                                         sample_mask, temperature, top_k,
                                         top_p)
        return pool, emitted, generators

    @replicated
    @torch.no_grad()
    def paged_spec_step(
        self, pool: PagedKVPool, tables, lengths, tokens, n_known, eos_ids,
        generators: List[Optional[torch.Generator]], active,
        block_size: int, temperature: float = 0.0,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        decode_attention: str = "gather",
    ):
        """Advance every slot over its W = tokens.shape[1] window against
        the block pool: one forward — the gather mode's dense decode over
        gathered views, or the fused `Transformer.paged_decode` (int8
        only) — which writes the window's K/V rows into the pool in
        place (rows past a slot's table to the trash block), then the
        host-side accept/reject per slot. Returns (pool, emitted [S, W]
        int32, counts [S] int32, generators); each generator advanced
        once per emitted token."""
        if decode_attention not in DECODE_ATTENTION_MODES:
            raise ValueError(
                f"decode_attention must be one of {DECODE_ATTENTION_MODES}, "
                f"got {decode_attention!r}"
            )
        if decode_attention == "fused" and self.tp_degree > 1:
            raise ValueError(
                "decode_attention='fused' cannot run tensor-parallel "
                "yet: paged_int8_window_attention reads the whole block "
                "pool inside one pallas kernel and cannot read a "
                f"tp={self.tp_degree}-sharded pool; use "
                "decode_attention='gather' (XLA shards the gather "
                "path), or tp=1"
            )
        if decode_attention == "fused":
            require_int8_pool(self.model.config)
        self._check_pool(pool, block_size)
        dev = self.device
        tokens_np = np.asarray(tokens, np.int64)
        slots, width = tokens_np.shape
        tokens_t = torch.as_tensor(tokens_np, device=dev)
        self._count("paged_spec_step_calls")
        with telemetry.span("decode_engine/paged_spec_step", slots=slots,
                            width=width):
            if decode_attention == "fused":
                logits = self.model.paged_decode(
                    tokens_t, pool,
                    torch.as_tensor(np.asarray(tables, np.int32), device=dev),
                    torch.as_tensor(np.asarray(lengths, np.int32), device=dev))
            else:
                view = _GatheredView(pool, tables, lengths, width, dev)
                logits = self.model.decode(tokens_t, view)
            if self.follows:
                return pool, None, None, None
            emitted, counts = self._verify_slots(
                logits, tokens_np, n_known, eos_ids, generators, active,
                temperature, top_k, top_p)
        return pool, emitted, counts, generators

    # -- block moves (host swap tier, block wire) --------------------------

    def _block_ids(self, pool: PagedKVPool, block_ids,
                   block_size: int) -> torch.Tensor:
        self._check_pool(pool, block_size)
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        if len(ids) and not 0 <= ids.min() <= ids.max() < pool.num_blocks:
            raise ValueError(f"block ids must lie in [0, {pool.num_blocks}), "
                             f"got {ids.tolist()}")
        return torch.as_tensor(ids, device=pool.key.device)

    @replicated
    @torch.no_grad()
    def extract_blocks(self, pool: PagedKVPool, block_ids,
                       block_size: int) -> Optional[PagedKVPool]:
        """Gather pool blocks `block_ids` (n ids) into a payload: a
        `PagedKVPool` of n blocks, ``[L, n, bs, Hkv, *]`` in the pool's
        own dtype (an int8 pool's payload stays int8), on the pool's
        device. Read-only. On a tp replica every rank's heads are joined
        on the leader's host, in rank order (the followers get None)."""
        ids = self._block_ids(pool, block_ids, block_size)
        self._count("extract_calls")
        with telemetry.span("decode_engine/extract_blocks", blocks=len(ids)):
            payload = PagedKVPool(**{
                name: None if getattr(pool, name) is None
                else getattr(pool, name).index_select(1, ids)
                for name in KV_NAMES})
            if self.channel is None:
                return payload
            whole = {name: None if getattr(payload, name) is None
                     else self.channel.gather(getattr(payload, name),
                                              HEAD_AXIS)
                     for name in KV_NAMES}
            return None if self.follows else PagedKVPool(**whole)

    def _check_payload(self, pool: PagedKVPool, block_ids,
                       payload: PagedKVPool, block_size: int) -> None:
        """`inject_blocks`' checks of its arguments: the ids, and each
        leaf's shape — whole heads on a tp leader, which checks them
        before it announces the op."""
        ids = self._block_ids(pool, block_ids, block_size)
        for name in KV_NAMES:
            leaf, rows = getattr(pool, name), getattr(payload, name)
            if (leaf is None) != (rows is None):
                raise ValueError(
                    f"payload leaf {name!r} is "
                    f"{'missing' if rows is None else 'extra'} for this pool")
            if leaf is None:
                continue
            tail = tuple(leaf.shape[2:])
            tail = tail[:1] + (tail[1] * self.tp_degree,) + tail[2:]
            if tuple(rows.shape) != (leaf.shape[0], len(ids)) + tail:
                raise ValueError(
                    f"payload {name} has shape {tuple(rows.shape)}; this "
                    f"pool takes {(leaf.shape[0], len(ids))} + "
                    f"{tail} for {len(ids)} block ids")

    def _scatter_heads(self, payload: Optional[PagedKVPool],
                       pool: PagedKVPool, n_blocks: int) -> PagedKVPool:
        """This rank's heads of `n_blocks` whole-head blocks, on the host
        in the pool's dtypes: the leader cuts its `payload` by heads, in
        rank order; the followers pass None."""
        out = {}
        for name in KV_NAMES:
            leaf = getattr(pool, name)
            out[name] = None if leaf is None else self.channel.scatter(
                None if self.follows else getattr(payload, name),
                (leaf.shape[0], n_blocks) + tuple(leaf.shape[2:]),
                leaf.dtype, HEAD_AXIS)
        return PagedKVPool(**out)

    @replicated(precheck=_check_payload)
    @torch.no_grad()
    def inject_blocks(self, pool: PagedKVPool, block_ids, payload: PagedKVPool,
                      block_size: int) -> PagedKVPool:
        """Write payload block j into pool block ``block_ids[j]``, IN
        PLACE (returns the same pool). The payload (`extract_blocks`'s
        layout, host or device tensors) is cast to the pool's dtype, as
        the JAX engine's splice casts it. On a tp replica the leader's
        payload holds the whole heads, and each rank gets its own (the
        followers pass None)."""
        if self.channel is None:
            self._check_payload(pool, block_ids, payload, block_size)
        ids = self._block_ids(pool, block_ids, block_size)
        self._count("inject_calls")
        with telemetry.span("decode_engine/inject_blocks", blocks=len(ids)):
            if len(ids):
                if self.channel is not None:
                    payload = self._scatter_heads(payload, pool, len(ids))
                for name in KV_NAMES:
                    leaf = getattr(pool, name)
                    if leaf is not None:
                        leaf.index_copy_(1, ids, getattr(payload, name).to(
                            leaf.device, leaf.dtype))
        return pool

    # -- the replica's ranks ---------------------------------------------------

    @replicated
    def rank_report(self, reset_launches: bool = False) -> List[Dict]:
        """Each rank's serving-path kernel launches (`ops` wrappers'
        counts) and peak device memory, in rank order ([this rank] on one
        device; the followers get None); `reset_launches` zeroes the
        counts after reading them."""
        from tf_yarn_tpu_torch.ops import decode_attention, quantize, rmsnorm

        wrappers = (rmsnorm.rmsnorm, quantize.quantize_int8,
                    decode_attention.int8_decode_attention,
                    decode_attention.paged_int8_window_attention)
        cuda = self.device.type == "cuda"
        report = {"rank": self.tp_rank, "device": str(self.device),
                  "kv_heads": self.model.kv_heads,
                  "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                      self.device) if cuda else None),
                  "launches": {fn.__name__: fn.launches for fn in wrappers}}
        if reset_launches:
            for fn in wrappers:
                fn.launches = 0
        if self.channel is None:
            return [report]
        return self.channel.gather_objects(report)


class _GatheredView:
    """Each slot's dense cache view gathered from the pool through its
    table row (the JAX `_gather_slot_cache`), for `Transformer.decode`:
    layer by layer, only up to the longest slot's end — the values read
    are the same. The window's rows go into the view (this layer's
    attention reads them) and through the table into the pool, rows past
    the table into the trash block. Positions past a slot's length are
    stale pool rows, which the decode masks to zero weight."""

    def __init__(self, pool: PagedKVPool, tables, lengths, width: int,
                 device: torch.device):
        lengths = np.asarray(lengths, np.int32)
        tables = torch.as_tensor(np.asarray(tables, np.int32), device=device)
        block_size = pool.block_size
        span = int(lengths.max()) + width if len(lengths) else width
        n_blocks = min(-(-span // block_size), tables.shape[1])
        self.pool = pool
        self.index = torch.as_tensor(lengths, device=device)
        self._capacity = n_blocks * block_size
        self._view_tables = tables[:, :n_blocks].long()
        positions = self.index[:, None] + torch.arange(
            width, dtype=torch.int32, device=device)[None, :]
        self._blocks, self._offsets = pool_rows(tables, positions, block_size)

    def live_span(self, width: int) -> int:
        return self._capacity

    def append(self, layer: int, rows, positions: torch.Tensor):
        slots = positions.shape[0]
        batch = torch.arange(slots, device=positions.device)[:, None]
        positions = positions.clamp(max=self._capacity - 1).long()
        out = []
        for name, row in zip(KV_NAMES, rows):
            leaf = getattr(self.pool, name)
            if leaf is None:
                out.append(None)
                continue
            leaf = leaf[layer]  # [NB, bs, Hkv, *]
            view = leaf[self._view_tables].reshape(
                slots, self._capacity, *leaf.shape[2:])
            row = row.to(leaf.dtype)
            view[batch, positions] = row
            leaf[self._blocks, self._offsets] = row.reshape(-1, *row.shape[2:])
            out.append(view)
        return tuple(out)


_ENGINES: Dict[Tuple[int, int], DecodeEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(model: Transformer, mesh=None) -> DecodeEngine:
    """The shared engine for `model` on `mesh` (keyed by both
    identities: torch modules hold their weights, so two models are two
    engines)."""
    with _ENGINES_LOCK:
        key = (id(model), id(mesh))
        engine = _ENGINES.get(key)
        if engine is None or engine.model is not model \
                or engine.mesh is not mesh:
            engine = _ENGINES[key] = DecodeEngine(model, mesh=mesh)
        return engine
