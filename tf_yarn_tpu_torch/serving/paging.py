"""Host-side accounting for the paged KV layout: block pool + prefix cache.

The device half of paging lives in `models/decode_engine.py`
(`make_paged_pool` / `pack_prefill` / `paged_spec_step`): a global pool
of fixed-size KV blocks that the paged decode kernel reads through each
slot's block table. This module is the host half — pure bookkeeping, no device work:

* :class:`BlockPool` — the free-list + refcount ledger over physical
  block ids. Allocation pops from the free list; freeing a slot is
  O(blocks-held) integer decrements (the dense layout's `evict_slot`
  was an O(max_seq_len) device zeroing program). Physical block 0 is
  reserved as the *trash block*: inactive slots in the compiled step
  write their (masked-off) garbage row somewhere, and block 0 is the
  somewhere — it is never allocated, so the garbage never lands in a
  live slot's cache.

* :class:`PrefixCache` — maps a prompt's leading tokens to the block
  ids that already hold their prefilled KV, so a request sharing a
  prompt prefix (system prompt, few-shot header) maps its leading
  block-table entries to refcounted shared blocks instead of re-running
  prefill. Only *full* blocks are shared — the partial tail block of a
  prefill gets written by the owning slot's replay and must stay
  private — so sharing never needs copy-on-write: a slot's writes start
  at its own length, which lies beyond every shared (full) block.
  EVERY full-block prefix of a prefill is registered (an incremental
  blake2b token-hash per block keeps keys constant-size and the whole
  registration O(prompt tokens)), so two prompts sharing only a short
  system prompt still share those leading blocks. Entries are evicted
  LRU when the pool runs dry.

* :class:`HostBlockStore` — the host-RAM tier under the pool: parks a
  suspended stream's KV block payload (host tensors) under its request
  id, capacity counted in blocks.

The cache's `export_entries`/`register_imported` are the two halves of
the block wire (``GET``/``POST /v1/blocks``): the content keys are the
same on every replica, the JAX package's included.

All three classes are driven by the scheduler thread only; no locking
here.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Deque, Dict, List, Optional, Sequence, Tuple

TRASH_BLOCK = 0  # physical block 0: write target for masked-off slots


def prefix_keys(prompt: Sequence[int], block_size: int,
                max_k: int) -> List[bytes]:
    """One constant-size content key per whole-block prefix length
    (k = 1..max_k), computed incrementally — O(len(prompt)) hashing
    total, not O(len^2). The key format is the JAX package's, which its
    block wire uses across replicas."""
    digest = hashlib.blake2b(digest_size=16)
    keys = []
    for k in range(1, max_k + 1):
        for token in prompt[(k - 1) * block_size: k * block_size]:
            digest.update(int(token).to_bytes(8, "little", signed=True))
        keys.append(digest.copy().digest())
    return keys


class BlockPool:
    """Free-list + refcount ledger for `num_blocks` physical KV blocks.

    Block 0 (the trash block) is never handed out. A block is *free*
    iff its refcount is 0; `allocate` pops free ids, `retain`/`release`
    move refcounts for sharing (a prefix-cache entry and every slot
    using it each hold one reference).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: Deque[int] = collections.deque(range(1, num_blocks))
        self._refs: List[int] = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def allocate(self, n: int) -> Optional[List[int]]:
        """Pop `n` free block ids (each at refcount 1), or None if the
        pool cannot satisfy the request — the caller decides whether to
        evict prefix entries or hold the admission."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for block in ids:
            self._refs[block] = 1
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        for block in ids:
            if self._refs[block] <= 0:
                raise ValueError(f"retain of free block {block}")
            self._refs[block] += 1

    def release(self, ids: Sequence[int]) -> int:
        """Drop one reference per id; ids reaching refcount 0 return to
        the free list. Returns how many blocks became free."""
        freed = 0
        for block in ids:
            if self._refs[block] <= 0:
                raise ValueError(f"release of free block {block}")
            self._refs[block] -= 1
            if self._refs[block] == 0:
                self._free.append(block)
                freed += 1
        return freed

    def refcount(self, block: int) -> int:
        return self._refs[block]


class PrefixCache:
    """LRU map: token-hash of a whole-block prompt prefix -> the shared
    prefilled block ids.

    The cache holds ONE reference on every block of every entry (a
    block shared by several prefix lengths carries one reference per
    entry); slots admitted on a hit `retain` their own reference on
    top, so an entry can be evicted (cache references released) while
    in-flight requests still hold the blocks — they only truly free
    once the last slot retires. `lookup` returns the LONGEST cached
    prefix covering at most `max_tokens` tokens (the admission path
    must keep >= 1 prompt token to replay through the step program —
    the step consuming the last prompt token samples the first
    generated one).
    """

    def __init__(self, pool: BlockPool, capacity: int = 256):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.pool = pool
        self.capacity = int(capacity)
        # blake2b(prefix tokens) -> block ids; move_to_end keeps LRU.
        self._entries: "collections.OrderedDict[bytes, List[int]]" \
            = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def entries(self) -> int:
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
        """Distinct block ids the cache currently pins."""
        unique = set()
        for ids in self._entries.values():
            unique.update(ids)
        return len(unique)

    @property
    def hit_rate(self) -> float:
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0

    def _prefix_keys(self, prompt: Sequence[int], max_k: int) -> List[bytes]:
        return prefix_keys(prompt, self.pool.block_size, max_k)

    def lookup(self, prompt: Sequence[int],
               max_tokens: int) -> Tuple[int, List[int]]:
        """Longest cached prefix of `prompt` spanning <= max_tokens
        tokens: (covered token count, block ids). The caller must
        `pool.retain` the returned ids before using them. Counts one
        hit or miss per call."""
        bs = self.pool.block_size
        max_k = min(len(prompt), max_tokens) // bs
        for k, key in zip(
            range(max_k, 0, -1),
            reversed(self._prefix_keys(prompt, max_k)),
        ):
            ids = self._entries.get(key)
            if ids is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return k * bs, list(ids)
        self.misses += 1
        return 0, []

    def register(self, prompt: Sequence[int], n_tokens: int,
                 ids: Sequence[int]) -> bool:
        """Offer the first `n_tokens` tokens' blocks for sharing: one
        entry per whole-block prefix length, so a later prompt sharing
        only the first block (a short system prompt) still hits.
        Partial tails (written by the owner's replay) are never shared.
        Returns whether any entry was stored."""
        if self.capacity == 0:
            return False
        max_k = n_tokens // self.pool.block_size
        if max_k < 1:
            return False
        stored = False
        for k, key in enumerate(self._prefix_keys(prompt, max_k), start=1):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            kept = list(ids[:k])
            self.pool.retain(kept)
            self._entries[key] = kept
            stored = True
            if len(self._entries) > self.capacity:
                self._evict_one()
        return stored

    def export_entries(
        self, limit: Optional[int] = None
    ) -> List[Tuple[bytes, List[int]]]:
        """Most-recently-used first ``(content key, block ids)`` pairs,
        at most `limit` of them: what the warm-start donor ships. A view:
        no refcount moves."""
        if limit is not None and limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        items = list(self._entries.items())
        items.reverse()  # the OrderedDict iterates LRU first
        if limit is not None:
            items = items[:limit]
        return [(key, list(ids)) for key, ids in items]

    def register_imported(self, key: bytes, ids: Sequence[int]) -> bool:
        """Install a peer's entry under its content key. The caller holds
        its own reference on every id; the cache retains one more, as
        `register` does. False when the key is already cached (it moves
        to the MRU end) or the capacity is 0."""
        if self.capacity == 0:
            return False
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        kept = list(ids)
        self.pool.retain(kept)
        self._entries[key] = kept
        if len(self._entries) > self.capacity:
            self._evict_one()
        return True

    def _evict_one(self) -> int:
        key, ids = self._entries.popitem(last=False)  # LRU end
        return self.pool.release(ids)

    def evictable_blocks(self) -> int:
        """Blocks that eviction would return to the pool now: those whose
        every reference is a cache entry's. A resume evicts only when
        these cover its deficit."""
        membership: Dict[int, int] = {}
        for ids in self._entries.values():
            for block in ids:
                membership[block] = membership.get(block, 0) + 1
        return sum(1 for block, count in membership.items()
                   if self.pool.refcount(block) == count)

    def evict_for(self, n_blocks: int) -> int:
        """Release LRU entries until >= n_blocks are free in the pool
        (or the cache is empty). Returns blocks actually freed. Entries
        whose blocks are still held by in-flight slots free nothing
        immediately — they are dropped from the cache anyway, and their
        blocks return to the pool when the slots retire."""
        freed = 0
        while self._entries and self.pool.free_blocks < n_blocks:
            freed += self._evict_one()
        return freed

    def clear(self) -> int:
        freed = 0
        while self._entries:
            freed += self._evict_one()
        return freed



class HostBlockStore:
    """Host-RAM parking for suspended streams' KV block payloads, keyed by
    request id, with its capacity counted in blocks (so ``kv_host_blocks``
    composes with the device pool's ``num_blocks``). The payload is
    opaque to the store: the scheduler hands it the host copy of what
    `DecodeEngine.extract_blocks` gathered, in the pool's own dtype."""

    def __init__(self, capacity_blocks: int, block_size: int):
        if capacity_blocks < 0:
            raise ValueError(
                f"capacity_blocks must be >= 0, got {capacity_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.capacity_blocks = int(capacity_blocks)
        self.block_size = int(block_size)
        self._entries: "collections.OrderedDict[object, Tuple[int, object]]" \
            = collections.OrderedDict()
        self._used = 0

    @property
    def used_blocks(self) -> int:
        return self._used

    @property
    def free_blocks(self) -> int:
        return self.capacity_blocks - self._used

    @property
    def entries(self) -> int:
        return len(self._entries)

    def can_hold(self, n_blocks: int) -> bool:
        return n_blocks <= self.free_blocks

    def put(self, key, n_blocks: int, payload) -> None:
        """Park `payload` under `key`, charging `n_blocks`. A key already
        held or a charge over capacity is a bookkeeping bug (the
        scheduler asks `can_hold` first) and raises."""
        if key in self._entries:
            raise ValueError(f"host store already holds key {key!r}")
        if n_blocks < 0:
            raise ValueError(f"cannot store {n_blocks} blocks")
        if n_blocks > self.free_blocks:
            raise ValueError(
                f"host store over capacity: {n_blocks} blocks requested, "
                f"{self.free_blocks} free of {self.capacity_blocks}")
        self._entries[key] = (int(n_blocks), payload)
        self._used += int(n_blocks)

    def pop(self, key) -> Tuple[int, object]:
        """Remove and return ``(n_blocks, payload)``, freeing its charge."""
        n_blocks, payload = self._entries.pop(key)
        self._used -= n_blocks
        return n_blocks, payload

    def __contains__(self, key) -> bool:
        return key in self._entries
