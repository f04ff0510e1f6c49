"""Prefix KV-cache reuse: the port of `accelerate_tpu.serving.prefix_cache`, a
block pool behind a host radix trie.

Serving traffic shares prefixes (system prompts, few-shot templates,
multi-turn history); without this cache every admission prefills its prompt
from token 0. With it (SGLang's RadixAttention, as the reference adapts it):

  - KV is kept in fixed blocks of ``block_tokens`` tokens (a power of two,
    default 16);
  - a host-side radix trie maps token-id prefixes to blocks, one node per
    block keyed by the block's token tuple. A node is ref-counted while an
    admitted request uses it, and evicted in deterministic LRU order (a
    monotonic touch counter, never the wall clock) when the pool is full;
    only unpinned leaves are evictable, so a pinned long prefix keeps its
    whole chain;
  - admission takes a longest-prefix match (`PrefixCache.acquire`, which
    pins), and only the uncached suffix is prefilled;
  - retirement donates the finished slot's prompt blocks back under the
    trie key. The engine never donates a poisoned slot.

Two modes, as in the reference:

  - slot mode (the engine's slot pool): this class owns a block pool
    mirroring the slot cache's leaves (`models.kv_cache.make_prefix_block_pool`,
    int8 payload and scales included). A hit is a copy: the engine gathers
    the matched blocks into the admitted rows
    (`models.kv_cache.gather_block_rows`), and `insert` copies a retired
    row's new blocks into the pool in one indexed write per leaf
    (`models.kv_cache.scatter_block_rows`);
  - paged mode (``allocator=``, the engine's `models.kv_cache.BlockAllocator`):
    the engine's paged pool is the pool, and this class holds no device
    state. A hit aliases the trie's blocks in the slot's block table (zero
    copy), donation is `adopt` (ownership of blocks the slot already wrote
    moves to the trie), and eviction hands blocks back to the allocator
    (`reclaim`).

A prefix starts at token 0, so a cached block always sits at the same
absolute positions, with its position embeddings baked in: it is valid for
every request that shares those tokens.

Paged mode with the engine's host-RAM tier (``kv_tier=``, `serving.kv_tier`)
sets the ``tier`` hook: a spilled node stays in the trie with ``block_id =
None``, a match pages its spilled nodes back in before pinning them
(`KVTier.ensure_resident`), donation onto a spilled node takes the slot's
fresh block instead (`KVTier.revive`), eviction passes spilled nodes by, and
`memory_stats` counts them under ``host_tier``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from ..models.kv_cache import (
    PagedKVCache,
    SlotKVCache,
    make_prefix_block_pool,
    scatter_block_rows,
    tree_nbytes,
)


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Knobs for the engine's ``prefix_cache=`` argument.

    ``block_tokens`` is the reuse granularity: a match is a whole number of
    blocks, so smaller blocks reuse more of a shared prefix and spend more
    trie nodes per prompt. A power of two dividing ``n_positions`` (in paged
    mode it must equal the pool's). ``num_blocks`` sizes the slot-mode pool;
    None derives ``2 * max_concurrency * (n_positions / block_tokens)``,
    twice the slot pool's KV, so the hot prefixes survive slot churn before
    LRU pressure starts."""

    block_tokens: int = 16
    num_blocks: int | None = None


class _TrieNode:
    """One cached block: a radix-trie edge keyed by the block's token tuple."""

    __slots__ = ("key", "parent", "children", "block_id", "ref", "last_used")

    def __init__(self, key: tuple[int, ...], parent: "_TrieNode | None", block_id: int | None):
        self.key = key
        self.parent = parent
        self.children: dict[tuple[int, ...], _TrieNode] = {}
        self.block_id = block_id
        self.ref = 0
        self.last_used = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """A pinned longest-prefix match: ``tokens`` cached tokens held in
    ``block_ids`` pool blocks. Every node in ``nodes`` carries one reference
    until `PrefixCache.release` (the engine releases at retirement)."""

    tokens: int
    block_ids: tuple[int, ...] = ()
    nodes: tuple[Any, ...] = ()


NO_MATCH = PrefixMatch(0)


def cache_batch_size(cache: SlotKVCache) -> int:
    """Leading (slot) dimension of a slot cache."""
    return int(cache.k[0].shape[0])


class PrefixCache:
    """Block-granular prefix KV cache for `serving.engine.ServingEngine`.

    ``cache`` is the engine's `models.kv_cache.SlotKVCache` (slot mode: the
    pool mirrors its leaves block by block); with ``allocator`` (paged mode)
    it is not read and may be None. The trie and all policy live on the
    host; the pool is touched only by the engine's cached admission (a
    gather) and by `insert` (a scatter)."""

    def __init__(self, cache: SlotKVCache | None, max_len: int, block_tokens: int = 16,
                 num_blocks: int | None = None, metrics: Any = None, allocator: Any = None):
        block_tokens = int(block_tokens)
        if block_tokens < 1 or block_tokens & (block_tokens - 1):
            raise ValueError(f"block_tokens must be a power of two, got {block_tokens}")
        if max_len % block_tokens:
            raise ValueError(f"block_tokens {block_tokens} must divide n_positions {max_len}")
        self.block_tokens = block_tokens
        self.max_len = int(max_len)
        self.blocks_per_row = self.max_len // block_tokens
        self.metrics = metrics
        self._root = _TrieNode((), None, -1)
        self._tick = 0
        # the host-RAM tier hook (`serving.kv_tier`, paged mode only): set
        # by the engine's ``kv_tier=``. With it, spilled nodes (``block_id
        # None``) stay in the trie and `acquire` pages them back in
        self.tier = None
        self.allocator = allocator
        self.pool: PagedKVCache | None = None
        self._free: deque[int] | None = None
        if allocator is not None:
            self.num_blocks = int(allocator.num_blocks)
            return
        if num_blocks is None:
            num_blocks = 2 * self.blocks_per_row * cache_batch_size(cache)
        self.num_blocks = int(num_blocks)
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.pool = make_prefix_block_pool(cache, self.num_blocks, block_tokens)
        self._free = deque(range(self.num_blocks))

    # ------------------------------------------------------------- matching
    def _walk(self, prompt: list[int]) -> list[_TrieNode]:
        """Longest-prefix walk over full blocks, capped so at least one
        prompt token is left for the suffix prefill (admission samples the
        first output from the last prompt token)."""
        cap = (len(prompt) - 1) // self.block_tokens
        node, path = self._root, []
        while len(path) < cap:
            lo = len(path) * self.block_tokens
            child = node.children.get(tuple(prompt[lo:lo + self.block_tokens]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match_len(self, prompt: list[int]) -> int:
        """Cached-prefix length of ``prompt`` without pinning (the
        scheduler's suffix probe): a multiple of ``block_tokens``, always
        ``< len(prompt)``."""
        return len(self._walk(prompt)) * self.block_tokens

    def acquire(self, prompt: list[int]) -> PrefixMatch:
        """Longest-prefix match that pins every matched node (ref + 1 each),
        so eviction cannot take blocks an admitted request depends on. Pair
        with `release`."""
        path = self._walk(prompt)
        if self.tier is not None:
            # page spilled blocks back in; a failed page-in (pool exhausted,
            # thrash guard frozen) truncates the match to what is on the
            # device, and only that is pinned
            path = self.tier.ensure_resident(path)
        for node in path:
            node.ref += 1
            self._touch(node)
        return PrefixMatch(tokens=len(path) * self.block_tokens,
                           block_ids=tuple(n.block_id for n in path), nodes=tuple(path))

    def trim(self, match: PrefixMatch, n_blocks: int) -> PrefixMatch:
        """Shrink a pinned match to its first ``n_blocks`` blocks, releasing
        the pins past the cut (the engine trims when the cached prefix plus
        the suffix bucket would overrun ``n_positions``)."""
        for node in match.nodes[n_blocks:]:
            node.ref -= 1
        return PrefixMatch(tokens=n_blocks * self.block_tokens,
                           block_ids=match.block_ids[:n_blocks], nodes=match.nodes[:n_blocks])

    def release(self, match: PrefixMatch) -> None:
        """Drop the pins `acquire` took (slot retirement)."""
        for node in match.nodes:
            node.ref -= 1

    # ------------------------------------------------------------- donation
    def insert(self, prompt: list[int], cache: SlotKVCache, slot: int) -> int:
        """Slot mode: donate a retired slot's prompt KV. Every full block of
        ``prompt`` not yet in the trie gets a pool block (evicting unpinned
        LRU leaves when the free list is empty) and one indexed write per
        leaf copies the new blocks out of row ``slot``. Returns how many
        blocks were stored (0: all were cached already, no device work).
        Donation stops at the first block it cannot place: a trie cannot
        reach block ``j + 1`` without block ``j``."""
        if self.allocator is not None:
            raise RuntimeError("paged mode donates via adopt(), not insert()")
        n_blocks = min(len(prompt) // self.block_tokens, self.blocks_per_row)
        dest = np.full(self.blocks_per_row, self.num_blocks, np.int64)
        node, new = self._root, 0
        for j in range(n_blocks):
            key = tuple(prompt[j * self.block_tokens:(j + 1) * self.block_tokens])
            child = node.children.get(key)
            if child is None:
                block_id = self._alloc()
                if block_id is None:
                    break
                child = _TrieNode(key, node, block_id)
                node.children[key] = child
                dest[j] = block_id
                new += 1
            self._touch(child)
            node = child
        if new:
            scatter_block_rows(self.pool, cache, slot, self._to_device(dest))
            if self.metrics is not None:
                self.metrics.prefix_blocks_donated.inc(new)
        return new

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device. On CUDA through pinned memory,
        copied ``non_blocking``: a copy from pageable memory would make the
        host wait for every dispatch in flight (PyTorch's pinned-memory
        allocator keeps the staging block until the copy has run)."""
        dev = self.pool.k[0].device
        if dev.type != "cuda":
            return torch.from_numpy(host)
        return torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)

    def adopt(self, prompt: list[int], block_ids: list[int], owned_from: int) -> int:
        """Paged mode: move ownership of a retired slot's full prompt blocks
        into the trie, with no device work (the prefill wrote them in place
        in the shared pool). ``block_ids[j]`` is the pool block holding
        prompt block ``j`` (the slot's table row); blocks before
        ``owned_from`` are the aliased prefix the admission matched (already
        the trie's: only touched), blocks from it on are the slot's own. An
        own block whose key is already in the trie (another sharer retired
        first) goes back to the allocator. Returns how many blocks were
        adopted."""
        n_blocks = min(len(prompt) // self.block_tokens, self.blocks_per_row)
        node, new = self._root, 0
        for j in range(n_blocks):
            key = tuple(prompt[j * self.block_tokens:(j + 1) * self.block_tokens])
            child = node.children.get(key)
            if child is None:
                if j < owned_from:
                    # the aliased prefix is pinned until release(): eviction
                    # cannot have taken it
                    raise RuntimeError(f"pinned prefix block {j} missing from the trie at adopt")
                child = _TrieNode(key, node, int(block_ids[j]))
                node.children[key] = child
                new += 1
            elif j >= owned_from:
                if child.block_id is None and self.tier is not None:
                    # the retiring slot just wrote this spilled block's bytes
                    # on the device: the trie takes the fresh block and the
                    # host copy goes, a page-in for free
                    self.tier.revive(child, int(block_ids[j]))
                else:
                    self.allocator.free([int(block_ids[j])])
            self._touch(child)
            node = child
        if new and self.metrics is not None:
            self.metrics.prefix_blocks_donated.inc(new)
        return new

    # ------------------------------------------------------------- eviction
    def reclaim(self, n: int) -> int:
        """Paged mode: evict up to ``n`` unpinned LRU leaves and hand their
        blocks to the allocator (admission calls this when the free list
        cannot cover a reservation). Returns how many were freed: fewer than
        ``n`` means the rest of the trie is pinned or interior."""
        freed = 0
        while freed < n:
            block_id = self._evict_one()
            if block_id is None:
                break
            self.allocator.free([block_id])
            freed += 1
        return freed

    def reclaimable_blocks(self, prompts: list[list[int]] = ()) -> int:
        """Paged mode: how many blocks ``reclaim`` could free by cascading,
        every resident unpinned node whose whole subtree is resident and
        unpinned. Evicting a leaf makes its parent the next leaf, so
        unpinned interior nodes (``blocks_stranded``) count too; a node
        above a pinned or spilled one never becomes a leaf, so it does not.
        The cached prefixes of ``prompts`` count as pinned: admitting them
        pins those nodes. Admission prices the pool with this: free +
        evictable leaves alone misses the stranded blocks, and a request
        needing more than that would wait forever with no slot active."""
        kept = {id(node) for prompt in prompts for node in self._walk(prompt)}
        order, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        clear: dict[int, bool] = {}
        count = 0
        for node in reversed(order):  # every node after all of its subtree
            ok = (node.block_id is not None and node.ref == 0 and id(node) not in kept
                  and all(clear[id(c)] for c in node.children.values()))
            clear[id(node)] = ok
            count += ok
        return count

    def _alloc(self) -> int | None:
        if self._free:
            return self._free.popleft()
        return self._evict_one()

    def _evict_one(self) -> int | None:
        """Take the least recently used evictable block: only unpinned leaves
        qualify (an interior node backs every longer prefix below it, a
        pinned one is in use). Deterministic: ``last_used`` is a unique
        monotonic counter."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.children or node.ref > 0 or node.block_id is None:
                # a spilled node holds no device block: its host copy is the
                # tier's to drop, not this eviction's
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        if self.metrics is not None:
            self.metrics.prefix_evictions.inc()
        return victim.block_id

    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    # ------------------------------------------------------------ inspection
    @property
    def cached_blocks(self) -> int:
        """Blocks resident in the trie (slot mode: allocated == resident,
        since eviction hands a block straight to its next tenant)."""
        if self._free is None:
            return self.node_count()
        return self.num_blocks - len(self._free)

    def node_count(self) -> int:
        count, stack = 0, list(self._root.children.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count

    @property
    def blocks_free(self) -> int:
        """Free blocks: the slot-mode pool's never-allocated ones, or the
        paged allocator's free count."""
        if self._free is None:
            return self.allocator.free_count
        return len(self._free)

    @property
    def pool_nbytes(self) -> int:
        """Device bytes of the slot-mode block pool (its sink block included);
        0 in paged mode, where the pool is the engine's."""
        return 0 if self.pool is None else tree_nbytes(self.pool)

    def memory_stats(self) -> dict[str, Any]:
        """Host-side occupancy gauges, one trie walk, no device work: resident
        blocks split into ``blocks_pinned`` (in use), ``blocks_evictable``
        (unpinned leaves: what eviction may take now) and ``blocks_stranded``
        (unpinned interior nodes); ``fragmentation`` is stranded / resident.
        With a host tier, spilled nodes (``block_id`` None) count in the
        ``host_tier`` sub-dict and in no device bucket, so ``free + resident
        + private == total`` keeps holding through every spill and page-in."""
        pinned = evictable = resident = spilled = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.block_id is None:
                spilled += 1
                continue
            resident += 1
            if node.ref > 0:
                pinned += 1
            elif not node.children:
                evictable += 1
        stranded = resident - pinned - evictable
        out: dict[str, Any] = {
            "pool_bytes": self.pool_nbytes,
            "blocks_total": self.num_blocks,
            "blocks_free": self.blocks_free,
            "blocks_resident": resident,
            "blocks_pinned": pinned,
            "blocks_evictable": evictable,
            "blocks_stranded": stranded,
            "fragmentation": stranded / resident if resident else 0.0,
        }
        if self.tier is not None:
            out["host_tier"] = {"blocks": spilled, "bytes": spilled * self.tier.block_bytes}
        return out
