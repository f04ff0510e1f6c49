"""Paged decode KV cache: the port of the paged half of
`accelerate_tpu.models.kv_cache`.

The reference keeps KV in flax ``cache`` collections and updates them
functionally (``.at[].set`` returns a new pool every step). The port keeps one
`PagedKVCache` object per engine and updates its pools IN PLACE, which saves
the copy a functional update makes of every pool, every layer, every step.

Pool layout per layer, as in the reference: ``[num_blocks, block_tokens,
kv_heads, head_dim]``. The storage carries one block more, id
``num_blocks``: the drop sink. The reference drops a write aimed at block id
``num_blocks`` (a frozen row, or a released slot's sentinel table row)
through ``mode="drop"``; torch indexing has no drop mode and a boolean-masked
write would make the host wait on the device, so such writes are steered
into the sink block, which nothing ever reads. `PagedKVCache.pools` hands out
the ``[:num_blocks]`` views that attention reads.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import torch


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantization: one fp32 absmax scale per trailing-axis
    group (per (..., kv-head) row). Returns ``(int8 values, fp32 scales)``;
    all-zero rows get scale 1.0 so the dequantized zero stays exact."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dq(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_q`: int8 values x fp32 scales, cast to the compute dtype."""
    return (q.float() * scale[..., None]).to(dtype)


class BlockAllocator:
    """Host-side free list over a device block pool's ids.

    Allocation is all-or-nothing: a request that cannot get every block it
    needs gets none (backpressure, never a half-placed request), and a double
    free fails loudly (an aliasing bug would otherwise corrupt two requests'
    KV silently)."""

    def __init__(self, num_blocks: int):
        num_blocks = int(num_blocks)
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(num_blocks))
        self._owned: set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def owned_count(self) -> int:
        return len(self._owned)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` distinct block ids, or None when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        self._owned.update(ids)
        return ids

    def free(self, ids) -> None:
        """Return block ids to the free list (slot retirement)."""
        for b in ids:
            b = int(b)
            if b not in self._owned:
                raise ValueError(f"double free of block {b}")
            self._owned.discard(b)
            self._free.append(b)


@dataclass
class PagedKVCache:
    """Every layer's K/V block pool plus the per-slot write cursor.

    ``k``/``v`` hold one storage tensor per layer, ``[num_blocks + 1,
    block_tokens, kv_heads, head_dim]`` (the last block is the drop sink).
    ``index`` is the ``[b]`` int32 frontier cursor: row ``i``'s next token
    lands at logical position ``index[i]``. The reference keeps one cursor
    leaf per layer, all equal; the port keeps one and `GPT2LMHead` advances
    it after the last layer. ``attention`` picks the decode attention path:
    ``"fused"`` (the kernel reads the pool in place) or ``"gather"`` (the
    plain path over the gathered view, the parity oracle)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: torch.Tensor
    attention: str = "fused"

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[0] - 1

    @property
    def block_tokens(self) -> int:
        return self.k[0].shape[1]

    def pools(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s ``[num_blocks, block_tokens, kv_heads,
        head_dim]`` K and V pools (contiguous views without the sink)."""
        n = self.num_blocks
        return self.k[layer][:n], self.v[layer][:n]


def make_block_pool(n_layer: int, batch: int, num_blocks: int, block_tokens: int,
                    kv_heads: int, head_dim: int, dtype: torch.dtype,
                    device: torch.device | str, attention: str = "fused") -> PagedKVCache:
    """Allocate the zeroed per-layer block pools of a paged engine with
    ``batch`` slot rows (the reference's ``make_block_pool`` role)."""
    if attention not in ("fused", "gather"):
        raise ValueError(f"attention must be 'fused' or 'gather', got {attention!r}")
    shape = (num_blocks + 1, block_tokens, kv_heads, head_dim)
    return PagedKVCache(
        k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)],
        v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)],
        index=torch.zeros(batch, dtype=torch.int32, device=device),
        attention=attention,
    )


def paged_frontier_write(
    storages: tuple[torch.Tensor, ...],  # [num_blocks + 1, block_tokens, ...] each
    news: tuple[torch.Tensor, ...],  # congruent [b, 1, ...] new rows
    idx: torch.Tensor,  # [b] int32 write cursors
    mask: torch.Tensor,  # [b] bool: False rows freeze (dropped write)
    block_tables: torch.Tensor,  # [b, blocks_per_slot] int pool block ids
) -> None:
    """The append-at-frontier write (the reference's ``_paged_frontier_write``,
    one-token branch), in place: row ``i``'s new entry lands in block
    ``block_tables[i, idx[i] // block_tokens]`` at offset ``idx[i] %
    block_tokens``. Frozen rows and table ids at or past ``num_blocks`` (the
    released-slot sentinel) write into the sink block instead, so they change
    nothing any reader sees. A cursor past the table's last column reads that
    column, as the reference's clamped gather does."""
    sink = storages[0].shape[0] - 1
    block_tokens = storages[0].shape[1]
    b = idx.shape[0]
    rows = torch.arange(b, device=idx.device)
    idx = idx.long()
    col = torch.clamp(idx // block_tokens, max=block_tables.shape[1] - 1)
    bids = block_tables[rows, col].long()
    keep = mask & (bids >= 0) & (bids < sink)
    bids = torch.where(keep, bids, torch.full_like(bids, sink))
    offs = idx % block_tokens
    for storage, new in zip(storages, news):
        storage[bids, offs] = new[:, 0].to(storage.dtype)


def paged_decode_write(cache: PagedKVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                       block_tables: torch.Tensor, write_mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write-only step for the fused path: land ``k``/``v`` (``[b, 1,
    kv_heads, head_dim]``) at each row's frontier and return layer
    ``layer``'s pools for the kernel to read in place. The cursor is not
    advanced here (see `PagedKVCache`)."""
    if k.shape[1] != 1:
        raise ValueError(
            f"paged decode writes one token per step, got a length-{k.shape[1]} "
            "segment (prefill writes through scatter_rows_to_blocks)"
        )
    paged_frontier_write((cache.k[layer], cache.v[layer]), (k, v), cache.index,
                         write_mask, block_tables)
    return cache.pools(layer)


def paged_decode_update(cache: PagedKVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                        block_tables: torch.Tensor, write_mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather path: the same frontier write, then the attended view, each
    row's table blocks concatenated in token order, ``[b, blocks_per_slot *
    block_tokens, kv_heads, head_dim]``: position ``p`` of row ``i`` sits at
    index ``p``, so the caller masks positions past the cursor. Sentinel
    table ids read block ``num_blocks - 1``, masked like every position
    past the frontier."""
    k_pool, v_pool = paged_decode_write(cache, layer, k, v, block_tables, write_mask)
    b, bps = block_tables.shape
    tables = block_tables.long().clamp(max=cache.num_blocks - 1)
    span = bps * cache.block_tokens

    def view(pool):
        return pool[tables].reshape((b, span) + tuple(pool.shape[2:]))

    return view(k_pool), view(v_pool)


def scatter_rows_to_blocks(
    cache: PagedKVCache,
    new_kv: list[tuple[torch.Tensor, torch.Tensor]],  # per layer [nb, bucket, kv_heads, head_dim]
    slots: torch.Tensor,  # [nb] slot rows whose cursor to stamp
    dest_blocks: torch.Tensor,  # [nb, ceil(bucket / block_tokens)] pool ids; >= num_blocks drops
    cache_index: torch.Tensor,  # [nb] per-row resume index (true prefill length)
) -> None:
    """Paged admission, in place: carve each freshly prefilled contiguous row
    into ``block_tokens``-sized pieces and write them to the row's pool
    blocks, one indexed write per layer. ``dest_blocks[i, j]`` is where row
    ``i``'s ``j``-th piece lands; ids at or past ``num_blocks`` (pieces of the
    pad region) go to the sink. The cursor of rows ``slots`` is stamped with
    ``cache_index``, decode's append frontier."""
    bt, sink = cache.block_tokens, cache.num_blocks
    dest = dest_blocks.long().reshape(-1)
    dest = torch.where((dest >= 0) & (dest < sink), dest, torch.full_like(dest, sink))
    n_blk = dest_blocks.shape[1]
    for layer, (k_new, v_new) in enumerate(new_kv):
        nb, bucket = k_new.shape[:2]
        pad = n_blk * bt - bucket
        if pad < 0:
            raise ValueError(f"dest_blocks covers {n_blk * bt} tokens, rows hold {bucket}")
        for storage, new in ((cache.k[layer], k_new), (cache.v[layer], v_new)):
            if pad:
                new = torch.nn.functional.pad(new, (0, 0, 0, 0, 0, pad))
            storage[dest] = new.reshape((nb * n_blk, bt) + tuple(new.shape[2:])).to(storage.dtype)
    cache.index[slots.long()] = cache_index.to(cache.index.dtype)
