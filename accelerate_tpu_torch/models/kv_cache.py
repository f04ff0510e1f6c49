"""Decode KV caches: the port of `accelerate_tpu.models.kv_cache`, its slot
cache and its paged pool.

The reference keeps KV in flax ``cache`` collections and updates them
functionally (``.at[].set`` and ``dynamic_update_slice`` return new buffers
every step). The port keeps one cache object per generation or engine,
passed explicitly to the model's ``forward``, and updates its buffers IN
PLACE, which saves the copy a functional update makes of every buffer, every
layer, every step, and keeps the addresses a captured CUDA graph holds.

The slot cache (`SlotKVCache`, `make_cache`, `decode_cache_update`,
`scatter_cache_slots`): per layer, fixed ``[b, max_len, kv_heads, head_dim]``
K and V buffers and a running write index, scalar (``generate``'s batch,
where every row shares one prompt length) or ``[b]`` (``per_slot``: the
serving engine's slot pool, every row at its own position; the reference's
``kv_cache_per_slot`` flag is the index's shape here). Attention reads the
whole ``[b, max_len, ...]`` buffer under a mask every step, as the
reference's does; an int8 cache dequantizes the whole buffer every step
(the reference's module docstring says the same of an unfused backend), so
it saves memory, not bandwidth.

The paged pool (`PagedKVCache`), per layer ``[num_blocks, block_tokens,
kv_heads, head_dim]``. The storage carries one block more, id
``num_blocks``: the drop sink. The reference drops a write aimed at block id
``num_blocks`` (a frozen row, or a released slot's sentinel table row)
through ``mode="drop"``; torch indexing has no drop mode and a boolean-masked
write would make the host wait on the device, so such writes are steered
into the sink block, which nothing ever reads. `PagedKVCache.pools` hands out
the ``[:num_blocks]`` views that attention reads.

The prefix cache's pieces (`serving.prefix_cache`): `make_prefix_block_pool`
carves a slot cache's leaves into a block pool of the same `PagedKVCache`
layout, `scatter_block_rows` donates a slot row's blocks into it, and
`gather_block_rows` assembles rows for a cached admission out of either pool
(the prefix pool in slot mode, the engine's own pool in paged mode).
`rewind_frontier` moves the write cursor back without touching KV, the
speculative verify step's rollback; the paged frontier write lands a
multi-token segment under ``write_len``, as the verify step needs.

int8 storage (``kv_cache_dtype=torch.int8``), in both, as the reference's:
the K and V buffers hold int8 values and sibling fp32 scale planes (slot:
``[b, max_len, kv_heads]``; paged: ``[num_blocks + 1, block_tokens,
kv_heads]``) hold one absmax scale per (row, position, kv head), written
through the same indices (`_q`), so a KV byte and its scale never diverge.
Readers dequantize (`_dq`); the paged fused path hands the scale planes to
the decode kernel.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields, is_dataclass

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


def kv_store_dtype(config) -> torch.dtype:
    """The dtype a model's paged pool stores: ``config.kv_cache_dtype`` when
    set (only ``torch.int8``), else the compute dtype."""
    kv = getattr(config, "kv_cache_dtype", None)
    if kv is None:
        return config.dtype
    if kv != torch.int8:
        raise ValueError(f"kv_cache_dtype supports None (compute dtype) or int8, got {kv}")
    return torch.int8


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


class _KVStore:
    """What both caches share: int8 storage carries scale planes, and new
    K/V rows are quantized on their way in."""

    k_scale: list[torch.Tensor] | None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def new_rows(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """New K/V rows as the storage leaves take them: ``(k, v)``, or
        quantized to ``(k_int8, v_int8, k_scale, v_scale)``."""
        if self.quantized:
            (kq, ks), (vq, vs) = _q(k), _q(v)
            return kq, vq, ks, vs
        return k, v


def cache_geometry(config) -> tuple[int, int, int, int]:
    """``(layers, kv_heads, head_dim, max_len)`` of a GPT-2 or Llama config."""
    if hasattr(config, "n_layer"):
        return config.n_layer, config.n_head, config.head_dim, config.n_positions
    return (config.num_layers, config.num_kv_heads, config.head_dim,
            config.max_position_embeddings)


@dataclass
class SlotKVCache(_KVStore):
    """Every layer's slot-cache buffers and the write index.

    ``k``/``v`` hold one ``[b, max_len, kv_heads, head_dim]`` tensor per
    layer; an int8 cache also holds ``k_scale``/``v_scale``, one fp32 ``[b,
    max_len, kv_heads]`` plane per layer (None at full precision). ``index``
    is int32: a scalar (every row writes at the same position) or ``[b]``
    (``per_slot``). The reference keeps one ``cache_index`` leaf per layer,
    all equal; the port keeps one, which the model advances after its last
    layer (`advance_index`)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: torch.Tensor
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    @property
    def per_slot(self) -> bool:
        return self.index.ndim == 1

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]

    def storages(self, layer: int) -> tuple[torch.Tensor, ...]:
        """Layer ``layer``'s buffers: ``(k, v)``, or ``(k, v, k_scale,
        v_scale)`` for an int8 cache."""
        if self.quantized:
            return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]
        return self.k[layer], self.v[layer]

    @classmethod
    def from_rows(cls, kv: list[tuple[torch.Tensor, ...]], index: torch.Tensor) -> "SlotKVCache":
        """A cache over rows a full-sequence forward collected (``kv_out``:
        per layer ``(k, v)`` or, for an int8 cache, ``(k_int8, v_int8,
        k_scale, v_scale)``), e.g. an admission's prefill for
        `scatter_cache_slots`."""
        quant = len(kv[0]) == 4
        return cls(k=[t[0] for t in kv], v=[t[1] for t in kv], index=index,
                   k_scale=[t[2] for t in kv] if quant else None,
                   v_scale=[t[3] for t in kv] if quant else None)


def make_cache(model, batch: int, per_slot: bool = True) -> SlotKVCache:
    """The zeroed slot cache of ``model`` for ``batch`` rows (the reference's
    ``make_cache``), on the model's device. Shapes come from the config, not
    from a traced init: ``[batch, max_len, kv_heads, head_dim]`` per layer
    in the config's ``kv_cache_dtype`` (int8 adds the fp32 scale planes), or
    its compute dtype; ``max_len`` is ``n_positions`` (GPT-2) or
    ``max_position_embeddings`` (Llama). ``per_slot`` gives the ``[batch]``
    write index of the serving engine's slot pool; False, the scalar index
    of `generation.generate`."""
    cfg = model.config
    n_layer, kv_heads, head_dim, max_len = cache_geometry(cfg)
    dtype, dev = kv_store_dtype(cfg), model.device
    shape = (batch, max_len, kv_heads, head_dim)

    def planes(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n_layer)]

    quant = dtype == torch.int8
    return SlotKVCache(
        k=planes(shape, dtype), v=planes(shape, dtype),
        index=torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=dev),
        k_scale=planes(shape[:3], torch.float32) if quant else None,
        v_scale=planes(shape[:3], torch.float32) if quant else None,
    )


def _row_shape(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[b]`` or ``[b, n]`` row mask viewed to broadcast over a buffer of
    ``ndim`` dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - mask.ndim))


def decode_cache_update(
    cache: SlotKVCache,
    layer: int,
    k: torch.Tensor,  # [b, s, kv_heads, head_dim] new keys
    v: torch.Tensor,
    write_mask: torch.Tensor | None = None,  # [b] bool: False rows freeze (per_slot)
    write_len: torch.Tensor | None = None,  # [b] int: per-row segment length cap (per_slot)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write layer ``layer``'s new K/V into the slot cache, in place, and
    return ``(k_all, v_all, write_index)``: the whole ``[b, max_len, ...]``
    buffers in k's dtype (dequantized when stored int8) and the index the
    entries were written at. ``write_index`` is the cache's own index tensor:
    the model advances it after its last layer (`advance_index`), so read it
    before that.

    The reference's rules (``decode_cache_update``):

    - a scalar index writes every row's ``s`` entries at ``index``, the start
      clamped into ``[0, max_len - s]`` as ``dynamic_update_slice`` clamps it;
    - ``per_slot``: row ``i`` writes at its own ``index[i]``, clamped the
      same way;
    - ``write_mask`` (per_slot only): a row whose mask is False re-writes its
      current entries, a bit-exact no-op, so its buffers stay bit-identical;
    - ``write_len`` (per_slot only): row ``i`` writes only its first
      ``clip(write_len[i], 0, s)`` entries (zero for a frozen row) at
      ``index[i]``, ``index[i] + 1``, ...; entries past ``max_len`` are
      dropped, so a segment never rewrites committed history;
    - int8 storage writes the `_q` payload and its scales through the same
      indices."""
    per_slot = cache.per_slot
    if write_mask is not None and not per_slot:
        raise ValueError("write_mask requires per_slot=True (the scalar-index cache has no "
                         "per-row freeze semantics)")
    if write_len is not None and not per_slot:
        raise ValueError("write_len requires per_slot=True (per-row segment clamping is a "
                         "slot-pool decode concept)")
    b, s = k.shape[:2]
    max_len, idx = cache.max_len, cache.index
    steps = torch.arange(s, device=idx.device)
    news = cache.new_rows(k, v)
    storages = cache.storages(layer)
    if not per_slot:
        cols = idx.long().clamp(0, max_len - s) + steps
        for buf, new in zip(storages, news):
            buf.index_copy_(1, cols, new.to(buf.dtype))
    elif write_len is not None:
        wl = write_len.to(idx.dtype).clamp(0, s)
        if write_mask is not None:
            wl = wl * write_mask.to(wl.dtype)
        # position p of row i takes entry p - index[i] when that entry is
        # one of the row's first wl[i]; every other position keeps its value
        j = torch.arange(max_len, device=idx.device)[None, :] - idx.long()[:, None]
        hit = (j >= 0) & (j < wl.long()[:, None])
        src = j.clamp(0, s - 1)
        rows = torch.arange(b, device=idx.device)[:, None]
        for buf, new in zip(storages, news):
            buf.copy_(torch.where(_row_shape(hit, buf.ndim), new.to(buf.dtype)[rows, src], buf))
    else:
        rows = torch.arange(b, device=idx.device)[:, None]
        cols = idx.long().clamp(0, max_len - s)[:, None] + steps
        for buf, new in zip(storages, news):
            new = new.to(buf.dtype)
            if write_mask is not None:
                new = torch.where(_row_shape(write_mask, buf.ndim), new, buf[rows, cols])
            buf[rows, cols] = new
    if cache.quantized:
        return (_dq(cache.k[layer], cache.k_scale[layer], k.dtype),
                _dq(cache.v[layer], cache.v_scale[layer], v.dtype), idx)
    return cache.k[layer], cache.v[layer], idx


def advance_index(cache: SlotKVCache, s: int, write_mask: torch.Tensor | None = None,
                  write_len: torch.Tensor | None = None) -> None:
    """Advance the write index past a step's ``s`` entries, in place, as the
    reference does: by ``clip(write_len, 0, s)`` (zero for a frozen row),
    else by ``s`` for each row whose ``write_mask`` is True, else by ``s``.
    The index is not clamped: a row may run past ``max_len``."""
    if write_len is not None:
        step = write_len.to(cache.index.dtype).clamp(0, s)
        if write_mask is not None:
            step = step * write_mask.to(step.dtype)
        cache.index.add_(step)
    elif write_mask is not None:
        cache.index.add_(write_mask.to(cache.index.dtype) * s)
    else:
        cache.index.add_(s)


def slot_attention_mask(idx: torch.Tensor, s: int, max_len: int,
                        window: int | None = None) -> torch.Tensor:
    """Which cache positions each of a step's ``s`` queries attends: query
    ``j`` of a row sits at ``idx + j`` and sees positions ``<= idx + j``
    (and ``> idx + j - window`` with a sliding window). A scalar ``idx``
    gives ``[s, max_len]``, a ``[b]`` one ``[b, 1, s, max_len]``."""
    kv_pos = torch.arange(max_len, device=idx.device)
    steps = torch.arange(s, device=idx.device)
    if idx.ndim == 1:
        q_pos = idx.long()[:, None, None] + steps[None, :, None]
        kv_pos = kv_pos[None, None, :]
    else:
        q_pos = idx.long() + steps[:, None]
        kv_pos = kv_pos[None, :]
    mask = kv_pos <= q_pos
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return mask[:, None] if idx.ndim == 1 else mask


def scatter_cache_slots(pool: SlotKVCache, new: SlotKVCache, slots: torch.Tensor,
                        cache_index: torch.Tensor) -> None:
    """Write an ``nb``-row cache into pool rows ``slots``, in place (the
    serving engine's batched admission; the reference's
    ``scatter_cache_slots``). Row ``i`` of every leaf lands at
    ``pool[slots[i]]``, over the first ``L`` positions when ``new`` holds
    ``L <= max_len`` of them (a prefill's bucket: the positions past it keep
    stale entries, which sit past the row's index and are masked until
    decode overwrites them). The index of rows ``slots`` is OVERWRITTEN with
    ``cache_index``: the prefill covered the padded bucket, but decode must
    resume (and overwrite the pad entries) from each row's true prompt
    end."""
    rows = slots.long()
    for layer in range(len(pool.k)):
        olds, fresh = pool.storages(layer), new.storages(layer)
        if len(olds) != len(fresh):
            raise ValueError(f"layer {layer}: {len(fresh)} new leaves for {len(olds)} cache leaves")
        for buf, rows_in in zip(olds, fresh):
            buf[rows, :rows_in.shape[1]] = rows_in.to(buf.dtype)
    pool.index[rows] = cache_index.to(pool.index.dtype)


@dataclass
class PagedKVCache(_KVStore):
    """Every layer's K/V block pool plus the per-slot write cursor.

    ``k``/``v`` hold one storage tensor per layer, ``[num_blocks + 1,
    block_tokens, kv_heads, head_dim]`` (the last block is the drop sink).
    ``index`` is the ``[b]`` int32 frontier cursor: row ``i``'s next token
    lands at logical position ``index[i]``. An int8 pool also holds
    ``k_scale``/``v_scale``, one fp32 ``[num_blocks + 1, block_tokens,
    kv_heads]`` plane per layer (None at full precision). The reference
    keeps one cursor leaf per layer, all equal; the port keeps one and `GPT2LMHead` advances
    it after the last layer. ``attention`` picks the decode attention path:
    ``"fused"`` (the kernel reads the pool in place) or ``"gather"`` (the
    plain path over the gathered view, the parity oracle)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: torch.Tensor
    attention: str = "fused"
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

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

    def scale_pools(self, layer: int) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Layer ``layer``'s ``[num_blocks, block_tokens, kv_heads]`` K and V
        scale planes (views without the sink), or None at full precision."""
        if not self.quantized:
            return None
        n = self.num_blocks
        return self.k_scale[layer][:n], self.v_scale[layer][:n]

    def storages(self, layer: int) -> tuple[torch.Tensor, ...]:
        """Layer ``layer``'s storage leaves, sink included: ``(k, v)``, or
        ``(k, v, k_scale, v_scale)`` for an int8 pool."""
        if self.quantized:
            return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]
        return self.k[layer], self.v[layer]


def make_block_pool(n_layer: int, batch: int, num_blocks: int, block_tokens: int,
                    kv_heads: int, head_dim: int, dtype: torch.dtype,
                    device: torch.device | str, attention: str = "fused") -> PagedKVCache:
    """Allocate the zeroed per-layer block pools of a paged engine with
    ``batch`` slot rows (the reference's ``make_block_pool`` role). ``dtype``
    ``torch.int8`` adds the fp32 scale planes."""
    if attention not in ("fused", "gather"):
        raise ValueError(f"attention must be 'fused' or 'gather', got {attention!r}")
    shape = (num_blocks + 1, block_tokens, kv_heads, head_dim)

    def planes(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)]

    quant = dtype == torch.int8
    return PagedKVCache(
        k=planes(shape, dtype),
        v=planes(shape, dtype),
        index=torch.zeros(batch, dtype=torch.int32, device=device),
        attention=attention,
        k_scale=planes(shape[:3], torch.float32) if quant else None,
        v_scale=planes(shape[:3], torch.float32) if quant else None,
    )


def paged_frontier_write(
    storages: tuple[torch.Tensor, ...],  # [num_blocks + 1, block_tokens, ...] each
    news: tuple[torch.Tensor, ...],  # congruent [b, s, ...] new rows (K, V[, scales])
    idx: torch.Tensor,  # [b] int32 write cursors
    mask: torch.Tensor,  # [b] bool: False rows freeze (dropped write)
    block_tables: torch.Tensor,  # [b, blocks_per_slot] int pool block ids
    write_len: torch.Tensor | None = None,  # [b] int per-row segment cap, or None (s == 1)
) -> None:
    """The append-at-frontier write (the reference's ``_paged_frontier_write``),
    in place. Without ``write_len`` (one token, ``s == 1``): row ``i``'s new
    entry lands in block ``block_tables[i, idx[i] // block_tokens]`` at
    offset ``idx[i] % block_tokens``. With ``write_len`` (the speculative
    verify segment): row ``i``'s first ``clip(write_len[i], 0, s)`` entries
    land at positions ``idx[i], idx[i] + 1, ...`` through its table, and the
    rest go to the sink, so a segment never writes into blocks the row's
    reservation does not own. Frozen rows and table ids at or past
    ``num_blocks`` (the released-slot sentinel) write into the sink block
    too, so they change nothing any reader sees. A cursor past the table's
    last column reads that column, as the reference's clamped gather does."""
    sink = storages[0].shape[0] - 1
    block_tokens = storages[0].shape[1]
    b, s = news[0].shape[:2]
    idx = idx.long()
    if write_len is None:
        if s != 1:
            raise ValueError(
                f"paged decode writes one token per step, got a length-{s} segment "
                "(prefill writes through scatter_rows_to_blocks; multi-token verify "
                "segments pass write_len)"
            )
        cols, valid = idx[:, None], mask[:, None]
    else:
        wl = write_len.long().clamp(0, s) * mask.long()
        steps = torch.arange(s, device=idx.device)
        cols = idx[:, None] + steps[None, :]  # [b, s]
        valid = steps[None, :] < wl[:, None]
    rows = torch.arange(b, device=idx.device)[:, None]
    bids = block_tables[rows, (cols // block_tokens).clamp(max=block_tables.shape[1] - 1)].long()
    keep = valid & (bids >= 0) & (bids < sink)
    bids = torch.where(keep, bids, torch.full_like(bids, sink))
    offs = cols % block_tokens
    for storage, new in zip(storages, news):
        storage[bids, offs] = new.to(storage.dtype)


def paged_decode_write(cache: PagedKVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                       block_tables: torch.Tensor, write_mask: torch.Tensor,
                       write_len: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor,
                                  tuple[torch.Tensor, torch.Tensor] | None]:
    """Write-only step: land ``k``/``v`` (``[b, s, kv_heads, head_dim]``,
    ``s == 1`` unless ``write_len`` caps a segment; quantized for an int8
    pool) at each row's frontier (`paged_frontier_write`) and return layer
    ``layer``'s pools for the kernel to read in place, with their scale
    planes (None at full precision). The cursor is not advanced here (see
    `PagedKVCache`)."""
    paged_frontier_write(cache.storages(layer), cache.new_rows(k, v), cache.index,
                         write_mask, block_tables, write_len)
    return (*cache.pools(layer), cache.scale_pools(layer))


def paged_decode_update(cache: PagedKVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                        block_tables: torch.Tensor, write_mask: torch.Tensor,
                        write_len: torch.Tensor | None = None,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather path: the same frontier write, then the attended view, each
    row's table blocks concatenated in token order, ``[b, blocks_per_slot *
    block_tokens, kv_heads, head_dim]``: position ``p`` of row ``i`` sits at
    index ``p``, so the caller masks positions past the cursor. Sentinel
    table ids read block ``num_blocks - 1``, masked like every position
    past the frontier. An int8 view is dequantized to k's dtype."""
    k_pool, v_pool, scales = paged_decode_write(cache, layer, k, v, block_tables, write_mask,
                                                write_len)
    b, bps = block_tables.shape
    tables = block_tables.long().clamp(max=cache.num_blocks - 1)
    span = bps * cache.block_tokens

    def view(pool):
        return pool[tables].reshape((b, span) + tuple(pool.shape[2:]))

    if scales is not None:
        return (_dq(view(k_pool), view(scales[0]), k.dtype),
                _dq(view(v_pool), view(scales[1]), v.dtype))
    return view(k_pool), view(v_pool)


def scatter_rows_to_blocks(
    cache: PagedKVCache,
    new_kv: list[tuple[torch.Tensor, ...]],  # per layer, congruent with cache.storages
    slots: torch.Tensor,  # [nb] slot rows whose cursor to stamp
    dest_blocks: torch.Tensor,  # [nb, ceil(bucket / block_tokens)] pool ids; >= num_blocks drops
    cache_index: torch.Tensor,  # [nb] per-row resume index (true prefill length)
) -> None:
    """Paged admission, in place: carve each freshly prefilled contiguous row
    into ``block_tokens``-sized pieces and write them to the row's pool
    blocks, one indexed write per leaf. ``new_kv[layer]`` holds K and V
    ``[nb, bucket, kv_heads, head_dim]`` (and, for an int8 pool, the int8
    values and their ``[nb, bucket, kv_heads]`` scales, as the prefill's
    ``kv_out`` collects them). ``dest_blocks[i, j]`` is where row
    ``i``'s ``j``-th piece lands; ids at or past ``num_blocks`` (pieces of the
    pad region) go to the sink. The cursor of rows ``slots`` is stamped with
    ``cache_index``, decode's append frontier."""
    bt, sink = cache.block_tokens, cache.num_blocks
    dest = dest_blocks.long().reshape(-1)
    dest = torch.where((dest >= 0) & (dest < sink), dest, torch.full_like(dest, sink))
    n_blk = dest_blocks.shape[1]
    for layer, news in enumerate(new_kv):
        storages = cache.storages(layer)
        if len(news) != len(storages):
            raise ValueError(f"layer {layer}: {len(news)} new leaves for "
                             f"{len(storages)} pool leaves")
        nb, bucket = news[0].shape[:2]
        pad = n_blk * bt - bucket
        if pad < 0:
            raise ValueError(f"dest_blocks covers {n_blk * bt} tokens, rows hold {bucket}")
        for storage, new in zip(storages, news):
            if pad:
                new = torch.nn.functional.pad(new, (0, 0) * (new.ndim - 2) + (0, pad))
            storage[dest] = new.reshape((nb * n_blk, bt) + tuple(new.shape[2:])).to(storage.dtype)
    cache.index[slots.long()] = cache_index.to(cache.index.dtype)


def rewind_frontier(cache: SlotKVCache | PagedKVCache, new_index: torch.Tensor) -> None:
    """Move the ``[b]`` write cursor to ``new_index``, in place, without
    touching a KV byte: the speculative verify step's rollback (the
    reference's ``rewind_frontier``). A rejected draft's entries stay behind
    the cursor as dead state: the next write lands on top of them and the
    frontier mask keeps attention from reading past the cursor. The slot
    cache (per slot) and the paged pool share the one cursor."""
    if cache.index.ndim != 1:
        raise ValueError("rewind_frontier needs a per-slot [b] cursor")
    cache.index.copy_(new_index.to(cache.index.dtype))


def make_prefix_block_pool(cache: SlotKVCache, num_blocks: int,
                           block_tokens: int) -> PagedKVCache:
    """The prefix cache's block pool in slot mode (the reference's
    ``make_block_pool(cache, num_blocks, block_tokens)``): every leaf of the
    slot cache ``cache`` carved into ``[num_blocks + 1, block_tokens, ...]``
    blocks (the last the drop sink, as in every `PagedKVCache`), zeroed, in
    the cache's dtypes, on its device, int8 scale planes included. Its
    ``index`` is an empty placeholder: occupancy lives in the host trie."""
    if cache.max_len % block_tokens:
        raise ValueError(f"block_tokens {block_tokens} must divide the cache's "
                         f"{cache.max_len} positions")
    num_blocks = int(num_blocks)

    def planes(leaves):
        return [torch.zeros((num_blocks + 1, block_tokens) + tuple(t.shape[2:]), dtype=t.dtype,
                            device=t.device) for t in leaves]

    return PagedKVCache(
        k=planes(cache.k), v=planes(cache.v),
        index=torch.zeros(0, dtype=torch.int32, device=cache.index.device),
        k_scale=planes(cache.k_scale) if cache.quantized else None,
        v_scale=planes(cache.v_scale) if cache.quantized else None,
    )


def gather_block_rows(pool: PagedKVCache, block_tables: torch.Tensor,
                      cache_index: torch.Tensor) -> SlotKVCache:
    """Assemble ``nb`` per-slot cache rows out of pool blocks, one gather per
    leaf (the reference's ``gather_block_rows``): row ``i`` is
    ``block_tables[i]``'s blocks concatenated along the token axis,
    ``blocks_per_row * block_tokens`` positions, and its index is
    ``cache_index[i]`` (the cached prefix length), so a suffix prefill over
    the rows writes and attends from each row's cached end. Table entries
    past a row's prefix may point anywhere: the positions they fill are
    overwritten by the suffix or sit past the index, masked; ids at or past
    ``num_blocks`` read block ``num_blocks - 1``. A new cache: the pool is
    not changed."""
    nb, bpr = block_tables.shape
    tables = block_tables.long().clamp(0, pool.num_blocks - 1)
    span = bpr * pool.block_tokens

    def rows(leaves):
        return [t[tables].reshape((nb, span) + tuple(t.shape[2:])) for t in leaves]

    return SlotKVCache(
        k=rows(pool.k), v=rows(pool.v), index=cache_index.to(torch.int32).clone(),
        k_scale=rows(pool.k_scale) if pool.quantized else None,
        v_scale=rows(pool.v_scale) if pool.quantized else None,
    )


def scatter_block_rows(pool: PagedKVCache, cache: SlotKVCache, slot: int | torch.Tensor,
                       dest_blocks: torch.Tensor) -> None:
    """Donate slot row ``slot``'s KV into pool blocks, in place, one indexed
    write per leaf (the reference's ``scatter_block_rows``, the prefix
    cache's donation): the row's ``j``-th block of ``block_tokens`` positions
    lands at pool block ``dest_blocks[j]`` (``[max_len // block_tokens]``);
    ids at or past ``num_blocks`` go to the sink, which is how blocks already
    in the trie and the region past the donated prefix are skipped."""
    sink, bt = pool.num_blocks, pool.block_tokens
    dest = dest_blocks.long().to(pool.k[0].device)
    dest = torch.where((dest >= 0) & (dest < sink), dest, torch.full_like(dest, sink))
    n_blk = dest.shape[0]
    for layer in range(len(pool.k)):
        olds, rows = pool.storages(layer), cache.storages(layer)
        if len(olds) != len(rows):
            raise ValueError(f"layer {layer}: {len(rows)} cache leaves for {len(olds)} pool leaves")
        for buf, row in zip(olds, rows):
            row = row[slot]
            if row.shape[0] != n_blk * bt:
                raise ValueError(f"dest_blocks covers {n_blk * bt} positions, the row holds "
                                 f"{row.shape[0]}")
            buf[dest] = row.reshape((n_blk, bt) + tuple(row.shape[1:])).to(buf.dtype)


def _leaves(tree):
    """Every tensor of a cache, or of a nest of dataclasses, dicts, lists and
    tuples of tensors."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif is_dataclass(tree):
        for f in fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from _leaves(leaf)
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            yield from _leaves(leaf)


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor in a cache (the reference's
    ``tree_nbytes``): the KV buffers, an int8 cache's fp32 scale planes and
    the write index, all counted."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def tree_bytes_by_dtype(tree) -> dict[str, int]:
    """Bytes of a cache by dtype name (``"int8"``, ``"float32"``, ...; sorted
    by name), as the reference splits them: what int8 storage saves, beside
    the fp32 scales that ride along."""
    out: dict[str, int] = {}
    for t in _leaves(tree):
        name = str(t.dtype).removeprefix("torch.")
        out[name] = out.get(name, 0) + t.numel() * t.element_size()
    return dict(sorted(out.items()))
