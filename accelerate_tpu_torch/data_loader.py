"""The data pipeline of the training loop: the port of
`accelerate_tpu.data_loader`.

`DataLoaderShard` wraps what yields batches (a list of batches, any
iterable, or a `torch.utils.data.DataLoader`) and hands each batch to the
training loop on its device, numpy leaves turned into tensors. It looks one
batch ahead (`_PrefetchIterator`), so ``end_of_dataloader`` turns true
exactly when the last batch is yielded; while it iterates it sits on its
`GradientState`'s loader stack, and `Accelerator._do_sync` reads that flag
to close the accumulation window at the end of the epoch.

``prefetch="auto"`` copies each batch into pinned host memory and issues
its copy to the card without blocking, one batch ahead: the copy of batch
i+1 runs while the step computes on batch i. ``"none"`` (the default)
copies each batch when it is yielded. ``"native"`` asks for the reference's
C++ staging ring, which the port does not have (ROADMAP Queue 1, item 31).

Across processes (one a device) each rank takes its share of the same data,
the reference's data-parallel contract:

- a torch ``DataLoader`` is rebuilt by `prepare_data_loader` around a
  `BatchSamplerShard` (map-style datasets: whole batches round robin, or
  each batch cut in ``num_processes`` slices with ``split_batches``) or an
  `IterableDatasetShard`, so each rank reads only its indices;
- any other iterable of batches yields global batches, which a
  `DataLoaderShard` with ``num_processes > 1`` cuts into equal slices, one a
  rank, as the reference's mesh shards a global batch over its ``data``
  axis; a batch that does not divide is completed by wrapping its own
  samples;
- `DataLoaderDispatcher`: rank 0 reads every batch and broadcasts it, and
  each rank keeps its slice.

Where the last global batch was completed with repeated samples,
``remainder`` holds its real ones, so ``gather_for_metrics`` drops the
repeats.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from .state import GradientState
from .utils.environment import resolve_device
from .utils.operations import find_batch_size, recursively_apply


class SeedableRandomSampler(torch.utils.data.Sampler):
    """A shuffling sampler re-seeded each epoch from ``seed + epoch``, with
    a `torch.Generator` of its own, so a resumed run shuffles as the
    uninterrupted one did (reference `data_loader.py:66`)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        g = torch.Generator().manual_seed(self.seed + self.epoch)
        yield from torch.randperm(self.data_source_len, generator=g).tolist()
        self.epoch += 1

    def __len__(self) -> int:
        return self.data_source_len


class BatchSamplerShard:
    """This process's share of a batch sampler's batches (reference
    `data_loader.py:87`). Whole batches go round robin, or with
    ``split_batches`` each batch is cut into ``num_processes`` slices. With
    ``even_batches`` a short trailing group is completed from the epoch's
    first indices, so every process yields batches of the nominal size (at
    one process too: a ragged last batch is filled up)."""

    def __init__(self, batch_sampler: Iterable[list[int]], num_processes: int = 1,
                 process_index: int = 0, split_batches: bool = False, even_batches: bool = True):
        if not 0 <= process_index < num_processes:
            raise ValueError(f"process_index {process_index} out of range for {num_processes} processes")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        if split_batches and self.batch_size is not None and self.batch_size % num_processes:
            raise ValueError(f"split_batches requires batch size ({self.batch_size}) divisible by "
                             f"num_processes ({num_processes})")
        if self.batch_size is None and even_batches:
            raise ValueError("even_batches=True requires the batch sampler to expose `batch_size`; "
                             "pass even_batches=False for samplers with variable batch sizes")
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self) -> int:
        return len(self.batch_sampler)

    def __len__(self) -> int:
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if self.drop_last:
            return n // self.num_processes
        if self.even_batches:
            return math.ceil(n / self.num_processes)
        base, extra = divmod(n, self.num_processes)
        return base + (1 if self.process_index < extra else 0)

    def __iter__(self) -> Iterator[list[int]]:
        return self._iter_split() if self.split_batches else self._iter_round_robin()

    def _iter_split(self) -> Iterator[list[int]]:
        nominal = self.batch_size
        if nominal is None:
            for batch in self.batch_sampler:
                batch = list(batch)
                size = math.ceil(len(batch) / self.num_processes)
                piece = batch[size * self.process_index:size * (self.process_index + 1)]
                if piece:
                    yield piece
            return
        size = nominal // self.num_processes
        lo, hi = size * self.process_index, size * (self.process_index + 1)
        first: list[int] | None = None
        last: list[int] = []
        for batch in self.batch_sampler:
            batch = list(batch)
            if first is None:
                first = batch
            if last and len(last) != nominal:
                raise ValueError(f"batch of {len(last)} followed by more batches; only the final "
                                 f"batch may differ from the nominal size {nominal}")
            last = batch
            if len(batch) == nominal:
                yield batch[lo:hi]
        if first is None or len(last) == nominal or self.drop_last:
            return
        if not self.even_batches:
            if last[lo:hi]:
                yield last[lo:hi]
            return
        pool = list(first)
        while len(pool) < nominal:
            pool = pool + pool
        yield (last + pool)[:nominal][lo:hi]

    def _iter_round_robin(self) -> Iterator[list[int]]:
        nominal = self.batch_size
        group: list[list[int]] = []
        seen: list[int] = []
        ragged_seen = False
        for batch in self.batch_sampler:
            batch = list(batch)
            if nominal is not None:
                if ragged_seen:
                    raise ValueError("a ragged batch was followed by more batches; only the "
                                     f"final batch may differ from the nominal size {nominal}")
                ragged_seen = len(batch) != nominal
            seen.extend(batch)
            group.append(batch)
            if len(group) == self.num_processes and (nominal is None or len(group[-1]) == nominal):
                yield group[self.process_index]
                group = []
        if not group or self.drop_last:
            return
        if not self.even_batches:
            if self.process_index < len(group):
                yield group[self.process_index]
            return
        k = 0
        filled: list[list[int]] = []
        for i in range(self.num_processes):
            b = list(group[i]) if i < len(group) else []
            while len(b) < nominal:
                b.append(seen[k % len(seen)])
                k += 1
            filled.append(b)
        yield filled[self.process_index]


class _PrefetchIterator:
    """One batch of lookahead, so ``on_last`` runs just before the last
    batch is handed out (reference `data_loader.py:314-360`)."""

    def __init__(self, iterator: Iterator, on_last: Callable[[], None]):
        self._it = iterator
        self._on_last = on_last
        self._lookahead: Any = None
        self._primed = False

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if not self._primed:
            self._lookahead = next(self._it)  # an empty loader stops here
            self._primed = True
        current = self._lookahead
        if current is None:
            raise StopIteration
        try:
            self._lookahead = next(self._it)
        except StopIteration:
            self._on_last()
            self._lookahead = None
        return current


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


class IterableDatasetShard(torch.utils.data.IterableDataset):
    """This process's share of an iterable dataset (reference
    `data_loader.py:259`): items are buffered one chunk at a time
    (``batch_size`` items a process, or ``batch_size`` in all with
    ``split_batches``) and each process yields its contiguous slice of the
    chunk; a short final chunk is completed from the first one unless
    ``drop_last``."""

    def __init__(self, dataset: Iterable, batch_size: int, num_processes: int = 1,
                 process_index: int = 0, drop_last: bool = False, split_batches: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_processes = num_processes
        self.process_index = process_index
        self.drop_last = drop_last
        self.split_batches = split_batches
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator[Any]:
        per_proc = self.batch_size // self.num_processes if self.split_batches else self.batch_size
        chunk = per_proc * self.num_processes
        start = per_proc * self.process_index
        first: list | None = None
        buffer: list = []
        for item in self.dataset:
            buffer.append(item)
            if len(buffer) == chunk:
                if first is None:
                    first = list(buffer)
                yield from buffer[start:start + per_proc]
                buffer = []
        if not buffer or self.drop_last:
            return
        if first is None:
            first = list(buffer)
        while len(buffer) < chunk:
            buffer.append(first[len(buffer) % len(first)])
        yield from buffer[start:start + per_proc]


class DataLoaderShard:
    """A loader that yields ``base_loader``'s batches on ``device`` (None:
    the preparing accelerator's device, or CUDA when it is iterated
    unprepared), with the bookkeeping the training loop reads:
    ``end_of_dataloader`` (true from the moment the epoch's last batch is
    yielded), ``remainder``, ``batches_seen_in_epoch``, and
    ``state_dict``/``load_state_dict`` to resume mid-epoch (reference
    `data_loader.py:412-617`). `Accelerator.prepare` binds it to the
    accelerator's `GradientState`; unprepared, it keeps one of its own.

    With ``num_processes > 1`` every batch of ``base_loader`` is a global
    batch and process ``process_index`` yields its slice (see the module
    docstring); `Accelerator.prepare` sets both from the process group."""

    def __init__(self, base_loader: Iterable, device: str | torch.device | None = None,
                 synchronized_generator: SeedableRandomSampler | None = None,
                 total_dataset_length: int | None = None, total_batch_size: int | None = None,
                 _drop_last: bool = False, prefetch: str = "none", num_processes: int = 1,
                 process_index: int = 0):
        if prefetch not in ("none", "auto", "native"):
            raise ValueError(f"prefetch must be none|auto|native, got {prefetch!r}")
        self.base_loader = base_loader
        self.device = device
        self.synchronized_generator = synchronized_generator
        self.skip_batches = 0
        self.total_dataset_length = total_dataset_length
        self.total_batch_size = total_batch_size
        self.prefetch = prefetch
        self.num_processes = num_processes
        self.process_index = process_index
        self.end_of_dataloader = False
        self.remainder = -1
        self.iteration = 0
        self.batches_seen_in_epoch = 0
        self.gradient_state = GradientState()
        if total_dataset_length is not None and total_batch_size and not _drop_last:
            if total_dataset_length % total_batch_size:
                self.remainder = total_dataset_length % total_batch_size

    @property
    def dataset(self) -> Any:
        return getattr(self.base_loader, "dataset", None)

    @property
    def batch_sampler(self) -> Any:
        return getattr(self.base_loader, "batch_sampler", None)

    def set_epoch(self, epoch: int) -> None:
        self.iteration = epoch
        for obj in (self.batch_sampler, getattr(self.batch_sampler, "batch_sampler", None),
                    self.synchronized_generator, self.dataset):
            if obj is not None and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base_loader)

    def _place(self, batch: Any, device: torch.device, pinned: bool) -> Any:
        """numpy leaves as tensors on ``device``; with ``pinned`` through a
        pinned host copy and a copy to the card that does not block."""
        def place(t: Any) -> torch.Tensor:
            t = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
            if pinned and t.device.type == "cpu":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

        return recursively_apply(place, batch, test_type=_is_array)

    def _slice(self, batch: Any, last: bool) -> Any:
        """This process's slice of a global batch: every leaf whose first
        dimension is the batch's size, completed to a multiple of the
        process count by wrapping (the real count kept in ``remainder`` when
        it is the epoch's last batch), then cut in equal parts."""
        n, rank = self.num_processes, self.process_index
        size = find_batch_size(batch)
        if size is None or n == 1:
            return batch
        per = -(-size // n)
        if per * n != size and last and self.remainder < 0:
            self.remainder = size

        def take(t: Any) -> Any:
            if t.ndim == 0 or t.shape[0] != size:
                return t
            if per * n != size:
                wrap = np.arange(per * n) % size
                t = t[torch.from_numpy(wrap)] if isinstance(t, torch.Tensor) else t[wrap]
            return t[rank * per:(rank + 1) * per]

        return recursively_apply(take, batch, test_type=_is_array)

    def _global_batches(self) -> Iterator[Any]:
        """``base_loader``'s batches, each cut to this process's slice when
        there are several processes (one batch of lookahead tells the last)."""
        source = iter(self.base_loader)
        if self.num_processes == 1:
            yield from source
            return
        try:
            current = next(source)
        except StopIteration:
            return
        for following in source:
            yield self._slice(current, last=False)
            current = following
        yield self._slice(current, last=True)

    def __iter__(self) -> Iterator[Any]:
        device = resolve_device(self.device)
        if self.prefetch == "native":
            raise RuntimeError(
                "prefetch='native' asks for the reference's C++ staging ring, which the PyTorch "
                "port does not have (ROADMAP Queue 1, item 31); use prefetch='auto' (pinned host "
                "buffers and a non-blocking copy one batch ahead)")
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        self.batches_seen_in_epoch = 0

        def mark_last() -> None:
            self.end_of_dataloader = True

        ahead = self.prefetch == "auto" and device.type == "cuda"
        try:
            source: Iterator = self._global_batches()
            if ahead:  # placed as the lookahead pulls it: one batch ahead of the step
                source = (self._place(b, device, pinned=True) for b in source)
            for idx, batch in enumerate(_PrefetchIterator(source, mark_last)):
                if idx < self.skip_batches:
                    continue
                self.batches_seen_in_epoch = idx + 1
                yield batch if ahead else self._place(batch, device, pinned=False)
        finally:
            self.gradient_state._remove_dataloader(self)
            self.skip_batches = 0

    def state_dict(self) -> dict[str, Any]:
        """Where the epoch stands: a resumed loader skips the batches already
        seen (reference `data_loader.py:572`)."""
        state = {"iteration": self.iteration, "batches_seen_in_epoch": self.batches_seen_in_epoch,
                 "end_of_dataloader": self.end_of_dataloader}
        if self.synchronized_generator is not None:
            state["sampler_epoch"] = self.synchronized_generator.epoch
        return state

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.iteration = state["iteration"]
        self.set_epoch(self.iteration)
        if "sampler_epoch" in state and self.synchronized_generator is not None:
            self.synchronized_generator.set_epoch(state["sampler_epoch"])
        if not state.get("end_of_dataloader", False):
            self.skip_batches = state.get("batches_seen_in_epoch", 0)


def _to_host(batch: Any) -> Any:
    """Tensor leaves on the host, for pickling to the other processes."""
    return recursively_apply(lambda t: t.detach().cpu(), batch)


class DataLoaderDispatcher(DataLoaderShard):
    """Rank 0 reads every batch of ``base_loader`` and broadcasts it (with
    whether it is the last); each process yields its slice, as a
    `DataLoaderShard` over global batches does (reference
    `data_loader.py:619-737`). For data only rank 0 can read, such as a
    stream; at one process it is a `DataLoaderShard`."""

    def _global_batches(self) -> Iterator[Any]:
        from .utils.operations import broadcast_object_list

        if self.num_processes == 1:
            yield from super()._global_batches()
            return
        source = iter(self.base_loader) if self.process_index == 0 else None
        pending = next(source, None) if source is not None else None
        while True:
            payload: list[Any] = [None]
            if self.process_index == 0:
                following = next(source, None) if pending is not None else None
                payload = [{"stop": pending is None,
                            "batch": None if pending is None else _to_host(pending),
                            "last": following is None}]
                pending = following
            broadcast_object_list(payload, from_process=0)
            info = payload[0]
            if info["stop"]:
                return
            yield self._slice(info["batch"], last=info["last"])


def prepare_data_loader(dataloader: Any, device: str | torch.device | None = None,
                        use_seedable_sampler: bool = True, seed: int = 0,
                        prefetch: str = "none", num_processes: int | None = None,
                        process_index: int | None = None, split_batches: bool = False,
                        even_batches: bool = True, dispatch_batches: bool | None = None
                        ) -> DataLoaderShard:
    """Wrap ``dataloader`` for this process (reference
    `data_loader.py:744`); ``num_processes`` and ``process_index`` default to
    the process group's. A `torch.utils.data.DataLoader` is rebuilt, keeping
    its collate function and workers: over a map-style dataset that
    shuffles, around a `SeedableRandomSampler`; at several processes around
    a `BatchSamplerShard` (``split_batches``, ``even_batches``), or for an
    iterable dataset an `IterableDatasetShard`, or with ``dispatch_batches``
    (the default for iterable datasets at several processes) left whole
    for a `DataLoaderDispatcher`. Any other iterable yields global batches
    (a `DataLoaderShard` that slices them, or a dispatcher)."""
    from .state import topology

    top = topology()
    num_processes = top.num_processes if num_processes is None else num_processes
    process_index = top.process_index if process_index is None else process_index
    shard = dict(num_processes=num_processes, process_index=process_index)
    if not isinstance(dataloader, torch.utils.data.DataLoader):
        cls = DataLoaderDispatcher if dispatch_batches else DataLoaderShard
        return cls(dataloader, device=device,
                   total_dataset_length=getattr(dataloader, "total_dataset_length", None),
                   total_batch_size=getattr(dataloader, "total_batch_size", None),
                   prefetch=prefetch, **shard)
    dataset = dataloader.dataset
    batch_size = dataloader.batch_size
    if batch_size is None and dataloader.batch_sampler is not None:
        batch_size = getattr(dataloader.batch_sampler, "batch_size", None)
    drop_last = dataloader.drop_last
    common = dict(num_workers=dataloader.num_workers, collate_fn=dataloader.collate_fn,
                  timeout=dataloader.timeout, worker_init_fn=dataloader.worker_init_fn)
    iterable = isinstance(dataset, torch.utils.data.IterableDataset)
    if dispatch_batches is None:
        dispatch_batches = num_processes > 1 and iterable
    sampler = None
    if iterable:
        local_bs = batch_size
        if num_processes > 1 and not dispatch_batches:
            dataset = IterableDatasetShard(
                dataset, batch_size=batch_size if split_batches else batch_size * num_processes,
                num_processes=num_processes, process_index=process_index, drop_last=drop_last,
                split_batches=True, seed=seed)
            local_bs = batch_size // num_processes if split_batches else batch_size
        loader = torch.utils.data.DataLoader(dataset, batch_size=local_bs, drop_last=drop_last,
                                             **common)
    else:
        batch_sampler = dataloader.batch_sampler
        if use_seedable_sampler and isinstance(getattr(batch_sampler, "sampler", None),
                                               torch.utils.data.RandomSampler):
            sampler = SeedableRandomSampler(len(dataset), seed=seed)
            batch_sampler = torch.utils.data.BatchSampler(sampler, batch_size=batch_size,
                                                          drop_last=drop_last)
        if num_processes > 1 and not dispatch_batches:
            batch_sampler = BatchSamplerShard(batch_sampler, num_processes, process_index,
                                              split_batches=split_batches,
                                              even_batches=even_batches)
        loader = torch.utils.data.DataLoader(dataset, batch_sampler=batch_sampler, **common)
    total = len(dataset) if hasattr(dataset, "__len__") else None
    global_batch = batch_size if (split_batches or dispatch_batches or batch_size is None) \
        else batch_size * num_processes
    cls = DataLoaderDispatcher if dispatch_batches else DataLoaderShard
    # the sampler or the dataset shard already split the data unless rank 0 dispatches it
    return cls(loader, device=device, synchronized_generator=sampler,
               total_dataset_length=total, total_batch_size=global_batch,
               _drop_last=drop_last, prefetch=prefetch,
               num_processes=num_processes if dispatch_batches else 1,
               process_index=process_index if dispatch_batches else 0)


class SkipBatchSampler:
    """A batch sampler without its first ``skip_batches`` batches (reference
    `data_loader.py:849`)."""

    def __init__(self, batch_sampler: Any, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def __iter__(self) -> Iterator[list[int]]:
        for i, batch in enumerate(self.batch_sampler):
            if i >= self.skip_batches:
                yield batch

    @property
    def total_length(self) -> int:
        return len(self.batch_sampler)

    def __len__(self) -> int:
        return max(len(self.batch_sampler) - self.skip_batches, 0)


class _SkipIterable:
    """An iterable without its first ``skip`` items."""

    def __init__(self, base: Iterable, skip: int):
        self.base = base
        self.skip = skip

    def __iter__(self) -> Iterator[Any]:
        for i, batch in enumerate(self.base):
            if i >= self.skip:
                yield batch

    def __len__(self) -> int:
        return max(len(self.base) - self.skip, 0)


def skip_first_batches(dataloader: Any, num_batches: int = 0) -> Any:
    """Resume mid-epoch: the next pass over a `DataLoaderShard` skips its
    first ``num_batches`` batches (the loader itself is returned, still
    bound to its accelerator); any other iterable is wrapped (reference
    `data_loader.py:880`)."""
    if isinstance(dataloader, DataLoaderShard):
        dataloader.skip_batches = num_batches
        return dataloader
    return _SkipIterable(dataloader, num_batches)
