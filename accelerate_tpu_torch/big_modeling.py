"""Big-model placement on one card: the port of `accelerate_tpu.big_modeling`.

A model too large for the card runs as a `BlockwiseModel`: a sequence of
blocks (``embed -> layer_i... -> head``), each a function of its own
parameter subtree. `infer_auto_device_map` fits the blocks onto ordered
tiers, ``device`` (or ``device:i``), ``cpu`` and ``disk``, with the
reference's solver (`accelerate_tpu/big_modeling.py:63-194`), and
`dispatch_model` places them: device blocks stay resident on the card, cpu
blocks sit in pinned host memory, disk blocks in the reference's offload
format (`utils.offload`). Device-map keys are ``/``-joined paths of the
blockwise state dict, so the two packages' maps compare key for key.

Streaming on the card, where the reference leans on JAX's async dispatch:

- each offloaded entry is copied ``non_blocking`` on a copy stream of the
  model's own; block i+1's host-to-device copies are issued before block i
  computes, and the compute stream waits on an event before it reads block
  i+1;
- the streamed tensors are allocated on the copy stream and marked with
  ``record_stream`` for the compute stream, so the caching allocator reuses
  their memory only after the block that read them ran; before it issues
  block i+1's copies, the host waits for block i-1 to finish, so at most two
  blocks' streamed tensors (the current one and the prefetched one) are
  alive;
- a disk entry is read from its memmap into a reused pinned staging buffer,
  sized to the largest disk leaf, and takes the same host-to-device path;
  the file reads of block i+1 run on the host while block i computes;
- a block the solver split is assembled from its entries, wherever each
  lies.

The peak device memory is then the resident blocks, the streamed bytes of
two consecutive blocks, and the activations. The entry points run on CUDA
unless the caller passes ``device="cpu"``; on the CPU every tier is host
memory and nothing streams.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .utils.environment import resolve_device
from .utils.modeling import (
    compute_module_sizes,
    find_tied_parameters,
    flatten_params,
    get_max_memory,
    unflatten_params,
)
from .utils.offload import (
    OffloadedWeightsLoader,
    load_offloaded_weight,
    offload_state_dict,
    offloaded_memmap,
    torch_dtype,
)


class _OnDevice:
    """What `init_on_device` yields: ``init(cls, *args, **kwargs)`` builds
    one of the port's models on the device."""

    def __init__(self, device: torch.device):
        self.device = device

    def init(self, module_cls: Callable[..., nn.Module], *args: Any, **kwargs: Any) -> nn.Module:
        return module_cls(*args, device=self.device, **kwargs)


@contextlib.contextmanager
def init_on_device(device: str | torch.device) -> Iterator[_OnDevice]:
    """Tensors made inside the block without a device land on ``device``
    (torch's default-device context), and the helper it yields builds the
    port's models there (they take ``device=``)."""
    device = torch.device(device)
    with torch.device(device):
        yield _OnDevice(device)


@contextlib.contextmanager
def init_empty_weights() -> Iterator[_OnDevice]:
    """`init_on_device` on the ``meta`` device: shapes and dtypes, no
    storage (reference `big_modeling.py:41`)."""
    with init_on_device("meta") as meta:
        yield meta


def infer_auto_device_map(
    params: Any,
    max_memory: dict[str, int] | None = None,
    no_split_module_classes: Sequence[str] | None = None,
    dtype: Any | None = None,
    clean_result: bool = True,
) -> dict[str, str]:
    """Fit a parameter tree (nested dicts of tensors) onto the ordered tiers
    ``device`` (pooled) or ``device:i`` in index order, then ``cpu``, then an
    unbounded ``disk``: the reference's solver as it is.

    - Top-level blocks linked by tied leaves are one placement unit, whose
      size counts the shared leaf once.
    - Units are placed in the tree's order, each on the first tier from the
      last one used that holds it: no backfill onto an earlier tier.
    - A single block too large for a (non-disk) tier is split into its
      children, which are placed in its stead, unless its key's last part
      contains an entry of ``no_split_module_classes``.
    - ``clean_result`` merges children that landed on one tier back into
      their parent (`clean_device_map`)."""
    budgets = get_max_memory(max_memory)
    tiers: list[list[Any]] = []
    if "device" in budgets:
        tiers.append(["device", budgets["device"]])
    tiers.extend(
        [k, budgets[k]]
        for k in sorted((k for k in budgets if k.startswith("device:")),
                        key=lambda k: int(k.split(":")[1]))
    )
    tiers.append(["cpu", budgets.get("cpu", 0)])
    tiers.append(["disk", 1 << 62])
    no_split = tuple(no_split_module_classes or ())
    sizes = compute_module_sizes(params, dtype=dtype)
    tied_groups = find_tied_parameters(params)

    def block_of(leaf_path: str) -> str:
        return leaf_path.split("/", 1)[0]

    if isinstance(params, dict):
        top_order = [str(k) for k in params.keys()]
    else:
        top_order = [k for k in sizes if k and "/" not in k]
    parent: dict[str, str] = {b: b for b in top_order if b in sizes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    shared_bytes: dict[tuple[str, ...], int] = {}
    for group in tied_groups:
        blocks = sorted({block_of(p) for p in group})
        for a, b in zip(blocks, blocks[1:]):
            parent[find(a)] = find(b)
        if len(blocks) > 1:
            dup = sizes.get(group[0], 0) * (len(group) - 1)
            shared_bytes[tuple(blocks)] = shared_bytes.get(tuple(blocks), 0) + dup

    units: list[tuple[list[str], int]] = []
    seen_roots: dict[str, int] = {}
    for b in parent:
        root = find(b)
        if root not in seen_roots:
            seen_roots[root] = len(units)
            units.append(([b], sizes[b]))
        else:
            names, total = units[seen_roots[root]]
            names.append(b)
            units[seen_roots[root]] = (names, total + sizes[b])
    for blocks, dup in shared_bytes.items():
        for i, (names, total) in enumerate(units):
            if set(blocks) <= set(names):
                units[i] = (names, total - dup)
                break

    device_map: dict[str, str] = {}
    queue: list[tuple[list[str], int]] = list(units)
    cursor = 0
    while queue:
        names, size = queue.pop(0)
        placed = False
        for ti in range(cursor, len(tiers)):
            tier_name, budget = tiers[ti]
            if size <= budget:
                for n in names:
                    device_map[n] = tier_name
                tiers[ti][1] = budget - size
                cursor = ti
                placed = True
                break
            if (
                tier_name != "disk"
                and len(names) == 1
                and not any(pat in names[0].rsplit("/", 1)[-1] for pat in no_split)
            ):
                children = [k for k in sizes if k.startswith(names[0] + "/")
                            and k.count("/") == names[0].count("/") + 1]
                if children:
                    queue = [([c], sizes[c]) for c in children] + queue
                    placed = True
                    break
        if not placed:
            for n in names:
                device_map[n] = "disk"

    if clean_result:
        device_map = clean_device_map(device_map)
    return device_map


def clean_device_map(device_map: dict[str, str], module_prefix: str = "") -> dict[str, str]:
    """Merge child entries that share one tier back into their parent
    (reference ``clean_device_map``)."""
    prefixes = {k.rsplit("/", 1)[0] for k in device_map if "/" in k}
    for prefix in sorted(prefixes, key=lambda p: -p.count("/")):
        children = {k: v for k, v in device_map.items() if k.startswith(prefix + "/")}
        if children and len(set(children.values())) == 1 and prefix not in device_map:
            for k in children:
                del device_map[k]
            device_map[prefix] = next(iter(children.values()))
    return device_map


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> list[torch.Tensor]:
    return list(flatten_params(tree).values()) if isinstance(tree, dict) else [tree]


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a (nested) tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


class _Method(nn.Module):
    """Calls one method of ``module`` as its forward, so that
    `functional_call` can run that method on other parameters."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return getattr(self.module, self.method)(*args, **kwargs)


def call_block(template: nn.Module, params: dict, *args: Any, method: str | None = None,
               **kwargs: Any) -> Any:
    """Run ``template``, a module that holds no weights of its own (built on
    ``meta``), on ``params``: nested dicts by its attribute names, as a
    blockwise state dict holds them. With ``method``, that method of the
    template runs instead of its forward (a model's ``embed`` or
    ``head``), reading the parameters it names from ``params``."""
    if method is not None:
        template, params = _Method(template, method), {"module": params}
    return functional_call(template, flatten_params(params, sep="."), args, kwargs)


@dataclass
class _Fetched:
    """One block's parameters on their way to its execution device."""

    name: str
    device: torch.device
    parts: list  # (device-map key, tree, or None until its disk read)
    params: Any = None  # the assembled tree, once finished
    streamed: bool = False
    ready: Any = None  # a CUDA event on the copy stream after the block's copies


@dataclass
class BlockwiseModel:
    """A sequential block decomposition: the unit of offload streaming.

    ``block_fns`` holds ``(name, fn(block_params, x) -> x)`` in execution
    order; `dispatch_model` fills ``params`` (per device-map entry: device
    tensors, pinned host tensors, or nothing for disk), ``device_map``,
    ``offload_loader`` and ``device``. ``streamed_bytes`` counts the bytes
    each tier sent to the device since it was last reset.

    ``cache_resident`` (`cpu_offload_with_hook`): streamed blocks stay on
    the device across calls until the hook's ``offload()``. With
    ``copy_log`` a list, each streamed entry on CUDA appends ``{"tier",
    "bytes", "start", "end", "read_s"}``: timing events on the copy stream
    around its copies, and the host seconds spent reading its file (disk)."""

    block_fns: list[tuple[str, Callable]]
    params: dict[str, Any] = field(default_factory=dict)
    device_map: dict[str, str] = field(default_factory=dict)
    offload_loader: OffloadedWeightsLoader | None = None
    device: torch.device | None = None
    cache_resident: bool = False
    streamed_bytes: dict[str, int] = field(default_factory=lambda: {"cpu": 0, "disk": 0})
    copy_log: list | None = None
    _cache: dict = field(default_factory=dict, repr=False)
    _prev_hook: Any = None
    _copy_stream: Any = field(default=None, repr=False)
    _staging: torch.Tensor | None = field(default=None, repr=False)
    _staging_free: Any = field(default=None, repr=False)
    _read_s: float = field(default=0.0, repr=False)

    # ------------------------------------------------------------ placement
    def _tier_device(self, tier: str) -> torch.device:
        """The device a ``device`` / ``device:i`` entry lives on."""
        if ":" not in tier:
            return self.device
        idx = int(tier.split(":")[1])
        count = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if idx >= count:
            raise ValueError(
                f"device_map tier {tier!r} but only {count} device(s) exist: the map was "
                "solved for a different topology; re-run infer_auto_device_map.")
        return torch.device("cuda", idx) if self.device.type == "cuda" else self.device

    def _entries(self, name: str) -> list[tuple[str, str]]:
        """The device-map entries that make up block ``name``."""
        if name in self.device_map:
            return [(name, self.device_map[name])]
        entries = [(k, t) for k, t in self.device_map.items() if k.startswith(name + "/")]
        if not entries:
            raise KeyError(f"no device_map entry covers block {name!r}")
        return entries

    def _block_device(self, name: str) -> torch.device:
        for _key, tier in self._entries(name):
            if tier.startswith("device"):
                return self._tier_device(tier)
        return self.device

    def offloaded_bytes(self) -> list[tuple[str, int, int]]:
        """Per block, in order: (name, bytes, tensors) of its cpu and disk
        entries, what a call streams to the device."""
        out = []
        for name, _ in self.block_fns:
            nbytes = count = 0
            for key, tier in self._entries(name):
                if tier == "cpu":
                    leaves = _leaves(self.params[key])
                    nbytes += sum(t.numel() * t.element_size() for t in leaves)
                    count += len(leaves)
                elif tier == "disk":
                    loader = self.offload_loader
                    for k in self._disk_keys(key):
                        nbytes += offloaded_memmap(loader.save_folder, k, loader.index[k]).nbytes
                        count += 1
            out.append((name, nbytes, count))
        return out

    def streamed_pair(self) -> tuple[int, int]:
        """(bytes, tensors) of the two consecutive blocks that stream the
        most: with the current block and the prefetched one alive, the
        streamed share of the peak device memory."""
        blocks = [(nbytes, count) for _name, nbytes, count in self.offloaded_bytes()]
        if len(blocks) == 1:
            return blocks[0]
        return max((a[0] + b[0], a[1] + b[1]) for a, b in zip(blocks, blocks[1:]))

    # ------------------------------------------------------------ streaming
    def _streams(self, target: torch.device) -> tuple[Any, Any]:
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=target)
        return self._copy_stream, torch.cuda.current_stream(target)

    def _h2d(self, host: torch.Tensor, target: torch.device, compute: Any) -> torch.Tensor:
        out = host.to(target, non_blocking=True)
        out.record_stream(compute)
        return out

    def _staged_h2d(self, key: str, target: torch.device, compute: Any) -> torch.Tensor:
        """One disk leaf: memmap -> the pinned staging buffer -> the device,
        on the copy stream (current when called)."""
        info = self.offload_loader.index[key]
        mm = offloaded_memmap(self.offload_loader.save_folder, key, info)
        n = mm.nbytes
        if self._staging is None or self._staging.numel() < n:
            self._staging = torch.empty(self._largest_disk_leaf(), dtype=torch.uint8,
                                        pin_memory=True)
        if self._staging_free is not None:
            self._staging_free.synchronize()  # the last staged copy has left the buffer
        host = self._staging[:n]
        t0 = time.perf_counter()
        np.copyto(host.numpy().view(mm.dtype).reshape(mm.shape), mm)
        if self.copy_log is not None:
            self._read_s += time.perf_counter() - t0
        out = self._h2d(host.view(torch_dtype(info)).reshape(info["shape"]), target, compute)
        self._staging_free = torch.cuda.Event()
        self._staging_free.record()
        return out

    def _largest_disk_leaf(self) -> int:
        loader = self.offload_loader
        return max(offloaded_memmap(loader.save_folder, k, info).nbytes
                   for k, info in loader.index.items())

    def _disk_keys(self, key: str) -> list[str]:
        index = self.offload_loader.index
        if key in index:
            return [key]
        return [k for k in index if k.startswith(key + "/")]

    def _read_disk_entry(self, key: str, target: torch.device, compute: Any) -> Any:
        """A disk entry on ``target``: staged and copied on CUDA (the copy
        stream current), read into host tensors on the CPU."""
        flat = {}
        for k in self._disk_keys(key):
            rel = k[len(key) + 1:] if k != key else ""
            if target.type == "cuda":
                flat[rel] = self._staged_h2d(k, target, compute)
                self.streamed_bytes["disk"] += tree_bytes(flat[rel])
            else:
                flat[rel] = load_offloaded_weight(self.offload_loader.save_folder, k,
                                                  self.offload_loader.index[k])
        return flat[""] if "" in flat else unflatten_params(flat)

    def _fetch(self, name: str) -> _Fetched:
        """Start bringing block ``name``'s parameters to its execution device:
        resident entries as they are; on CUDA, cpu entries' copies issued on
        the copy stream now, disk entries left for `_finish` (their file
        reads are host work)."""
        target = self._block_device(name)
        fetched = _Fetched(name, target, [])
        for key, tier in self._entries(name):
            if tier.startswith("device"):
                fetched.parts.append((key, self.params[key]))
            elif tier == "cpu" and target.type == "cuda":
                copy, compute = self._streams(target)
                with torch.cuda.stream(copy):
                    start = self._log_start(copy)
                    part = _tree_map(lambda t: self._h2d(t, target, compute), self.params[key])
                    self.streamed_bytes["cpu"] += tree_bytes(part)
                    self._log_end(copy, start, "cpu", tree_bytes(part))
                fetched.parts.append((key, part))
                fetched.streamed = True
            elif tier == "cpu":
                fetched.parts.append((key, self.params[key]))
            else:
                fetched.parts.append((key, None))  # read in _finish
        return fetched

    def _finish(self, fetched: _Fetched) -> _Fetched:
        """Read and copy the block's disk entries, assemble its tree, and on
        CUDA record ``ready`` on the copy stream after all its copies."""
        target = fetched.device
        cuda = target.type == "cuda"
        ctx = torch.cuda.stream(self._streams(target)[0]) if cuda else contextlib.nullcontext()
        with ctx:
            for n, (key, part) in enumerate(fetched.parts):
                if part is None:
                    copy, compute = self._streams(target) if cuda else (None, None)
                    start, before = self._log_start(copy), self.streamed_bytes["disk"]
                    fetched.parts[n] = (key, self._read_disk_entry(key, target, compute))
                    self._log_end(copy, start, "disk", self.streamed_bytes["disk"] - before)
                    fetched.streamed = cuda
            if fetched.streamed:
                fetched.ready = torch.cuda.Event()
                fetched.ready.record(self._copy_stream)
        sub: Any = {}
        for key, part in fetched.parts:
            if key == fetched.name:
                sub = part
                continue
            node = sub
            rel = key[len(fetched.name) + 1:].split("/")
            for p in rel[:-1]:
                node = node.setdefault(p, {})
            node[rel[-1]] = part
        fetched.params = sub
        return fetched

    def _log_start(self, copy: Any) -> Any:
        if copy is None or self.copy_log is None:
            return None
        self._read_s = 0.0
        start = torch.cuda.Event(enable_timing=True)
        start.record(copy)
        return start

    def _log_end(self, copy: Any, start: Any, tier: str, nbytes: int) -> None:
        if start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(copy)
        self.copy_log.append({"tier": tier, "bytes": nbytes, "start": start, "end": end,
                              "read_s": self._read_s if tier == "disk" else 0.0})

    def _fetch_cached(self, name: str) -> _Fetched:
        if name not in self._cache:
            self._cache[name] = self._finish(self._fetch(name))
        return self._cache[name]

    def _evict_cache(self) -> None:
        self._cache.clear()

    # ------------------------------------------------------------------ run
    def __call__(self, x: Any) -> Any:
        if self._prev_hook is not None:
            # entering this model evicts the previous one's device copies
            self._prev_hook.offload()
        if self.device is None:
            raise RuntimeError("dispatch the model (dispatch_model) before calling it")
        if self.cache_resident:
            fetch, finish = self._fetch_cached, (lambda f: f)
        else:
            fetch, finish = self._fetch, self._finish
        names = [n for n, _ in self.block_fns]
        fns = dict(self.block_fns)
        done: Any = None  # the compute stream's event after the last block ran
        nxt = finish(fetch(names[0]))
        for i, name in enumerate(names):
            cur = nxt
            cuda = cur.device.type == "cuda"
            if isinstance(x, torch.Tensor) and x.device != cur.device:
                x = x.to(cur.device)
            if i + 1 < len(names):
                if done is not None:
                    done.synchronize()  # block i-1 ran: its streamed memory is free again
                nxt = fetch(names[i + 1])  # block i+1's copies, issued before block i computes
            if cuda and cur.ready is not None:
                torch.cuda.current_stream(cur.device).wait_event(cur.ready)
            x = fns[name](cur.params, x)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(cur.device))
            del cur  # block i's streamed tensors go (record_stream: once it has run)
            if i + 1 < len(names):
                nxt = finish(nxt)  # block i+1's file reads, while block i computes
        return x


def _resolve(state_dict: Any, path: str) -> Any:
    node = state_dict
    for part in path.split("/"):
        node = node[part]
    return node


def dispatch_model(
    model: BlockwiseModel,
    device_map: dict[str, str],
    state_dict: Any,
    offload_dir: str | None = None,
    device: str | torch.device | None = None,
) -> BlockwiseModel:
    """Place each entry of ``device_map`` (reference `big_modeling.py:308`):
    ``device`` and ``device:i`` entries are copied to the card (raising for
    an index past ``torch.cuda.device_count()``), ``cpu`` entries pinned in
    host memory once, here, and ``disk`` entries written to ``offload_dir``
    in the offload format. ``device`` is the execution device: CUDA unless
    ``"cpu"`` is passed (there, every tier is host memory)."""
    model.device = resolve_device(device)
    model.device_map = dict(device_map)
    cuda = model.device.type == "cuda"
    placed: dict[str, Any] = {}
    disk_flat: dict[str, torch.Tensor] = {}
    for name, tier in device_map.items():
        block = _resolve(state_dict, name)
        if tier.startswith("device"):
            target = model._tier_device(tier)
            placed[name] = _tree_map(lambda t, d=target: t.to(d), block)
        elif tier == "cpu":
            placed[name] = _tree_map(
                lambda t: t.detach().to("cpu").pin_memory() if cuda else t.detach().to("cpu"), block)
        elif tier == "disk":
            for k, v in flatten_params({name: block}).items():
                disk_flat[k] = v
        else:
            raise ValueError(f"device_map entry {name!r} -> unknown tier {tier!r}")
    loader = None
    if disk_flat:
        if offload_dir is None:
            raise ValueError("disk offload requires offload_dir")
        offload_state_dict(offload_dir, disk_flat)
        loader = OffloadedWeightsLoader(save_folder=offload_dir)
    model.params = placed
    model.offload_loader = loader
    model._cache = {}
    model._staging = None
    return model


def cpu_offload(model: BlockwiseModel, state_dict: Any,
                device: str | torch.device | None = None) -> BlockwiseModel:
    """Every block in host memory, streamed per block (reference
    `big_modeling.py:371`)."""
    return dispatch_model(model, {name: "cpu" for name, _ in model.block_fns}, state_dict,
                          device=device)


class UserCpuOffloadHook:
    """What `cpu_offload_with_hook` returns: ``offload()`` frees the model's
    streamed device copies; ``remove()`` also ends their staying."""

    def __init__(self, model: BlockwiseModel):
        self.model = model

    def offload(self) -> None:
        self.model._evict_cache()

    def remove(self) -> None:
        self.model.cache_resident = False
        self.model._prev_hook = None
        self.model._evict_cache()


def cpu_offload_with_hook(
    model: BlockwiseModel,
    state_dict: Any = None,
    prev_module_hook: UserCpuOffloadHook | None = None,
    device: str | torch.device | None = None,
) -> tuple[BlockwiseModel, UserCpuOffloadHook]:
    """CPU-offload ``model`` but keep its streamed weights on the device
    across calls until the returned hook's ``offload()``: the multi-model
    pipeline (reference `big_modeling.py:395`). Calling this model first
    offloads ``prev_module_hook``'s."""
    if state_dict is not None:
        model = cpu_offload(model, state_dict, device=device)
    model.cache_resident = True
    model._prev_hook = prev_module_hook
    return model, UserCpuOffloadHook(model)


def disk_offload(model: BlockwiseModel, state_dict: Any, offload_dir: str,
                 device: str | torch.device | None = None) -> BlockwiseModel:
    return dispatch_model(model, {name: "disk" for name, _ in model.block_fns}, state_dict,
                          offload_dir=offload_dir, device=device)


def load_checkpoint_and_dispatch(
    model: BlockwiseModel,
    checkpoint: str,
    device_map: dict[str, str] | str = "auto",
    max_memory: dict[str, int] | None = None,
    offload_folder: str | None = None,
    device: str | torch.device | None = None,
) -> BlockwiseModel:
    """Load a consolidated export of the blockwise state dict
    (`checkpointing.load_model_weights`) and dispatch it on the given, or
    solved (``"auto"``), map (reference `big_modeling.py:416`). The solver
    fits blocks in the tree's order, so the loaded tree is put in the
    model's execution order first (a file lists its tensors in its own)."""
    from .checkpointing import load_model_weights

    loaded = load_model_weights(checkpoint)
    order = [name for name, _ in model.block_fns if name in loaded]
    state_dict = {**{name: loaded[name] for name in order},
                  **{k: v for k, v in loaded.items() if k not in order}}
    if device_map == "auto":
        device_map = infer_auto_device_map(state_dict, max_memory=max_memory)
    return dispatch_model(model, device_map, state_dict, offload_dir=offload_folder,
                          device=device)
