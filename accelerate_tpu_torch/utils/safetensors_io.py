"""safetensors interchange, both directions: the port of
`accelerate_tpu.utils.safetensors_io`.

The format is written and read here by hand, with no ``safetensors`` and no
``ml_dtypes`` package: a file is a little-endian u64 header size, a JSON
header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` (start and end in the data section, and an optional
``__metadata__`` of strings), then the raw bytes of every tensor. Every dtype
crosses as raw bytes of a torch tensor (``view(torch.uint8)``), so bf16 never
passes through a numpy dtype. A checkpoint either package writes loads in the
other, byte for byte.

Export (`save_safetensors_checkpoint`): sharded ``.safetensors`` files with
``model.safetensors.index.json``, tied (aliased) tensors saved once and
recorded under ``metadata.tied_weights``, as the reference writes them. Import
(`load_safetensors_checkpoint`): a single file, a sharded directory with its
index, or a directory of ``.safetensors`` files, into a flat dict of CPU
tensors (``nested=True`` unflattens the dotted keys); tied aliases come back
as the canonical tensor. `load_checkpoint_in_model` loads such a checkpoint
into a module's state dict, through a ``mapper`` for a foreign layout (the
models' ``params_from_jax`` maps a checkpoint the reference wrote).
"""

from __future__ import annotations

import json
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Mapping

import torch

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _flatten_leaves(tree: Any, sep: str = ".") -> dict[str, Any]:
    """Nested dicts, lists and tuples -> flat ``{dotted_key: leaf}``, the
    leaves themselves (aliasing must survive for tied-weight detection)."""
    flat: dict[str, Any] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{sep}{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{sep}{i}" if prefix else str(i))
        elif node is not None:
            flat[prefix] = node

    walk(tree, "")
    return flat


def flatten_state_dict(tree: Any, sep: str = ".") -> dict[str, torch.Tensor]:
    """Nested dicts of tensors -> flat ``{dotted_key: tensor}``."""
    return {k: torch.as_tensor(v) for k, v in _flatten_leaves(tree, sep).items()}


def unflatten_state_dict(flat: Mapping[str, Any], sep: str = ".") -> dict:
    """Flat ``{dotted_key: tensor}`` -> nested dicts."""
    out: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(sep)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _parse_size(size: str | int) -> int:
    if isinstance(size, int):
        return size
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([KMGT]?B)\s*", size, re.IGNORECASE)
    if not m:
        raise ValueError(f"Unparseable max_shard_size {size!r}")
    mult = {"B": 1, "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12}
    return int(float(m.group(1)) * mult[m.group(2).upper()])


def find_tied_weights(flat: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """``{alias_key: canonical_key}`` for entries that are the SAME view of
    the same memory (data pointer, shape, strides and dtype): two different
    views of one buffer (q/k/v slices of a fused qkv) are not tied. The first
    occurrence is canonical."""
    seen: dict[tuple, str] = {}
    tied: dict[str, str] = {}
    for k, v in flat.items():
        ident = (v.data_ptr(), tuple(v.shape), v.stride(), v.dtype, v.device)
        if ident in seen:
            tied[k] = seen[ident]
        else:
            seen[ident] = k
    return tied


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    """The raw little-endian bytes of a tensor, by way of a uint8 view."""
    t = t.detach().to("cpu").contiguous()
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Mapping[str, torch.Tensor], path: str | os.PathLike,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write one ``.safetensors`` file: the header, then each tensor's bytes,
    widest dtype first so every tensor starts aligned to its element size.
    The header is padded with spaces to a multiple of 8 bytes, as the
    format's own writer pads it."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    tensors = dict(sorted(tensors.items(), key=lambda kv: -kv[1].element_size()))
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(_tensor_bytes(t))


def _read_header(f) -> tuple[dict, int]:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n)), 8 + n


def read_metadata(path: str | os.PathLike) -> dict[str, str]:
    """A file's ``__metadata__`` (empty when it has none)."""
    with open(path, "rb") as f:
        return dict(_read_header(f)[0].get("__metadata__") or {})


def load_file(path: str | os.PathLike, dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over one
    buffer read whole from disk. ``dtype`` casts the floating ones."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        f.seek(0, os.SEEK_END)
        data = bytearray(f.tell() - start)
        f.seek(start)
        f.readinto(data)
    buf = torch.frombuffer(data, dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        kind = _DTYPES[info["dtype"]]
        part = buf[lo:hi]
        if lo % kind.itemsize:  # a writer that did not align this tensor
            part = part.clone()
        t = part.view(kind).reshape(info["shape"])
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out


def save_safetensors_checkpoint(
    state_dict: Any,
    save_directory: str | os.PathLike,
    max_shard_size: str | int = "10GB",
    metadata: dict[str, str] | None = None,
) -> list[str]:
    """Write a (possibly nested) state dict as sharded safetensors with an
    index when it takes more than one shard; returns the files written. A new
    shard starts when the next tensor would take the current one past
    ``max_shard_size``. Tied (aliased) tensors are saved once and recorded
    under ``tied_weights`` in the metadata, as the reference records them."""
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    raw = _flatten_leaves(state_dict)
    tied = find_tied_weights(raw)
    flat = {k: v for k, v in raw.items() if k not in tied}

    limit = _parse_size(max_shard_size)
    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for k, v in flat.items():
        nbytes = v.numel() * v.element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += nbytes

    meta = {"format": "pt", **(metadata or {})}
    if tied:
        meta["tied_weights"] = json.dumps(tied)
    if len(shards) == 1:
        path = save_directory / SAFE_WEIGHTS_NAME
        save_file(shards[0], path, meta)
        return [str(path)]
    n = len(shards)
    written: list[str] = []
    weight_map: dict[str, str] = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file(shard, save_directory / name, meta)
        written.append(str(save_directory / name))
        weight_map.update({k: name for k in shard})
    index_meta = {"total_size": int(sum(sizes)), **{k: v for k, v in meta.items() if k != "format"}}
    index = {"metadata": index_meta, "weight_map": weight_map}
    index_path = save_directory / SAFE_WEIGHTS_INDEX_NAME
    index_path.write_text(json.dumps(index, indent=2, sort_keys=True))
    written.append(str(index_path))
    return written


def load_safetensors_checkpoint(
    checkpoint: str | os.PathLike,
    *,
    nested: bool = False,
    dtype: torch.dtype | None = None,
) -> dict[str, Any]:
    """Read a safetensors checkpoint (single file, sharded directory with
    index, or a directory of ``.safetensors`` files) into a flat dict of CPU
    tensors, shards read in parallel threads. Tied aliases recorded by
    `save_safetensors_checkpoint` come back as the canonical tensor.
    ``nested=True`` unflattens the dotted keys; ``dtype`` casts the floating
    tensors."""
    path = Path(checkpoint)
    tied: dict[str, str] = {}
    if path.is_file():
        files = [path]
    elif (path / SAFE_WEIGHTS_INDEX_NAME).exists():
        index = json.loads((path / SAFE_WEIGHTS_INDEX_NAME).read_text())
        files = [path / name for name in sorted(set(index["weight_map"].values()))]
        if "tied_weights" in index.get("metadata", {}):
            tied = json.loads(index["metadata"]["tied_weights"])
    elif (path / SAFE_WEIGHTS_NAME).exists():
        files = [path / SAFE_WEIGHTS_NAME]
    else:
        files = sorted(path.glob("*.safetensors")) if path.is_dir() else []
        if not files:
            raise FileNotFoundError(f"No safetensors checkpoint at {checkpoint}")
    flat: dict[str, Any] = {}
    with ThreadPoolExecutor(max_workers=min(len(files), 8)) as pool:
        for part in pool.map(lambda f: load_file(f, dtype), files):
            flat.update(part)
    for f in files:
        if not tied:
            meta = read_metadata(f)
            if "tied_weights" in meta:
                tied = json.loads(meta["tied_weights"])
    for alias, canonical in tied.items():
        if canonical in flat:
            flat[alias] = flat[canonical]
    return unflatten_state_dict(flat) if nested else flat


def to_device(t: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """``t`` on ``device``, its bytes moved as they lie: a transposed view of
    a contiguous tensor (a mapper's ``[in, out]`` -> ``[out, in]`` kernel)
    crosses as that contiguous tensor and is transposed on the device, not
    copied into the new layout on the host first."""
    if t.ndim == 2 and not t.is_contiguous() and t.T.is_contiguous():
        return t.T.to(device).T
    return t.to(device)


def load_checkpoint_in_model(
    model: torch.nn.Module,
    checkpoint: str | os.PathLike,
    mapper: Callable[[dict], dict] | None = None,
    strict: bool = True,
) -> torch.nn.Module:
    """Load a safetensors checkpoint into ``model`` (the reference's
    ``load_checkpoint_in_model``): the flat dict it holds, passed through
    ``mapper`` when its names and layout are not the module's own (a
    checkpoint the reference wrote maps through the model's
    ``params_from_jax``), is copied into the module's state, leaf by leaf:
    each tensor goes to its parameter's device in the checkpoint's dtype and
    is cast there. ``strict`` refuses missing and unexpected names, as
    ``load_state_dict`` does. Returns ``model``."""
    flat = load_safetensors_checkpoint(checkpoint)
    state = mapper(flat) if mapper is not None else flat
    own = model.state_dict()
    missing, unexpected = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if strict and (missing or unexpected):
        raise RuntimeError(f"Error(s) in loading state_dict for {type(model).__name__}: "
                           f"Missing key(s): {missing[:8]}; Unexpected key(s): {unexpected[:8]}")
    with torch.no_grad():
        for name, value in state.items():
            if name in own:
                if tuple(value.shape) != tuple(own[name].shape):
                    raise RuntimeError(f"size mismatch for {name}: checkpoint "
                                       f"{tuple(value.shape)}, model {tuple(own[name].shape)}")
                own[name].copy_(to_device(value, own[name].device))
    return model
