"""Model introspection for placement: the port of
`accelerate_tpu.utils.modeling`.

Sizes, memory budgets, tied weights and the flat <-> nested converters the
offload and dispatch stack uses. A parameter tree is nested dicts whose
leaves are tensors (or numpy arrays); a flat key joins the path with the
reference's ``/`` separator, so device-map keys read the same in both
packages (``layer_1/attn``).

Tied leaves are the same view of the same memory, as
`utils.safetensors_io.find_tied_weights` finds them: data pointer, shape,
strides and dtype (meta and empty tensors by object, as they have no
storage).
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def dtype_byte_size(dtype: Any) -> float:
    """Bytes of one element of a torch or numpy dtype (or its name)."""
    if hasattr(dtype, "itemsize"):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def flatten_params(params: Any, prefix: str = "", sep: str = "/") -> dict[str, Any]:
    """Nested dicts -> ``{'a/b/c': leaf}``."""
    flat: dict[str, Any] = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}{sep}", sep))
    else:
        flat[prefix[: -len(sep)]] = params
    return flat


def unflatten_params(flat: Mapping[str, Any], sep: str = "/") -> dict[str, Any]:
    nested: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return nested


def named_module_tensors(params: Any) -> list[tuple[str, Any]]:
    return sorted(flatten_params(params).items())


def _nbytes(leaf: Any, dtype: Any | None = None) -> int:
    shape = tuple(getattr(leaf, "shape", ()))
    return int(math.prod(shape or (1,))) * int(dtype_byte_size(dtype or leaf.dtype))


def compute_module_sizes(params: Any, dtype: Any | None = None) -> dict[str, int]:
    """Bytes per module path, summed up the tree (the reference's
    ``compute_module_sizes``); key ``""`` is the total. Keys come in sorted
    order, as the reference's do."""
    sizes: dict[str, int] = {}
    for name, leaf in named_module_tensors(params):
        nbytes = _nbytes(leaf, dtype)
        parts = name.split("/")
        for i in range(len(parts) + 1):
            key = "/".join(parts[:i])
            sizes[key] = sizes.get(key, 0) + nbytes
    return sizes


def calculate_maximum_sizes(params: Any) -> tuple[int, tuple[int, str]]:
    """(total bytes, (largest leaf's bytes, its name))."""
    total = 0
    largest = (0, "")
    for name, leaf in named_module_tensors(params):
        nbytes = _nbytes(leaf)
        total += nbytes
        if nbytes > largest[0]:
            largest = (nbytes, name)
    return total, largest


def _storage_identity(leaf: Any) -> tuple | None:
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type == "meta" or leaf.numel() == 0:
            return ("object", id(leaf))
        return (leaf.data_ptr(), tuple(leaf.shape), leaf.stride(), leaf.dtype, leaf.device)
    if isinstance(leaf, np.ndarray):
        if leaf.size == 0:
            return ("object", id(leaf))
        return (leaf.__array_interface__["data"][0], leaf.shape, leaf.strides, leaf.dtype)
    return None


def find_tied_parameters(params: Any) -> list[list[str]]:
    """Groups of leaf names (sorted) that are one view of one buffer (the
    reference's ``find_tied_parameters``)."""
    by_storage: dict[tuple, list[str]] = {}
    for name, leaf in named_module_tensors(params):
        ident = _storage_identity(leaf)
        if ident is not None:
            by_storage.setdefault(ident, []).append(name)
    return [names for names in by_storage.values() if len(names) > 1]


def _host_available_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            avail_kb = int(re.search(r"MemAvailable:\s+(\d+)", f.read()).group(1))
        return avail_kb * 1024
    except (OSError, AttributeError):
        return 16 * 1024**3


def get_max_memory(max_memory: dict | None = None) -> dict[str, int]:
    """Memory budget per tier: 0.9 of each CUDA device's free memory as
    ``device:i`` (``torch.cuda.mem_get_info``), half the host's available
    RAM as ``cpu``, an unbounded ``disk`` (reference
    `utils/modeling.py:89-110`). A given ``max_memory`` is returned as it
    is."""
    if max_memory is not None:
        return dict(max_memory)
    out: dict[str, int] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, _total = torch.cuda.mem_get_info(i)
            out[f"device:{i}"] = int(free * 0.9)
    out["cpu"] = _host_available_bytes() // 2
    out["disk"] = 1 << 62
    return out


def get_balanced_memory(
    params: Any,
    num_devices: int | None = None,
    no_split_module_classes: Any = None,
    low_zero: bool = False,
) -> dict[str, int]:
    """Per-device budgets that spread the model evenly (the reference's
    ``get_balanced_memory``): each device gets at least the largest
    top-level block, with 10 % slack, and ``low_zero`` halves device 0's
    share (room for generation there)."""
    total, (largest_leaf, _) = calculate_maximum_sizes(params)
    sizes = compute_module_sizes(params)
    top_blocks = [v for k, v in sizes.items() if k and "/" not in k]
    largest_block = max(top_blocks, default=largest_leaf)
    n = num_devices or max(torch.cuda.device_count(), 1)
    per = max(-(-total // n), largest_block)
    per = int(per * 1.1)
    budget = {f"device:{i}": per for i in range(n)}
    if low_zero and n > 1:
        budget["device:0"] = per // 2
    budget["cpu"] = get_max_memory()["cpu"]
    budget["disk"] = 1 << 62
    return budget


def state_dict_subtree(state_dict: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """The entries of a flat (dotted) state dict under ``prefix``, nested by
    the rest of their names: ``blocks.0.`` of GPT-2's gives ``{"ln_1":
    {"weight": ..., "bias": ...}, "attn": {...}, ...}``. The tensors are the
    state dict's own, so tied ones stay tied."""
    return unflatten_params({k[len(prefix):]: v for k, v in state_dict.items()
                             if k.startswith(prefix)}, sep=".")
