"""Disk-offloaded weights: the port of `accelerate_tpu.utils.offload`.

The reference's on-disk format, so a folder written by either package is
read by the other: one raw ``.dat`` memmap per leaf, named by its key with
``/`` written as ``--``, and an ``index.json`` of each leaf's dtype (numpy's
name) and shape. bf16 is stored as its uint16 bits under ``"bfloat16"``; a
scalar as one element.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch


def _host_array(weight: Any) -> tuple[np.ndarray, str]:
    """(the array to write, the index's dtype name)."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(weight)
    return arr, str(arr.dtype)


def offload_weight(weight: Any, weight_name: str, offload_folder: str,
                   index: dict | None = None) -> dict:
    """Write one tensor (or array) to ``<name>.dat`` and record it in
    ``index``."""
    arr, dtype = _host_array(weight)
    os.makedirs(offload_folder, exist_ok=True)
    path = Path(offload_folder) / f"{weight_name.replace('/', '--')}.dat"
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape or (1,))
    mm[:] = arr if arr.shape else arr.reshape(1)
    mm.flush()
    del mm
    if index is not None:
        index[weight_name] = {"dtype": dtype, "shape": list(arr.shape)}
    return index if index is not None else {}


def save_offload_index(index: dict, offload_folder: str) -> None:
    with open(Path(offload_folder) / "index.json", "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    with open(Path(offload_folder) / "index.json") as f:
        return json.load(f)


def storage_dtype(info: dict) -> np.dtype:
    """The numpy dtype a leaf's ``.dat`` file holds."""
    return np.dtype(np.uint16) if info["dtype"] == "bfloat16" else np.dtype(info["dtype"])


def torch_dtype(info: dict) -> torch.dtype:
    """The torch dtype of an offloaded leaf."""
    if info["dtype"] == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=info["dtype"])).dtype


def offloaded_memmap(offload_folder: str, weight_name: str, info: dict) -> np.memmap:
    """A read-only memmap of one leaf's file (bf16 as uint16 bits; a scalar
    as shape ``(1,)``)."""
    path = Path(offload_folder) / f"{weight_name.replace('/', '--')}.dat"
    return np.memmap(path, dtype=storage_dtype(info), mode="r",
                     shape=tuple(info["shape"]) or (1,))


def load_offloaded_weight(offload_folder: str, weight_name: str, info: dict) -> torch.Tensor:
    """One leaf, read into a CPU tensor of its dtype and shape."""
    arr = np.array(offloaded_memmap(offload_folder, weight_name, info))
    if info["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.reshape(info["shape"])


class OffloadedWeightsLoader(Mapping):
    """A read-only mapping over in-memory weights and an offload folder
    (reference ``OffloadedWeightsLoader``); folder leaves are read on each
    access."""

    def __init__(self, state_dict: dict[str, Any] | None = None,
                 save_folder: str | None = None):
        if state_dict is None and save_folder is None:
            raise ValueError("Need at least one of state_dict or save_folder.")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        self.index = load_offload_index(save_folder) if save_folder else {}
        self.all_keys = list(self.state_dict) + [k for k in self.index if k not in self.state_dict]

    def __getitem__(self, key: str) -> torch.Tensor:
        if key in self.state_dict:
            return self.state_dict[key]
        return load_offloaded_weight(self.save_folder, key, self.index[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self.all_keys)

    def __len__(self) -> int:
        return len(self.all_keys)


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> None:
    """Write a flat state dict to ``save_dir`` with its index."""
    index: dict = {}
    for name, value in state_dict.items():
        index = offload_weight(value, name, save_dir, index)
    save_offload_index(index, save_dir)
