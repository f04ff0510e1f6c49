"""Operations over nested containers of tensors: the port of
`accelerate_tpu.utils.operations` at one process.

``recursively_apply`` walks dicts (any Mapping, keeping its type and key
order), lists, tuples and namedtuples down to their tensors. The collectives
(``gather``, ``broadcast``, ``reduce``, ``pad_across_processes`` and their
object forms) are those of a world of one process: each returns what this
process holds, as the reference's do when ``num_processes == 1``. Their
multi-process forms over ``torch.distributed`` wait for ROADMAP Queue 1,
item 21.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch


def is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def recursively_apply(func: Callable, data: Any, *args: Any,
                      test_type: Callable[[Any], bool] = is_tensor,
                      error_on_other_type: bool = False, **kwargs: Any) -> Any:
    """``func`` over every leaf of ``data`` that passes ``test_type``; other
    leaves pass through unchanged (or raise with ``error_on_other_type``)."""
    def walk(x: Any) -> Any:
        if test_type(x):
            return func(x, *args, **kwargs)
        if isinstance(x, Mapping):
            return type(x)({k: walk(v) for k, v in x.items()})
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # namedtuple
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if error_on_other_type:
            raise TypeError(
                f"Unsupported type {type(x)} passed: only nested containers of tensors are handled.")
        return x

    return walk(data)


def send_to_device(tensor: Any, device: str | torch.device, non_blocking: bool = False) -> Any:
    """Every tensor leaf moved to ``device`` (reference
    `utils/operations.py:136`); numpy arrays become tensors first. With
    ``non_blocking`` a copy from pinned host memory to a CUDA device returns
    before it lands, ordered on the current stream."""
    def send(t: Any) -> torch.Tensor:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(device, non_blocking=non_blocking)

    return recursively_apply(send, tensor, test_type=lambda x: isinstance(x, (torch.Tensor, np.ndarray)))


def concatenate(data: list, dim: int = 0) -> Any:
    """Leafwise ``torch.cat`` of a list of containers of one structure."""
    first = data[0]
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(concatenate(list(parts), dim=dim) for parts in zip(*data)))
    if isinstance(first, (list, tuple)):
        return type(first)(concatenate(list(parts), dim=dim) for parts in zip(*data))
    if not is_tensor(first):
        raise TypeError(f"Can only concatenate containers of tensors, got {type(first)}.")
    return torch.cat(data, dim=dim)


def gather(tensor: Any) -> Any:
    """Every process's ``tensor`` concatenated on dim 0 (reference
    `utils/operations.py:423`): at one process, this process's own."""
    return tensor


def gather_object(object: Any) -> list:
    """Every process's list of picklable objects, concatenated (reference
    `utils/operations.py:449`)."""
    if not isinstance(object, list):
        raise TypeError(f"gather_object expects a list, got {type(object)}")
    return list(object)


def broadcast(tensor: Any, from_process: int = 0) -> Any:
    """``tensor`` as ``from_process`` holds it, on every process."""
    return tensor


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    return object_list


def reduce(tensor: Any, reduction: str = "mean", scale: float = 1.0) -> Any:
    """The sum (or mean) over processes of every leaf, times ``scale``
    (reference `utils/operations.py:728`): at one process each leaf times
    ``scale``."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be 'sum', 'mean' or 'none', got {reduction!r}")
    return recursively_apply(lambda t: t * scale, tensor)


def pad_across_processes(tensor: Any, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False) -> Any:
    """Every leaf padded along ``dim`` to the largest size any process
    holds: at one process, its own size, so nothing changes."""
    return tensor


def convert_to_fp32(tensor: Any) -> Any:
    """Every floating leaf that is not fp32 cast to fp32 (reference
    `utils/operations.py:769`)."""
    def upcast(t: torch.Tensor) -> torch.Tensor:
        return t.float() if t.is_floating_point() and t.dtype != torch.float32 else t

    return recursively_apply(upcast, tensor)


def find_batch_size(data: Any) -> int | None:
    """The leading dimension of the first array leaf found (tensors and
    numpy arrays), None when there is none."""
    if isinstance(data, Mapping):
        data = list(data.values())
    if isinstance(data, (list, tuple)):
        for d in data:
            bs = find_batch_size(d)
            if bs is not None:
                return bs
        return None
    shape = getattr(data, "shape", None)
    return int(shape[0]) if shape is not None and len(shape) >= 1 else None


def listify(data: Any) -> Any:
    """Tensor and numpy leaves as plain Python numbers and lists, for
    logging."""
    return recursively_apply(lambda t: t.tolist(), data,
                             test_type=lambda x: isinstance(x, (torch.Tensor, np.ndarray)))
