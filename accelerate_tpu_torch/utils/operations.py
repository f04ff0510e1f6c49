"""Operations over nested containers of tensors: the port of
`accelerate_tpu.utils.operations`.

``recursively_apply`` walks dicts (any Mapping, keeping its type and key
order), lists, tuples and namedtuples down to their tensors. The collectives
(``gather``, ``gather_object``, ``broadcast``, ``broadcast_object_list``,
``reduce``, ``pad_across_processes``) run over the default process group
(`state.init_distributed`), one process per device, and take tensor and
numpy leaves (a numpy leaf comes back as numpy). With no group, or a world
of one, each returns what this process holds, as the reference's do when
``num_processes == 1``.

Which memory a collective runs in is a rule of the backend, not a retry:
NCCL carries only CUDA tensors, so a host leaf goes to this process's
device and back; gloo is used here for host tensors, so a CUDA leaf is
copied to host memory, reduced there and copied back. Under
``ACCELERATE_TPU_DEBUG_MODE`` every collective first checks that all
processes hold the same structure and shapes (`verify_operation`) and
raises `DistributedOperationException` listing them when they do not.
"""

from __future__ import annotations

import functools
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


class DistributedOperationException(Exception):
    """Processes called a collective with different structures or shapes
    (reference `utils/operations.py:139`)."""


def _dist():
    """``torch.distributed`` when a group of more than one process exists,
    else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist
    return None


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _carried(t: Any) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``t`` as a tensor the backend carries, which a collective may
    overwrite without touching ``t``, and the function that turns a result
    back into ``t``'s kind and device (see the module docstring)."""
    import torch.distributed as dist

    was_numpy = isinstance(t, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(t)) if was_numpy else t
    home = x.device
    if dist.get_backend() == "nccl":
        wire = torch.device("cuda", torch.cuda.current_device())
    else:
        wire = torch.device("cpu")
    src = x
    x = x.detach().to(wire).contiguous()
    if x.data_ptr() == src.data_ptr():
        x = x.clone()

    def back(y: torch.Tensor) -> Any:
        return y.cpu().numpy() if was_numpy else y.to(home)

    return x, back


def _structure(data: Any, skip_dim: int | None) -> Any:
    def one(t: Any) -> tuple:
        shape = list(t.shape)
        if skip_dim is not None and len(shape) > skip_dim:
            shape[skip_dim] = "*"
        return tuple(shape), str(t.dtype)

    return recursively_apply(one, data, test_type=_is_leaf)


def verify_operation(function: Callable | None = None, *, skip_dim: int | None = None) -> Callable:
    """Under ``ACCELERATE_TPU_DEBUG_MODE`` at more than one process, gather
    every process's structure and shapes (``skip_dim`` may differ: the
    ragged dimension of ``gather`` and ``pad_across_processes``) before the
    collective, and raise `DistributedOperationException` naming each
    process's when they differ, where the collective would hang or fail
    (reference `utils/operations.py:139`)."""
    if function is None:
        return functools.partial(verify_operation, skip_dim=skip_dim)

    @functools.wraps(function)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        from .environment import parse_flag_from_env

        if _dist() is None or not parse_flag_from_env("ACCELERATE_TPU_DEBUG_MODE"):
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        dim = kwargs.get("dim", skip_dim) if skip_dim is not None else None
        shapes = _structure(tensor, dim)
        everyone = gather_object([shapes])
        if any(s != everyone[0] for s in everyone):
            raise DistributedOperationException(
                f"Cannot apply {function.__module__}.{function.__name__}: the structure or "
                "shapes differ across processes:\n"
                + "\n".join(f"  - process {i}: {s}" for i, s in enumerate(everyone)))
        return function(*args, **kwargs)

    return wrapper


def _all_sizes(dist, size: int, like: torch.Tensor) -> list[int]:
    """Every process's ``size``."""
    mine = torch.tensor([size], dtype=torch.int64, device=like.device)
    sizes = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, mine)
    return [int(s.item()) for s in sizes]


def _gather_one(t: Any) -> Any:
    dist = _dist()
    x, back = _carried(t)
    if x.ndim == 0:
        x = x.reshape(1)
    sizes = _all_sizes(dist, x.shape[0], x)
    top = max(sizes)
    if x.shape[0] < top:  # ragged: pad to the largest, gather, trim each part
        x = torch.cat([x, x.new_zeros((top - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x)
    return back(torch.cat([p[:n] for p, n in zip(parts, sizes)]))


@verify_operation(skip_dim=0)
def gather(tensor: Any) -> Any:
    """Every process's ``tensor`` concatenated on dim 0 in rank order, on
    every process (reference `utils/operations.py:180`). First dimensions
    may differ between processes: each leaf is padded to the largest,
    gathered and cut back. A 0-d leaf gathers to one element a process."""
    if _dist() is None:
        return tensor
    return recursively_apply(_gather_one, tensor, test_type=_is_leaf)


def consolidate_on_main(tree: Any, keep_on_all: bool = False) -> Any:
    """Every leaf of a replicated ``tree`` copied to host memory on the main
    process, None elsewhere (or on every process with ``keep_on_all``),
    one leaf at a time (reference `utils/operations.py:199`). Every
    data-parallel rank holds the whole tree, so no collective runs."""
    from ..state import topology

    keep = keep_on_all or topology().process_index == 0
    return recursively_apply(
        lambda t: (t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else np.array(t))
        if keep else None, tree, test_type=_is_leaf)


def gather_object(object: Any) -> list:
    """Every process's list of picklable objects, concatenated in rank order
    (reference `utils/operations.py:226`)."""
    if not isinstance(object, list):
        raise TypeError(f"gather_object expects a list, got {type(object)}")
    dist = _dist()
    if dist is None:
        return list(object)
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, object)
    return [x for part in parts for x in part]


def _broadcast_one(t: Any, from_process: int) -> Any:
    dist = _dist()
    x, back = _carried(t)
    dist.broadcast(x, src=from_process)
    return back(x)


@verify_operation
def broadcast(tensor: Any, from_process: int = 0) -> Any:
    """Every leaf as process ``from_process`` holds it, on every process
    (any rank may send; reference `utils/operations.py:251`). Leaves keep
    their shape and dtype, which must agree across processes."""
    if _dist() is None:
        return tensor
    return recursively_apply(_broadcast_one, tensor, from_process, test_type=_is_leaf)


def broadcast_(tensors: list[torch.Tensor], from_process: int = 0) -> None:
    """Overwrite each tensor in place with ``from_process``'s (the
    parameters a prepared model starts from)."""
    if _dist() is None:
        return
    for t in tensors:
        t.copy_(_broadcast_one(t, from_process))


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """``object_list`` replaced in place by ``from_process``'s (picklable
    objects; reference `utils/operations.py:270`); returns it."""
    dist = _dist()
    if dist is None:
        return object_list
    dist.broadcast_object_list(object_list, src=from_process)
    return object_list


def _pad_one(t: Any, dim: int, pad_index: int, pad_first: bool) -> Any:
    dist = _dist()
    x, back = _carried(t)
    if dim >= x.ndim:
        return t
    top = max(_all_sizes(dist, x.shape[dim], x))
    if top == x.shape[dim]:
        return t
    shape = list(x.shape)
    shape[dim] = top - x.shape[dim]
    pad = x.new_full(shape, pad_index)
    return back(torch.cat([pad, x] if pad_first else [x, pad], dim=dim))


@verify_operation(skip_dim=0)
def pad_across_processes(tensor: Any, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False) -> Any:
    """Every leaf padded with ``pad_index`` along ``dim`` to the largest size
    any process holds, at the end (or the start with ``pad_first``), so a
    later gather is rectangular (reference `utils/operations.py:298`)."""
    if _dist() is None:
        return tensor
    return recursively_apply(_pad_one, tensor, dim, pad_index, pad_first, test_type=_is_leaf)


def pad_input_tensors(tensor: Any, batch_size: int, num_processes: int, dim: int = 0) -> Any:
    """Every leaf's ``dim`` padded to a multiple of ``num_processes`` by
    repeating its last entry (reference `utils/operations.py:325`)."""
    def pad(t: Any) -> Any:
        remainder = t.shape[dim] % num_processes
        if remainder == 0:
            return t
        last = t.narrow(dim, t.shape[dim] - 1, 1) if isinstance(t, torch.Tensor) \
            else np.take(t, [t.shape[dim] - 1], axis=dim)
        reps = [1] * t.ndim
        reps[dim] = num_processes - remainder
        if isinstance(t, torch.Tensor):
            return torch.cat([t, last.repeat(*reps)], dim=dim)
        return np.concatenate([t, np.tile(last, reps)], axis=dim)

    return recursively_apply(pad, tensor, test_type=_is_leaf)


def _reduce_one(t: Any, reduction: str, scale: float) -> Any:
    dist = _dist()
    if dist is None:
        return t * scale
    x, back = _carried(t)
    dist.all_reduce(x)
    if reduction == "mean":
        x = x / dist.get_world_size()
    return back(x * scale)


@verify_operation
def reduce(tensor: Any, reduction: str = "mean", scale: float = 1.0) -> Any:
    """The sum over processes of every leaf (divided by their number for
    ``"mean"``; ``"none"`` sums, as the reference's does), times ``scale``
    (reference `utils/operations.py:344`)."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be 'sum', 'mean' or 'none', got {reduction!r}")
    return recursively_apply(_reduce_one, tensor, reduction, scale, test_type=_is_leaf)


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
