"""Small utilities: the port of `accelerate_tpu.utils.other`.

`convert_bytes` and `get_pretty_name` for display, `extract_model_from_parallel`
(what `Accelerator.unwrap_model` returns) and the rank-gated `save` / `load`
behind `Accelerator.save`: tensors go to the host first, then to safetensors
with ``safe_serialization`` (through `utils.safetensors_io`) or to
``torch.save`` otherwise.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .operations import recursively_apply
from .safetensors_io import flatten_state_dict, load_safetensors_checkpoint, save_file


def convert_bytes(size: float) -> str:
    """A byte count for people: ``"1.50 KB"``."""
    for unit in ("B", "KB", "MB", "GB"):
        if abs(size) < 1024.0:
            return f"{size:.2f} {unit}"
        size /= 1024.0
    return f"{size:.2f} TB"


def get_pretty_name(obj: Any) -> str:
    """An object's qualified name, or its type's."""
    if hasattr(obj, "__qualname__"):
        return obj.__qualname__
    if hasattr(obj, "__name__"):
        return obj.__name__
    return type(obj).__qualname__


def extract_model_from_parallel(model: Any, keep_fp32_wrapper: bool = True) -> Any:
    """The module handed to `Accelerator.prepare`. A module keeps its own
    API, so it is returned unwrapped whatever ``keep_fp32_wrapper`` says, as
    the reference returns a flax module."""
    from ..accelerator import PreparedModel

    return model.module if isinstance(model, PreparedModel) else model


def save(obj: Any, f: str | os.PathLike, save_on_each_node: bool = False,
         safe_serialization: bool = False) -> None:
    """Write ``obj`` from the main process (every node's local main with
    ``save_on_each_node``): a tensor tree to safetensors with
    ``safe_serialization``, anything to ``torch.save`` otherwise; tensors
    are copied to the host first."""
    from ..state import PartialState

    state = PartialState(device="cpu")
    if not (state.is_local_main_process if save_on_each_node else state.is_main_process):
        return
    host = recursively_apply(lambda t: t.detach().to("cpu", copy=True), obj)
    if safe_serialization:
        save_file(flatten_state_dict(host), f)
        return
    torch.save(host, f)


def load(f: str | os.PathLike, map_location: Any = None, **kwargs: Any) -> Any:
    """What `save` wrote: a safetensors file as nested dicts of tensors,
    anything else through ``torch.load`` (a pickle: load only files this
    program wrote)."""
    if _is_safetensors_file(f):
        return load_safetensors_checkpoint(f, nested=True)
    return torch.load(f, map_location=map_location or "cpu", weights_only=False)


def _is_safetensors_file(f: str | os.PathLike) -> bool:
    """A ``.safetensors`` name, or the format's header: an 8-byte
    little-endian length then ``{``."""
    if str(f).endswith(".safetensors"):
        return True
    try:
        size = os.path.getsize(f)
        with open(f, "rb") as fh:
            head = fh.read(9)
    except OSError:
        return False
    if len(head) < 9:
        return False
    n = int.from_bytes(head[:8], "little")
    return head[8:9] == b"{" and 0 < n <= size - 8
