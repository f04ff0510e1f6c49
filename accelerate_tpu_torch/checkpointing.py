"""Loading a consolidated model export: the port of the safetensors half of
`accelerate_tpu.checkpointing` ``load_model_weights``.

The reference's exports are safetensors (sharded or single, the default) or
``model.msgpack``, flax's serialization. The port reads the first with
`utils.safetensors_io` and refuses the second, which is flax's format and
needs flax to read.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

from .utils.safetensors_io import load_safetensors_checkpoint


def load_model_weights(save_directory: str | os.PathLike) -> dict[str, Any]:
    """The weights of a consolidated export as nested dicts of CPU tensors
    (the dotted safetensors keys unflattened, as the reference returns
    them). Raises ValueError for a ``model.msgpack`` export."""
    directory = Path(save_directory)
    if (directory / "model.msgpack").exists():
        raise ValueError(
            f"{directory / 'model.msgpack'} is flax's msgpack serialization, which the PyTorch "
            "port does not read; export with safe_serialization=True (safetensors)"
        )
    return load_safetensors_checkpoint(directory, nested=True)
