"""Device resolution: the port's counterpart of `accelerate_tpu.utils.environment`
``on_tpu_platform`` (the platform probe kernels dispatch on).

The port's entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and a missing CUDA device is an error, never a
quiet fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on. ``None`` means ``"cuda"``; a CUDA
    device without an index gets the current one, so it compares equal to the
    devices tensors report. Raises RuntimeError when CUDA is asked for (or
    defaulted to) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: accelerate_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run its plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_hopper(device: str | torch.device | None = None) -> bool:
    """True when a CUDA device of compute capability 9.0 (H100, H200) is
    present: the target the port's kernels are built for (``sm_90a``)."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)
