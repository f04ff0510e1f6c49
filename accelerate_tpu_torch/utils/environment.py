"""Device resolution and environment-variable parsing: the port of
`accelerate_tpu.utils.environment`.

`resolve_device` and `on_hopper` take the place of the reference's
``on_tpu_platform`` (the platform probe kernels dispatch on). The port's
entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and a missing CUDA device is an error, never a
quiet fall back to the CPU. The flag, choice and integer parsers and the
`patch_environment` / `clear_environment` contexts are the reference's
(`accelerate_tpu/utils/environment.py:25-100`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator

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


def str_to_bool(value: str) -> int:
    """1 for a truthy string (y, yes, t, true, on, 1), 0 for a falsy one;
    ValueError otherwise."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key, None)
    if value is None:
        return default
    try:
        return bool(str_to_bool(value))
    except ValueError:
        raise ValueError(f"If set, {key} must be yes or no, got {value!r}.") from None


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def parse_int_from_env(key: str, default: int) -> int:
    """An integer knob; an unset, empty or blank value gives ``default``."""
    raw = os.environ.get(key, "").strip()
    return int(raw) if raw else default


def get_int_from_env(keys: list[str], default: int) -> int:
    """The first of ``keys`` that is set, as an integer."""
    for key in keys:
        value = os.environ.get(key, None)
        if value is not None:
            return int(value)
    return default


@contextlib.contextmanager
def patch_environment(**kwargs: Any) -> Iterator[None]:
    """Set the variables (keys upper-cased, values as strings) inside the
    block and restore what was there after."""
    existing: dict[str, str] = {}
    for key, value in kwargs.items():
        key = key.upper()
        if key in os.environ:
            existing[key] = os.environ[key]
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key in kwargs:
            key = key.upper()
            if key in existing:
                os.environ[key] = existing[key]
            else:
                os.environ.pop(key, None)


@contextlib.contextmanager
def clear_environment() -> Iterator[None]:
    """An empty ``os.environ`` inside the block, the old one after."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)
