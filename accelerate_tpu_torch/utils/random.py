"""Seeding and the RNG state of a checkpoint: the port of
`accelerate_tpu.utils.random` at one process.

The reference seeds Python, numpy and a root JAX key; the port seeds Python,
numpy and PyTorch's default generators (the CPU one and every CUDA device's).
Code that needs a stream of its own (the models' dropout, the samplers) takes
an explicit `torch.Generator` instead of these globals.
"""

from __future__ import annotations

import random as _py_random
from typing import Any

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed Python's `random`, numpy's global state and PyTorch's default
    generators on the CPU and on every CUDA device (reference
    `utils/random.py:25`; its ``device_specific`` offset is the process
    index, 0 at one process)."""
    _py_random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # seeds every CUDA device too, lazily if CUDA is not up yet


def capture_rng_state() -> dict[str, Any]:
    """Every global RNG state a training loop draws from, for a checkpoint
    (reference `utils/random.py:55`): Python's, numpy's, PyTorch's CPU
    generator and, once CUDA is initialised, each CUDA device's."""
    state = {"python": _py_random.getstate(), "numpy": np.random.get_state(),
             "torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["torch_cuda"] = torch.cuda.get_rng_state_all()
    return state


def restore_rng_state(state: dict[str, Any]) -> None:
    """Put back what `capture_rng_state` took (reference
    `utils/random.py:67`)."""
    _py_random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    torch.set_rng_state(state["torch"])
    if "torch_cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(state["torch_cuda"])
