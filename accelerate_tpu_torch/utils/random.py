"""Seeding, the RNG state of a checkpoint, and RNG synchronization across
processes: the port of `accelerate_tpu.utils.random`.

The reference seeds Python, numpy and a root JAX key; the port seeds Python,
numpy and PyTorch's default generators (the CPU one and every CUDA device's).
Code that needs a stream of its own (the models' dropout, the samplers) takes
an explicit `torch.Generator` instead of these globals.
`synchronize_rng_state` gives every process rank 0's state.
"""

from __future__ import annotations

import random as _py_random
from typing import Any

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False) -> None:
    """Seed Python's `random`, numpy's global state and PyTorch's default
    generators on the CPU and on every CUDA device (reference
    `utils/random.py:25-36`); with ``device_specific`` each process adds its
    rank, so their streams differ."""
    if device_specific:
        from ..state import topology

        seed += topology().process_index
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


def synchronize_rng_state(rng_type: str | None = None, generator: torch.Generator | None = None
                          ) -> None:
    """Give every process rank 0's RNG state (reference
    `utils/random.py:73-87`): all of `capture_rng_state`'s with no
    ``rng_type``; else one of ``"python"``, ``"numpy"``, ``"torch"`` (the
    CPU generator), ``"cuda"`` (the current device's) or ``"generator"``
    (``generator``)."""
    from .operations import broadcast_object_list

    getters = {
        None: (capture_rng_state, restore_rng_state),
        "python": (_py_random.getstate, _py_random.setstate),
        "numpy": (np.random.get_state, np.random.set_state),
        "torch": (torch.get_rng_state, torch.set_rng_state),
        "cuda": (torch.cuda.get_rng_state, torch.cuda.set_rng_state),
        "generator": (lambda: generator.get_state(), lambda s: generator.set_state(s)),
    }
    if rng_type not in getters:
        raise ValueError(f"unknown rng_type {rng_type!r}; one of {sorted(k for k in getters if k)}")
    if rng_type == "generator" and generator is None:
        raise ValueError("rng_type='generator' needs the generator")
    get, put = getters[rng_type]
    payload = [get()]
    broadcast_object_list(payload, from_process=0)
    put(payload[0])


def synchronize_rng_states(rng_types: list[str] | None = None,
                           generator: torch.Generator | None = None) -> None:
    """`synchronize_rng_state` for each of ``rng_types`` (every state when
    None)."""
    for rng_type in rng_types if rng_types is not None else [None]:
        synchronize_rng_state(rng_type, generator)
