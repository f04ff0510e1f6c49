"""Feature-availability probes: the port of `accelerate_tpu.utils.imports`.

Each check asks the import system whether a package is installed, without
importing it (`importlib.util.find_spec`), and caches the answer.
`is_cuda_available` takes the place of the reference's ``is_tpu_available``;
the compute stack is PyTorch, so there is no ``is_torch_available`` to
ask, and orbax (the reference's checkpoint backend) has no role here.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache
def _package_available(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def is_tensorboard_available() -> bool:
    return _package_available("tensorboardX") or _package_available("tensorboard")


def is_wandb_available() -> bool:
    return _package_available("wandb")


def is_mlflow_available() -> bool:
    return _package_available("mlflow")


def is_comet_ml_available() -> bool:
    return _package_available("comet_ml")


def is_clearml_available() -> bool:
    return _package_available("clearml")


def is_aim_available() -> bool:
    return _package_available("aim")


def is_dvclive_available() -> bool:
    return _package_available("dvclive")


def is_transformers_available() -> bool:
    return _package_available("transformers")


def is_datasets_available() -> bool:
    return _package_available("datasets")


def is_rich_available() -> bool:
    return _package_available("rich")


def is_tqdm_available() -> bool:
    return _package_available("tqdm")


def is_pandas_available() -> bool:
    return _package_available("pandas")


def is_cuda_available() -> bool:
    """True when PyTorch sees a CUDA device (the reference asks JAX for a
    TPU)."""
    import torch

    return torch.cuda.is_available()
