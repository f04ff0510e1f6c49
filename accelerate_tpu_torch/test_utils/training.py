"""Toy training fixtures, the port of `accelerate_tpu.test_utils.training`:
the linear regression y = a*x + b that the parity checks train."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class RegressionDataset:
    """Map-style dataset of (x, y = a*x + b + noise) pairs, from a seed."""

    def __init__(self, a: float = 2.0, b: float = 3.0, length: int = 64, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + 0.05 * rng.normal(size=(length,))).astype(np.float32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return {"x": self.x[i], "y": self.y[i]}


class RegressionModel(nn.Module):
    """``a * x + b`` with ``a`` and ``b`` of shape (1,)."""

    def __init__(self, a: float = 0.0, b: float = 0.0, device: str | torch.device | None = "cpu"):
        super().__init__()
        self.a = nn.Parameter(torch.full((1,), float(a), device=device))
        self.b = nn.Parameter(torch.full((1,), float(b), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.a * x + self.b


def regression_loss_fn(model, batch) -> torch.Tensor:
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_regression_batches(num_batches: int, batch_size: int, a: float = 2.0, b: float = 3.0,
                            seed: int = 0) -> list[dict[str, np.ndarray]]:
    """Batches of numpy arrays that a `DataLoaderShard` takes as they are."""
    ds = RegressionDataset(a=a, b=b, length=num_batches * batch_size, seed=seed)
    return [{"x": ds.x[i * batch_size:(i + 1) * batch_size],
             "y": ds.y[i * batch_size:(i + 1) * batch_size]} for i in range(num_batches)]
