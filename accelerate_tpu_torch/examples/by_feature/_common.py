"""The shared workload of the by_feature examples (the reference's
`examples/by_feature/_common.py`): a 2-class MLP on separable synthetic
features, 16 of them, class 1 shifted by 1.5.

The batches and the initial weights come from numpy's ``default_rng`` as in
the reference, so both packages start from the same numbers; `MLP` is the
reference's ``apply_fn`` (``tanh(x w1 + b1) w2 + b2``) as an ``nn.Module``,
and `params_from_jax` turns the reference's param dict into its state dict.
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEATURES = 16
CLASSES = 2


def make_batches(n_batches: int, batch_size: int, seed: int = 0) -> list[dict]:
    """``n_batches`` batches of numpy arrays: ``x`` [batch, 16], ``labels``."""
    rng = np.random.default_rng(seed)
    n = n_batches * batch_size
    labels = rng.integers(0, CLASSES, size=(n,)).astype(np.int32)
    x = rng.normal(size=(n, FEATURES)).astype(np.float32) + labels[:, None] * 1.5
    x = x.astype(np.float32)  # the sum is float64; JAX sees it as float32, as here
    return [{"x": x[i * batch_size:(i + 1) * batch_size],
             "labels": labels[i * batch_size:(i + 1) * batch_size]} for i in range(n_batches)]


def init_params(seed: int = 0, hidden: int = 32) -> dict[str, np.ndarray]:
    """The reference's initial weights: normal times 0.1, zero biases."""
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.normal(size=(FEATURES, hidden)) * 0.1).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": (rng.normal(size=(hidden, CLASSES)) * 0.1).astype(np.float32),
        "b2": np.zeros((CLASSES,), np.float32),
    }


def params_from_jax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The reference's ``{w1, b1, w2, b2}`` (``[in, out]`` kernels) as `MLP`'s
    state dict."""
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    return {"fc1.weight": t(params["w1"]).T.contiguous(), "fc1.bias": t(params["b1"]),
            "fc2.weight": t(params["w2"]).T.contiguous(), "fc2.bias": t(params["b2"])}


class MLP(nn.Module):
    def __init__(self, hidden: int = 32, device: Any = None):
        super().__init__()
        self.fc1 = nn.Linear(FEATURES, hidden, device=device)
        self.fc2 = nn.Linear(hidden, CLASSES, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.tanh(self.fc1(x)))


def make_model(seed: int, device: Any) -> MLP:
    """An `MLP` on ``device`` holding `init_params(seed)`."""
    model = MLP(device=device)
    model.load_state_dict(params_from_jax(init_params(seed)))
    return model


def loss_fn(model, batch: dict) -> torch.Tensor:
    """Softmax cross-entropy over the integer labels, the mean."""
    return F.cross_entropy(model(batch["x"]).float(), batch["labels"].long())


def evaluate(accelerator, model, eval_batches) -> float:
    """Accuracy over ``eval_batches``, gathered with ``gather_for_metrics``."""
    correct = total = 0
    with torch.no_grad():
        for batch in eval_batches:
            g = accelerator.gather_for_metrics({"preds": model(batch["x"]).argmax(-1),
                                                "labels": batch["labels"]})
            correct += int((g["preds"] == g["labels"]).sum())
            total += len(g["labels"])
    return correct / max(total, 1)


def base_parser(**extra_defaults: Any) -> argparse.ArgumentParser:
    """The reference's arguments, and ``--device`` (default CUDA)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="no", choices=["no", "bf16", "fp16"])
    parser.add_argument("--lr", type=float, default=extra_defaults.get("lr", 1e-2))
    parser.add_argument("--num_epochs", type=int, default=extra_defaults.get("num_epochs", 2))
    parser.add_argument("--batch_size", type=int, default=extra_defaults.get("batch_size", 32))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--project_dir", default=None)
    parser.add_argument("--tiny", action="store_true", help="smoke-test sizes")
    parser.add_argument("--device", default=None, help="default: CUDA; 'cpu' for the plain path")
    return parser
