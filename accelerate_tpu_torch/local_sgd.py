"""Local SGD: each rank trains on its own for a few steps, then the ranks
average their parameters: the port of `accelerate_tpu.local_sgd`.

`make_local_train_step` returns the reference's four functions over an
island (this rank's module and optimizer, `Island`): ``replicate`` makes
every rank start from rank 0's parameters, ``local_step`` runs a forward,
backward and optimizer step on this rank's batch with no collective,
``sync`` averages the parameters and every floating tensor of the
optimizer's state over the ranks (one all-reduce a bucket), and
``unreplicate`` gives the parameters on the host. `LocalSGD` drives the
cadence: every ``local_sgd_steps`` steps it calls ``sync``.

    local_step, sync, replicate, unreplicate = make_local_train_step(loss_fn, model, opt)
    island = replicate()
    with LocalSGD(sync_fn=sync, local_sgd_steps=8) as lsgd:
        for batch in dl:
            island, loss = local_step(island, batch)
            island = lsgd.step(island)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from .parallel.compression import all_reduce_mean_
from .utils import operations


@dataclass
class Island:
    """One rank's copy of the model and its optimizer."""

    module: nn.Module
    optimizer: torch.optim.Optimizer


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """The optimizer's floating state (moments; not its step counts, which
    every rank holds alike)."""
    return [v for state in optimizer.state.values() for k, v in state.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point() and k != "step"]


def make_local_train_step(loss_fn: Callable[[Any, Any], torch.Tensor], module: nn.Module,
                          optimizer: Any, group: Any = None
                          ) -> tuple[Callable, Callable, Callable, Callable]:
    """``(local_step, sync, replicate, unreplicate)`` for ``module`` and
    ``optimizer`` (a torch optimizer over its parameters, or a prepared
    one), averaging over ``group`` (default: every rank). ``loss_fn(model,
    batch)`` gets the module (reference `local_sgd.py:29-106`)."""
    module = getattr(module, "module", module)
    optimizer = getattr(optimizer, "optimizer", optimizer)

    def replicate(state_dict: dict[str, torch.Tensor] | None = None) -> Island:
        if state_dict is not None:
            module.load_state_dict(state_dict)
        with torch.no_grad():
            operations.broadcast_([*module.parameters()], from_process=0)
        return Island(module, optimizer)

    def local_step(island: Island, batch: Any) -> tuple[Island, torch.Tensor]:
        island.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(island.module, batch)
        loss.backward()
        island.optimizer.step()
        return island, loss.detach()

    def sync(island: Island) -> Island:
        with torch.no_grad():
            all_reduce_mean_([p.data for p in island.module.parameters()], group)
            all_reduce_mean_(_optimizer_tensors(island.optimizer), group)
        return island

    def unreplicate(island: Island) -> dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True) for n, p in island.module.named_parameters()}

    return local_step, sync, replicate, unreplicate


class LocalSGD:
    """The sync cadence (reference `local_sgd.py:109-137`): ``step(island)``
    counts a step and every ``local_sgd_steps`` returns ``sync_fn(island)``;
    disabled, it never syncs."""

    def __init__(self, sync_fn: Callable | None = None, local_sgd_steps: int = 8,
                 enabled: bool = True):
        self.sync_fn = sync_fn
        self.local_sgd_steps = local_sgd_steps
        self.enabled = enabled
        self.num_steps = 0

    def __enter__(self) -> "LocalSGD":
        self.num_steps = 0
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def step(self, island: Any) -> Any:
        self.num_steps += 1
        if not self.enabled:
            return island
        if self.num_steps % self.local_sgd_steps == 0:
            return self.sync_fn(island)
        return island
