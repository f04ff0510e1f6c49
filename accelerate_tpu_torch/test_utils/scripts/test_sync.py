"""Gradient accumulation across processes, the port of the reference's
`test_utils/scripts/test_sync.py`: four microbatches at
``gradient_accumulation_steps=2`` update on the second and the fourth, to
the weights of two hand-computed SGD steps."""

from __future__ import annotations

import numpy as np
import torch


def run_checks(device: str | torch.device | None = None) -> None:
    from ...accelerator import Accelerator
    from ...data_loader import DataLoaderShard
    from ..training import RegressionModel

    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(4,)).astype(np.float32),
                "y": rng.normal(size=(4,)).astype(np.float32)} for _ in range(4)]

    def loss_fn(m, batch):
        return ((m(batch["x"]) - batch["y"]) ** 2).mean()

    lr = 0.1
    acc = Accelerator(gradient_accumulation_steps=2, device=device)
    module = RegressionModel(device=acc.device)
    model, opt, dl = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=lr),
                                 DataLoaderShard(batches))
    step = acc.make_train_step(loss_fn)
    sync_flags = []
    for batch in dl:
        step(batch)
        sync_flags.append(acc.gradient_state.sync_gradients)
    assert sync_flags == [False, True, False, True], sync_flags

    # each global batch is cut between the ranks; the mean over ranks of the
    # slices' mean gradients is the mean over the whole batch
    a = b = 0.0
    for pair in (batches[0:2], batches[2:4]):
        ga = gb = 0.0
        for bt in pair:
            err = a * bt["x"].astype(np.float64) + b - bt["y"]
            ga += (2 * err * bt["x"]).mean() / 2
            gb += (2 * err).mean() / 2
        a, b = a - lr * ga, b - lr * gb
    got = acc.get_state_dict(model)
    np.testing.assert_allclose(got["a"].numpy(), [a], rtol=1e-5)
    np.testing.assert_allclose(got["b"].numpy(), [b], rtol=1e-5)
    acc.wait_for_everyone()
    print(f"proc {acc.process_index}: accumulation semantics OK", flush=True)


if __name__ == "__main__":
    run_checks()
