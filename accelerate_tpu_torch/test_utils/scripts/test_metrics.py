"""``gather_for_metrics`` across processes with a ragged last batch, the
port of the reference's `test_utils/scripts/test_metrics.py`: a torch
DataLoader of 22 samples sharded by `prepare_data_loader`, whose repeated
samples at the global end are dropped, so the metric equals one
process's."""

from __future__ import annotations

import numpy as np
import torch


def run_checks(device: str | torch.device | None = None) -> None:
    import torch.utils.data as tud

    from ...accelerator import Accelerator

    n = 22
    rng = np.random.default_rng(1)
    preds = rng.integers(0, 2, size=(n,)).astype(np.int32)
    labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
    truth = float((preds == labels).mean())

    class DS(tud.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"preds": preds[i], "labels": labels[i], "idx": np.int32(i)}

    acc = Accelerator(device=device)
    dl = acc.prepare_data_loader(tud.DataLoader(DS(), batch_size=8, shuffle=False))
    got = {"preds": [], "labels": [], "idx": []}
    for b in dl:
        g = acc.gather_for_metrics({k: b[k] for k in got})
        for k in got:
            got[k].append(g[k].cpu().numpy())
    got = {k: np.concatenate(v) for k, v in got.items()}
    assert len(got["preds"]) == n, (len(got["preds"]), n)
    np.testing.assert_array_equal(np.sort(got["idx"]), np.arange(n))
    order = np.argsort(got["idx"])
    np.testing.assert_array_equal(got["preds"][order], preds)
    np.testing.assert_array_equal(got["labels"][order], labels)
    assert abs(float((got["preds"] == got["labels"]).mean()) - truth) < 1e-9
    acc.wait_for_everyone()
    print(f"proc {acc.process_index}: gather_for_metrics OK", flush=True)


if __name__ == "__main__":
    run_checks()
