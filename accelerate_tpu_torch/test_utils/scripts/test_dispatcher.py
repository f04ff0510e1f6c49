"""The `DataLoaderDispatcher` loop across processes, the port of the
reference's `test_utils/scripts/test_dispatcher.py`: rank 0 reads an
uneven dataset, every rank takes its slice of each global batch, the
ragged last batch is completed by wrapping and kept in ``remainder``, and
``gather_for_metrics`` gives back exactly the dataset."""

from __future__ import annotations

import numpy as np
import torch


def run_checks(expected: int | None = None, device: str | torch.device | None = None) -> None:
    from ...accelerator import Accelerator
    from ...data_loader import DataLoaderDispatcher
    from ...utils.operations import gather_object

    acc = Accelerator(device=device)
    n = acc.num_processes
    if expected is not None:
        assert n == expected, (n, expected)
    data = np.arange(27.0)  # batches of 8, the last of 3
    batches = [data[i:i + 8] for i in range(0, 27, 8)]
    dl = acc.prepare(DataLoaderDispatcher(batches if acc.is_main_process else []))
    seen, sizes = [], []
    for batch in dl:
        sizes.append(batch.shape[0])
        seen.append(acc.gather_for_metrics(batch).cpu().numpy())
    # each global batch is shape-complete: every rank's slice has one size
    everywhere = gather_object([sizes])
    assert all(s == everywhere[0] for s in everywhere), everywhere
    np.testing.assert_array_equal(np.concatenate(seen), data)
    assert n == 1 or dl.remainder == 3, dl.remainder
    acc.wait_for_everyone()
    print(f"proc {acc.process_index}: dispatcher uneven-dataset loop OK", flush=True)


if __name__ == "__main__":
    run_checks()
