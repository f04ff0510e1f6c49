"""Collective checks across processes, the port of the reference's
`test_utils/scripts/test_multiprocess_ops.py`: every expectation comes
from the live process count. Run it under the launcher, or through
`test_utils.test_script` at two processes."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def run_checks(expected: int | None = None, device: str | torch.device | None = None) -> None:
    from ...state import PartialState
    from ...utils import operations

    state = PartialState(device)
    n, p = state.num_processes, state.process_index
    if expected is not None:
        assert n == expected, (n, expected)

    got = operations.gather_object([f"proc{p}"])
    assert got == [f"proc{i}" for i in range(n)], got

    g = operations.gather(torch.full((2,), float(p), device=state.device))
    np.testing.assert_array_equal(g.cpu().numpy(), np.repeat(np.arange(float(n)), 2))

    # a broadcast from the last rank, and of objects from it
    b = operations.broadcast(np.full((3,), float(p + 5)), from_process=n - 1)
    np.testing.assert_array_equal(b, np.full((3,), float(n - 1 + 5)))
    objs = operations.broadcast_object_list([f"payload{p}", p * 10], from_process=n - 1)
    assert objs == [f"payload{n - 1}", (n - 1) * 10], objs

    # ragged lengths padded to the longest
    ragged = torch.arange(float(p + 1), device=state.device)
    padded = operations.pad_across_processes(ragged, dim=0).cpu().numpy()
    assert padded.shape[0] == n, padded.shape
    np.testing.assert_array_equal(padded[:p + 1], ragged.cpu().numpy())
    np.testing.assert_array_equal(padded[p + 1:], 0.0)

    # main_process_first runs the main process's body first: a marker file on
    # this machine's shared temporary directory, named by the rendezvous
    marker = os.path.join(tempfile.gettempdir(), "mpf_" + os.environ.get("MASTER_PORT", "0"))
    if state.is_main_process and os.path.exists(marker):
        os.remove(marker)
    state.wait_for_everyone()
    with state.main_process_first():
        if state.is_main_process:
            with open(marker, "w") as f:
                f.write("main was here")
        else:
            assert os.path.exists(marker), "main_process_first did not run main first"
    state.wait_for_everyone()
    if state.is_main_process:
        os.remove(marker)
    state.wait_for_everyone()
    print(f"proc {p}/{n}: multi-process collectives OK", flush=True)


if __name__ == "__main__":
    run_checks(int(os.environ.get("WORLD_SIZE", "2")))
