"""A world of gloo processes on the CPU for the port's multi-process tests.

`World` starts ``n`` fresh interpreters, each with the torchrun contract of
`accelerate_tpu_torch.commands.launch` on a free localhost port, a scrubbed
environment (no ``JAX_*`` and no other launcher's variables, which other
test files leave in a worker), one PyTorch thread, and
``ACCELERATE_TPU_USE_CPU=1``. Each runs ``function(*args)`` from a worker
file, which records its checks with `Recorder` into ``<out>/rank<r>.pkl``.
The world runs in the background while the test computes its reference;
`World.wait` kills every process past the timeout, so a hang fails the
tests of that world instead of cutting the suite.
"""

from __future__ import annotations

import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable

from accelerate_tpu_torch.commands.launch import contract, free_port, scrubbed_environ

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 120


class World:
    def __init__(self, worker: Path, function: str, args: tuple, n: int, out: Path,
                 timeout: float = WORLD_TIMEOUT_S):
        self.n, self.out, self.timeout = n, Path(out), timeout
        self.out.mkdir(parents=True, exist_ok=True)
        port = free_port()
        runner = (f"import runpy, torch; torch.set_num_threads(1); "
                  f"runpy.run_path({str(worker)!r})[{function!r}](*{args!r})")
        base = {**scrubbed_environ(), "ACCELERATE_TPU_USE_CPU": "1", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": str(ROOT)}
        self.logs = [open(self.out / f"rank{r}.log", "w+") for r in range(n)]
        self.start = time.monotonic()
        self.procs = [subprocess.Popen([sys.executable, "-c", runner], cwd=ROOT,
                                       stdout=self.logs[r], stderr=subprocess.STDOUT,
                                       env={**base, **contract(r, n, port)})
                      for r in range(n)]
        self._results: list[dict] | None = None

    def wait(self) -> list[dict]:
        """Every rank's recorded checks (rank order), once all have ended;
        raises with the logs when a process failed or outlived the
        timeout."""
        if self._results is not None:
            return self._results
        deadline = self.start + self.timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=max(deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                codes.append("timeout")
        for p in self.procs:
            p.wait()
        logs = []
        for f in self.logs:
            f.seek(0)
            logs.append(f.read())
            f.close()
        self.seconds = time.monotonic() - self.start
        if any(c != 0 for c in codes):
            raise RuntimeError(f"world of {self.n}: exit codes {codes}\n"
                               + "\n".join(f"--- rank {r} ---\n{log[-6000:]}"
                                           for r, log in enumerate(logs)))
        self._results = [pickle.loads((self.out / f"rank{r}.pkl").read_bytes())
                         for r in range(self.n)]
        return self._results


class Recorder:
    """One rank's checks: ``check(name, fn)`` stores ``fn()``'s value, or
    the traceback when it raises; `save` writes them."""

    def __init__(self, out: Path, rank: int):
        self.path = Path(out) / f"rank{rank}.pkl"
        self.results: dict[str, Any] = {}

    def check(self, name: str, fn: Callable[[], Any]) -> Any:
        try:
            value = fn()
        except Exception:
            value = {"error": traceback.format_exc()}
        self.results[name] = value
        return value

    def save(self) -> None:
        self.path.write_bytes(pickle.dumps(self.results))


def result(world: list[dict], rank: int, name: str) -> Any:
    """A rank's recorded value; a recorded traceback fails the test."""
    value = world[rank][name]
    if isinstance(value, dict) and set(value) == {"error"}:
        raise AssertionError(f"rank {rank}, {name}:\n{value['error']}")
    return value
