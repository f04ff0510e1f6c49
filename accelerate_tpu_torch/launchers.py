"""Launch a function on several processes from Python: the port of
`accelerate_tpu.launchers`.

`notebook_launcher` forks ``num_processes`` workers that inherit the
interpreter, so a function defined in a notebook cell runs without being
importable; `debug_launcher` starts fresh interpreters on the CPU over
gloo, each loading the function's module file. Both give every worker the
torchrun contract of `commands.launch` (a free localhost port when none is
given), stop the others at the first failure, and raise RuntimeError
carrying the failed worker's traceback.
"""

from __future__ import annotations

import inspect
import multiprocessing
import os
import subprocess
import sys
import tempfile
import textwrap
import traceback
from pathlib import Path
from typing import Any, Callable

from .commands.launch import contract, free_port, scrubbed_environ, supervise


def _notebook_worker(function: Callable, args: tuple, env: dict[str, str], errors: Any) -> None:
    """A forked worker: take the contract, run, and leave with ``os._exit``
    (no inherited exit hooks run); a raise sends its traceback home."""
    os.environ.update(env)
    try:
        function(*args)
    except BaseException:
        errors.put((int(env["RANK"]), traceback.format_exc()))
        code = 1
    else:
        code = 0
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


class _ForkedWorker:
    """A forked ``multiprocessing.Process`` with the ``poll`` / ``terminate`` /
    ``wait`` / ``kill`` of a ``subprocess.Popen``, for `supervise`."""

    def __init__(self, process: multiprocessing.Process):
        self.process = process

    def poll(self) -> int | None:
        return self.process.exitcode

    def terminate(self) -> None:
        self.process.terminate()

    def kill(self) -> None:
        self.process.kill()

    def wait(self, timeout: float | None = None) -> int:
        self.process.join(timeout)
        if self.process.exitcode is None:
            raise subprocess.TimeoutExpired("worker", timeout)
        return self.process.exitcode


def notebook_launcher(function: Callable, args: tuple = (), num_processes: int | None = None,
                      mixed_precision: str = "no", use_port: str = "29500",
                      master_addr: str = "127.0.0.1", node_rank: int = 0, num_nodes: int = 1,
                      max_restarts: int = 0, monitor_interval: float = 0.1) -> None:
    """Run ``function(*args)`` on ``num_processes`` forked workers of this
    machine (reference `launchers.py:65`), or here when there is one.
    Workers ``node_rank * num_processes + i`` of ``num_nodes`` machines meet
    at ``master_addr:use_port`` (``"0"``: a free port, one machine only). A
    failed generation is started again up to ``max_restarts`` times. Refused
    inside a launched job, after CUDA is initialized in this process (the
    workers would inherit a dead context), or where fork is missing."""
    os.environ.setdefault("ACCELERATE_TPU_MIXED_PRECISION", mixed_precision)
    if (num_processes is None or num_processes <= 1) and num_nodes <= 1:
        function(*args)
        return
    import torch

    num_processes = num_processes or 1
    if "WORLD_SIZE" in os.environ:
        raise RuntimeError("notebook_launcher cannot run inside an already launched job")
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "CUDA is initialized in this process; forked workers would inherit a context they "
            "cannot use. Call notebook_launcher before anything touches the GPU.")
    if num_nodes > 1 and str(use_port) == "0":
        raise ValueError("use_port='0' would give each machine its own port; pass one")
    try:
        ctx = multiprocessing.get_context("fork")
    except ValueError:
        raise RuntimeError("notebook_launcher needs the fork start method; use debug_launcher "
                           "with a module-level function instead") from None
    world = num_nodes * num_processes
    errors = ctx.SimpleQueue()
    ports: dict[int, str] = {}

    def spawn(i: int, restart: int) -> _ForkedWorker:
        if restart not in ports:
            ports[restart] = str(free_port(master_addr)) if str(use_port) == "0" else str(use_port)
        env = {**contract(node_rank * num_processes + i, world, int(ports[restart]), master_addr),
               "LOCAL_RANK": str(i), "LOCAL_WORLD_SIZE": str(num_processes),
               "ACCELERATE_TPU_MIXED_PRECISION": mixed_precision,
               "ACCELERATE_TPU_NUM_PROCESSES": str(world),
               "ACCELERATE_TPU_RESTART_COUNT": str(restart)}
        p = ctx.Process(target=_notebook_worker, args=(function, args, env, errors))
        p.start()
        return _ForkedWorker(p)

    code = supervise(spawn, num_processes, max_restarts, monitor_interval)
    if code:
        failures = []
        while not errors.empty():
            failures.append(errors.get())
        detail = "\n".join(f"--- worker {rank} ---\n{tb}" for rank, tb in failures)
        raise RuntimeError(f"notebook_launcher: a worker failed with exit code {code}"
                           + (f":\n{detail}" if detail else ""))


def debug_launcher(function: Callable, args: tuple = (), num_processes: int = 2,
                   timeout: float | None = None) -> None:
    """Run ``function(*args)`` in ``num_processes`` fresh CPU processes over
    gloo (reference `launchers.py:221`). ``function`` must be a module-level
    function of a file (each worker loads the file) and ``args`` literals.
    Each worker's environment is this one's, scrubbed, with the contract,
    ``ACCELERATE_TPU_USE_CPU=1`` and ``OMP_NUM_THREADS=1``. ``timeout``
    (seconds) stops every worker and raises when they run longer."""
    module = inspect.getmodule(function)
    name = function.__qualname__
    if module is None or not getattr(module, "__file__", None) or "." in name \
            or "<locals>" in name:
        raise ValueError("debug_launcher needs a module-level function defined in a file")
    runner = textwrap.dedent(f"""
        import runpy
        ns = runpy.run_path({module.__file__!r})
        ns[{name!r}](*{args!r})
        """)
    port = free_port()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    base = {**scrubbed_environ(), "ACCELERATE_TPU_USE_CPU": "1", "OMP_NUM_THREADS": "1"}
    root = str(Path(__file__).resolve().parents[1])  # the package importable in each worker
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, base.get("PYTHONPATH")) if p)
    failed: list[tuple[int, int]] = []

    def spawn(i: int, restart: int) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, "-c", runner], stderr=logs[i],
                                env={**base, **contract(i, num_processes, port)})

    try:
        code = supervise(spawn, num_processes, on_failure=lambda i, c: failed.append((i, c)),
                         timeout=timeout)
    except TimeoutError as exc:
        code, failed[:] = 124, [(0, 124)]
        timed_out = str(exc)
    else:
        timed_out = ""
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    for text in outputs:
        sys.stderr.write(text)
    if code:
        rank = failed[0][0] if failed else 0
        raise RuntimeError(f"debug_launcher: worker {rank} failed with exit code {code}"
                           f"{' (' + timed_out + ')' if timed_out else ''}:\n"
                           f"{outputs[rank][-8000:]}")
