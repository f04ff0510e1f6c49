"""``python -m accelerate_tpu_torch.commands.launch``: start a training
script on every device of this machine, one process each. The port of
`accelerate_tpu.commands.launch`.

The reference runs one process a host; the port runs one a device, so the
launcher starts ``--num_processes`` children (``--debug_cpu N``: N children
on the CPU, over gloo) and gives each the torchrun contract, ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
(localhost) and ``MASTER_PORT`` (``--main_process_port``, else a free port),
which `state.init_distributed` reads, plus the reference's
``ACCELERATE_TPU_*`` variables (`launch_env`: mixed precision, gradient
accumulation, the mesh's degrees, debug mode; ``ACCELERATE_TPU_USE_CPU``
under ``--debug_cpu``, ``ACCELERATE_TPU_BACKEND`` with ``--backend``).
Each child's environment is this one scrubbed of
``JAX_*``, of any other launcher's contract and of the variables above,
then set. ``OMP_NUM_THREADS`` is 1 unless set (torchrun's rule).

The first child to fail stops the others (SIGTERM, then SIGKILL after a
grace period), and its exit code is the launcher's (128 + the signal for a
child killed by one). ``--max_restarts N`` restarts the whole generation up
to N times (``ACCELERATE_TPU_RESTART_COUNT`` tells the script which), as
the reference's supervisor does; ``--monitor_interval`` is how often the
children are polled. ``--dry_run`` prints each child's contract and command
and starts nothing. The reference's multi-machine launches (``--workers``,
``--hostfile``, ``--tpu_name``, ``--sagemaker``, ``--main_process_ip``,
``--num_machines`` above 1) raise NotImplementedError (ROADMAP Queue 1,
item 21.3).
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

from .config import LaunchConfig

# variables a child never inherits: another launcher's contract and ours
_SCRUBBED = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
             "GROUP_RANK", "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_WORLD_SIZE", "NODE_RANK",
             "ACCELERATE_TPU_USE_CPU", "ACCELERATE_TPU_RESTART_COUNT", "ACCELERATE_TPU_NUM_PROCESSES",
             "ACCELERATE_TPU_MIXED_PRECISION", "ACCELERATE_TPU_GRAD_ACCUM_STEPS",
             "ACCELERATE_TPU_PARALLELISM", "ACCELERATE_TPU_DEBUG_MODE", "ACCELERATE_TPU_BACKEND")
_SCRUBBED_PREFIXES = ("JAX_", "TORCHELASTIC_")
GRACE_S = 10.0


def free_port(host: str = "127.0.0.1") -> int:
    """A port nothing listens on now (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def scrubbed_environ() -> dict[str, str]:
    """This process's environment without any launcher's contract or
    ``JAX_*``."""
    return {k: v for k, v in os.environ.items()
            if k not in _SCRUBBED and not k.startswith(_SCRUBBED_PREFIXES)}


def contract(rank: int, world: int, port: int, addr: str = "127.0.0.1") -> dict[str, str]:
    """The torchrun variables of local rank ``rank`` in a one-machine world."""
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": addr, "MASTER_PORT": str(port)}


def launch_env(cfg: LaunchConfig) -> dict[str, str]:
    """The reference's ``ACCELERATE_TPU_*`` variables for ``cfg``
    (reference `commands/launch.py:36`)."""
    env = {
        "ACCELERATE_TPU_MIXED_PRECISION": cfg.mixed_precision,
        "ACCELERATE_TPU_GRAD_ACCUM_STEPS": str(cfg.gradient_accumulation_steps),
        "ACCELERATE_TPU_PARALLELISM": ",".join(str(x) for x in (
            cfg.data_parallel_size, cfg.fsdp_size, cfg.stage_size, cfg.sequence_size,
            cfg.tensor_size)),
        "ACCELERATE_TPU_NUM_PROCESSES": str(cfg.num_processes),
    }
    if cfg.debug:
        env["ACCELERATE_TPU_DEBUG_MODE"] = "1"
    return env


def child_command(script: str, script_args: list[str], module: bool) -> list[str]:
    if module:
        return [sys.executable, "-m", script, *script_args]
    return [sys.executable, script, *script_args]


def exit_code(returncode: int) -> int:
    """A child's return code as a shell exit code (a signal ``s`` is 128 +
    ``s``)."""
    return 128 - returncode if returncode < 0 else returncode


def stop(procs: list[subprocess.Popen], grace_s: float = GRACE_S) -> None:
    """SIGTERM every child still running, SIGKILL those alive after
    ``grace_s``, and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def supervise(spawn: Callable[[int, int], subprocess.Popen], n: int, max_restarts: int = 0,
              monitor_interval: float = 0.5,
              on_failure: Callable[[int, int], None] | None = None,
              timeout: float | None = None) -> int:
    """Run ``spawn(rank, restart)`` for every rank and wait: 0 when all exit
    0; at the first failure stop the others and start a new generation (up
    to ``max_restarts`` times), else return that child's exit code.
    ``on_failure(rank, code)`` hears of each failure before the stop. Past
    ``timeout`` seconds every child is stopped and TimeoutError raised."""
    restarts = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    procs = [spawn(i, restarts) for i in range(n)]
    try:
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {n} processes ran longer than {timeout} s")
            codes = [p.poll() for p in procs]
            failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is None and all(c == 0 for c in codes):
                return 0
            if failed is not None:
                code = exit_code(codes[failed])
                if on_failure is not None:
                    on_failure(failed, code)
                stop(procs)
                if restarts >= max_restarts:
                    return code
                restarts += 1
                print(f"[accelerate_tpu_torch launch] rank {failed} failed with exit code {code}; "
                      f"restart {restarts}/{max_restarts}", file=sys.stderr, flush=True)
                procs = [spawn(i, restarts) for i in range(n)]
            time.sleep(monitor_interval)
    finally:
        stop(procs)


def _render(env: dict[str, str], command: list[str]) -> str:
    return " ".join([*(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())),
                     *(shlex.quote(c) for c in command)])


def _refuse_multi_machine(args: argparse.Namespace) -> None:
    for flag in ("workers", "hostfile", "tpu_name", "zone", "main_process_ip",
                 "coordinator_address"):
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag}: launches across machines (pods, ssh, gcloud, SageMaker) are not "
                "ported; one machine, one process a device (ROADMAP Queue 1, item 21.3)")
    if args.sagemaker:
        raise NotImplementedError("--sagemaker is not ported (ROADMAP Queue 1, item 21.3)")
    if (args.num_machines or 1) > 1 or (args.machine_rank or 0) > 0:
        raise NotImplementedError("--num_machines above 1: launches across machines are not "
                                  "ported (ROADMAP Queue 1, item 21.3)")


def launch_command(args: argparse.Namespace) -> int:
    """Start the children (or print them with ``--dry_run``); returns the
    exit code."""
    _refuse_multi_machine(args)
    cfg = LaunchConfig.from_yaml(Path(args.config_file) if args.config_file else None)
    for attr in ("num_processes", "mixed_precision", "gradient_accumulation_steps",
                 "data_parallel_size"):
        value = getattr(args, attr, None)
        if value is not None:
            setattr(cfg, attr, value)
    if args.debug_cpu:
        cfg.num_processes = args.debug_cpu
    if args.debug:
        cfg.debug = True
    n = cfg.num_processes
    if n < 1:
        raise SystemExit(f"--num_processes must be at least 1, got {n}")
    extra = launch_env(cfg)
    if args.debug_cpu:
        extra["ACCELERATE_TPU_USE_CPU"] = "1"
    if args.backend:
        extra["ACCELERATE_TPU_BACKEND"] = args.backend
    command = child_command(args.training_script, args.training_script_args, args.module)
    fixed_port = args.main_process_port

    def env_of(rank: int, restart: int, port: int) -> dict[str, str]:
        return {**extra, **contract(rank, n, port), "ACCELERATE_TPU_RESTART_COUNT": str(restart)}

    if args.dry_run:
        port = fixed_port or 29500
        for rank in range(n):
            print(f"rank {rank}: {_render(env_of(rank, 0, port), command)}")
        return 0
    base = scrubbed_environ()
    base.setdefault("OMP_NUM_THREADS", "1")
    ports: dict[int, int] = {}

    def spawn(rank: int, restart: int) -> subprocess.Popen:
        if restart not in ports:  # a fresh rendezvous for each generation
            ports[restart] = fixed_port or free_port()
        return subprocess.Popen(command, env={**base, **env_of(rank, restart, ports[restart])})

    return supervise(spawn, n, max_restarts=args.max_restarts,
                     monitor_interval=args.monitor_interval)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("launch", help="launch a training script, one process a device")
    p.add_argument("--config_file", default=None)
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes on this machine, one a device (default: the config's, 1)")
    p.add_argument("--debug_cpu", type=int, default=None, metavar="N",
                   help="N processes on the CPU over gloo (ACCELERATE_TPU_USE_CPU=1)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: NCCL on GPUs, gloo on the "
                        "CPU; gloo lets processes share a GPU)")
    p.add_argument("--main_process_port", type=int, default=None,
                   help="rank 0's rendezvous port (default: a free one)")
    p.add_argument("--mixed_precision", default=None, choices=["no", "bf16", "fp16", "fp8"])
    p.add_argument("--gradient_accumulation_steps", type=int, default=None)
    p.add_argument("--data_parallel_size", "--dp", type=int, default=None,
                   dest="data_parallel_size")
    p.add_argument("--debug", action="store_true",
                   help="check the collectives' shapes across processes (ACCELERATE_TPU_DEBUG_MODE)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="restart every process after a failure, up to N times")
    p.add_argument("--monitor_interval", type=float, default=0.5,
                   help="seconds between polls of the children")
    p.add_argument("-m", "--module", action="store_true", help="run the script as a module")
    p.add_argument("--dry_run", action="store_true",
                   help="print each process's environment and command; start nothing")
    # the reference's launches across machines: refused (item 21.3)
    p.add_argument("--num_machines", type=int, default=None)
    p.add_argument("--machine_rank", type=int, default=None)
    p.add_argument("--main_process_ip", default=None)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--workers", default=None)
    p.add_argument("--hostfile", default=None)
    p.add_argument("--tpu_name", default=None)
    p.add_argument("--zone", default=None)
    p.add_argument("--sagemaker", action="store_true")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    p.set_defaults(func=launch_command)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("accelerate_tpu_torch.commands.launch")
    sub = parser.add_subparsers(dest="_cmd")
    add_parser(sub)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "launch":
        argv = ["launch", *argv]
    args = parser.parse_args(argv)
    # a SIGTERM to the launcher stops its children (supervise's finally)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
