"""Process, accelerator and gradient-accumulation state: the port of
`accelerate_tpu.state`.

The reference runs one process per host over a device mesh; the port runs
one process per device over ``torch.distributed``. The topology is
process-wide: `PartialState` reads the rank, local rank and world size from
the default process group, which it initializes from the launcher's
environment the first time one is built (`init_distributed`: the torchrun
contract ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, which `commands.launch` sets; a multi-task SLURM step and
SageMaker's ``SM_HOSTS`` are translated to it). With none of that in the
environment no group is made: the program is one process, every process
predicate is true, and the barriers return at once.

Everything else stays per accelerator: an `Accelerator` creates one
`AcceleratorState` and one `GradientState` and passes them to what it
prepares (its optimizers, data loaders and schedulers), so two accelerators
in one process never see each other's step counts or boundaries.
"""

from __future__ import annotations

import datetime
import functools
import json
import logging
import os
from contextlib import contextmanager
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from .utils.environment import parse_flag_from_env, resolve_device

logger = logging.getLogger(__name__)

# the reference's default rendezvous and collective timeout
# (`InitProcessGroupKwargs.timeout_seconds`)
DEFAULT_TIMEOUT_S = 1800


class DistributedType(str):
    """The reference's topology values: ``NO`` (one process), ``SPMD``
    (several processes on one host: the reference's several devices under
    one process), ``MULTI_HOST`` (processes on several hosts)."""

    NO = "NO"
    SPMD = "SPMD"
    MULTI_HOST = "MULTI_HOST"


class Topology(NamedTuple):
    process_index: int
    local_process_index: int
    num_processes: int
    local_num_processes: int


def _sagemaker_env_to_contract() -> None:
    """SageMaker's cluster (``SM_HOSTS``, a JSON list, and
    ``SM_CURRENT_HOST``) as the torchrun contract, one process per host, when
    ``ACCELERATE_TPU_USE_SAGEMAKER=true`` and no contract is set (reference
    `state.py:46`)."""
    if os.environ.get("ACCELERATE_TPU_USE_SAGEMAKER") != "true" or "WORLD_SIZE" in os.environ:
        return
    hosts_raw, current = os.environ.get("SM_HOSTS"), os.environ.get("SM_CURRENT_HOST")
    if not hosts_raw or not current:
        return
    try:
        hosts = sorted(json.loads(hosts_raw))
    except ValueError:
        logger.warning("SM_HOSTS is not JSON (%r); skipping cluster translation", hosts_raw)
        return
    if len(hosts) <= 1 or current not in hosts:
        return
    os.environ.update({"MASTER_ADDR": hosts[0], "MASTER_PORT": os.environ.get("MASTER_PORT", "29500"),
                       "WORLD_SIZE": str(len(hosts)), "RANK": str(hosts.index(current)),
                       "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"})


def _in_multitask_slurm_step() -> bool:
    """True inside an ``srun`` task of a multi-task SLURM step (reference
    `state.py:72`): the step's task count, not the allocation's, decides, so
    the single process of an ``sbatch --ntasks=N`` script is not taken for
    one of N."""
    if "SLURM_PROCID" not in os.environ or "SLURM_JOB_ID" not in os.environ:
        return False
    try:
        step_tasks = int(os.environ.get("SLURM_STEP_NUM_TASKS") or 1)
    except ValueError:
        return False
    return step_tasks > 1


def _slurm_env_to_contract() -> None:
    """A multi-task SLURM step's task ids as the torchrun contract; the
    rendezvous host is ``MASTER_ADDR``, else the node ``srun`` ran on."""
    if "WORLD_SIZE" in os.environ or not _in_multitask_slurm_step():
        return
    addr = os.environ.get("MASTER_ADDR") or os.environ.get("SLURM_LAUNCH_NODE_IPADDR")
    os.environ.update({"RANK": os.environ["SLURM_PROCID"],
                       "WORLD_SIZE": os.environ["SLURM_STEP_NUM_TASKS"],
                       "LOCAL_RANK": os.environ.get("SLURM_LOCALID", "0"),
                       "MASTER_PORT": os.environ.get("MASTER_PORT", "29500")})
    if addr:
        os.environ["MASTER_ADDR"] = addr


def _env_int(key: str, default: int) -> int:
    raw = os.environ.get(key, "").strip()
    return int(raw) if raw else default


def init_distributed(device: str | torch.device | None = None, backend: str | None = None,
                     timeout: float | None = None) -> bool:
    """Initialize the default process group from the launcher's environment
    when it names a world (``WORLD_SIZE``) and no group exists yet; returns
    whether a group exists afterwards. The backend is ``backend``, else the
    launcher's ``ACCELERATE_TPU_BACKEND``, else NCCL for a CUDA device and
    gloo for the CPU (gloo lets several ranks share one GPU, which NCCL
    refuses); the rendezvous is
    ``tcp://MASTER_ADDR:MASTER_PORT`` and ``timeout`` (seconds, default
    1800) bounds it and every collective after. A CUDA device without an
    index becomes ``cuda:LOCAL_RANK``. ``WORLD_SIZE`` without
    ``MASTER_ADDR`` raises ValueError rather than waiting for a rendezvous
    that cannot happen."""
    import torch.distributed as dist

    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    _sagemaker_env_to_contract()
    _slurm_env_to_contract()
    if "WORLD_SIZE" not in os.environ:
        return False
    world, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT", "29500")
    if not addr:
        raise ValueError(
            f"WORLD_SIZE={world} is set but MASTER_ADDR is not: a process group needs the "
            "rendezvous address of rank 0 (the torchrun contract RANK, WORLD_SIZE, LOCAL_RANK, "
            "MASTER_ADDR, MASTER_PORT; `python -m accelerate_tpu_torch.commands.launch` sets it)")
    dev = _process_device(device)
    if backend is None:
        backend = os.environ.get("ACCELERATE_TPU_BACKEND") or ("nccl" if dev.type == "cuda"
                                                               else "gloo")
    seconds = DEFAULT_TIMEOUT_S if timeout is None else timeout
    try:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=seconds))
    except Exception as exc:
        if _in_multitask_slurm_step() and parse_flag_from_env("ACCELERATE_TPU_ALLOW_SLURM_FALLBACK"):
            logger.warning("multi-task SLURM step detected but the process group failed (%s); "
                           "ACCELERATE_TPU_ALLOW_SLURM_FALLBACK=1 set: each task runs alone", exc)
            return False
        raise
    return True


def _process_device(device: str | torch.device | None) -> torch.device:
    """The device this process runs on: ``device``, with a CUDA device
    without an index taken as ``cuda:LOCAL_RANK`` (made current) under a
    launcher; ``ACCELERATE_TPU_USE_CPU`` (the launcher's ``--debug_cpu``)
    turns the default into the CPU."""
    if device is None and parse_flag_from_env("ACCELERATE_TPU_USE_CPU"):
        device = "cpu"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
        torch.cuda.set_device(dev)
    return resolve_device(dev)


def topology() -> Topology:
    """(rank, local rank, world size, ranks on this host) of this process,
    read without creating anything: from the process group when one exists,
    else from the launcher's environment, else one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        return Topology(dist.get_rank(), _env_int("LOCAL_RANK", 0), world,
                        _env_int("LOCAL_WORLD_SIZE", world))
    world = _env_int("WORLD_SIZE", 1)
    return Topology(_env_int("RANK", 0), _env_int("LOCAL_RANK", 0), world,
                    _env_int("LOCAL_WORLD_SIZE", world))


class PartialState:
    """This process's place in the job: ``device``, ``process_index``,
    ``local_process_index``, ``num_processes`` and ``distributed_type``, and
    the coordination that spans processes (barriers, ordered sections, the
    split of inputs, rank-gated calls). Building one initializes the
    process group from the environment (`init_distributed`); the topology is
    then the group's, shared by every instance in the process."""

    def __init__(self, device: str | torch.device | None = None, backend: str | None = None,
                 timeout: float | None = None):
        init_distributed(device, backend, timeout)
        self.device = _process_device(device)

    # ------------------------------------------------------------ topology
    @property
    def process_index(self) -> int:
        return topology().process_index

    @property
    def local_process_index(self) -> int:
        return topology().local_process_index

    @property
    def num_processes(self) -> int:
        return topology().num_processes

    @property
    def backend(self) -> str | None:
        import torch.distributed as dist

        return dist.get_backend() if dist.is_available() and dist.is_initialized() else None

    @property
    def distributed_type(self) -> str:
        top = topology()
        if top.num_processes == 1:
            return DistributedType.NO
        return DistributedType.SPMD if top.local_num_processes == top.num_processes \
            else DistributedType.MULTI_HOST

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    # -------------------------------------------------------- coordination
    def wait_for_everyone(self) -> None:
        """A barrier over every process (reference `state.py:343`), bounded
        by the group's timeout; returns at once at one process."""
        if self.num_processes > 1:
            barrier()

    @contextmanager
    def main_process_first(self) -> Iterator[None]:
        """The main process runs the body before the others (reference
        `state.py:478`)."""
        with self._first(self.is_main_process):
            yield

    @contextmanager
    def local_main_process_first(self) -> Iterator[None]:
        """Each host's local main process runs the body before the host's
        other processes."""
        with self._first(self.is_local_main_process):
            yield

    @contextmanager
    def _first(self, leader: bool) -> Iterator[None]:
        if not leader:
            self.wait_for_everyone()
        yield
        if leader:
            self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs: Any, apply_padding: bool = False) -> Iterator[Any]:
        """This process's slice of ``inputs`` (reference `state.py:251-288`):
        lists, tuples, numpy arrays and tensors on their first dimension, a
        dict value by value (equal lengths). The first ``len % processes``
        processes take one more element; with ``apply_padding`` the others
        repeat the last element so every slice has that length."""
        n, rank = self.num_processes, self.process_index
        if n == 1:
            yield inputs
            return

        def slice_one(obj: Any) -> Any:
            length = len(obj)
            base, extra = divmod(length, n)
            start = rank * base + min(rank, extra)
            stop = start + base + (1 if rank < extra else 0)
            piece = obj[start:stop]
            pad_n = (base + 1 - len(piece)) if apply_padding and extra else 0
            if pad_n <= 0 or length == 0:
                return piece
            if isinstance(piece, np.ndarray):
                return np.concatenate([piece, np.repeat(obj[-1:], pad_n, axis=0)])
            if isinstance(piece, torch.Tensor):
                return torch.cat([piece, obj[-1:].expand(pad_n, *obj.shape[1:])])
            return type(piece)(list(piece) + [obj[-1]] * pad_n) if isinstance(piece, tuple) \
                else list(piece) + [obj[-1]] * pad_n

        if isinstance(inputs, dict):
            lengths = {len(v) for v in inputs.values()}
            if len(lengths) > 1:
                raise ValueError(f"All dict values must have equal length, got {lengths}.")
            yield {k: slice_one(v) for k, v in inputs.items()}
        else:
            yield slice_one(inputs)

    # ----------------------------------------------------------- rank gating
    def _on(self, predicate: Callable[[], bool], function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if predicate():
                return function(*args, **kwargs)
            return None

        return wrapper

    def on_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_last_process, function)

    def on_process(self, function: Callable | None = None, process_index: int = 0) -> Callable:
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self._on(lambda: self.process_index == process_index, function)

    def on_local_process(self, function: Callable | None = None,
                         local_process_index: int = 0) -> Callable:
        if function is None:
            return functools.partial(self.on_local_process, local_process_index=local_process_index)
        return self._on(lambda: self.local_process_index == local_process_index, function)

    def print(self, *args: Any, **kwargs: Any) -> None:
        """Print once per job: on the main process."""
        if self.is_main_process:
            print(*args, **kwargs)

    def shutdown(self) -> None:
        """Destroy the process group (reference `state.py:793`), after a
        barrier so no rank leaves while another still talks to it."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            self.wait_for_everyone()
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return (f"PartialState(device={self.device}, distributed_type={self.distributed_type}, "
                f"num_processes={self.num_processes}, process_index={self.process_index})")


def barrier() -> None:
    """``torch.distributed.barrier`` on the default group; under NCCL on the
    current device, so no rank guesses another's."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class AcceleratorState:
    """The process state plus the training plan: the mixed-precision mode."""

    def __init__(self, mixed_precision: str, device: str | torch.device | None = None,
                 backend: str | None = None, timeout: float | None = None):
        self.partial = PartialState(device, backend=backend, timeout=timeout)
        self.mixed_precision = mixed_precision

    @property
    def device(self) -> torch.device:
        return self.partial.device

    def __repr__(self) -> str:
        return f"AcceleratorState(mixed_precision={self.mixed_precision!r}, device={self.device})"


class GradientState:
    """Gradient-accumulation bookkeeping, as the reference keeps it
    (`accelerate_tpu/state.py:483-530`): ``num_steps`` microbatches per
    update, ``sync_gradients`` true on an update boundary, and the stack of
    data loaders being iterated. The innermost active loader's
    ``end_of_dataloader`` forces a boundary on its last batch (when
    ``sync_with_dataloader``), and its ``remainder`` tells
    ``gather_for_metrics`` how many samples of the last batch are real."""

    def __init__(self, gradient_accumulation_steps: int = 1, adjust_scheduler: bool = True,
                 sync_with_dataloader: bool = True):
        if gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got {gradient_accumulation_steps}")
        self.num_steps = gradient_accumulation_steps
        self.adjust_scheduler = adjust_scheduler
        self.sync_with_dataloader = sync_with_dataloader
        self.sync_gradients = True
        self.active_dataloader: Any = None
        self.dataloader_references: list[Any] = [None]

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        """Real samples in the last (global) batch of a ragged epoch, -1 when
        none is ragged or no loader is active."""
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = sync

    def _add_dataloader(self, dataloader: Any) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader: Any) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    def __repr__(self) -> str:
        return f"GradientState(num_steps={self.num_steps}, sync_gradients={self.sync_gradients})"
