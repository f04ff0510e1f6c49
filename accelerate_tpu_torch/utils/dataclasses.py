"""Kwargs handlers and configuration dataclasses: the port of
`accelerate_tpu.utils.dataclasses` at one process.

`Accelerator(kwargs_handlers=[...])` takes `GradScalerKwargs` (the fp16
scaler's settings), `AutocastKwargs` (what ``Accelerator.autocast`` does by
default), `ProfileKwargs` (what ``Accelerator.profile`` records, mapped onto
``torch.profiler``) and the data-only `FP8RecipeKwargs`;
`DataLoaderConfiguration` goes to ``dataloader_config=``. `CompilationConfig`
and `FP8RecipeKwargs` are data only: the port has no compiled step and no
fp8 yet (ROADMAP Queue 1, items 25 and 21.1).

The multi-process plugins and handlers (`FullyShardedDataParallelPlugin`,
`DeepSpeedPlugin`, `MegatronLMPlugin`, `InitProcessGroupKwargs`,
`DistributedDataParallelKwargs`) wait for the multi-process runtime: each
raises NotImplementedError (ROADMAP Queue 1, item 21.3).
"""

from __future__ import annotations

import copy
import itertools
import os
from dataclasses import dataclass
from typing import Any

import torch


class KwargsHandler:
    """Base of the typed kwargs containers."""

    def to_dict(self) -> dict:
        return copy.deepcopy(self.__dict__)


@dataclass
class GradScalerKwargs(KwargsHandler):
    """The fp16 dynamic loss scale's settings (`utils.precision.DynamicGradScaler`);
    ``enabled=False`` turns the scaler off."""

    init_scale: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """Data loader behaviour, the reference's fields. At one process
    ``split_batches``, ``dispatch_batches`` and ``even_batches`` change
    nothing; prepared loaders save and resume their position whatever
    ``use_stateful_dataloader`` says, and transfers are asynchronous."""

    split_batches: bool = False
    dispatch_batches: bool | None = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = True
    use_stateful_dataloader: bool = True


class _TraceContext:
    """A ``torch.profiler.profile`` that writes its Chrome trace into a
    directory when it ends; ``profiler`` is the torch profiler."""

    _seq = itertools.count()

    def __init__(self, kwargs: "ProfileKwargs", output_dir: str, device: Any):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.output_dir = output_dir
        self.trace_path: str | None = None
        self.profiler = torch.profiler.profile(activities=activities,
                                               record_shapes=kwargs.host_tracer_level >= 3,
                                               with_stack=kwargs.python_tracer_level > 0)

    def __enter__(self) -> Any:
        self.profiler.__enter__()
        return self.profiler

    def __exit__(self, *exc: Any) -> None:
        self.profiler.__exit__(*exc)
        os.makedirs(self.output_dir, exist_ok=True)
        self.trace_path = os.path.join(self.output_dir,
                                       f"trace_{os.getpid()}_{next(self._seq)}.json")
        self.profiler.export_chrome_trace(self.trace_path)


@dataclass
class ProfileKwargs(KwargsHandler):
    """What ``Accelerator.profile`` records, the reference's fields mapped
    onto ``torch.profiler``: host activity always, CUDA kernels when the
    accelerator runs on the card; ``host_tracer_level >= 3`` records input
    shapes and ``python_tracer_level > 0`` Python stacks. The trace is a
    Chrome trace (``trace_<pid>_<n>.json``) under ``output_trace_dir``; it
    opens in ui.perfetto.dev, so ``create_perfetto_link`` has nothing to
    add."""

    output_trace_dir: str | None = None
    create_perfetto_link: bool = False
    host_tracer_level: int = 2
    python_tracer_level: int = 0

    def build(self, output_dir: str | None = None, device: Any = "cpu") -> _TraceContext:
        """The profiling context for ``device``, writing into ``output_dir``
        (default ``output_trace_dir``, else ``profile_traces``)."""
        return _TraceContext(self, output_dir or self.output_trace_dir or "profile_traces", device)


@dataclass
class CompilationConfig(KwargsHandler):
    """The reference's compile options, kept as data: the port's train step
    runs eagerly (ROADMAP item 25)."""

    donate_buffers: bool = True
    scan_layers: bool = False
    remat: bool = False
    remat_policy: str | None = None


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The reference's delayed-scaling fp8 recipe, kept as data until the
    Hopper fp8 matmuls are ported (ROADMAP Queue 1, item 21.1)."""

    margin: int = 0
    interval: int = 16
    fp8_format: str = "HYBRID"
    amax_history_len: int = 1024
    amax_compute_algo: str = "max"
    backend: str = "native"
    opt_level: str = "O1"


@dataclass
class AutocastKwargs(KwargsHandler):
    """What ``Accelerator.autocast`` does. Mixed precision is a cast of the
    parameters around the forward, not ``torch.autocast``, so the lever is
    ``enabled=False``: prepared-model calls inside the block skip the
    compute-dtype cast and run on the fp32 masters. ``cache_enabled`` is
    accepted and changes nothing."""

    enabled: bool = True
    cache_enabled: bool | None = None


def _multi_process(name: str) -> type:
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            f"{name} configures the multi-process runtime, which is not ported yet "
            "(ROADMAP Queue 1, item 21.3)")

    return type(name, (KwargsHandler,), {"__init__": __init__, "__doc__":
                                         f"The reference's ``{name}``: raises until the "
                                         "multi-process runtime is ported (item 21.3)."})


FullyShardedDataParallelPlugin = _multi_process("FullyShardedDataParallelPlugin")
DeepSpeedPlugin = _multi_process("DeepSpeedPlugin")
MegatronLMPlugin = _multi_process("MegatronLMPlugin")
InitProcessGroupKwargs = _multi_process("InitProcessGroupKwargs")
DistributedDataParallelKwargs = _multi_process("DistributedDataParallelKwargs")
