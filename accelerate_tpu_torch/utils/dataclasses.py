"""Kwargs handlers and configuration dataclasses: the port of
`accelerate_tpu.utils.dataclasses`.

`Accelerator(kwargs_handlers=[...])` takes `GradScalerKwargs` (the fp16
scaler's settings), `AutocastKwargs` (what ``Accelerator.autocast`` does by
default), `ProfileKwargs` (what ``Accelerator.profile`` records, mapped onto
``torch.profiler``) and `FP8RecipeKwargs` (the fp8 recipe, ``to_recipe()``
for a model's ``fp8_recipe``, and the optimizer's opt level);
`DataLoaderConfiguration` goes to ``dataloader_config=``. `CompilationConfig`
is data only: the port has no compiled step (ROADMAP Queue 1, item 25).

The data-parallel handlers are real: `InitProcessGroupKwargs` (the process
group's backend and timeout) and `DistributedDataParallelKwargs` (the
gradient reduction's comm hook, which ``make_train_step`` applies). The
engine plugins (`FullyShardedDataParallelPlugin`, `DeepSpeedPlugin`,
`MegatronLMPlugin`) wait for the sharded axes: each raises
NotImplementedError (ROADMAP Queue 1, item 21.3).
"""

from __future__ import annotations

import copy
import itertools
import os
from dataclasses import dataclass, field
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
    """The reference's delayed-scaling fp8 recipe: `to_recipe` gives the
    `ops.fp8.DelayedScalingRecipe` a model's ``fp8_recipe`` takes;
    ``opt_level="O2"`` asks for `ops.fp8.AdamWFp8` (``prepare`` warns when
    the optimizer is another). ``interval`` and ``amax_compute_algo`` are
    the reference's fields and change nothing, as there."""

    margin: int = 0
    interval: int = 16
    fp8_format: str = "HYBRID"
    amax_history_len: int = 1024
    amax_compute_algo: str = "max"
    backend: str = "native"
    opt_level: str = "O1"

    def to_recipe(self):
        from ..ops.fp8 import DelayedScalingRecipe

        return DelayedScalingRecipe(margin=self.margin, amax_history_len=self.amax_history_len,
                                    fp8_format=self.fp8_format, backend=self.backend)


@dataclass
class AutocastKwargs(KwargsHandler):
    """What ``Accelerator.autocast`` does. Mixed precision is a cast of the
    parameters around the forward, not ``torch.autocast``, so the lever is
    ``enabled=False``: prepared-model calls inside the block skip the
    compute-dtype cast and run on the fp32 masters. ``cache_enabled`` is
    accepted and changes nothing."""

    enabled: bool = True
    cache_enabled: bool | None = None


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """How `state.init_distributed` makes the process group: the reference's
    ``timeout_seconds`` (rendezvous and every collective after), and the
    backend (None: NCCL for a CUDA device, gloo for the CPU)."""

    timeout_seconds: int = 1800
    backend: str | None = None


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """The data-parallel knobs, the reference's fields: ``comm_hook`` (one
    of ``parallel.compression.COMM_HOOK_TYPES``) with PowerSGD's
    ``matrix_approximation_rank`` and ``start_powerSGD_iter``, which
    ``make_train_step`` applies to its gradient reduction; ``bucket_cap_mb``
    sizes the flat buckets of the plain all-reduce. ``comm_wrapper`` (``"no"``,
    ``"fp16"`` or ``"bf16"``) carries PowerSGD's P and Q factors in that
    dtype, and ``comm_state_option`` overrides PowerSGD's settings by name
    (``matrix_approximation_rank``, ``start_powerSGD_iter``,
    ``min_compression_elems``), as the reference library's names do.
    ``find_unused_parameters`` and ``static_graph`` change nothing: the
    module is never wrapped in ``DistributedDataParallel``."""

    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    static_graph: bool = False
    comm_hook: str = "no"
    matrix_approximation_rank: int = 1
    start_powerSGD_iter: int = 2
    comm_wrapper: str = "no"
    comm_state_option: dict = field(default_factory=dict)

    def to_comm_hook_config(self):
        """The `parallel.compression.CommHookConfig` this asks for, None for
        ``comm_hook="no"``."""
        from ..parallel.compression import CommHookConfig

        if self.comm_hook == "no":
            return None
        options = {"matrix_approximation_rank": self.matrix_approximation_rank,
                   "start_powerSGD_iter": self.start_powerSGD_iter, **self.comm_state_option}
        return CommHookConfig(comm_hook=self.comm_hook, wrapper=self.comm_wrapper, **options)


def _multi_process(name: str) -> type:
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            f"{name} configures a sharded engine (FSDP, DeepSpeed, Megatron-LM), whose mesh "
            "axes are not ported yet (ROADMAP Queue 1, item 21.3)")

    return type(name, (KwargsHandler,), {"__init__": __init__, "__doc__":
                                         f"The reference's ``{name}``: raises until the "
                                         "sharded axes are ported (item 21.3)."})


FullyShardedDataParallelPlugin = _multi_process("FullyShardedDataParallelPlugin")
DeepSpeedPlugin = _multi_process("DeepSpeedPlugin")
MegatronLMPlugin = _multi_process("MegatronLMPlugin")
