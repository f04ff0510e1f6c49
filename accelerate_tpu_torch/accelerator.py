"""The port of `accelerate_tpu.accelerator` ``Accelerator``: the facade a
training loop calls, one process on each device.

``prepare(*args)`` takes models (``nn.Module``, their parameters the fp32
masters), optimizers, data loaders and schedulers in any order and returns
them in that order: a `PreparedModel`, an `AcceleratedOptimizer`, a
`DataLoaderShard` and an `AcceleratedScheduler`, each bound to this
accelerator's `GradientState`. A loop then runs either

  - the fused step: ``step = make_train_step(loss_fn)``, ``step(batch)``
    per microbatch; or
  - the reference's imperative loop: ``with accumulate(): loss =
    backward(loss_fn, batch)``, ``clip_grad_norm_``, ``optimizer.step()``,
    ``scheduler.step()``, ``optimizer.zero_grad()``.

Both keep the reference's semantics (`accelerate_tpu/accelerator.py`):

  - every microbatch is one `_do_sync`: a boundary every
    ``gradient_accumulation_steps`` microbatches, and at the last batch of a
    prepared loader's epoch (the step count then restarts);
  - the loss runs on compute-dtype copies of the fp32 masters
    (`utils.precision.PrecisionPolicy.cast_to_compute`), through a
    `BoundModel`, and its gradients reach the masters' ``.grad`` in fp32,
    summed over the microbatches and scaled by ``1/k``;
  - under fp16 the loss is scaled inside the backward by the scaler's inner
    factor, the gradients are unscaled at the boundary, and an update whose
    gradients are not finite is skipped (and the scheduler with it);
  - clipping uses one global norm over every gradient, with factor
    ``min(1, max_norm / (norm + 1e-6))``.

The rest of the reference's one-process facade: ``autocast`` (a block
where prepared-model calls skip the compute-dtype cast), ``profile`` (a
``torch.profiler`` trace), ``save``, the ``set_trigger``/``check_trigger``
breakpoint, ``split_between_processes``, ``verify_device_map`` (``prepare``
refuses a model dispatched over several devices) and the kwargs handlers of
`utils.dataclasses`.

Data parallelism over ranks (one process a device, launched by
`commands.launch` or a launcher of `launchers`) keeps the reference's
contract for a step on a ``data = N`` mesh: each rank takes its slice of the
same global batch (`data_loader`), the gradients are averaged over the N
ranks, and the parameters stay identical on every rank. ``prepare``
broadcasts rank 0's parameters; at each boundary the accumulated gradients
are averaged in flat buckets on ``all_reduce``, or through a comm hook
(`parallel.compression`; ``make_train_step(comm_hook=)`` or a
`DistributedDataParallelKwargs`), which reduces every microbatch, as the
reference's does. The module is never wrapped in
``DistributedDataParallel``: the step runs it under ``functional_call`` on
compute-dtype copies, and the reduction is the reference's. A step's loss is
the mean over the ranks. Under fp16 the ranks agree on "finite" before an
update is skipped. With no launcher environment there is no process group
and nothing of this runs.

PyTorch runs eagerly, so there is no compiled step and nothing is donated;
the optimizer updates the masters in place.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import warnings
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from . import checkpointing
from .data_loader import (
    BatchSamplerShard,
    DataLoaderShard,
    IterableDatasetShard,
    prepare_data_loader,
    skip_first_batches,
)
from .optimizer import AcceleratedOptimizer
from .parallel.compression import (
    CommHookConfig,
    init_comm_state,
    matrix_views,
    reduce_gradients,
)
from .parallel.mesh import ParallelismConfig, build_mesh
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState, PartialState
from .tracking import filter_trackers
from .utils import operations
from .utils.intermediates import collecting_intermediates
from .utils.precision import (
    DynamicGradScaler,
    PrecisionPolicy,
    autocast_enabled,
    reset_autocast_enabled,
    set_autocast_enabled,
)


class BoundModel:
    """What ``loss_fn(model, batch)`` receives from the train step (the
    reference's ``BoundModel``): calling it runs the module on ``params``
    through `torch.func.functional_call`, so gradients flow back through
    them. ``params`` is the dict of compute-dtype tensors the call receives
    (buffers included), so a loss that needs a weight itself, as the fused
    cross-entropy needs the tied ``wte.weight``, reads the same copy the
    forward uses, and autograd sums both uses into the fp32 master.

    ``extra_state`` is the reference's mutable collection as the last call
    left it: ``{"intermediates": {name: [values]}}``, what that forward
    sowed (`utils.intermediates`; the MoE router's ``aux_loss`` terms),
    emptied at the start of every call. The values are tensors of the
    step's autograd graph, so a loss that adds
    ``ops.moe.collect_aux_losses(model.extra_state)`` sends gradient to the
    routers."""

    __slots__ = ("module", "params", "extra_state")

    def __init__(self, module: nn.Module, params: dict[str, torch.Tensor]):
        self.module = module
        self.params = params
        self.extra_state: dict[str, Any] = {"intermediates": {}}

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        with collecting_intermediates() as sown:
            out = functional_call(self.module, self.params, args, kwargs)
        self.extra_state = {"intermediates": sown}
        return out


class PreparedModel:
    """What `Accelerator.prepare` returns for a model (the reference's
    ``PreparedModel``). Calling it is the eval forward: the module runs on
    compute-dtype copies of its masters and floating outputs come back in
    fp32 (reference `accelerator.py:169-205`). Every other attribute is the
    module's own (``parameters()``, ``to()``, ``config``, ...), so code
    written for the module keeps working; ``module`` is the module itself.

    A hook attached with `hooks.add_hook_to_module` wraps the call: its
    ``pre_forward`` sees the parameter dict the call would run on (the
    compute-dtype copies, or the masters when no cast applies) and may hand
    back another, and ``post_forward`` sees the output.

    ``extra_state`` holds what the last call sowed, as `BoundModel`'s does,
    so a loss function such as ``mixtral_loss_fn`` adds the same aux terms
    on an eval forward as in the train step."""

    def __init__(self, module: nn.Module, policy: PrecisionPolicy):
        self.module = module
        self.policy = policy
        self._hook = None
        self.extra_state: dict[str, Any] = {"intermediates": {}}

    def compute_params(self) -> dict[str, torch.Tensor]:
        """The module's parameters in the compute dtype, and its buffers."""
        return {**self.policy.cast_to_compute(dict(self.module.named_parameters())),
                **dict(self.module.named_buffers())}

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        with collecting_intermediates() as sown:
            out = self._forward(args, kwargs)
        self.extra_state = {"intermediates": sown}
        return out

    def _forward(self, args: tuple, kwargs: dict) -> Any:
        # inside autocast(AutocastKwargs(enabled=False)) the masters run as they are
        cast = self.policy.mode != "no" and autocast_enabled()
        if self._hook is None:
            if not cast:
                return self.module(*args, **kwargs)
            return operations.convert_to_fp32(
                functional_call(self.module, self.compute_params(), args, kwargs))
        params = self.compute_params() if cast else {**dict(self.module.named_parameters()),
                                                      **dict(self.module.named_buffers())}
        params, args, kwargs = self._hook.pre_forward(self, params, args, kwargs)
        out = functional_call(self.module, params, args, kwargs)
        if cast:
            out = operations.convert_to_fp32(out)
        return self._hook.post_forward(self, out)

    def eval(self) -> "PreparedModel":
        self.module.eval()
        return self

    def train(self, mode: bool = True) -> "PreparedModel":
        self.module.train(mode)
        return self

    def state_dict(self, *args: Any, **kwargs: Any) -> dict[str, torch.Tensor]:
        return self.module.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict: dict[str, Any], strict: bool = True) -> Any:
        return self.module.load_state_dict(state_dict, strict=strict)

    def __getattr__(self, name: str) -> Any:
        module = self.__dict__.get("module")
        if module is None:
            raise AttributeError(name)
        return getattr(module, name)

    def __repr__(self) -> str:
        return f"PreparedModel({self.module.__class__.__name__}, mixed_precision={self.policy.mode!r})"


@dataclass
class ProjectConfiguration:
    """Where checkpoints and logs go (reference `accelerator.py:223`).
    ``automatic_checkpoint_naming`` makes each ``save_state()`` write
    ``checkpoints/checkpoint_<iteration>``, keeping at most ``total_limit``;
    ``async_save`` is ``save_state``'s default."""

    project_dir: str | None = None
    logging_dir: str | None = None
    automatic_checkpoint_naming: bool = False
    total_limit: int | None = None
    iteration: int = 0
    async_save: bool = False

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


@dataclass
class GradientAccumulationPlugin:
    """Reference `accelerator.py:243`."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True


class _RemovableHandle:
    """Removes a registered save or load pre-hook."""

    _ids = itertools.count()

    def __init__(self, registry: dict):
        self._registry = registry
        self.id = next(self._ids)

    def remove(self) -> None:
        self._registry.pop(self.id, None)


class Accelerator:
    """``device=None`` means CUDA (RuntimeError when it is absent; pass
    ``device="cpu"``, or the reference's ``cpu=True``, for the plain path).
    The reference's other keywords keep their meanings:
    ``device_placement=False`` leaves prepared models and batches where they
    are; ``split_batches``, ``even_batches`` and ``dispatch_batches`` reach
    the prepared loaders as the same fields of ``dataloader_config`` do
    (passing both forms is a ValueError); ``rng_types`` reaches every
    prepared `DataLoaderShard`; ``step_scheduler_with_optimizer`` every
    `AcceleratedScheduler`. ``sharding_rules`` and the three engine plugins
    raise NotImplementedError when set (ROADMAP Queue 1, item 21.3); other
    keywords are accepted and unused, as the reference's ``**kwargs``.
    ``mixed_precision`` is ``"no"``,
    ``"bf16"`` or ``"fp16"`` (with a `DynamicGradScaler` at torch
    GradScaler's defaults, or at a `GradScalerKwargs`' settings); ``"fp8"``
    computes in bf16 around the fp8 projections of a model built with an
    fp8 recipe (`ops.fp8`). ``kwargs_handlers`` takes at most one of each of
    `GradScalerKwargs`, `AutocastKwargs`, `ProfileKwargs` and
    `FP8RecipeKwargs`, `InitProcessGroupKwargs` and
    `DistributedDataParallelKwargs` (`utils.dataclasses`);
    ``dataloader_config`` a `DataLoaderConfiguration`. Under a launcher the
    device defaults to ``cuda:LOCAL_RANK`` and the process group is made
    here (`state.init_distributed`); ``parallelism_config`` names the mesh
    (only its ``data`` axis may exceed 1). Unset, ``mixed_precision``,
    ``gradient_accumulation_steps`` and the mesh come from the launcher's
    ``ACCELERATE_TPU_MIXED_PRECISION``, ``ACCELERATE_TPU_GRAD_ACCUM_STEPS``
    and ``ACCELERATE_TPU_PARALLELISM`` when set, as in the reference."""

    def __init__(self, device_placement: bool = True, split_batches: bool = False,
                 mixed_precision: str | None = None, gradient_accumulation_steps: int = 1,
                 gradient_accumulation_plugin: GradientAccumulationPlugin | None = None,
                 cpu: bool = False, parallelism_config: ParallelismConfig | None = None,
                 sharding_rules: Any = None, log_with: Any = None, project_dir: str | None = None,
                 project_config: ProjectConfiguration | None = None, even_batches: bool = True,
                 step_scheduler_with_optimizer: bool = True, rng_types: list[str] | None = None,
                 dispatch_batches: bool | None = None, dataloader_config: Any = None,
                 deepspeed_plugin: Any = None, fsdp_plugin: Any = None,
                 megatron_lm_plugin: Any = None, kwargs_handlers: list[Any] | None = None,
                 device: str | torch.device | None = None, **kwargs: Any):
        import os

        for name, value in (("sharding_rules", sharding_rules), ("deepspeed_plugin", deepspeed_plugin),
                            ("fsdp_plugin", fsdp_plugin), ("megatron_lm_plugin", megatron_lm_plugin)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}: sharded parameters and the engines that shard them are not ported "
                    "to the PyTorch port yet (ROADMAP Queue 1, item 21.3)")
        if dataloader_config is not None:
            if split_batches or not even_batches or dispatch_batches is not None:
                raise ValueError(
                    "Pass dataloader behavior EITHER via dataloader_config= OR via the "
                    "split_batches/even_batches/dispatch_batches kwargs, not both.")
            split_batches = dataloader_config.split_batches
            even_batches = dataloader_config.even_batches
            dispatch_batches = dataloader_config.dispatch_batches
        if cpu:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(f"cpu=True and device={device!r} disagree")
            device = "cpu"
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_TPU_MIXED_PRECISION")
        if gradient_accumulation_steps == 1:
            gradient_accumulation_steps = int(os.environ.get("ACCELERATE_TPU_GRAD_ACCUM_STEPS", 1))
        if parallelism_config is None and os.environ.get("ACCELERATE_TPU_PARALLELISM"):
            dp, fsdp, stage, seq, tp = (int(x) for x in
                                        os.environ["ACCELERATE_TPU_PARALLELISM"].split(","))
            parallelism_config = ParallelismConfig(dp, fsdp, stage, seq, tp)
        self.policy = PrecisionPolicy.from_mode(mixed_precision)
        scaler_config = self._resolve_handlers(kwargs_handlers)
        init = self.init_handler
        self.state = AcceleratorState(self.policy.mode, device,
                                      backend=init.backend if init else None,
                                      timeout=init.timeout_seconds if init else None)
        self.parallelism_config = parallelism_config or ParallelismConfig()
        self.mesh = build_mesh(self.parallelism_config)
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        plugin = gradient_accumulation_plugin or GradientAccumulationPlugin(gradient_accumulation_steps)
        self.gradient_state = GradientState(plugin.num_steps, plugin.adjust_scheduler,
                                            plugin.sync_with_dataloader)
        self.scaler = None
        if self.policy.requires_loss_scaling and scaler_config.pop("enabled", True):
            self.scaler = DynamicGradScaler(**scaler_config)
        self._use_seedable_sampler = self._use_stateful_dataloader = True
        if dataloader_config is not None:
            self._use_seedable_sampler = dataloader_config.use_seedable_sampler
            self._use_stateful_dataloader = dataloader_config.use_stateful_dataloader
        self.device_placement = device_placement
        self.split_batches, self.even_batches = split_batches, even_batches
        self.dispatch_batches = dispatch_batches
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.rng_types = rng_types
        self.flag_tensor: torch.Tensor | None = None
        self.step = 0
        self.trackers: list = []
        self._log_with = log_with
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []
        self._custom_objects: list[Any] = []
        self._save_state_pre_hooks: dict[int, Callable] = {}
        self._load_state_pre_hooks: dict[int, Callable] = {}
        self._pending_saves: list = []
        self._reducers: dict[int, _GradReducer] = {}
        self._join: dict[str, Any] | None = None  # inside join_uneven_inputs

    def _resolve_handlers(self, kwargs_handlers: list[Any] | None) -> dict[str, Any]:
        """Sort the kwargs handlers onto the accelerator (reference
        `accelerator.py:378-470`); returns the scaler's settings."""
        from .utils.dataclasses import (
            AutocastKwargs,
            DataLoaderConfiguration,
            DistributedDataParallelKwargs,
            FP8RecipeKwargs,
            GradScalerKwargs,
            InitProcessGroupKwargs,
            ProfileKwargs,
        )

        self.profile_handler = self.autocast_handler = self.fp8_recipe_handler = None
        self.ddp_handler = self.init_handler = None
        scaler_config: dict[str, Any] = {}
        seen: set[type] = set()
        for handler in kwargs_handlers or []:
            if type(handler) in seen:
                raise ValueError(f"Duplicate kwargs handler of type {type(handler).__name__}.")
            seen.add(type(handler))
            if isinstance(handler, GradScalerKwargs):
                scaler_config = handler.to_dict()
            elif isinstance(handler, ProfileKwargs):
                self.profile_handler = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe_handler = handler
            elif isinstance(handler, DistributedDataParallelKwargs):
                self.ddp_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            elif isinstance(handler, DataLoaderConfiguration):
                raise ValueError("Pass DataLoaderConfiguration as dataloader_config=, not a handler.")
            else:
                raise ValueError(f"Unsupported kwargs handler: {handler!r}")
        return scaler_config

    # ------------------------------------------------------------ topology
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self) -> str:
        """The reference's ``DistributedType``: ``"NO"`` at one process,
        ``"SPMD"`` for processes on one host, ``"MULTI_HOST"`` across hosts."""
        return self.partial_state.distributed_type

    @property
    def num_devices(self) -> int:
        """Devices in the job: one a process."""
        return self.num_processes

    @property
    def use_distributed(self) -> bool:
        return self.partial_state.use_distributed

    @property
    def use_seedable_sampler(self) -> bool:
        return self._use_seedable_sampler

    @property
    def non_blocking(self) -> bool:
        """Prepared loaders copy batches to the device asynchronously."""
        return True

    @property
    def use_stateful_dataloader(self) -> bool:
        """``DataLoaderConfiguration.use_stateful_dataloader``; prepared
        loaders save and resume their position either way."""
        return self._use_stateful_dataloader

    @property
    def save_iteration(self) -> int:
        """The index the next automatic checkpoint takes."""
        return self.project_configuration.iteration

    @property
    def partial_state(self) -> PartialState:
        return self.state.partial

    @property
    def mixed_precision(self) -> str:
        return self.policy.mode

    @property
    def project_dir(self) -> str | None:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> str | None:
        return self.project_configuration.logging_dir

    @property
    def num_processes(self) -> int:
        return self.partial_state.num_processes

    @property
    def process_index(self) -> int:
        return self.partial_state.process_index

    @property
    def local_process_index(self) -> int:
        return self.partial_state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.partial_state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.partial_state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.partial_state.is_last_process

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int) -> None:
        self.gradient_state.num_steps = value

    @property
    def optimizer_step_was_skipped(self) -> bool:
        return any(opt.step_was_skipped for opt in self._optimizers)

    def on_main_process(self, function: Callable) -> Callable:
        return self.partial_state.on_main_process(function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self.partial_state.on_local_main_process(function)

    def on_last_process(self, function: Callable) -> Callable:
        return self.partial_state.on_last_process(function)

    def on_process(self, function: Callable | None = None, process_index: int = 0) -> Callable:
        return self.partial_state.on_process(function, process_index)

    def on_local_process(self, function: Callable | None = None,
                         local_process_index: int = 0) -> Callable:
        return self.partial_state.on_local_process(function, local_process_index)

    def print(self, *args: Any, **kwargs: Any) -> None:
        self.partial_state.print(*args, **kwargs)

    def wait_for_everyone(self) -> None:
        self.partial_state.wait_for_everyone()

    @contextlib.contextmanager
    def main_process_first(self) -> Iterator[None]:
        with self.partial_state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self) -> Iterator[None]:
        with self.partial_state.local_main_process_first():
            yield

    def split_between_processes(self, inputs: Any, apply_padding: bool = False
                                ) -> contextlib.AbstractContextManager:
        """This process's share of ``inputs``, as a context
        (`state.PartialState.split_between_processes`)."""
        return self.partial_state.split_between_processes(inputs, apply_padding=apply_padding)

    # ------------------------------------------------------------- prepare
    def prepare(self, *args: Any) -> Any:
        """Prepare models, optimizers, data loaders and schedulers, in any
        order, returning them in that order (reference
        `accelerator.py:598`). Models first, then optimizers (each over the
        parameters of a prepared model), then schedulers (over the prepared
        optimizers); anything else passes through. A model dispatched over
        several devices (`verify_device_map`) is refused."""
        for obj in args:
            if self.verify_device_map(obj):
                raise ValueError(
                    "You can't train a model that has been loaded with a multi-entry device map "
                    "(big-model inference dispatch); prepare the model on one device instead.")
        result: list[Any] = list(args)
        for i, obj in enumerate(args):
            if isinstance(obj, (nn.Module, PreparedModel)):
                result[i] = self.prepare_model(obj)
            elif isinstance(obj, (DataLoaderShard, torch.utils.data.DataLoader)) or (
                    hasattr(obj, "__iter__") and not isinstance(obj, (str, bytes, dict))):
                result[i] = self.prepare_data_loader(obj)
        for i, obj in enumerate(args):
            if isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                result[i] = self.prepare_optimizer(obj)
        for i, obj in enumerate(args):
            if isinstance(obj, AcceleratedScheduler) or (
                    hasattr(obj, "step") and hasattr(obj, "state_dict") and result[i] is obj
                    and not isinstance(obj, (torch.optim.Optimizer, nn.Module))):
                result[i] = self.prepare_scheduler(obj)
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module | PreparedModel) -> PreparedModel:
        """Register ``model``, whose parameters are the fp32 masters, moved
        to this accelerator's device if they lie elsewhere (the parameters
        stay the same objects, so an optimizer built over them still holds
        them). At several processes every rank then takes rank 0's
        parameters and buffers, so all start equal."""
        if isinstance(model, PreparedModel):
            model = model.module
        if self.device_placement and any(
                t.device != self.device for t in itertools.chain(model.parameters(), model.buffers())):
            model.to(self.device)
        if self.num_processes > 1:
            with torch.no_grad():
                operations.broadcast_(_state_tensors(model), from_process=0)
        prepared = PreparedModel(model, self.policy)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer | AcceleratedOptimizer
                          ) -> AcceleratedOptimizer:
        """Wrap ``optimizer``, built over the parameters of a prepared model
        as PyTorch's idiom has it."""
        if isinstance(optimizer, AcceleratedOptimizer):
            optimizer = optimizer.optimizer
        owned = {id(p) for m in self._models for p in m.module.parameters()}
        for group in optimizer.param_groups:
            if any(id(p) not in owned for p in group["params"]):
                raise ValueError("the optimizer holds tensors that are not parameters of the model")
        if getattr(self.fp8_recipe_handler, "opt_level", "O1") == "O2":
            from .ops.fp8 import AdamWFp8

            if not isinstance(optimizer, AdamWFp8):
                # another optimizer cannot be rewritten into the fp8-state
                # form: say so instead of silently ignoring the recipe
                warnings.warn(
                    "FP8RecipeKwargs(opt_level='O2') is configured, but the "
                    "optimizer passed to prepare() does not carry fp8 state. "
                    "Construct it with accelerate_tpu_torch.ops.fp8.adamw_fp8(..., "
                    "opt_level='O2') to get the low-precision moments.")
        wrapped = AcceleratedOptimizer(optimizer, self.gradient_state, scaler=self.scaler)
        if self.num_processes > 1:
            wrapped.agree_finite = _finite_on_every_rank
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, data_loader: Any) -> DataLoaderShard:
        """A `DataLoaderShard` over ``data_loader`` (a loader of its own, a
        torch DataLoader or any iterable of batches), yielding this
        process's share on this accelerator's device and bound to its
        `GradientState` (`data_loader.prepare_data_loader`, with the
        `DataLoaderConfiguration`'s ``split_batches``, ``even_batches`` and
        ``dispatch_batches``). A `DataLoaderShard` built by the caller over
        global batches is told this process's rank and the world."""
        if not isinstance(data_loader, DataLoaderShard):
            data_loader = prepare_data_loader(
                data_loader, device=self.device, use_seedable_sampler=self.use_seedable_sampler,
                split_batches=self.split_batches, even_batches=self.even_batches,
                dispatch_batches=self.dispatch_batches, device_placement=self.device_placement,
                rng_types=self.rng_types)
        else:
            if data_loader.device is None:
                data_loader.device = self.device
            if data_loader.rng_types is None and self.rng_types is not None:
                data_loader.rng_types = list(self.rng_types)
            sharded = isinstance(data_loader.batch_sampler, BatchSamplerShard) or isinstance(
                data_loader.dataset, IterableDatasetShard)
            if data_loader.num_processes == 1 and not sharded:
                data_loader.num_processes = self.num_processes
                data_loader.process_index = self.process_index
        data_loader.gradient_state = self.gradient_state
        self._dataloaders.append(data_loader)
        return data_loader

    def prepare_scheduler(self, scheduler: Any) -> AcceleratedScheduler:
        """An `AcceleratedScheduler` over ``scheduler`` that steps with this
        accelerator's optimizers."""
        if isinstance(scheduler, AcceleratedScheduler):
            scheduler = scheduler.scheduler
        wrapped = AcceleratedScheduler(scheduler, optimizers=self._optimizers,
                                       step_with_optimizer=self.step_scheduler_with_optimizer,
                                       split_batches=self.split_batches,
                                       gradient_state=self.gradient_state)
        self._schedulers.append(wrapped)
        return wrapped

    def _prepared(self, model: Any) -> PreparedModel:
        if model is None:
            if len(self._models) != 1:
                raise ValueError("pass `model=` when zero or several models are prepared")
            return self._models[0]
        for m in self._models:
            if m is model or m.module is model:
                return m
        raise ValueError("the model was not prepared by this accelerator")

    def _optimizer_for(self, model: PreparedModel) -> AcceleratedOptimizer | None:
        owned = {id(p) for p in model.module.parameters()}
        for opt in self._optimizers:
            if any(id(p) in owned for group in opt.param_groups for p in group["params"]):
                return opt
        return None

    # ------------------------------------------------- gradient machinery
    def _do_sync(self) -> None:
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients(self.step % gs.num_steps == 0)

    @contextlib.contextmanager
    def accumulate(self, *models: Any) -> Iterator[None]:
        """One microbatch (reference `accelerator.py:820`): decides whether it
        closes an accumulation boundary; off one, ``optimizer.step()`` and
        ``zero_grad()`` do nothing."""
        self._do_sync()
        yield

    @contextlib.contextmanager
    def no_sync(self, model: Any = None) -> Iterator[None]:
        """No gradient all-reduce and no optimizer update inside the block:
        backward passes add to this rank's gradients only, and the first
        boundary after it averages what they summed (reference
        `accelerator.py:828`)."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    def trigger_sync_in_backward(self, model: Any = None) -> None:
        """Make the next backward average the gradients over the ranks and the
        next ``optimizer.step()`` apply, though the step count says the window
        is still accumulating (reference `accelerator.py:839`)."""
        self.gradient_state._set_sync_gradients(True)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables: list | None = None,
                           even_batches: bool | None = None) -> Iterator[None]:
        """Train on ranks whose loaders hold different numbers of batches
        (reference `accelerator.py:848`, torch's ``Join``). ``even_batches``
        overrides the prepared loaders' for the block. Inside it every step
        first sums a flag of the ranks still stepping; a rank whose data ran
        out waits at the end of the block and shadows the others'
        collectives with zeros (the gradients are still divided by the whole
        world, as ``DistributedDataParallel``'s join does, and the loss by the
        ranks that stepped), until no rank steps. Then every rank takes the
        parameters of the rank that stepped most, so all leave equal."""
        overridden: list[tuple[Any, bool]] = []
        if even_batches is not None:
            for dl in self._dataloaders:
                if isinstance(dl.batch_sampler, BatchSamplerShard):
                    overridden.append((dl.batch_sampler, dl.batch_sampler.even_batches))
                    dl.batch_sampler.even_batches = even_batches
            if not overridden:
                warnings.warn("join_uneven_inputs(even_batches=...) found no prepared data loader "
                              "sharded by a BatchSamplerShard; the argument has no effect.",
                              stacklevel=3)
        if self.num_processes == 1:
            try:
                yield
            finally:
                for target, prev in overridden:
                    target.even_batches = prev
            return
        self._join = {"steps": 0, "reducers": {}}
        try:
            yield
            while True:  # out of data: shadow the ranks still stepping
                active, reduces, hooked, votes = self._join_flag(0, 0, 0, 0)
                if active == 0:
                    break
                operations.reduce(torch.zeros(1, device=self.device), reduction="sum")
                if reduces:
                    if bool(hooked) not in self._join["reducers"]:
                        raise RuntimeError(
                            "join_uneven_inputs: this rank ran out of data before taking a step "
                            "of the kind the others take, so it cannot shadow their reduction")
                    self._join["reducers"][bool(hooked)].shadow()
                if votes:
                    _finite_on_every_rank(torch.ones((), dtype=torch.bool, device=self.device))
            steps = operations.gather_object([self._join["steps"]])
            source = max(range(len(steps)), key=lambda i: (steps[i], -i))
            with torch.no_grad():
                for model in self._models:
                    operations.broadcast_(_state_tensors(model.module), from_process=source)
        finally:
            self._join = None
            for target, prev in overridden:
                target.even_batches = prev

    def _join_flag(self, *flags: int) -> tuple[int, ...]:
        """The sums over ranks of (stepping, reducing gradients, through a
        hook, voting on fp16 finiteness) for this step, inside
        `join_uneven_inputs`."""
        flag = torch.tensor(flags, dtype=torch.int64, device=self.device)
        total = operations.reduce(flag, reduction="sum")
        return tuple(int(x) for x in total.tolist())

    def _step_collectives(self, reducer: "_GradReducer | None", reduces: bool, hooked: bool,
                          votes: bool) -> int:
        """Open one step's collectives (the loss, the gradients when
        ``reduces``, the fp16 vote when ``votes``, in that order): inside
        `join_uneven_inputs` the flag exchange first. Returns how many ranks
        the loss is averaged over."""
        if self._join is None or reducer is None:
            return self.num_processes
        self._join["steps"] += 1
        self._join["reducers"][hooked] = reducer
        return self._join_flag(1, int(reduces), int(hooked), int(votes))[0]

    def _mean_loss(self, loss: torch.Tensor, ranks: int) -> torch.Tensor:
        """The step's loss averaged over the ``ranks`` that stepped."""
        if self.num_processes == 1:
            return loss
        return operations.reduce(loss, reduction="sum") / ranks

    def _reducer(self, prepared: PreparedModel, hook: CommHookConfig | None = None,
                 q: dict[str, Any] | None = None) -> "_GradReducer | None":
        """The gradient reduction of ``prepared`` over the ranks (None at one
        process); a step with a hook gets its own, with its own state."""
        if self.num_processes == 1:
            return None
        bucket = (self.ddp_handler.bucket_cap_mb if self.ddp_handler is not None else 25) << 20
        if hook is not None:
            return _GradReducer(prepared.module, hook, bucket, q=q)
        key = id(prepared)
        if key not in self._reducers:
            self._reducers[key] = _GradReducer(prepared.module, None, bucket)
        return self._reducers[key]

    def _scales(self, optimizer: AcceleratedOptimizer | None) -> tuple[Any, Any]:
        """(inner, outer): the factor on the loss inside the backward and the
        one on its fp32 gradients after it (reference
        `accelerator.py:940-975`)."""
        inv_k = 1.0 / self.gradient_state.num_steps
        if optimizer is None or optimizer.scaler is None:
            return 1.0, inv_k
        inner, rest = optimizer.scaler.split_scale(optimizer.scaler_state.scale)
        return inner, rest * inv_k

    def backward(self, loss_fn: Callable[[Callable, Any], Any], batch: Any = None,
                 model: Any = None, **kwargs: Any) -> Any:
        """Compute the gradients of ``loss_fn(model, batch)`` (``model`` a
        `BoundModel` over the compute-dtype copies) and add them, times
        ``1/gradient_accumulation_steps`` and the fp16 scale, into the fp32
        masters' ``.grad``. Returns the loss (fp32), or ``(loss, *aux)``
        when ``loss_fn`` returns a tuple: the reference's signature, which
        takes the loss function because JAX has no tape."""
        prepared = self._prepared(model)
        reducer = self._reducer(prepared)
        sync = self.gradient_state.sync_gradients
        opt = self._optimizer_for(prepared)
        ranks = self._step_collectives(reducer, sync, False,
                                       votes=sync and opt is not None and opt.scaler is not None)
        inner, outer = self._scales(opt)
        named = [(n, p) for n, p in prepared.module.named_parameters() if p.requires_grad]
        out = loss_fn(BoundModel(prepared.module, prepared.compute_params()), batch)
        loss, aux = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        loss = loss.float()
        grads = torch.autograd.grad(loss * inner, [p for _, p in named], allow_unused=True)
        with torch.no_grad():
            pairs = [(p, g) for (_, p), g in zip(named, grads) if g is not None]
            if not (isinstance(outer, float) and outer == 1.0):
                torch._foreach_mul_([g for _, g in pairs], outer)
            fresh = [(p, g) for p, g in pairs if p.grad is None]
            for p, g in fresh:
                p.grad = g
            held = [(p, g) for p, g in pairs if p.grad is not g]
            if held:
                torch._foreach_add_([p.grad for p, _ in held], [g for _, g in held])
        loss = self._mean_loss(loss.detach(), ranks)
        if reducer is not None and sync:
            reducer.reduce_into_grads()
        return (loss, *aux) if aux else loss

    def unscale_gradients(self, optimizer: AcceleratedOptimizer | None = None) -> None:
        """Unscale the fp16 gradients now (``optimizer.step()`` does it
        otherwise); once per boundary."""
        for opt in [optimizer] if optimizer is not None else self._optimizers:
            if opt.grads():
                opt.unscale_()

    def clip_grad_norm_(self, parameters: Any = None, max_norm: float = 1.0,
                        norm_type: float = 2.0) -> torch.Tensor | None:
        """Scale every prepared optimizer's gradients by one factor,
        ``min(1, max_norm / (norm + 1e-6))`` of their global norm, after
        unscaling fp16 ones (reference `accelerator.py:997`); returns the
        norm before clipping (a device scalar), None when there are no
        gradients. ``parameters`` is accepted for the reference's signature:
        the norm is always over every prepared optimizer's gradients."""
        if norm_type != 2.0:
            raise NotImplementedError("Only L2 global-norm clipping is supported.")
        self.unscale_gradients()
        grads = [g for opt in self._optimizers for g in opt.grads()]
        if not grads:
            return None
        with torch.no_grad():
            return _clip_by_global_norm_(grads, max_norm)

    def clip_grad_value_(self, parameters: Any = None, clip_value: float = 1.0) -> None:
        self.unscale_gradients()
        with torch.no_grad():
            for opt in self._optimizers:
                for g in opt.grads():
                    g.clamp_(-clip_value, clip_value)

    def make_train_step(self, loss_fn: Callable[[Callable, Any], Any], model: Any = None,
                        optimizer: AcceleratedOptimizer | None = None,
                        max_grad_norm: float | None = None, comm_hook: Any = None,
                        comm_q: dict[str, Any] | None = None) -> Callable[[Any], torch.Tensor]:
        """``step(batch) -> loss``. ``loss_fn(model, batch)`` gets a
        `BoundModel`: it calls ``model`` like the module
        (``model(input_ids)``), and the call runs the module on the
        compute-dtype copies of its parameters, ``model.params``. With
        ``max_grad_norm``, ``step.grad_norm`` holds the last boundary's
        global norm before clipping (a device scalar). Under fp16 the loss
        is scaled by the scaler's inner factor and the boundary divides the
        gradients by it, checks them, and skips a non-finite update (one
        host sync per boundary).

        At several processes the returned loss is the mean over the ranks,
        and the gradients are averaged over them before unscaling, clipping
        and the update: at each boundary in flat buckets, or with
        ``comm_hook`` (a hook name, a `CommHookConfig` or a
        `DistributedDataParallelKwargs`; default the accelerator's
        `DistributedDataParallelKwargs`) through the hook on every microbatch
        (reference `accelerator.py:1025-1150`). PowerSGD runs its first
        ``start_powerSGD_iter`` updates plainly; ``comm_q`` gives its initial
        Q by parameter name (`parallel.compression.init_comm_state`).
        ``step.comm_state`` holds the hook's ``(rep, err)``."""
        prepared = self._prepared(model if model is not None
                                  else (self._models[0] if self._models else None))
        if optimizer is None:
            optimizer = self._optimizer_for(prepared)
        if optimizer is None:
            raise ValueError("make_train_step needs an optimizer prepared over the model's parameters")
        module = prepared.module
        named = dict(module.named_parameters())
        gs = self.gradient_state
        scaler = optimizer.scaler
        hook = _comm_hook_config(comm_hook if comm_hook is not None else self.ddp_handler)
        reducer = self._reducer(prepared)
        hooked_reducer = self._reducer(prepared, hook, q=comm_q) if hook is not None else None
        warmup = hook.warmup_updates if hook is not None else 0
        boundaries = 0

        def step(batch: Any) -> torch.Tensor:
            nonlocal boundaries
            self._do_sync()
            hooked = hooked_reducer is not None and boundaries >= warmup
            ranks = self._step_collectives(hooked_reducer if hooked else reducer,
                                           hooked or gs.sync_gradients, hooked,
                                           votes=gs.sync_gradients and scaler is not None)
            inner = scaler.split_scale(optimizer.scaler_state.scale)[0] if scaler else None
            out = loss_fn(BoundModel(module, prepared.compute_params()), batch)
            loss = (out[0] if isinstance(out, tuple) else out).float()
            scaled = loss if inner is None else loss * inner
            if hooked:  # this microbatch's own gradients, reduced through the hook
                local = torch.autograd.grad(scaled, list(hooked_reducer.named.values()),
                                            allow_unused=True)
            else:
                scaled.backward()
            loss = self._mean_loss(loss.detach(), ranks)
            if hooked:
                hooked_reducer.add_reduced(local)
            if gs.sync_gradients:
                boundaries += 1
                if reducer is not None and not hooked:
                    reducer.reduce_into_grads()
                grads = [p.grad for p in named.values() if p.grad is not None]
                with torch.no_grad():
                    factor = 1.0 / gs.num_steps
                    if inner is not None:
                        torch._foreach_mul_(grads, factor / inner)
                        finite = scaler.all_finite(grads)
                        if reducer is not None:
                            finite = _finite_on_every_rank(finite)
                    elif gs.num_steps != 1:
                        torch._foreach_mul_(grads, factor)
                    if max_grad_norm is not None:
                        step.grad_norm = _clip_by_global_norm_(grads, max_grad_norm)
                if scaler is not None:
                    optimizer.scaler_state = scaler.update_state(optimizer.scaler_state, finite)
                    optimizer.step_was_skipped = not bool(finite)
                optimizer._apply()
                optimizer.optimizer.zero_grad(set_to_none=True)
            if hooked_reducer is not None:
                step.comm_state = (hooked_reducer.rep, hooked_reducer.err)
            return loss

        step.grad_norm = None
        step.comm_state = ((hooked_reducer.rep, hooked_reducer.err)
                           if hooked_reducer is not None else (None, None))
        return step

    # --------------------------------------------------------- collectives
    def gather(self, tensor: Any) -> Any:
        return operations.gather(tensor)

    def gather_for_metrics(self, input_data: Any, use_gather_object: bool = False) -> Any:
        """Gathered eval outputs, the last batch of a ragged epoch cut to
        its real samples (``remainder``; reference `accelerator.py:1398`)."""
        objects = use_gather_object or not _all_tensors(input_data)
        if objects:
            data = operations.gather_object(input_data if isinstance(input_data, list)
                                            else [input_data])
        else:
            data = operations.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            if objects:
                return data[:remainder]
            data = operations.recursively_apply(lambda t: t[:remainder], data, test_type=_is_array)
        return data

    def reduce(self, tensor: Any, reduction: str = "sum", scale: float = 1.0) -> Any:
        return operations.reduce(tensor, reduction=reduction, scale=scale)

    # ------------------------------------------------------------ triggers
    def set_trigger(self) -> None:
        """Raise the breakpoint flag (reference `accelerator.py:1426`): any
        process may, and `check_trigger` on every process sees it."""
        self.flag_tensor = torch.ones(1, dtype=torch.int64, device=self.device)

    def check_trigger(self) -> bool:
        """True once after any process called `set_trigger` (the flag is
        summed over processes, then lowered). One host sync."""
        flag = self.flag_tensor if self.flag_tensor is not None else \
            torch.zeros(1, dtype=torch.int64, device=self.device)
        if int(operations.reduce(flag, reduction="sum")[0]) > 0:
            self.flag_tensor = None
            return True
        return False

    def pad_across_processes(self, tensor: Any, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False) -> Any:
        return operations.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                               pad_first=pad_first)

    def broadcast(self, tensor: Any, from_process: int = 0) -> Any:
        return operations.broadcast(tensor, from_process=from_process)

    # ------------------------------------------------------- checkpointing
    def register_for_checkpointing(self, *objects: Any) -> None:
        """Save and load these objects (each with ``state_dict`` and
        ``load_state_dict``) with the accelerator's state."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"Objects lack state_dict/load_state_dict: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable) -> _RemovableHandle:
        """``hook(models, weights, output_dir)`` runs first in `save_state`;
        ``weights`` is the list of each model's state dict, which it may
        change in place to change what is written."""
        handle = _RemovableHandle(self._save_state_pre_hooks)
        self._save_state_pre_hooks[handle.id] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable) -> _RemovableHandle:
        """``hook(models, input_dir)`` runs first in `load_state`."""
        handle = _RemovableHandle(self._load_state_pre_hooks)
        self._load_state_pre_hooks[handle.id] = hook
        return handle

    def save_state(self, output_dir: str | None = None, async_save: bool | None = None,
                   **save_model_kwargs: Any) -> str:
        """Write every prepared object's state (`checkpointing`); returns the
        directory. ``async_save`` (default ``ProjectConfiguration.async_save``)
        returns once the tensors are in host memory."""
        checkpointing.wait_for_checkpoint_saves(self)
        resolved = str(checkpointing.get_checkpoint_dir(self, output_dir))
        weights = [m.module.state_dict() for m in self._models]
        for hook in self._save_state_pre_hooks.values():
            hook(self._models, weights, resolved)
        if async_save is None:
            async_save = self.project_configuration.async_save
        return checkpointing.save_accelerator_state(self, resolved, weights=weights,
                                                    async_save=async_save)

    def wait_for_checkpoint(self) -> None:
        """Block until every async `save_state` has landed on disk."""
        checkpointing.wait_for_checkpoint_saves(self)

    def load_state(self, input_dir: str | None = None, **load_model_kwargs: Any) -> str:
        """Load every prepared object from ``input_dir``, or from the newest
        complete automatic checkpoint that loads; returns the directory."""
        if self._load_state_pre_hooks:
            resolved = (str(checkpointing.latest_checkpoint_dir(self)) if input_dir is None
                        else str(input_dir))
            for hook in self._load_state_pre_hooks.values():
                hook(self._models, resolved)
        return checkpointing.load_accelerator_state(self, input_dir)

    def unwrap_model(self, model: Any, keep_fp32_wrapper: bool = True) -> nn.Module:
        """The module handed to `prepare`."""
        from .utils.other import extract_model_from_parallel

        return extract_model_from_parallel(model, keep_fp32_wrapper=keep_fp32_wrapper)

    def save(self, obj: Any, f: str, safe_serialization: bool = False) -> None:
        """Write ``obj`` from the main process (`utils.other.save`): a
        tensor tree to safetensors with ``safe_serialization``, anything to
        ``torch.save`` otherwise."""
        from .utils.other import save as _save

        _save(obj, f, safe_serialization=safe_serialization)

    @property
    def fp8_backend(self) -> str | None:
        """``"NATIVE"`` when fp8 training is configured (the port's
        delayed-scaling path, `ops.fp8`), else None."""
        if self.mixed_precision == "fp8" or self.fp8_recipe_handler is not None:
            return "NATIVE"
        return None

    def verify_device_map(self, model: Any) -> bool:
        """True when ``model`` carries a ``device_map`` with more than one
        entry (a big-model dispatch); `prepare` refuses such a model."""
        device_map = getattr(model, "device_map", None)
        return isinstance(device_map, dict) and len(device_map) > 1

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Any = None) -> Iterator[None]:
        """A block under ``autocast_handler`` (default: the `AutocastKwargs`
        of ``kwargs_handlers``). Mixed precision is a cast of the parameters
        around each prepared forward, so enabling is the standing state;
        ``AutocastKwargs(enabled=False)`` makes prepared-model calls inside
        the block run on the fp32 masters (reference
        `accelerator.py:1509-1524`). Train steps keep their policy."""
        handler = autocast_handler or self.autocast_handler
        token = set_autocast_enabled(handler.enabled if handler is not None else True)
        try:
            yield
        finally:
            reset_autocast_enabled(token)

    @contextlib.contextmanager
    def profile(self, profile_handler: Any = None, log_dir: str | None = None) -> Iterator[Any]:
        """A ``torch.profiler`` window (reference `accelerator.py:1527-1545`)
        under ``profile_handler`` (default: the `ProfileKwargs` of
        ``kwargs_handlers``), CUDA kernels included on the card; the Chrome
        trace lands under ``log_dir``, else the handler's
        ``output_trace_dir``, else ``logging_dir``, else
        ``profile_traces``. Yields the torch profiler."""
        from .utils.dataclasses import ProfileKwargs

        handler = profile_handler or self.profile_handler or ProfileKwargs()
        target = (log_dir or handler.output_trace_dir or self.project_configuration.logging_dir
                  or "profile_traces")
        with handler.build(target, self.device) as profiler:
            yield profiler

    def get_state_dict(self, model: Any, unwrap: bool = True) -> dict[str, torch.Tensor]:
        """The model's state dict on the host (fp32 masters)."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.unwrap_model(model).state_dict().items()}

    def save_model(self, model: Any, save_directory: str, max_shard_size: str | int = "10GB",
                   safe_serialization: bool = True) -> list[str]:
        """A consolidated safetensors export, under the reference's parameter
        names when the module has ``reference_state_dict`` (BERT, GPT-2), so
        the reference's ``load_model_weights`` reads it; under the module's
        own names otherwise."""
        module = self.unwrap_model(model)
        if hasattr(module, "reference_state_dict"):
            state = module.reference_state_dict()
        else:
            state = self.get_state_dict(module)
        return checkpointing.save_model_weights(state, save_directory,
                                                max_shard_size=max_shard_size,
                                                safe_serialization=safe_serialization)

    def free_memory(self, *objects: Any) -> tuple:
        """Drop the prepared objects and release cached device memory."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._reducers.clear()
        self.step = 0
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects: Any) -> tuple:
        """`free_memory` (reference `accelerator.py:1577`)."""
        return self.free_memory(*objects)

    # ------------------------------------------------------------ tracking
    def init_trackers(self, project_name: str, config: dict | None = None,
                      init_kwargs: dict | None = None) -> None:
        """Start the trackers ``log_with`` named, logging into
        ``logging_dir``: on the main process only, as every tracker writes
        one run."""
        if not self.is_main_process:
            self.trackers = []
            return
        self.trackers = filter_trackers(self._log_with, self.logging_dir, project_name, config,
                                        init_kwargs or {})

    def log(self, values: dict, step: int | None = None, log_kwargs: dict | None = None) -> None:
        if not self.is_main_process:
            return
        for tracker in self.trackers:
            tracker.log(values, step=step, **(log_kwargs or {}).get(tracker.name, {}))

    def get_tracker(self, name: str, unwrap: bool = False) -> Any:
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"Tracker {name} not initialized (have: {[t.name for t in self.trackers]})")

    def end_training(self) -> None:
        """Finish every tracker and land every async checkpoint."""
        for tracker in self.trackers:
            tracker.finish()
        self.wait_for_checkpoint()
        self.wait_for_everyone()

    def skip_first_batches(self, dataloader: Any, num_batches: int = 0) -> Any:
        return skip_first_batches(dataloader, num_batches)

    def __repr__(self) -> str:
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"grad_accum={self.gradient_state.num_steps}, num_processes={self.num_processes})")


def _comm_hook_config(hook: Any) -> CommHookConfig | None:
    """A hook name, a `CommHookConfig` or a `DistributedDataParallelKwargs`
    as the config it asks for; None for no hook."""
    if hook is None:
        return None
    if hasattr(hook, "to_comm_hook_config"):
        hook = hook.to_comm_hook_config()
    elif isinstance(hook, str):
        hook = CommHookConfig(hook)
    return None if hook is None or hook.comm_hook == "no" else hook


def _finite_on_every_rank(finite: torch.Tensor) -> torch.Tensor:
    """True on every rank iff the gradients are finite on every rank: a
    skipped fp16 update is skipped everywhere."""
    votes = operations.reduce(finite.to(torch.int64).reshape(1), reduction="sum")
    return (votes == _world_size()).reshape(())


def _world_size() -> int:
    from .state import topology

    return topology().num_processes


class _GradReducer:
    """Averages one module's gradients over the ranks
    (`parallel.compression.reduce_gradients`), plainly or through a hook,
    whose state it keeps: ``rep`` and this rank's ``err``."""

    def __init__(self, module: nn.Module, hook: CommHookConfig | None, bucket_bytes: int,
                 q: dict[str, Any] | None = None):
        self.named = {n: p for n, p in module.named_parameters() if p.requires_grad}
        self.cfg = hook or CommHookConfig()
        self.views = matrix_views(module)
        self.bucket_bytes = bucket_bytes
        self.rep, self.err = init_comm_state(self.named, self.cfg, q=q, views=self.views)

    def _reduce(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        out, self.rep, self.err = reduce_gradients(grads, self.rep, self.err, self.cfg,
                                                   views=self.views, bucket_bytes=self.bucket_bytes)
        return out

    def reduce_into_grads(self) -> None:
        """Every parameter's ``.grad`` replaced by its mean over the ranks (a
        parameter without one counts zeros, and gets the mean)."""
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.named.items()}
            for n, g in self._reduce(grads).items():
                self.named[n].grad = g

    def add_reduced(self, local: tuple) -> None:
        """Reduce one microbatch's gradients (``local``, in parameter order)
        through the hook and add them into ``.grad``."""
        with torch.no_grad():
            grads = {n: g if g is not None else torch.zeros_like(p)
                     for (n, p), g in zip(self.named.items(), local)}
            for n, g in self._reduce(grads).items():
                p = self.named[n]
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.add_(g)

    def shadow(self) -> None:
        """The collectives of one reduction, carrying zeros: a rank whose
        data ran out takes part in the others' (`Accelerator.join_uneven_inputs`)."""
        with torch.no_grad():
            zeros = {n: torch.zeros_like(p) for n, p in self.named.items()}
            err = None if self.err is None else {
                n: None if e is None else torch.zeros_like(e) for n, e in self.err.items()}
            reduce_gradients(zeros, self.rep, err, self.cfg, views=self.views,
                             bucket_bytes=self.bucket_bytes)


def _state_tensors(module: nn.Module) -> list[torch.Tensor]:
    """What every rank must hold alike: the parameters and the floating
    buffers (running statistics; masks and tables are built alike)."""
    return [*module.parameters(), *(b for b in module.buffers() if b.is_floating_point())]


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _all_tensors(data: Any) -> bool:
    """Every leaf of ``data`` is a tensor or a numpy array."""
    if isinstance(data, Mapping):
        return all(_all_tensors(v) for v in data.values())
    if isinstance(data, (list, tuple)):
        return all(_all_tensors(v) for v in data)
    return _is_array(data)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor, in
    fp32 (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def _clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-6))`` (the
    reference's ``_clip_tree``); returns the norm before clipping. No host
    sync: the factor stays on the device."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, factor)
    return norm
