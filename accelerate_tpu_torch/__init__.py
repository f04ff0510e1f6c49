"""accelerate_tpu_torch: the PyTorch and CUDA port of `accelerate_tpu` for one
NVIDIA H100.

The JAX package `accelerate_tpu` is the reference; this package mirrors its
module paths (``accelerate_tpu_torch/serving/engine.py`` ports
``accelerate_tpu/serving/engine.py``) and never imports it, nor JAX. Every
kernel the reference wrote in Pallas for the TPU becomes a kernel written by
hand for Hopper under ``ops/csrc/``, built by ``nvcc`` at first use.

Ported so far: GPT-2 continuous-batching serving over a paged KV pool, with
decode attention reading the pool in place through a CUDA kernel
(`ops.flash_attention.paged_decode_attention`); and the GPT-2 training step
(`accelerator.Accelerator`: ``prepare``, ``make_train_step``), with flash
attention forward and backward as CUDA kernels
(`ops.flash_attention.flash_attention`), and the tied LM head fused with the
cross-entropy as CUDA forward, dH and dW kernels
(`ops.fused_ce.fused_cross_entropy`, `models.gpt2.lm_loss_fn_pallas`); and
Mistral-class sliding-window training (`models.llama`), with causal and
windowed attention on CUDA band forward, dQ and dK/dV kernels that read
grouped-query K/V unrepeated (`flash_attention(..., window=)`).
And quantized GPT-2 serving (`serving.engine.WeightQuantConfig`,
`utils.quantization`): int8 and nf4 weights, the nf4 projections on a CUDA
dequant-matmul kernel (`ops.nf4_matmul.nf4_matmul`), and int8 paged KV.
And decode over the slot KV cache (`models.kv_cache.SlotKVCache`) for GPT-2
and Llama: `models.generation.generate` for either, the serving engine's
slot-pool mode (its default, as the reference's), and big-model inference:
safetensors checkpoints (`utils.safetensors_io`, `checkpointing`) loaded and
quantized on the card (`utils.quantization.load_and_quantize_model`).
And the serving engine's prefix KV cache (`serving.prefix_cache`,
``prefix_cache=``) and speculative decoding (`serving.speculation`,
``speculation=``), and the Llama loss with its untied head on the fused-CE
kernels (`models.llama.llama_loss_fn_fused`); flash attention runs at
head_dim 64, 128, 192 and 256 and at every multiple of 64 above (the
padding's head_dims). And crash-exact serving: the durable request journal
(`serving.journal`), the engine's snapshot and resume, its in-step health
flag with quarantine, queue deadlines and drain, and `reliability` (fault
injection, retry, SIGTERM preemption). And the reference's training loop at
one process: the `accelerator.Accelerator` facade (``prepare`` of models,
optimizers, loaders and schedulers in any order; ``accumulate``,
``backward``, ``clip_grad_norm_``, ``gather_for_metrics``; fp16 with
`utils.precision.DynamicGradScaler`; ``save_state``/``load_state`` in
`checkpointing`; trackers in `tracking`), `data_loader.DataLoaderShard`,
`scheduler.AcceleratedScheduler`, `models.bert`, and the reference's
headline example, ``python -m accelerate_tpu_torch.examples.nlp_example``.
And image classification (`models.resnet`, ``examples.cv_example``,
``examples.complete_cv_example``), the rest of the one-process facade
(``autocast``, ``profile``, ``save``, the triggers, the kwargs handlers of
`utils.dataclasses`, `memory`, `logging`, `utils.other`) and the
reference's by_feature examples (``examples.by_feature``). And precision on
one card: fp8 projections with delayed scaling (`ops.fp8`, the fp8 GEMM
through ``torch._scaled_mm``) and their O2 AdamW, rematerialization
(`utils.remat`), fp16 instances of the flash and fused-CE kernels,
schedule-free AdamW (`optimizer.AdamWScheduleFree`) and the Hugging Face
name maps (`models.gpt2.params_from_hf_gpt2`,
`models.llama.params_from_hf_llama`).
And big models on one card (`big_modeling`: device maps, CPU and disk
offload streaming, `hooks`) with Mixtral-8x7B and its MoE layer
(`models.mixtral`, `ops.moe`); T5 (`models.t5`) on the fused-CE kernels and
ViT (`models.vit`) with the one-process inference examples
(``examples.inference``); data parallelism across processes over
``torch.distributed`` (`state`, the collectives of `utils.operations`,
rank-sharded loaders, gradient all-reduce with the comm hooks of
`parallel.compression`, `local_sgd`, `launchers` and
``python -m accelerate_tpu_torch.commands.launch``).
And the rest of the one-machine surface: every name of the reference's
package root that has a port is exported here (`__all__`), the
``Accelerator``'s remaining keywords (``cpu``, ``device_placement``,
``split_batches``, ``even_batches``, ``dispatch_batches``, ``rng_types``,
``step_scheduler_with_optimizer``) and ``clear``, the serving example
(``python -m accelerate_tpu_torch.examples.serving_gpt2``), the config
templates (``examples/config_yaml_templates/run_me.py``) and the commands
``env``, ``estimate-memory`` and ``test`` beside ``config``,
``config-update`` and ``launch`` (``python -m
accelerate_tpu_torch.commands.cli``).

The root imports nothing eagerly, so ``import accelerate_tpu_torch`` is
cheap: each name is loaded from its module at first access. The nine names
of `DEFERRED_ROOT_NAMES` belong to modules that shard parameters or span
devices, which are not ported yet; each cites the ROADMAP item it waits for.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    # accelerator
    "Accelerator": "accelerator", "BoundModel": "accelerator",
    "GradientAccumulationPlugin": "accelerator", "PreparedModel": "accelerator",
    "ProjectConfiguration": "accelerator",
    # data_loader
    "BatchSamplerShard": "data_loader", "DataLoaderDispatcher": "data_loader",
    "DataLoaderShard": "data_loader", "IterableDatasetShard": "data_loader",
    "SeedableRandomSampler": "data_loader", "SkipBatchSampler": "data_loader",
    "get_sampler": "data_loader", "prepare_data_loader": "data_loader",
    "skip_first_batches": "data_loader",
    # launchers, logging, memory, optimizer, scheduler
    "debug_launcher": "launchers", "notebook_launcher": "launchers",
    "get_logger": "logging",
    "find_executable_batch_size": "memory", "release_memory": "memory",
    "AcceleratedOptimizer": "optimizer",
    "AcceleratedScheduler": "scheduler", "OptaxSchedule": "scheduler",
    # parallel
    "ParallelismConfig": "parallel.mesh", "build_mesh": "parallel.mesh",
    "CommHookConfig": "parallel.compression", "DDPCommunicationHookType": "parallel.compression",
    # reliability
    "FaultInjector": "reliability", "FaultSpec": "reliability",
    "PreemptionHandler": "reliability", "RetryError": "reliability",
    "RetryPolicy": "reliability", "install_preemption_handler": "reliability",
    # serving
    "FIFOScheduler": "serving", "Request": "serving", "RequestOutput": "serving",
    "SamplingParams": "serving", "ServingEngine": "serving", "ServingMetrics": "serving",
    # state
    "AcceleratorState": "state", "DistributedType": "state", "GradientState": "state",
    "PartialState": "state",
    # utils.operations
    "broadcast": "utils.operations", "broadcast_object_list": "utils.operations",
    "concatenate": "utils.operations", "gather": "utils.operations",
    "gather_object": "utils.operations", "pad_across_processes": "utils.operations",
    "reduce": "utils.operations", "send_to_device": "utils.operations",
    "ConvertOutputsToFp32": "utils.operations", "convert_outputs_to_fp32": "utils.operations",
    # precision, fp8 and quantization
    "DelayedScalingRecipe": "ops.fp8", "adamw_fp8": "ops.fp8",
    "DynamicGradScaler": "utils.precision", "PrecisionPolicy": "utils.precision",
    "QuantizationConfig": "utils.quantization", "QuantizedTensor": "utils.quantization",
    "dequantize_params": "utils.quantization", "load_and_quantize_model": "utils.quantization",
    "quantize_model": "utils.quantization", "quantize_params": "utils.quantization",
    # big_modeling
    "BlockwiseModel": "big_modeling", "cpu_offload": "big_modeling",
    "cpu_offload_with_hook": "big_modeling", "disk_offload": "big_modeling",
    "dispatch_model": "big_modeling", "infer_auto_device_map": "big_modeling",
    "init_empty_weights": "big_modeling", "init_on_device": "big_modeling",
    "load_checkpoint_and_dispatch": "big_modeling",
    # utils
    "is_rich_available": "utils.imports",
    "AutocastKwargs": "utils.dataclasses", "DataLoaderConfiguration": "utils.dataclasses",
    "DeepSpeedPlugin": "utils.dataclasses", "DistributedDataParallelKwargs": "utils.dataclasses",
    "FP8RecipeKwargs": "utils.dataclasses", "FullyShardedDataParallelPlugin": "utils.dataclasses",
    "GradScalerKwargs": "utils.dataclasses", "InitProcessGroupKwargs": "utils.dataclasses",
    "MegatronLMPlugin": "utils.dataclasses", "ProfileKwargs": "utils.dataclasses",
    "convert_bytes": "utils.other", "extract_model_from_parallel": "utils.other",
    "get_pretty_name": "utils.other", "load": "utils.other", "save": "utils.other",
    "write_basic_config": "commands.config",
    "set_seed": "utils.random", "synchronize_rng_states": "utils.random",
    "load_checkpoint_in_model": "utils.safetensors_io",
    "load_safetensors_checkpoint": "utils.safetensors_io",
    "save_safetensors_checkpoint": "utils.safetensors_io",
}
# names exported under another name in the port: the reference's Fp8Dense is
# the port's Fp8Linear
_RENAMED = {"Fp8Dense": ("ops.fp8", "Fp8Linear")}
# the port's own names that its root resolved before it had the reference's:
# still resolved, not in __all__, which holds the reference's names only
_PORT_ONLY = {"WeightQuantConfig": "serving.engine", "quantize_module": "utils.quantization",
              "dequantize_module": "utils.quantization", "quantized_nbytes": "utils.quantization"}
# names of the reference's root whose modules are not ported yet, each with
# the ROADMAP item it waits for
DEFERRED_ROOT_NAMES = (
    ("prepare_pippy", "ROADMAP Queue 1, item 21.3: pipeline-parallel inference"),
    ("pipeline_apply", "ROADMAP Queue 1, item 21.3: pipeline stages over a mesh"),
    ("stack_stage_params", "ROADMAP Queue 1, item 21.3: pipeline stages over a mesh"),
    ("ring_attention", "ROADMAP Queue 1, item 21.3: sequence-sharded ring attention"),
    ("ring_attention_sharded", "ROADMAP Queue 1, item 21.3: sequence-sharded ring attention"),
    ("ShardingRules", "ROADMAP Queue 1, item 21.3: sharded parameter axes"),
    ("infer_param_shardings", "ROADMAP Queue 1, item 21.3: sharded parameter axes"),
    ("DummyOptim", "ROADMAP Queue 1, item 21.3: the DeepSpeed engine's placeholders"),
    ("DummyScheduler", "ROADMAP Queue 1, item 21.3: the DeepSpeed engine's placeholders"),
)


def _rich_available() -> bool:
    from .utils.imports import is_rich_available

    return is_rich_available()


__all__ = sorted([*_LAZY, *_RENAMED, *(["rich"] if _rich_available() else [])])


def __getattr__(name: str):
    if name in _LAZY or name in _PORT_ONLY:
        module = _LAZY.get(name) or _PORT_ONLY[name]
        return getattr(importlib.import_module(f".{module}", __name__), name)
    if name in _RENAMED:
        module, attr = _RENAMED[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    if name == "rich" and _rich_available():
        return importlib.import_module(".utils.rich", __name__)
    deferred = dict(DEFERRED_ROOT_NAMES)
    if name in deferred:
        raise AttributeError(f"{name} is not ported to accelerate_tpu_torch yet ({deferred[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
