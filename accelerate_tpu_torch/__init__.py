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
reference's by_feature examples (``examples.by_feature``).
Import submodules directly;
this package imports nothing eagerly, so ``import accelerate_tpu_torch`` is
cheap. The quantization names below are also exported here, loaded at first
access.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    "QuantizationConfig": "utils.quantization",
    "QuantizedTensor": "utils.quantization",
    "quantize_params": "utils.quantization",
    "dequantize_params": "utils.quantization",
    "quantize_module": "utils.quantization",
    "dequantize_module": "utils.quantization",
    "quantized_nbytes": "utils.quantization",
    "quantize_model": "utils.quantization",
    "load_and_quantize_model": "utils.quantization",
    "WeightQuantConfig": "serving.engine",
}
__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
