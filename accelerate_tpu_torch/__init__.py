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
(`ops.fused_ce.fused_cross_entropy`, `models.gpt2.lm_loss_fn_pallas`).
Import submodules directly;
this package imports nothing eagerly, so ``import accelerate_tpu_torch`` is
cheap.
"""

__version__ = "0.1.0"
