"""The port's `llama_loss_fn_fused` against the reference's, on the CPU.

A tiny Llama (GQA, untied head) carries the reference's params into the
port (`params_from_jax`). The reference's `llama_loss_fn_fused` runs its
Pallas fused-CE kernels in interpret mode (as it picks them off the TPU);
the port's runs the fused-CE kernels' plain versions on a CPU tensor. Both
take the untied ``lm_head`` from their `BoundModel`'s params. The loss and
every parameter's gradient are compared at fp32, then the parameters and
losses of three AdamW `make_train_step` steps.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.accelerator import BoundModel as JaxBoundModel  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu.models.llama import llama_loss_fn_fused as jax_llama_loss_fn_fused  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel  # noqa: E402
from accelerate_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
    llama_loss_fn,
    llama_loss_fn_fused,
    params_from_jax,
)
from accelerate_tpu_torch.ops import fused_ce  # noqa: E402

B, S = 2, 32
# fp32 on both sides: the same logits summed in another order (the
# reference's own bar for its Pallas loss against the full-logits loss)
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-4
# after 3 AdamW steps at lr 1e-2 (as tests/test_torch_llama.py). Adam's
# first update of a coordinate is about +-0.64 lr whatever the gradient's
# size, so a gradient that is rounding noise moves it a full step in a
# random direction: here an embedding row first seen in the third batch has
# a gradient of 1.7e-6 (terms of 1e-2 that cancel), whose sign the
# reference's own fused and full-logits losses do not agree on. Both sides
# therefore run Adam with eps 1e-4, which leaves gradients of 1e-3 and more
# their full step and moves a noise-level one by about lr * g / eps
ADAM_EPS = 1e-4
PARAM_ATOL = 5e-4


@pytest.fixture(scope="module")
def reference():
    jmod = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla"))
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jmod, jax.tree.map(np.asarray, variables["params"])


def _port_model(params):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, attention_impl="xla"),
                             device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _fused_counts():
    return (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_dh.launches,
            fused_ce.fused_ce_dw.launches)


def test_loss_and_every_gradient_match(reference):
    """Through `BoundModel` on both sides; the port's also against its own
    `llama_loss_fn` (the full fp32 logits)."""
    jmod, params = reference
    ids = _ids(0)

    def jloss(p):
        bound = JaxBoundModel(lambda q, *a, **kw: jmod.apply({"params": q}, *a, **kw), p)
        return jax_llama_loss_fn_fused(bound, {"input_ids": jnp.asarray(ids)}, block_r=32,
                                       block_v=128)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))

    batch = {"input_ids": torch.from_numpy(ids).long()}
    losses, grads = {}, {}
    before = _fused_counts()
    for fn in (llama_loss_fn_fused, llama_loss_fn):
        model = _port_model(params)
        named = dict(model.named_parameters())
        loss = fn(BoundModel(model, named), batch)
        loss.backward()
        losses[fn.__name__] = loss.item()
        grads[fn.__name__] = {name: p.grad.numpy() for name, p in named.items()}
    assert _fused_counts() == before  # the CPU runs the plain versions

    got = grads["llama_loss_fn_fused"]
    np.testing.assert_allclose(losses["llama_loss_fn_fused"], float(want_loss), atol=LOSS_ATOL)
    np.testing.assert_allclose(losses["llama_loss_fn_fused"], losses["llama_loss_fn"],
                               atol=LOSS_ATOL)
    assert sorted(got) == sorted(want) and "lm_head" in got
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(g, grads["llama_loss_fn"][name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_tpu_tiles_are_accepted_and_ignored(reference):
    _, params = reference
    model = _port_model(params)
    bound = BoundModel(model, dict(model.named_parameters()))
    batch = {"input_ids": torch.from_numpy(_ids(1)).long()}
    with torch.no_grad():
        a = llama_loss_fn_fused(bound, batch)
        b = llama_loss_fn_fused(bound, batch, block_r=7, block_v=9)
    assert a.item() == b.item()


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def test_three_train_steps_match(reference):
    """``prepare`` + ``make_train_step(llama_loss_fn_fused)``, 3 steps:
    optax ``adamw(1e-2, eps=ADAM_EPS)`` against torch ``AdamW(lr=1e-2,
    weight_decay=1e-4, eps=ADAM_EPS)``, with global-norm clipping at 1.0."""
    jmod, params = reference
    batches = [_ids(10 + i) for i in range(3)]
    jacc = _jax_accelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jmod, params), optax.adamw(1e-2, eps=ADAM_EPS))
    jstep = jacc.make_train_step(jax_llama_loss_fn_fused, max_grad_norm=1.0)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params)
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                      weight_decay=1e-4, eps=ADAM_EPS))
    step = acc.make_train_step(llama_loss_fn_fused, max_grad_norm=1.0)
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]

    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    assert opt.num_updates == 3
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
