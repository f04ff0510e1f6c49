"""The port's GPT-2 training step against the reference's, on the CPU.

`GPT2Config.tiny(dtype=float32, attention_impl="flash")` params from the JAX
package are carried into the port by `params_from_jax`. The reference runs
its flash kernels in Pallas interpret mode; the port runs their plain
versions. Logits, the LM loss, every parameter's gradient, and the
parameters and losses of three steps of `make_train_step` with AdamW are
compared.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import cross_entropy_loss as jax_cross_entropy_loss  # noqa: E402
from accelerate_tpu.models.gpt2 import lm_loss_fn as jax_lm_loss_fn  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config,
    GPT2LMHead,
    cross_entropy_loss,
    lm_loss_fn,
    params_from_jax,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

B, S = 8, 32
# fp32 on both sides; matmuls, LayerNorm and softmax reduce in other orders
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
# after 3 AdamW steps at lr 1e-2: each step moves a parameter by up to
# ~lr, and m / sqrt(v) amplifies gradient differences where a gradient is
# tiny (one element of mlp.up in 16384 moves 1.4e-4 apart at k=2): 5% of a step
PARAM_ATOL = 5e-4


def _param_pairs(model, want, lr, steps):
    """(name, port, reference) for every parameter, with the key third of
    each qkv bias checked apart: adding a constant to every key's logit
    leaves the softmax as it is, so its gradient is zero in exact arithmetic
    and both sides update it from rounding noise, which Adam scales to ~lr
    per step either way."""
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            e = got.shape[0] // 3
            np.testing.assert_allclose(got[e:2 * e], ref[e:2 * e], atol=2 * lr * steps, rtol=0)
            got, ref = np.delete(got, np.s_[e:2 * e]), np.delete(ref, np.s_[e:2 * e])
        yield name, got, ref


def _assert_params_match(model, want, lr, steps):
    for name, got, ref in _param_pairs(model, want, lr, steps):
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def reference():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="flash"))
    # parameter values do not depend on the init batch's shape; a short one
    # keeps the eager (interpret-mode) init cheap
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    return jmod, params


def _port_model(params, **cfg):
    model = GPT2LMHead(GPT2Config.tiny(attention_impl="flash", **{"dtype": torch.float32, **cfg}),
                       device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def test_logits_loss_and_every_gradient_match(reference):
    jmod, params = reference
    ids = _ids(0)

    def jloss(p):
        return jax_lm_loss_fn(lambda x: jmod.apply({"params": p}, x), {"input_ids": jnp.asarray(ids)})

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want_logits = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(ids)))

    model = _port_model(params)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        np.testing.assert_allclose(model(batch["input_ids"]).numpy(), want_logits, atol=LOGIT_ATOL, rtol=0)
    loss = lm_loss_fn(model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("k,max_norm", [(1, 0.5), (2, None)])
def test_three_train_steps_match(reference, k, max_norm):
    """``prepare`` + ``make_train_step(lm_loss_fn)`` for 3 updates (3k
    microbatches): optax ``adamw(1e-2)`` (weight decay 1e-4 by default)
    against torch ``AdamW(lr=1e-2, weight_decay=1e-4)``; at k=1 with
    global-norm clipping at 0.5 (which clips here), and with gradient
    accumulation over k=2 microbatches."""
    jmod, params = reference
    batches = [_ids(10 + i) for i in range(3 * k)]

    jacc = _jax_accelerator(mixed_precision="no", gradient_accumulation_steps=k)
    jmodel, _ = jacc.prepare((jmod, params), optax.adamw(1e-2))
    jstep = jacc.make_train_step(jax_lm_loss_fn, max_grad_norm=max_norm)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params)
    acc = Accelerator(mixed_precision="no", gradient_accumulation_steps=k, device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn, max_grad_norm=max_norm)
    losses = [step({"input_ids": torch.from_numpy(b).long()}) for b in batches]

    assert all(t.dtype == torch.float32 and t.ndim == 0 for t in losses)
    np.testing.assert_allclose([t.item() for t in losses], want_losses, atol=LOSS_ATOL, rtol=0)
    assert opt.num_updates == 3
    if max_norm is not None:
        assert step.grad_norm.item() > max_norm  # the clip engaged
    _assert_params_match(model, want, lr=1e-2, steps=3)


def test_bf16_policy_casts_layernorm_too(reference):
    """Under ``mixed_precision="bf16"`` every floating parameter (LayerNorm
    scale and bias, wte and wpe included) runs as a bf16 copy of its fp32
    master, whose gradient lands in fp32; one bf16 step matches the
    reference's bf16 step within bf16's resolution."""
    jmod, params = reference
    r = np.random.default_rng(5)
    # LayerNorm scales off the bf16 grid (spacing 2^-7 near 1): casting them
    # moves every normalized activation
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + r.uniform(0.001, 0.003, x.shape)).astype(np.float32)
        if "ln" in jax.tree_util.keystr(path) and "scale" in jax.tree_util.keystr(path) else x,
        params)
    ids = _ids(1)

    jbf16 = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.bfloat16, attention_impl="flash"))
    jacc = _jax_accelerator(mixed_precision="bf16")
    jmodel, _ = jacc.prepare((jbf16, params), optax.adamw(1e-2))
    want_loss = float(jacc.make_train_step(jax_lm_loss_fn)({"input_ids": jnp.asarray(ids)}))
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params, dtype=torch.bfloat16)
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    compute = acc.policy.cast_to_compute(dict(model.named_parameters()))
    for name in ("blocks.0.ln_1.weight", "blocks.1.ln_2.bias", "ln_f.weight", "wte.weight",
                 "wpe.weight", "blocks.0.attn.qkv.weight"):
        assert compute[name].dtype == torch.bfloat16, name
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn, max_grad_norm=1e9)
    loss = step({"input_ids": torch.from_numpy(ids).long()})
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the masters stay fp32

    # the loss is computed in bf16 on both sides from the same bf16 weights
    np.testing.assert_allclose(loss.item(), want_loss, atol=2e-2, rtol=0)
    # one AdamW step moves each parameter by ~lr = 1e-2 along sign(grad); the
    # bf16 gradients agree in sign except where they are near zero
    for name, got, ref in _param_pairs(model, want, lr=1e-2, steps=1):
        assert np.mean(np.abs(got - ref) < 1e-3) > 0.95, name


def test_cross_entropy_of_an_all_ignored_batch_is_zero():
    logits = np.random.default_rng(2).standard_normal((2, 5, 7)).astype(np.float32)
    labels = np.full((2, 5), -100, np.int32)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    want = jax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert got.item() == 0.0 == float(want)


def test_accelerator_refusals():
    # fp8 is taken (bf16 compute around a model's fp8 projections); an
    # unknown mode is refused, as by the reference
    assert Accelerator(mixed_precision="fp8", device="cpu").policy.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="Unknown mixed_precision"):
        Accelerator(mixed_precision="fp4", device="cpu")
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    other = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="not parameters of the model"):
        Accelerator(device="cpu").prepare(model, torch.optim.AdamW(other.parameters()))


def test_dropout_draws_from_the_generator():
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, dropout=0.5), device="cpu")
    ids = torch.from_numpy(_ids(3)).long()
    with torch.no_grad():
        plain = model(ids)
        a = model(ids, deterministic=False, generator=torch.Generator().manual_seed(1))
        b = model(ids, deterministic=False, generator=torch.Generator().manual_seed(1))
        c = model(ids, deterministic=False, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, plain)
    with pytest.raises(ValueError, match="Generator"):
        model(ids, deterministic=False)
