"""The port's Llama training path against the reference's, on the CPU.

`LlamaConfig.tiny(dtype=float32, sliding_window=24, attention_impl="flash")`
params from the JAX package are carried into the port by `params_from_jax`.
On the JAX side ``ACCELERATE_TPU_FLASH_TRIANGLE`` (set with monkeypatch, 16
rows for the gradients, 32 for the cheaper train steps) puts the reference's
band kernels, in Pallas interpret mode, on a band of several cells at seq 64,
some cut by the window; the port runs the band kernels' plain versions.
Logits, `llama_loss_fn`, every parameter's gradient, and the parameters and
losses of three AdamW `make_train_step` steps are compared; then an MHA
variant and a `rope_theta` variant on the plain path, the two refusals and
the CUDA default.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
    llama_loss_fn,
    params_from_jax,
)
from accelerate_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

B, S, WINDOW = 1, 64, 24
# fp32 on both sides; matmuls, RMSNorm and softmax reduce in other orders
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
# after 3 AdamW steps at lr 1e-2, as tests/test_torch_train.py: m / sqrt(v)
# amplifies gradient differences where a gradient is tiny
PARAM_ATOL = 5e-4


def _params(**cfg):
    """Reference params of a tiny Llama. They do not depend on the attention
    route or the init batch's shape, so the init runs the plain path on a
    short batch and stays cheap."""
    jmod = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla", **cfg))
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def params():
    return _params()


def _band_reference(monkeypatch, cell: int):
    """The reference model on the band route with ``cell``-row band cells."""
    monkeypatch.setenv("ACCELERATE_TPU_FLASH_TRIANGLE", str(cell))
    return JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, sliding_window=WINDOW,
                                                   attention_impl="flash"))


def _port_model(params, **cfg):
    model = LlamaForCausalLM(LlamaConfig.tiny(**{"dtype": torch.float32, **cfg}), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def _band_counts():
    return (fa.flash_band_fwd.launches, fa.flash_band_dq.launches, fa.flash_band_dkv.launches)


def test_logits_loss_and_every_gradient_match(params, monkeypatch):
    band_reference = _band_reference(monkeypatch, 16)
    ids = _ids(0)

    def jloss(p):
        logits = band_reference.apply({"params": p}, jnp.asarray(ids))
        return jax_llama_loss_fn(lambda _: logits, {"input_ids": jnp.asarray(ids)}), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    model = _port_model(params, sliding_window=WINDOW, attention_impl="flash")
    batch = {"input_ids": torch.from_numpy(ids).long()}
    before = _band_counts()
    with torch.no_grad():
        logits = model(batch["input_ids"])
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, S, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    loss = llama_loss_fn(model, batch)
    loss.backward()
    assert _band_counts() == before  # the CPU runs the plain versions
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_three_train_steps_match(params, monkeypatch):
    """``prepare`` + ``make_train_step(llama_loss_fn)`` for 3 steps: optax
    ``adamw(1e-2)`` (weight decay 1e-4 by default) against torch
    ``AdamW(lr=1e-2, weight_decay=1e-4)``, with global-norm clipping at 1.0."""
    batches = [_ids(10 + i) for i in range(3)]
    jacc = _jax_accelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((_band_reference(monkeypatch, 32), params), optax.adamw(1e-2))
    jstep = jacc.make_train_step(jax_llama_loss_fn, max_grad_norm=1.0)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params, sliding_window=WINDOW, attention_impl="flash")
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4))
    step = acc.make_train_step(llama_loss_fn, max_grad_norm=1.0)
    losses = [step({"input_ids": torch.from_numpy(b).long()}) for b in batches]

    assert all(t.dtype == torch.float32 and t.ndim == 0 for t in losses)
    np.testing.assert_allclose([t.item() for t in losses], want_losses, atol=LOSS_ATOL, rtol=0)
    assert opt.num_updates == 3
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("cfg", [
    dict(num_kv_heads=4, sliding_window=WINDOW),  # MHA, windowed
    dict(rope_theta=500000.0),  # Llama-3's rope base, no window
], ids=["mha_window", "rope_theta_500k"])
def test_plain_route_variants_match(cfg):
    """The plain (``"xla"``) route against the reference's at the same
    config: logits, loss and every gradient."""
    params = _params(**cfg)
    jmod = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla", **cfg))
    ids = _ids(3, s=48)

    def jloss(p):
        logits = jmod.apply({"params": p}, jnp.asarray(ids))
        return jax_llama_loss_fn(lambda _: logits, {"input_ids": jnp.asarray(ids)}), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = _port_model(params, attention_impl="xla", **cfg)
    loss = llama_loss_fn(model, {"input_ids": torch.from_numpy(ids).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_window_changes_logits_past_the_window(params):
    """A window cuts only where it reaches: logits of the first W positions
    equal the unwindowed model's, later ones differ."""
    ids = torch.from_numpy(_ids(4)).long()
    with torch.no_grad():
        windowed = _port_model(params, sliding_window=WINDOW, attention_impl="flash")(ids)
        full = _port_model(params, attention_impl="flash")(ids)
    torch.testing.assert_close(windowed[:, :WINDOW], full[:, :WINDOW], atol=1e-5, rtol=1e-5)
    assert not torch.allclose(windowed[:, WINDOW:], full[:, WINDOW:], atol=1e-3)


def test_params_from_jax_layout(params):
    sd = params_from_jax(params)
    cfg = LlamaConfig.tiny()
    e, hd = cfg.hidden_size, cfg.head_dim
    assert tuple(sd["embed_tokens"].shape) == tuple(sd["lm_head"].shape) == (cfg.vocab_size, e)
    assert tuple(sd["layers.0.attn.k_proj.weight"].shape) == (cfg.num_kv_heads * hd, e)
    assert tuple(sd["layers.1.mlp.down_proj.weight"].shape) == (e, cfg.intermediate_size)
    np.testing.assert_array_equal(sd["layers.1.mlp.gate_proj.weight"].numpy(),
                                  params["layer_1"]["mlp"]["gate_proj"]["kernel"].T)


def test_decode_is_refused(params):
    """Decode runs over an explicit slot cache (tests/test_torch_llama_decode.py);
    ``decode=True`` without one is refused, naming where the cache comes from."""
    model = _port_model(params)
    with pytest.raises(ValueError, match="make_cache"):
        model(torch.zeros((1, 4), dtype=torch.long), decode=True)


def test_ring_attention_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 21"):
        LlamaForCausalLM(LlamaConfig.tiny(attention_impl="ring"), device="cpu")


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator(mixed_precision="bf16")
