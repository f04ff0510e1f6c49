"""The fp16 instances of the port's flash-attention and fused-CE kernels
against the reference's Pallas kernels, on the CPU.

The kernels take fp16 since this slice (dtype code 2 in
``csrc/flash_attention.cu`` and ``csrc/fused_ce.cu``); on a CPU tensor their
wrappers run the plain versions, which round p, dS and dlogits to fp16 where
the kernels do. The reference runs its Pallas kernels in interpret mode, as
its own tests do: rectangular and band flash attention (outputs and the
gradients of ``sum(out * cotangent)``) and the fused head + cross-entropy
(loss, dH, dW). Then a tiny GPT-2 with ``attention_impl="flash"`` and the
fused loss trains under ``mixed_precision="fp16"`` with loss scaling,
against the reference's step.
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
from accelerate_tpu.models.gpt2 import lm_loss_fn_pallas as jax_lm_loss_fn_pallas  # noqa: E402
from accelerate_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from accelerate_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_cross_entropy  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models import gpt2  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as port  # noqa: E402
from accelerate_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BLOCK = 32
# fp16 rounds p and dS (flash) and dlogits (fused CE) to fp16 before the
# products, relative to a running max on the reference's side and the global
# max on the plain one, and each output once more: bf16's bars of the other
# port tests (2e-2 for 8 mantissa bits) scaled to fp16's 11, with room for a
# value near a rounding boundary that rounds the other way
FLASH_ATOL, FLASH_RTOL = 5e-3, 5e-3
CE_LOSS_RTOL = 1e-5
CE_GRAD_ATOL, CE_GRAD_RTOL = 2e-5, 2e-3
LR, STEPS = 1e-2, 3

FLASH_CASES = {
    "causal_d64": dict(causal=True, window=None, s=128, d=64, hq=2, hk=2),
    "full_d40_padded": dict(causal=False, window=None, s=128, d=40, hq=2, hk=2),
    "causal_gqa_4q_2kv": dict(causal=True, window=None, s=96, d=64, hq=4, hk=2),
    "band_w48_gqa_4q_1kv": dict(causal=True, window=48, s=128, d=64, hq=4, hk=1),
    "band_triangle": dict(causal=True, window=None, s=96, d=64, hq=2, hk=2, triangle=True),
}


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_fp16_matches_the_reference(name):
    spec = FLASH_CASES[name]
    r = np.random.default_rng(sorted(FLASH_CASES).index(name))
    q, k, v, ct = (r.standard_normal((2, spec["s"], h, spec["d"])).astype(np.float32)
                   for h in (spec["hq"], spec["hk"], spec["hk"], spec["hq"]))
    band = spec["window"] is not None or spec.get("triangle")
    kw = (dict(window=spec["window"], triangle_block=BLOCK) if band
          else dict(block_q=BLOCK, block_kv=BLOCK))
    fn = jax.jit(lambda a, b, c: jax_flash_attention(a, b, c, causal=spec["causal"], **kw))
    jq, jk, jv, jct = (jnp.asarray(x, dtype=jnp.float16) for x in (q, k, v, ct))
    out, vjp = jax.vjp(fn, jq, jk, jv)
    want = [np.asarray(x, dtype=np.float32) for x in (out, *vjp(jct))]

    tq, tk, tv = (torch.from_numpy(x).half().requires_grad_() for x in (q, k, v))
    before = (port.flash_attention_fwd.launches, port.flash_band_fwd.launches)
    got_out = port.flash_attention(tq, tk, tv, causal=spec["causal"], **kw)
    grads = torch.autograd.grad(got_out, (tq, tk, tv), grad_outputs=torch.from_numpy(ct).half())
    assert (port.flash_attention_fwd.launches, port.flash_band_fwd.launches) == before
    for label, g, w, src in zip(("out", "dq", "dk", "dv"), (got_out, *grads), want, (tq, tq, tk, tv)):
        assert g.dtype == torch.float16 and tuple(g.shape) == w.shape == tuple(src.shape), label
        np.testing.assert_allclose(_np(g), w, atol=FLASH_ATOL, rtol=FLASH_RTOL, err_msg=label)


@pytest.mark.parametrize("n,v,e", [(96, 307, 64), (33, 500, 64), (40, 300, 96)])
def test_fused_ce_fp16_matches_the_reference(n, v, e):
    r = np.random.default_rng(n + v)
    h = r.normal(size=(n, e)).astype(np.float32)
    w = (r.normal(size=(v, e)) * 0.1).astype(np.float32)
    labels = r.integers(0, v, n).astype(np.int32)
    labels[[3, n // 2]] = -100

    def loss(a, b):
        return jax_fused_cross_entropy(a, b, jnp.asarray(labels), block_r=32, block_v=128)

    val, (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(h, jnp.float16),
                                                             jnp.asarray(w, jnp.float16))
    ht, wt = (torch.from_numpy(x).half().requires_grad_() for x in (h, w))
    got = fused_cross_entropy(ht, wt, torch.from_numpy(labels).long())
    got.backward()
    assert got.dtype == torch.float32 and ht.grad.dtype == wt.grad.dtype == torch.float16
    np.testing.assert_allclose(got.item(), float(val), rtol=CE_LOSS_RTOL)
    for label, g, want in (("dh", ht.grad, gh), ("dw", wt.grad, gw)):
        np.testing.assert_allclose(_np(g), np.asarray(want, np.float32), atol=CE_GRAD_ATOL,
                                   rtol=CE_GRAD_RTOL, err_msg=label)


def test_gpt2_flash_fused_loss_trains_under_fp16():
    """Three steps of a tiny GPT-2 (fp16 compute, flash attention, the fused
    loss, AdamW, the dynamic loss scale) on both packages: the losses, and
    the parameters after the steps. Each step moves a parameter by about lr
    along the sign of its gradient; the fp16 gradients agree in sign except
    where they are near zero, and fp16 rounds the two sides' activations
    apart a little more each step, so 95% of each tensor's elements agree
    within a tenth of the three steps' reach and all within twice it."""
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float16, attention_impl="flash"))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    batches = [np.random.default_rng(40 + i).integers(0, 256, (4, 64)).astype(np.int32)
               for i in range(STEPS)]
    for state in (AcceleratorState, GradientState, PartialState):
        state._reset_state()
    jacc = JaxAccelerator(mixed_precision="fp16")
    jmodel, _ = jacc.prepare((jmod, params), optax.adamw(LR))
    jstep = jacc.make_train_step(jax_lm_loss_fn_pallas)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = gpt2.params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float16, attention_impl="flash"),
                            device="cpu")
    model.load_state_dict(gpt2.params_from_jax(params))
    acc = Accelerator(mixed_precision="fp16", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR,
                                                      weight_decay=1e-4))
    step = acc.make_train_step(gpt2.lm_loss_fn_pallas)
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]
    assert opt.num_updates == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-2)
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            # the key third's gradient is rounding noise on both sides (the
            # softmax ignores a constant added to every key's logit)
            e = got.shape[0] // 3
            got, ref = np.delete(got, np.s_[e:2 * e]), np.delete(ref, np.s_[e:2 * e])
        diff = np.abs(got - ref)
        assert (diff < 0.1 * LR * STEPS).mean() > 0.95 and diff.max() <= 2 * LR * STEPS, name
