"""The port's chunked head + cross-entropy (`models.gpt2.chunked_cross_entropy`,
`lm_loss_fn_fused`, ``bench.py``'s ``BENCH_FUSED_CE=1``) against the
reference's, on the CPU: the loss and both gradients over a ragged row count
with ignored labels, in fp32 and bf16, and three ``make_train_step`` steps of
tiny GPT-2 with the fused loss against the reference's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models import gpt2 as jgpt2  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel  # noqa: E402
from accelerate_tpu_torch.models import gpt2  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32: the same logits summed in another order; bf16 operands are exact in
# fp32 products on both sides, so bf16 holds the same bar on the loss
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6


def _inputs(n, v, e, seed=0):
    r = np.random.default_rng(seed)
    h = r.standard_normal((n, e)).astype(np.float32)
    w = (r.standard_normal((v, e)) * 0.2).astype(np.float32)
    labels = r.integers(0, v, n).astype(np.int32)
    labels[::5] = -100
    return h, w, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [7, 64])
def test_chunked_cross_entropy_matches_reference(dtype, chunk):
    h, w, labels = _inputs(45, 33, 16)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(hh, ww):
        return jgpt2.chunked_cross_entropy(hh.astype(jd), ww.astype(jd), jnp.asarray(labels),
                                           chunk=chunk)

    want, (want_dh, want_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                                          jnp.asarray(w))
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = gpt2.chunked_cross_entropy(ht.to(td), wt.to(td), torch.from_numpy(labels), chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh, np.float32), atol=GRAD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw, np.float32), atol=GRAD_ATOL,
                               rtol=0)
    # every label ignored: 0, not NaN, as the reference
    none = gpt2.chunked_cross_entropy(ht, wt, torch.full((45,), -100), chunk=chunk)
    assert none.item() == 0.0


def test_lm_loss_fn_fused_trains_as_the_reference():
    jmod = jgpt2.GPT2LMHead(jgpt2.GPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    r = np.random.default_rng(3)
    batches = [r.integers(0, 256, (4, 24)).astype(np.int32) for _ in range(3)]
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare((jmod, params), optax.adamw(1e-2))
    jstep = jacc.make_train_step(lambda m, b: jgpt2.lm_loss_fn_fused(m, b, chunk=40))
    want = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]

    module = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32, attention_impl="xla"),
                             device="cpu")
    module.load_state_dict(gpt2.params_from_jax(params))
    acc = Accelerator(device="cpu")
    acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-2, weight_decay=1e-4))
    step = acc.make_train_step(lambda m, b: gpt2.lm_loss_fn_fused(m, b, chunk=40))
    got = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    batch = {"input_ids": torch.from_numpy(batches[0]).long()}
    fused = gpt2.lm_loss_fn_fused(BoundModel(module, dict(module.named_parameters())), batch)
    np.testing.assert_allclose(fused.item(), gpt2.lm_loss_fn(module, batch).item(),
                               atol=LOSS_ATOL, rtol=0)
