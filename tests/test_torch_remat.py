"""The port's rematerialization (`accelerate_tpu_torch.utils.remat`) against
the reference's `accelerate_tpu.utils.remat`, on the CPU, held to the
reference's own cases (tests/test_remat.py).

The policy names and their errors; a tiny GPT-2's loss and gradients under
no remat, ``"full"``, ``"dots"`` and ``"dots_no_batch"`` equal to the
non-remat ones and to the reference's; a tiny Llama's remat forward equal to
the reference's. Then the three places where a recompute could silently
differ from the first forward in PyTorch: an fp8 model's delayed-scaling
state (three steps under remat leave it, the gradients and the parameters
as three steps without), dropout drawn from an explicit generator (the
recompute replays the masks, and the generator advances once), and the
compute-dtype copies of the weights the train step runs on (bf16 steps
under remat equal those without).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from accelerate_tpu.utils.remat import resolve_remat_policy as jax_resolve  # noqa: E402
from accelerate_tpu_torch.models import gpt2, llama  # noqa: E402
from accelerate_tpu_torch.ops import fp8  # noqa: E402
from accelerate_tpu_torch.utils import remat  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32 on both sides, matmuls and LayerNorm summed in other orders (the
# reference's own bar in tests/test_remat.py is rtol 1e-5, atol 1e-6 between
# its remat and non-remat runs)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_ATOL = 1e-5
POLICIES = [None, "full", "dots", "dots_no_batch"]


def test_resolve_named_policies():
    for name in (None, "full", "nothing"):
        assert remat.resolve_remat_policy(name) is None
        assert jax_resolve(name) is None
    for name in ("dots", "dots_no_batch"):
        assert callable(remat.resolve_remat_policy(name)) and callable(jax_resolve(name))

    def custom(ctx, op, *args, **kwargs):
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE

    assert remat.resolve_remat_policy(custom) is custom
    for resolve in (remat.resolve_remat_policy, jax_resolve):
        with pytest.raises(ValueError, match="Unknown remat policy"):
            resolve("bogus")


def test_dots_policies_save_the_products():
    """``"dots"`` saves mm, addmm, bmm and the fp8 product; ``"dots_no_batch"``
    the same without bmm; everything else recomputes."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    dots, no_batch = (remat.resolve_remat_policy(n) for n in ("dots", "dots_no_batch"))
    for op in (aten.mm.default, aten.addmm.default, aten._scaled_mm.default):
        assert dots(None, op) == no_batch(None, op) == CheckpointPolicy.MUST_SAVE
    assert dots(None, aten.bmm.default) == CheckpointPolicy.MUST_SAVE
    assert no_batch(None, aten.bmm.default) == CheckpointPolicy.PREFER_RECOMPUTE
    assert dots(None, aten.gelu.default) == CheckpointPolicy.PREFER_RECOMPUTE


def _ids(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def gpt2_reference():
    """The reference's tiny GPT-2 params and its non-remat loss and
    gradients of ``mean(logits^2)``, the reference test's loss."""
    ids = jnp.asarray(_ids(0))
    module = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = module.init_params(jax.random.key(0), batch=2, seq=16)
    loss, grads = jax.value_and_grad(lambda p: jnp.mean(module.apply({"params": p}, ids) ** 2))(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            gpt2.params_from_jax(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(params, **cfg):
    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32, attention_impl="xla", **cfg),
                            device="cpu")
    model.load_state_dict(gpt2.params_from_jax(params))
    loss = (model(torch.from_numpy(_ids(0)).long()) ** 2).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt2_remat_grad_parity(gpt2_reference, policy):
    params, want_loss, want_grads = gpt2_reference
    base_loss, base = _port_loss_and_grads(params)
    loss, grads = _port_loss_and_grads(params, remat=True, remat_policy=policy)
    assert loss == base_loss
    for name, g in grads.items():
        torch.testing.assert_close(g, base[name], rtol=0, atol=0, msg=name)  # same ops, same order
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    assert abs(loss - want_loss) < LOSS_ATOL


def test_llama_remat_forward_parity():
    params = jax.tree.map(np.asarray, JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(0)))
    ids = _ids(1, s=8)
    want = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, remat=True, remat_policy="dots")).apply(
        {"params": params}, jnp.asarray(ids))
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(dtype=torch.float32, remat=True,
                                                          remat_policy="dots"), device="cpu")
    model.load_state_dict(llama.params_from_jax(params))
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got.pow(2).mean().backward()  # the checkpointed layers take a backward
    assert all(p.grad is not None for p in model.parameters())


def _train(cfg, steps=3, dropout_seed=None):
    """``steps`` AdamW steps of a tiny GPT-2 (seed 3) over seeded batches:
    (losses, the state dict, the generator's final state)."""
    model = gpt2.GPT2LMHead(cfg, device="cpu", seed=3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    gen = None if dropout_seed is None else torch.Generator().manual_seed(dropout_seed)
    losses = []
    for i in range(steps):
        ids = torch.from_numpy(_ids(10 + i)).long()
        logits = model(ids, deterministic=gen is None, generator=gen)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.clone() for k, v in model.state_dict().items()}, gen


@pytest.mark.parametrize("backend", ["native", "qdq"])
@pytest.mark.parametrize("policy", [None, "dots"])
def test_fp8_meta_advances_once_under_remat(backend, policy):
    """Three fp8 steps under remat equal three without, bit for bit: the
    recompute reads the scales its forward used and does not advance the
    state a second time."""
    recipe = fp8.DelayedScalingRecipe(backend=backend)
    base = _train(gpt2.GPT2Config.tiny(dtype=torch.float32, fp8_recipe=recipe))
    got = _train(gpt2.GPT2Config.tiny(dtype=torch.float32, fp8_recipe=recipe, remat=True,
                                      remat_policy=policy))
    assert got[0] == base[0]
    for name, v in base[1].items():
        torch.testing.assert_close(got[1][name], v, rtol=0, atol=0, msg=name)
    hist = base[1]["blocks.0.attn.qkv.input_amax_history"]
    assert (hist > 0).sum() == 3  # one entry per step


def test_recompute_replays_the_forward_scales():
    """Inside a checkpointed block the recompute runs with the flag set and
    reads the saved scales; the state advances once."""
    lin = fp8.Fp8Linear(8, 8, recipe=fp8.DelayedScalingRecipe(), device="cpu")
    seen = []
    x = torch.randn(4, 8, requires_grad=True)

    def block(t):
        frame = remat.current_frame()
        seen.append((frame.recompute, lin.input_scale.item()))
        return lin(t, torch.float32)

    remat.remat_block(block)(x).sum().backward()
    assert [r for r, _ in seen] == [False, True]
    assert seen[0][1] == 1.0 and seen[1][1] != 1.0  # the state moved between them
    assert (lin.input_amax_history > 0).sum() == 1
    assert remat.current_frame() is None


@pytest.mark.parametrize("policy", [None, "dots"])
def test_dropout_under_remat_replays_the_generator(policy):
    """Dropout 0.3 from one generator: three steps under remat give the
    losses, parameters and generator state of three steps without."""
    cfg = dict(dtype=torch.float32, dropout=0.3)
    base = _train(gpt2.GPT2Config.tiny(**cfg), dropout_seed=5)
    got = _train(gpt2.GPT2Config.tiny(remat=True, remat_policy=policy, **cfg), dropout_seed=5)
    assert got[0] == base[0]
    for name, v in base[1].items():
        torch.testing.assert_close(got[1][name], v, rtol=0, atol=0, msg=name)
    assert torch.equal(got[2].get_state(), base[2].get_state())
    plain = _train(gpt2.GPT2Config.tiny(dtype=torch.float32))
    assert plain[0] != base[0]  # dropout was on


@pytest.mark.parametrize("fp8_on", [False, True])
def test_bf16_train_step_under_remat_equals_without(fp8_on):
    """Three bf16 ``make_train_step`` steps (AdamW) under remat equal three
    without, bit for bit: the recompute runs on the compute-dtype copies the
    forward ran on, not on the fp32 masters that `functional_call` has put
    back by the time the backward runs (after one update a bf16 LayerNorm
    scale and its fp32 master differ)."""
    from accelerate_tpu_torch.accelerator import Accelerator

    def run(**cfg):
        recipe = fp8.DelayedScalingRecipe() if fp8_on else None
        model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.bfloat16, fp8_recipe=recipe,
                                                     **cfg), device="cpu", seed=0)
        acc = Accelerator(mixed_precision="fp8" if fp8_on else "bf16", device="cpu")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
        step = acc.make_train_step(gpt2.lm_loss_fn)
        ids = torch.from_numpy(_ids(7, b=4, s=32)).long()
        return [step({"input_ids": ids}).item() for _ in range(3)], model.state_dict()

    (base, want), (got, state) = run(), run(remat=True, remat_policy="dots")
    assert got == base
    for name, v in want.items():
        torch.testing.assert_close(state[name], v, rtol=0, atol=0, msg=name)
