"""The port's schedule-free AdamW (`accelerate_tpu_torch.optimizer.
AdamWScheduleFree`) against optax's ``contrib.schedule_free_adamw``, which
the reference's ``examples/by_feature/schedule_free.py`` trains with, on the
CPU.

Ten steps over seeded gradients of three parameters, with and without
warmup and weight decay: the parameters (optax's y) and the eval point
(``schedule_free_eval_params``) after every step. The optimizer follows
optax's fp32 arithmetic op for op, so they agree bit for bit. Then its state
dict round trip, and a tiny GPT-2 through ``make_train_step`` against the
reference's accelerator with the same optimizer.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")
contrib = pytest.importorskip("optax.contrib")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import lm_loss_fn as jax_lm_loss_fn  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models import gpt2  # noqa: E402
from accelerate_tpu_torch.optimizer import AdamWScheduleFree, schedule_free_eval_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SHAPES = {"w": (7, 5), "b": (5,), "s": ()}
# tiny GPT-2 through both train steps: fp32 gradients summed in other
# orders, then 3 Adam-normalized steps (as tests/test_torch_train.py)
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-4


def _problem(seed):
    r = np.random.default_rng(seed)
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (r.standard_normal(s) * 10.0 ** r.integers(-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(10)]
    return params, grads


class Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("warmup,weight_decay,lr", [(2, 0.01, 0.05), (None, 0.0, 0.0025),
                                                     (5, 0.1, 1.0)])
def test_steps_and_eval_params_match_optax(warmup, weight_decay, lr):
    params, grads = _problem(0)
    tx = contrib.schedule_free_adamw(lr, warmup_steps=warmup, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    module = Params(params)
    opt = AdamWScheduleFree(module.parameters(), lr=lr, warmup_steps=warmup,
                            weight_decay=weight_decay)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(np.array(g[k]))
        opt.step()
        want_eval = contrib.schedule_free_eval_params(state, jp)
        got_eval = schedule_free_eval_params(opt, module)
        for k, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp[k]), err_msg=f"{i} {k}")
            np.testing.assert_array_equal(got_eval[k].numpy(), np.asarray(want_eval[k]),
                                          err_msg=f"eval {i} {k}")
    assert opt.param_groups[0]["step_count"] == int(state.step_count) == 11


def test_eval_params_before_a_step_and_refusals():
    module = Params(_problem(1)[0])
    opt = AdamWScheduleFree(module.parameters())
    got = schedule_free_eval_params(opt, module)
    assert all(torch.equal(got[k], p) for k, p in module.named_parameters())
    with pytest.raises(ValueError, match="AdamWScheduleFree"):
        schedule_free_eval_params(torch.optim.SGD(module.parameters(), lr=1.0), module)
    with pytest.raises(ValueError, match="b1"):
        AdamWScheduleFree(module.parameters(), b1=0.0)


def test_state_dict_round_trip():
    """Five steps, a state dict, five more; a fresh optimizer loaded from it
    takes the same five: the same parameters bit for bit."""
    params, grads = _problem(2)

    def run(module, opt, gs):
        for g in gs:
            for k, p in module.named_parameters():
                p.grad = torch.from_numpy(np.array(g[k]))
            opt.step()

    a = Params(params)
    opt = AdamWScheduleFree(a.parameters(), lr=0.05, warmup_steps=3, weight_decay=0.01)
    run(a, opt, grads[:5])
    saved_params = {k: v.clone() for k, v in a.state_dict().items()}
    saved = copy.deepcopy(opt.state_dict())  # a torch state dict is a live view
    run(a, opt, grads[5:])
    b = Params(params)
    b.load_state_dict(saved_params)
    opt_b = AdamWScheduleFree(b.parameters(), lr=0.05, warmup_steps=3, weight_decay=0.01)
    opt_b.load_state_dict(saved)
    run(b, opt_b, grads[5:])
    for k, p in a.named_parameters():
        assert torch.equal(p, dict(b.named_parameters())[k]), k


def test_tiny_gpt2_train_step_matches_the_reference():
    """Three ``make_train_step`` steps of a tiny fp32 GPT-2 with schedule-free
    AdamW (warmup 2) on both packages: losses and parameters."""
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    batches = [np.random.default_rng(30 + i).integers(0, 256, (4, 32)).astype(np.int32)
               for i in range(3)]
    for state in (AcceleratorState, GradientState, PartialState):
        state._reset_state()
    jacc = JaxAccelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jmod, params), contrib.schedule_free_adamw(1e-2, warmup_steps=2))
    jstep = jacc.make_train_step(jax_lm_loss_fn)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = gpt2.params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32, attention_impl="xla"),
                            device="cpu")
    model.load_state_dict(gpt2.params_from_jax(params))
    acc = Accelerator(device="cpu")
    model, _ = acc.prepare(model, AdamWScheduleFree(model.parameters(), lr=1e-2, warmup_steps=2))
    step = acc.make_train_step(gpt2.lm_loss_fn)
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_ATOL)
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            # the key third's gradient is rounding noise on both sides (the
            # softmax ignores a constant added to every key's logit), which
            # Adam scales up to ~lr a step either way
            e = got.shape[0] // 3
            np.testing.assert_allclose(got[e:2 * e], ref[e:2 * e], atol=2 * 1e-2 * 3, rtol=0)
            got, ref = np.delete(got, np.s_[e:2 * e]), np.delete(ref, np.s_[e:2 * e])
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL, err_msg=name)
