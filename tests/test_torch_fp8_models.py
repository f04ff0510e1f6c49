"""A tiny GPT-2 and a tiny Llama built with an fp8 recipe
(`accelerate_tpu_torch.ops.fp8`) against the reference's, on the CPU.

Both packages start from one state, the reference's variables (params and
``fp8_meta``) carried by `params_from_jax`, and take three
``make_train_step`` steps: the losses, every parameter and the scaling state
after them, for the native and the q-dq backends and under
``mixed_precision="fp8"``. Then which projections are fp8, `params_to_jax`
back to the reference's variables, and the refusal of decode over an fp8
model.
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
from accelerate_tpu.models.gpt2 import lm_loss_fn as jax_lm_loss_fn  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from accelerate_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn  # noqa: E402
from accelerate_tpu.ops import fp8 as ref  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models import gpt2, llama  # noqa: E402
from accelerate_tpu_torch.ops import fp8  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# the tiny models' three train steps: both sides quantize the same values,
# but an fp32 activation that differs in its last bit (LayerNorm and matmul
# summation order) lands across an e4m3 rounding boundary now and then, and
# moves that element by one fp8 step (6% of it); measured over these cases:
# loss 2.4e-3, parameters 4.2e-3 after three SGD steps at lr 0.1, scales and
# amax histories 4.6% (a history holds the amax the flip moved)
TRAIN_LOSS_ATOL = 1e-2
TRAIN_PARAM_ATOL = 2e-2
TRAIN_META_RTOL = 0.15


def _rng(seed):
    return np.random.default_rng(seed)


def _fp8_modules(module):
    return [(name, m) for name, m in module.named_modules() if isinstance(m, fp8.Fp8Linear)]


# ------------------------------------------------ tiny models, three steps
def _jax_accelerator(**kwargs):
    for state in (AcceleratorState, GradientState, PartialState):
        state._reset_state()
    return JaxAccelerator(**kwargs)


MODELS = {
    "gpt2": (JaxGPT2Config, JaxGPT2LMHead, jax_lm_loss_fn, gpt2.GPT2Config, gpt2.GPT2LMHead,
             gpt2.lm_loss_fn, gpt2.params_from_jax, "blocks", "block"),
    "llama": (JaxLlamaConfig, JaxLlama, jax_llama_loss_fn, llama.LlamaConfig,
              llama.LlamaForCausalLM, llama.llama_loss_fn, llama.params_from_jax, "layers", "layer"),
}


@pytest.mark.parametrize("family,backend,mixed", [
    ("gpt2", "native", "no"), ("gpt2", "qdq", "no"), ("gpt2", "native", "fp8"),
    ("llama", "native", "no"), ("llama", "qdq", "no")])
def test_tiny_model_train_steps_match(family, backend, mixed):
    """Both packages start from one state, the reference's variables with
    scales from a calibrating forward (fresh scales of 1.0 would round most
    activations to fp8 zeros), and take three SGD steps: the losses, every
    parameter and the scaling state after them. ``mixed="fp8"`` runs the
    bf16 model under ``mixed_precision="fp8"`` on both sides."""
    jcfg, jcls, jloss, tcfg, tcls, tloss, from_jax, layers, prefix = MODELS[family]
    dtype = "bfloat16" if mixed == "fp8" else "float32"
    kw = {"attention_impl": "xla"} if family == "gpt2" else {}
    jmod = jcls(jcfg.tiny(dtype=getattr(jnp, dtype), fp8_recipe=ref.DelayedScalingRecipe(backend=backend), **kw))
    variables = jmod.init_params(jax.random.key(0), batch=1, seq=8)
    calib = jnp.asarray(_rng(9).integers(0, 256, (4, 32)).astype(np.int32))
    _, st = jmod.apply(variables, calib, mutable=["fp8_meta"])
    variables = jax.tree.map(np.asarray, {"params": variables["params"], "fp8_meta": st["fp8_meta"]})
    batches = [_rng(10 + i).integers(0, 256, (4, 32)).astype(np.int32) for i in range(3)]

    jacc = _jax_accelerator(mixed_precision=mixed)
    jmodel, _ = jacc.prepare((jmod, variables), optax.sgd(0.1))
    jstep = jacc.make_train_step(jloss)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = from_jax({"params": jax.tree.map(np.asarray, jmodel.params),
                     "fp8_meta": jax.tree.map(np.asarray, jmodel.extra_state["fp8_meta"])})

    model = tcls(tcfg.tiny(dtype=getattr(torch, dtype),
                           fp8_recipe=fp8.DelayedScalingRecipe(backend=backend), **kw), device="cpu")
    model.load_state_dict(from_jax(variables))
    acc = Accelerator(mixed_precision=mixed, device="cpu")
    model, _ = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = acc.make_train_step(tloss)
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]

    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TRAIN_LOSS_ATOL)
    assert losses[-1] < losses[0] + 0.05  # SGD at lr 0.1 moves a loss of ~5.5 little
    got = model.state_dict()
    assert set(got) == set(want)
    n_meta = 0
    for name, w in want.items():
        g, w = got[name].float().numpy(), w.float().numpy()
        if fp8.is_meta_key(name):
            n_meta += 1
            if name.endswith("amax_history"):
                # one entry per step: calibration and the three steps
                assert (g > 0).sum() == (w > 0).sum() == 4, name
            np.testing.assert_allclose(g, w, rtol=TRAIN_META_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_PARAM_ATOL, err_msg=name)
    assert n_meta == 4 * len(_fp8_modules(model.module)) > 0


def test_only_block_projections_are_fp8():
    r = fp8.DelayedScalingRecipe()
    g = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(fp8_recipe=r), device="cpu")
    assert sorted({n.split(".", 2)[2] for n, _ in _fp8_modules(g)}) == [
        "attn.proj", "attn.qkv", "mlp.down", "mlp.up"]
    m = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(fp8_recipe=r), device="cpu")
    assert sorted({n.split(".", 2)[2] for n, _ in _fp8_modules(m)}) == [
        "attn.k_proj", "attn.o_proj", "attn.q_proj", "attn.v_proj", "mlp.down_proj",
        "mlp.gate_proj", "mlp.up_proj"]
    assert not _fp8_modules(gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(), device="cpu"))


def test_params_to_jax_gives_the_reference_variables():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, fp8_recipe=ref.DelayedScalingRecipe()))
    variables = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(1), batch=1, seq=8))
    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32,
                                                 fp8_recipe=fp8.DelayedScalingRecipe()), device="cpu")
    model.load_state_dict(gpt2.params_from_jax(variables))
    back = gpt2.params_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the export drops the scaling state: the reference's param tree
    assert jax.tree.structure(model.reference_state_dict()) == jax.tree.structure(variables["params"])


def test_decode_over_an_fp8_model_raises():
    r = fp8.DelayedScalingRecipe()
    ids = torch.zeros(1, 4, dtype=torch.long)
    g = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(fp8_recipe=r), device="cpu")
    with pytest.raises(ValueError, match="fp8 model"):
        g(ids, kv_out=[])
    from accelerate_tpu_torch.models.kv_cache import make_cache

    m = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(fp8_recipe=r), device="cpu")
    with pytest.raises(ValueError, match="fp8 model"):
        m(ids, cache=make_cache(m, 1))
    with pytest.raises(ValueError, match="backend"):
        fp8.DelayedScalingRecipe(backend="nativ")
