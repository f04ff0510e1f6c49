"""The port's Hugging Face name maps against the reference's, on the CPU.

Synthetic Hugging Face state dicts, seeded numpy values under HF's names and
layouts (GPT-2's ``Conv1D`` weights ``[in, out]``, no ``transformer.``
prefix; Llama's ``Linear`` weights ``[out, in]``), go through
`params_from_hf_gpt2` / `params_from_hf_llama` of both packages: the port's
state dict equals the reference's param tree carried through the port's
`params_from_jax`, tensor for tensor, and the tiny models loaded each way
give the same logits.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import params_from_hf_gpt2 as jax_from_hf_gpt2  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from accelerate_tpu.models.llama import params_from_hf_llama as jax_from_hf_llama  # noqa: E402
from accelerate_tpu_torch.models import gpt2, llama  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32 on both sides, the same weights, matmuls summed in other orders
LOGIT_ATOL = 1e-4


def _hf_gpt2(cfg, seed=0):
    r = np.random.default_rng(seed)
    e, f = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd
    sd = {"wte.weight": (cfg.vocab_size, e), "wpe.weight": (cfg.n_positions, e),
          "ln_f.weight": (e,), "ln_f.bias": (e,)}
    for i in range(cfg.n_layer):
        sd.update({f"h.{i}.ln_1.weight": (e,), f"h.{i}.ln_1.bias": (e,),
                   f"h.{i}.ln_2.weight": (e,), f"h.{i}.ln_2.bias": (e,),
                   f"h.{i}.attn.c_attn.weight": (e, 3 * e), f"h.{i}.attn.c_attn.bias": (3 * e,),
                   f"h.{i}.attn.c_proj.weight": (e, e), f"h.{i}.attn.c_proj.bias": (e,),
                   f"h.{i}.mlp.c_fc.weight": (e, f), f"h.{i}.mlp.c_fc.bias": (f,),
                   f"h.{i}.mlp.c_proj.weight": (f, e), f"h.{i}.mlp.c_proj.bias": (e,)})
    return {k: torch.from_numpy((r.standard_normal(s) * 0.05).astype(np.float32)) for k, s in sd.items()}


def _hf_llama(cfg, seed=0):
    r = np.random.default_rng(seed)
    e, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size // cfg.num_heads
    kv = cfg.num_kv_heads * hd
    sd = {"model.embed_tokens.weight": (cfg.vocab_size, e), "model.norm.weight": (e,),
          "lm_head.weight": (cfg.vocab_size, e)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": (e,), p + "post_attention_layernorm.weight": (e,),
                   p + "self_attn.q_proj.weight": (e, e), p + "self_attn.k_proj.weight": (kv, e),
                   p + "self_attn.v_proj.weight": (kv, e), p + "self_attn.o_proj.weight": (e, e),
                   p + "mlp.gate_proj.weight": (f, e), p + "mlp.up_proj.weight": (f, e),
                   p + "mlp.down_proj.weight": (e, f)})
    return {k: torch.from_numpy((r.standard_normal(s) * 0.05 + (1.0 if "norm" in k else 0.0))
                                .astype(np.float32)) for k, s in sd.items()}


CASES = {
    "gpt2": (JaxGPT2Config, JaxGPT2LMHead, jax_from_hf_gpt2, gpt2.GPT2Config, gpt2.GPT2LMHead,
             gpt2.params_from_hf_gpt2, gpt2.params_from_jax, _hf_gpt2),
    "llama": (JaxLlamaConfig, JaxLlama, jax_from_hf_llama, llama.LlamaConfig,
              llama.LlamaForCausalLM, llama.params_from_hf_llama, llama.params_from_jax, _hf_llama),
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_name_map_equals_the_reference_s(family):
    jcfg, _, jmap, tcfg, tcls, tmap, from_jax, make = CASES[family]
    hf = make(tcfg.tiny())
    got = tmap(hf, tcfg.tiny())
    want = from_jax(jax.tree.map(np.asarray, jmap(hf, jcfg.tiny())))
    assert set(got) == set(want) == set(tcls(tcfg.tiny(), device="cpu").state_dict())
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("family", sorted(CASES))
def test_models_loaded_through_the_maps_agree(family):
    jcfg, jcls, jmap, tcfg, tcls, tmap, _, make = CASES[family]
    hf = make(tcfg.tiny(), seed=1)
    ids = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32)
    kw = {"attention_impl": "xla"} if family == "gpt2" else {}
    want = jcls(jcfg.tiny(dtype=jnp.float32, **kw)).apply(
        {"params": jax.tree.map(jnp.asarray, jmap(hf, jcfg.tiny()))}, jnp.asarray(ids))
    model = tcls(tcfg.tiny(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(tmap(hf, tcfg.tiny()))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_a_transposed_square_projection_changes_the_logits():
    """The maps' layout is load-bearing: Llama's square q_proj and o_proj
    load without an error either way round, so a transposed copy must give
    other logits (seeded non-zero values; zeros would hide it)."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    hf = _hf_llama(cfg, seed=3)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 8))).long()
    outs = []
    for flip in (False, True):
        sd = dict(hf)
        if flip:
            for i in range(cfg.num_layers):
                key = f"model.layers.{i}.self_attn.q_proj.weight"
                sd[key] = sd[key].T.contiguous()
        model = llama.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(llama.params_from_hf_llama(sd, cfg))
        with torch.no_grad():
            outs.append(model(ids))
    assert (outs[0] - outs[1]).abs().max() > 1e-3
