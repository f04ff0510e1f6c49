"""The port's Llama decode over the slot cache against the reference's, on the
CPU.

A tiny grouped-query Llama with a sliding window (4 query heads over 2 kv
heads, window 5, fp32), its params from the JAX package carried into the port
by `params_from_jax`: the prefill's and every decode step's logits against
the reference's ``apply(decode=True)``, cached `generate` against the
no-cache argmax rollout (the reference's ``tests/test_llama.py``), greedy
tokens equal to the reference's `generate` with the top-2 margin asserted,
the int8 KV cache tracking the exact one, and the refusal of other
``kv_cache_dtype``s. Then the quantized Llama: every eligible leaf
(projections, ``embed_tokens`` and ``lm_head``) byte-equal to the reference's
``quantize_params``, and its greedy tokens equal to a dense Llama's over the
dequantized copy.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu.utils import quantization as jq  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import make_cache  # noqa: E402
from accelerate_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
    params_from_jax,
)
from accelerate_tpu_torch.utils import quantization as tq  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WINDOW = 5
# fp32 on both sides: the same matmuls, RMSNorm and softmax in other
# summation orders, through 2 layers at hidden 64
LOGIT_ATOL = 1e-5
# a greedy step whose top-2 logit gap is below twice the logit bar could flip
# on the differences above; such a near-tie is reported as one, not as a port
# fault (the tiny Llama's logits are small, normal(0.02) head, so its gaps
# run down to a few 1e-4)
MIN_MARGIN = 2 * LOGIT_ATOL
# int8 KV against the exact cache (the reference's own bar,
# tests/test_llama.py:test_int8_kv_cache_decode_close_to_exact)
INT8_KV_TOL = 0.05


def _jax_model(**cfg):
    return JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, sliding_window=WINDOW,
                                                   attention_impl="xla", **cfg))


@pytest.fixture(scope="module")
def params():
    variables = jax.jit(_jax_model().init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, variables["params"])


def _port(params, **cfg):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, sliding_window=WINDOW, **cfg),
                             device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_and_decode_logits_match_reference(params, int8):
    """A 7-token prefill, then 6 decode steps of forced tokens, past the
    window: each call's logits against the reference's decode branch."""
    kv = dict(kv_cache_dtype=jnp.int8) if int8 else {}
    jmod = _jax_model(**kv)
    model = _port(params, kv_cache_dtype=torch.int8 if int8 else None)
    prompt, forced = _ids(1, (2, 7)), _ids(2, (2, 6))
    weights = jax.tree.map(jnp.asarray, params)
    apply = jax.jit(lambda c, x, off: jmod.apply({"params": weights, "cache": c}, x, decode=True,
                                                 position_offset=off, mutable=["cache"]))
    cache = jmod.init(jax.random.key(0), jnp.zeros((2, 1), jnp.int32), decode=True)["cache"]
    port_cache = make_cache(model, 2, per_slot=False)
    steps = [(prompt, 0)] + [(forced[:, i:i + 1], 7 + i) for i in range(forced.shape[1])]
    with torch.no_grad():
        for x, off in steps:
            want, mutated = apply(cache, jnp.asarray(x), off)
            cache = mutated["cache"]
            got = model(torch.from_numpy(x).long(), off, decode=True, cache=port_cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    assert int(port_cache.index) == 7 + forced.shape[1]
    assert (port_cache.k[0].dtype == torch.int8) == int8


def _nocache_rollout(model, ids, n):
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            out.append(nxt)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("prompt_len", [3, 9])
def test_greedy_generate_matches_reference_and_nocache(params, prompt_len):
    jmod = _jax_model()
    model = _port(params)
    ids = _ids(prompt_len, (2, prompt_len))
    n = 10
    want = np.asarray(jax_generate(jmod, params, jnp.asarray(ids), max_new_tokens=n))
    # every step's reference choice must be clear of a near-tie
    full = np.concatenate([ids, want[:, :-1]], axis=1)
    logits = np.asarray(jmod.apply({"params": params}, jnp.asarray(full)))[:, prompt_len - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN, "near-tie in the reference stream"
    got = generate(model, torch.from_numpy(ids), n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _nocache_rollout(model, torch.from_numpy(ids).long(), n).numpy())


def test_sampled_generate_is_reproducible_and_samples(params):
    model = _port(params)
    ids = torch.from_numpy(_ids(4, (3, 5)))

    def run(seed):
        return generate(model, ids, 8, temperature=0.9, top_k=20,
                        generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b = run(7), run(7)
    assert a.shape == (3, 8) and torch.equal(a, b)
    assert not torch.equal(a, generate(model, ids, 8, device="cpu"))


def test_int8_kv_generation_tracks_exact(params):
    """The int8-cache greedy rollout agrees with the exact one on most
    positions, as the reference's own test asks (int8 error may flip a
    near-tie, not the bulk of decisions)."""
    ids = torch.from_numpy(_ids(0, (2, 6)))
    exact = generate(_port(params), ids, 8, device="cpu")
    quant = generate(_port(params, kv_cache_dtype=torch.int8), ids, 8, device="cpu")
    assert quant.shape == (2, 8)
    assert (exact == quant).float().mean() >= 0.5


def test_int8_kv_prefill_close_to_exact(params):
    ids = torch.from_numpy(_ids(3, (2, 6))).long()
    out = {}
    for int8 in (False, True):
        model = _port(params, kv_cache_dtype=torch.int8 if int8 else None)
        with torch.no_grad():
            out[int8] = model(ids, cache=make_cache(model, 2, per_slot=False))
    torch.testing.assert_close(out[True], out[False], rtol=INT8_KV_TOL, atol=INT8_KV_TOL)


def test_kv_cache_dtype_rejects_unsupported(params):
    jmod = _jax_model(kv_cache_dtype=jnp.float16)
    with pytest.raises(ValueError, match="kv_cache_dtype") as want:
        jmod.init(jax.random.key(0), jnp.zeros((1, 1), jnp.int32), decode=True)
    model = _port(params, kv_cache_dtype=torch.float16)
    with pytest.raises(ValueError, match="kv_cache_dtype") as got:
        generate(model, torch.zeros((1, 2), dtype=torch.long), 2, device="cpu")
    assert str(got.value).split(", got")[0] == str(want.value).split(", got")[0]


def test_generate_refuses_a_prompt_past_the_cache(params):
    with pytest.raises(ValueError, match="exceeds"):
        generate(_port(params), torch.zeros((1, 120), dtype=torch.long), 9, device="cpu")


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_quantized_llama_bytes_and_tokens(params, kind):
    """Every leaf the reference quantizes (ndim >= 2, >= min_weight_size
    elements: the projections and, at this size, ``embed_tokens`` and
    ``lm_head``) is quantized in the port too, byte for byte; the quantized
    model's greedy tokens equal a dense model's over the dequantized copy."""
    jcfg = jq.QuantizationConfig(load_in_4bit=kind == "nf4", load_in_8bit=kind == "int8",
                                 compute_dtype=jnp.float32, min_weight_size=2048)
    ref = jq.quantize_params(params, jcfg)
    ref_q = {jq._flat_path(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]
        if isinstance(leaf, jq.QuantizedTensor)}
    model = _port(params)
    tcfg = tq.QuantizationConfig(load_in_4bit=kind == "nf4", load_in_8bit=kind == "int8",
                                 compute_dtype=torch.float32, min_weight_size=2048)
    qmodel = tq.quantize_module(model, tcfg)
    got = {n: leaf for n, leaf in tq.named_leaves(qmodel) if isinstance(leaf, tq.QuantizedTensor)}

    def port_name(path):
        parts = path.split("/")
        if parts[0].startswith("layer_"):
            return f"layers.{parts[0][6:]}.{parts[1]}.{parts[2]}.weight"
        return parts[0]

    assert {port_name(p) for p in ref_q} == set(got)
    assert {"embed_tokens", "lm_head"} <= set(got)
    for path, leaf in ref_q.items():
        np.testing.assert_array_equal(got[port_name(path)].data.numpy(), np.asarray(leaf.data))
        np.testing.assert_array_equal(got[port_name(path)].scales.numpy(), np.asarray(leaf.scales))
    assert tq.quantized_nbytes(qmodel) == jq.quantized_nbytes(ref)
    dense = tq.dequantize_module(qmodel)
    assert isinstance(dense.embed_tokens, torch.nn.Parameter)
    ids = torch.from_numpy(_ids(6, (2, 5)))
    np.testing.assert_array_equal(generate(qmodel, ids, 8, device="cpu").numpy(),
                                  generate(dense, ids, 8, device="cpu").numpy())
    with torch.no_grad():
        torch.testing.assert_close(qmodel(ids.long()), dense(ids.long()), rtol=0, atol=1e-5)
