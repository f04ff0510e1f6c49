"""Quantized serving: the port's `ServingEngine` against the reference's.

A tiny GPT-2 at ``n_embd`` 128 (so that every projection has the nf4
kernel's shape: N a multiple of 128), fp32 compute, the reference's weights
carried across. Each reference engine (paged, ``pipeline_depth=1``, as the
port runs) serves the same greedy requests in one quantized mode: nf4
weights, int8 weights, and nf4 weights over an int8 paged KV pool. The port's engine, with the fused and with the gather decode path,
must give the same streams per request and the same `quant_stats()`. The
reference engines decode on the gather path, the reference's own oracle for
its fused path. Each equality is also shown not to rest on a near-tie: both
quantized models run a teacher-forced forward over the reference's streams
(through a fresh decode cache, so an int8 pool's prefill attends over the
dequantized K/V it stores, as in the engines), the reference's logits must
choose every token, and the port's logits must lie within half the
smallest top-2 gap of them, so no greedy choice could flip.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving.engine import WeightQuantConfig as JaxWeightQuantConfig  # noqa: E402
from accelerate_tpu.utils.quantization import QuantizedModule, quantize_params  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.ops.nf4_matmul import nf4_matmul  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    Request,
    SamplingParams,
    ServingEngine,
    WeightQuantConfig,
)

TINY = dict(n_embd=128, n_head=2)
PROMPT_LENS = (5, 23, 40, 9, 16)  # 5 requests over 4 slots: a backfill
N_NEW = 10
ENGINE_KW = dict(max_concurrency=4, prompt_buckets=(64,))
# (weight mode, int8 KV)
MODES = {
    "nf4": ("nf4", False),
    "int8": ("int8", False),
    "nf4_int8_kv": ("nf4", True),
}


@pytest.fixture(scope="module")
def weights():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, **TINY))
    return jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0)))


def _prompts(seed=7):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (n,)).astype(np.int32).tolist() for n in PROMPT_LENS]


def _forced(prompts, streams):
    """Each prompt and its stream but the last token, right-padded into one
    batch (causal attention: the pad changes no earlier logit)."""
    rows = [p + streams[i][:-1] for i, p in enumerate(prompts)]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
    return ids


def _steps(logits, prompts):
    """The logits that chose each generated token: ``[requests, N_NEW, vocab]``."""
    return np.stack([logits[i, len(p) - 1:len(p) - 1 + N_NEW] for i, p in enumerate(prompts)])


@pytest.fixture(scope="module")
def reference(weights):
    """Per mode: the reference engine's greedy streams, its quant_stats, and
    the reference model's teacher-forced logits over those streams."""
    out = {}
    prompts = _prompts()
    for name, (wq, int8_kv) in MODES.items():
        cfg = JaxGPT2Config.tiny(dtype=jnp.float32, kv_cache_dtype=jnp.int8 if int8_kv else None,
                                 **TINY)
        jmod = JaxGPT2LMHead(cfg)
        engine = JaxServingEngine(jmod, weights, paged_kv=True, paged_attention="gather",
                                  pipeline_depth=1, weight_quant=wq, **ENGINE_KW)
        reqs = [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=N_NEW))
                for p in prompts]
        streams = {o.request_id: o.tokens for o in engine.run(reqs)}
        model, params = jmod, weights
        if wq is not None:
            model = QuantizedModule(jmod)
            params = quantize_params(weights, JaxWeightQuantConfig(mode=wq).quantization_config(
                jnp.float32))
        ids = jnp.asarray(_forced(prompts, streams))
        cache = jmod.init(jax.random.key(0), ids[:, :1], decode=True)["cache"]
        logits, _ = jax.jit(lambda p, c, x: model.apply({"params": p, "cache": c}, x, decode=True,
                                                        mutable=["cache"]))(params, cache, ids)
        out[name] = (streams, engine.quant_stats(), _steps(np.asarray(logits), prompts))
    return prompts, out


def _port_engine(weights, name, attention):
    wq, int8_kv = MODES[name]
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32,
                                       kv_cache_dtype=torch.int8 if int8_kv else None, **TINY),
                       device="cpu")
    model.load_state_dict(params_from_jax(weights))
    return ServingEngine(model, device="cpu", paged_kv=True, paged_attention=attention,
                         weight_quant=wq, **ENGINE_KW)


@pytest.mark.parametrize("attention", ["fused", "gather"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_greedy_streams_and_quant_stats_match_reference(weights, reference, name, attention):
    prompts, ref = reference
    want, want_stats, ref_logits = ref[name]
    engine = _port_engine(weights, name, attention)
    reqs = [Request(prompt=list(p), params=SamplingParams(max_new_tokens=N_NEW)) for p in prompts]
    before = nf4_matmul.launches
    got = {o.request_id: o.tokens for o in engine.run(reqs)}
    assert nf4_matmul.launches == before  # on the CPU the kernel's plain version runs
    assert got == want
    assert engine.quant_stats() == want_stats
    # no choice rests on a near-tie: the reference's logits pick each token,
    # and the port's lie within half the smallest top-2 gap of them
    assert (ref_logits.argmax(-1) == np.asarray([want[i] for i in range(len(prompts))])).all()
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    with torch.no_grad():
        port = engine.model(torch.from_numpy(_forced(prompts, want)).long(), kv_out=[]).numpy()
    assert np.abs(_steps(port, prompts) - ref_logits).max() < gap / 2


@pytest.mark.parametrize("name", sorted(MODES))
def test_solo_generate_over_the_quantized_model_matches(weights, reference, name):
    """`generate` over the engine's quantized model (its int8 pool included)
    is the solo oracle of the same streams."""
    prompts, ref = reference
    model = _port_engine(weights, name, "gather").model
    for i in (0, 2):
        got = generate(model, torch.tensor([prompts[i]]), N_NEW, device="cpu")[0].tolist()
        assert got == ref[name][0][i]


def test_int8_pool_geometry_and_sampled_streams_repeat(weights):
    """The int8 pool stores int8 values and fp32 scale planes (the sink block
    included), and seeded sampled streams repeat port against port."""
    engine = _port_engine(weights, "nf4_int8_kv", "fused")
    cache = engine._cache
    assert cache.k[0].dtype == torch.int8 and cache.k_scale[0].dtype == torch.float32
    assert tuple(cache.k_scale[0].shape) == tuple(cache.k[0].shape[:3])
    assert cache.k[0].shape[0] == engine._allocator.num_blocks + 1
    reqs = [Request(prompt=list(p), params=SamplingParams(max_new_tokens=6, temperature=0.9,
                                                          top_k=5, seed=i))
            for i, p in enumerate(_prompts(9))]
    runs = [[o.tokens for o in _port_engine(weights, "nf4_int8_kv", attn).run(
        [Request(prompt=list(r.prompt), params=r.params) for r in reqs])]
        for attn in ("fused", "gather")]
    assert runs[0] == runs[1] and all(len(t) == 6 for t in runs[0])


def test_weight_quant_mode_validation(weights):
    with pytest.raises(ValueError, match="int8.*nf4") as want:
        JaxWeightQuantConfig(mode="fp8")
    with pytest.raises(ValueError, match="int8.*nf4") as got:
        ServingEngine(GPT2LMHead(GPT2Config.tiny(**TINY), device="cpu"), device="cpu",
                      weight_quant="fp8")
    assert str(got.value) == str(want.value)
    engine = _port_engine(weights, "int8", "fused")
    assert engine.weight_quant == WeightQuantConfig(mode="int8")
    assert engine.quant_stats()["weight_bits"] == 8
    assert _port_engine(weights, "nf4_int8_kv", "gather").quant_stats()["kv_bits"] == 8
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingEngine(GPT2LMHead(GPT2Config.tiny(kv_cache_dtype=torch.float16), device="cpu"),
                      device="cpu")
