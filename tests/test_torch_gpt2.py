"""The port's GPT-2 against the reference's, on the reference's weights.

`GPT2Config.tiny(dtype=float32)` params from the JAX package are carried into
the port by `params_from_jax`; logits, greedy `generate` and the paged decode
step are compared on the CPU.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.ops.attention import attention as jax_attention  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import make_block_pool, scatter_rows_to_blocks  # noqa: E402
from accelerate_tpu_torch.ops.attention import attention  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32 on both sides: matmuls and LayerNorm reduce in another order (and flax
# computes the variance as E[x^2] - E[x]^2), so logits agree to ~1e-6 at the
# tiny config's scale; 1e-4 is the stated bar
LOGIT_ATOL = 1e-4
# a greedy step whose top-2 logit gap is below this could flip on the
# differences above; such a near-tie is reported as one, not as a port fault
MIN_MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    apply = jax.jit(lambda p, ids, off=0: jmod.apply({"params": p}, ids, position_offset=off))
    return apply, params, model


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_full_sequence_logits_match(models):
    apply, params, model = models
    ids = _ids(0, (2, 24))
    want = np.asarray(apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_per_row_position_offsets_match(models):
    apply, params, model = models
    ids = _ids(1, (3, 5))
    offsets = np.asarray([0, 7, 40], np.int32)
    want = np.asarray(apply(params, jnp.asarray(ids), jnp.asarray(offsets)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(offsets))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("prompt_len", [5, 21])
def test_greedy_generate_matches(models, prompt_len):
    apply, params, model = models
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    ids = _ids(prompt_len, (2, prompt_len))
    n = 12
    want = np.asarray(jax_generate(jmod, params, jnp.asarray(ids), max_new_tokens=n))
    got = generate(model, torch.from_numpy(ids), n, device="cpu").numpy()
    # every step's reference choice must be clear of a near-tie
    full = np.concatenate([ids, want[:, :-1]], axis=1)
    logits = np.asarray(apply(params, jnp.asarray(full)))[:, prompt_len - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN, "near-tie in the reference stream"
    np.testing.assert_array_equal(got, want)


def _decode_logits(model, prompts, attention, steps=4):
    """Prefill ``prompts`` into a paged cache, then ``steps`` greedy decode
    steps with ``attention``; returns the stacked step logits ``[steps, b,
    vocab]`` and the tokens the steps took as input ``[steps, b]``."""
    cfg, bt = model.config, 16
    b, bps = len(prompts), cfg.n_positions // bt
    cache = make_block_pool(cfg.n_layer, b, b * bps, bt, cfg.n_head, cfg.head_dim, cfg.dtype,
                            "cpu", attention=attention)
    # rows own interleaved blocks, so a wrong table lookup reads a neighbour
    tables = torch.arange(b * bps, dtype=torch.int32).reshape(bps, b).T.contiguous()
    tokens = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            kv: list = []
            logits = model(torch.tensor([p]), kv_out=kv)
            scatter_rows_to_blocks(cache, kv, torch.tensor([i]), tables[i:i + 1, : -(-len(p) // bt)],
                                   torch.tensor([len(p)], dtype=torch.int32))
            tokens.append(logits[0, -1].argmax())
        token = torch.stack(tokens)
        pos = torch.tensor([len(p) for p in prompts])
        out, fed = [], []
        for step in range(steps):
            fed.append(token)
            logits = model(token[:, None], pos + step, cache=cache, block_tables=tables)[:, -1]
            out.append(logits)
            token = logits.argmax(-1)
    return torch.stack(out), torch.stack(fed)


def test_fused_and_gather_decode_steps_agree(models):
    _, _, model = models
    prompts = [_ids(s, (n,)).tolist() for s, n in ((1, 3), (2, 17), (3, 40))]
    fused, _ = _decode_logits(model, prompts, "fused")
    gather, _ = _decode_logits(model, prompts, "gather")
    # same fp32 arithmetic on the CPU (the fused call takes the plain version)
    torch.testing.assert_close(fused, gather, atol=1e-6, rtol=0)


def test_decode_steps_match_full_forward(models):
    """The paged decode steps reproduce the reference's full-sequence logits
    at each decoded position."""
    apply, params, model = models
    prompt = _ids(9, (11,)).tolist()
    steps, fed = _decode_logits(model, [prompt], "gather", steps=3)
    seq = np.asarray([prompt + fed[:, 0].tolist()], np.int32)
    want = np.asarray(apply(params, jnp.asarray(seq)))[0, len(prompt):]  # causal: one forward
    np.testing.assert_allclose(steps[:, 0].numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_device_none_means_cuda(monkeypatch, models):
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT2LMHead(GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, torch.zeros((1, 3), dtype=torch.long), 2)


@pytest.mark.parametrize("hq,hk,causal", [(4, 4, True), (4, 2, True), (4, 2, False)])
def test_attention_dispatcher_matches_reference(hq, hk, causal):
    r = np.random.default_rng(hq * 10 + hk + causal)
    q = r.standard_normal((2, 9, hq, 16)).astype(np.float32)
    k = r.standard_normal((2, 9, hk, 16)).astype(np.float32)
    v = r.standard_normal((2, 9, hk, 16)).astype(np.float32)
    mask = None
    if not causal:  # a boolean keep-mask takes the plain path on both sides
        mask = r.random((2, 1, 9, 9)) < 0.7
        mask[..., 0] = True
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                    mask=None if mask is None else jnp.asarray(mask)))
    got = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_flash_route_and_auto_at_long_seq_reach_flash_attention(monkeypatch):
    """``implementation="flash"`` calls `flash_attention`; ``"auto"`` calls
    it for self-attention at seq >= 1024 on a CUDA tensor (the device check
    is stubbed: this runs on the CPU) and takes the plain path otherwise."""
    from accelerate_tpu_torch.ops import attention as attention_mod
    from accelerate_tpu_torch.ops import flash_attention as flash_mod

    calls = []
    real = flash_mod.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention", spy)
    x = torch.zeros(1, 4, 2, 8)
    assert attention(x, x, x, causal=True, implementation="flash").shape == x.shape
    assert calls == [4]
    long = torch.zeros(1, 1024, 1, 8)
    attention(long, long, long, causal=True)  # a CPU tensor: the plain path
    assert calls == [4]
    monkeypatch.setattr(attention_mod, "_on_cuda", lambda t: True)
    attention(long, long, long, causal=True)
    attention(x, x, x, causal=True)  # short: the plain path
    assert calls == [4, 1024]
    # a masked call takes the plain path whatever was asked, as in the reference
    keep = torch.ones(1024, 1024, dtype=torch.bool)
    attention(long, long, long, mask=keep, implementation="flash")
    attention(long, long, long, mask=keep)
    assert calls == [4, 1024]
