"""The port's `generate` over the slot cache against the reference's, on GPT-2.

The reference's ``tests/test_generation.py`` holds its cached generation to
the no-cache argmax rollout and its int8-cache rollout to the exact one; the
port's is held to both of those and to the reference's own tokens, on the
reference's weights (`GPT2Config.tiny(dtype=float32)` through
`params_from_jax`), with the top-2 margin of every reference step asserted.
Sampled generation is checked port against port: ``jax.random`` and
`torch.Generator` draw different numbers from one seed.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import make_cache  # noqa: E402

# fp32 on both sides, the same arithmetic in other summation orders
LOGIT_ATOL = 1e-4
# a reference step whose top-2 gap is below this could flip on such
# differences: reported as a near-tie, not as a port fault
MIN_MARGIN = 1e-3


@pytest.fixture(scope="module")
def weights():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    return jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0)))


def _models(weights, int8=False):
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32,
                                            kv_cache_dtype=jnp.int8 if int8 else None))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32,
                                       kv_cache_dtype=torch.int8 if int8 else None), device="cpu")
    model.load_state_dict(params_from_jax(weights))
    return jmod, model


def _prompt(seed, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _nocache(model, ids, n):
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            out.append(nxt)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1)


def test_cached_generation_matches_nocache_and_reference(weights):
    jmod, model = _models(weights)
    ids = _prompt(0)
    want = np.asarray(jax_generate(jmod, weights, jnp.asarray(ids), max_new_tokens=12))
    full = np.concatenate([ids, want[:, :-1]], axis=1)
    logits = np.asarray(jmod.apply({"params": weights}, jnp.asarray(full)))[:, ids.shape[1] - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN, "near-tie in the reference stream"
    got = generate(model, torch.from_numpy(ids), 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _nocache(model, torch.from_numpy(ids).long(), 12))


def test_int8_cache_generation_tracks_exact_and_reference(weights):
    """The int8 cache's rollout agrees with the exact one on most positions
    (the reference's bar), and its tokens are the reference's int8 ones."""
    ids = _prompt(1)
    exact = generate(_models(weights)[1], torch.from_numpy(ids), 8, device="cpu")
    jmod, model = _models(weights, int8=True)
    quant = generate(model, torch.from_numpy(ids), 8, device="cpu")
    assert (exact == quant).float().mean() >= 0.5
    want = np.asarray(jax_generate(jmod, weights, jnp.asarray(ids), max_new_tokens=8))
    np.testing.assert_array_equal(quant.numpy(), want)


def test_prefill_logits_over_the_slot_cache_match_reference(weights):
    """The one-pass prefill of `generate` (decode over a fresh cache at
    position 0, full-length masked attention) against the reference's."""
    jmod, model = _models(weights)
    ids = _prompt(2, (3, 11))
    cache = jmod.init(jax.random.key(0), jnp.zeros((3, 1), jnp.int32), decode=True)["cache"]
    want, _ = jmod.apply({"params": jax.tree.map(jnp.asarray, weights), "cache": cache},
                         jnp.asarray(ids), decode=True, position_offset=0, mutable=["cache"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), 0, cache=make_cache(model, 3, per_slot=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


def test_sampled_generation_shape_and_determinism(weights):
    _, model = _models(weights)
    prompt = torch.zeros((3, 4), dtype=torch.long)

    def run():
        return generate(model, prompt, 6, temperature=1.0,
                        generator=torch.Generator().manual_seed(7), device="cpu")

    a, b = run(), run()
    assert a.shape == (3, 6) and torch.equal(a, b)
    assert int(a.max()) < model.config.vocab_size


def test_generate_refuses_a_model_on_another_device(weights):
    _, model = _models(weights)
    with pytest.raises(ValueError, match="model lives on"):
        generate(model, torch.zeros((1, 3), dtype=torch.long), 2, device="meta")


def test_cpu_generate_keeps_no_captured_step(weights):
    """On the CPU every step runs eagerly over a cache of its own: nothing is
    kept for the model's next call, and `release_captured` has nothing to
    free."""
    from accelerate_tpu_torch.models import generation

    _, model = _models(weights)
    generate(model, torch.from_numpy(_prompt(3)), 4, device="cpu")
    assert model not in generation._CAPTURED
    generation.release_captured(model)
