"""The port's BERT (`accelerate_tpu_torch.models.bert`) against the
reference's, on the CPU.

`BertConfig.tiny(dtype=float32)` params from the JAX package are carried
into the port by `params_from_jax`: the logits with a padding mask, the
classification loss and every gradient are compared, and `params_to_jax`
gives the reference's tree back."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from accelerate_tpu.models.bert import (  # noqa: E402
    BertForSequenceClassification as JaxBert,
)
from accelerate_tpu.models.bert import classification_loss_fn as jax_loss_fn  # noqa: E402
from accelerate_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForSequenceClassification,
    classification_loss_fn,
    params_from_jax,
    params_to_jax,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

B, S = 4, 24
# fp32 on both sides; matmuls, LayerNorm and softmax reduce in other orders
LOGIT_ATOL = 1e-5
LOSS_ATOL = 1e-6
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    jmod = JaxBert(JaxBertConfig.tiny(dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    return jmod, params


def _batch(seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 1024, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 17:] = 0  # padded rows: the mask must hide their keys
    mask[3, 5:] = 0
    labels = r.integers(0, 2, (B,)).astype(np.int32)
    types = (np.arange(S) >= S // 2).astype(np.int32)[None].repeat(B, 0)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels, "token_type_ids": types}


def _port(params, **cfg):
    model = BertForSequenceClassification(BertConfig.tiny(**{"dtype": torch.float32, **cfg}),
                                          device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("with_types", [False, True])
def test_logits_match_reference(reference, with_types):
    jmod, params = reference
    batch = _batch(1)
    types = batch["token_type_ids"] if with_types else None
    want = jmod.apply({"params": params}, jnp.asarray(batch["input_ids"]),
                      jnp.asarray(batch["attention_mask"]),
                      None if types is None else jnp.asarray(types))
    model = _port(params)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"]),
                    None if types is None else torch.from_numpy(types))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


def test_loss_and_every_gradient_match(reference):
    jmod, params = reference
    batch = _batch(2)

    def jloss(p):
        return jax_loss_fn(lambda *a: jmod.apply({"params": p}, *a),
                           {k: jnp.asarray(v) for k, v in batch.items()})

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = _port(params)
    loss = classification_loss_fn(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_base_width_loss_and_gradients_match():
    """BERT-base's width (768, 12 heads, intermediate 3072, vocab 30522, 512
    positions) at 2 of its 12 layers: the loss and every gradient, each
    within 2e-5 of its largest element (the largest reading: 1.9e-6)."""
    jmod = JaxBert(JaxBertConfig(num_layers=2, dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(1), batch=1, seq=8))
    batch = _batch(4)
    batch["input_ids"] = np.random.default_rng(4).integers(0, 30522, (B, S)).astype(np.int32)

    def jloss(p):
        return jax_loss_fn(lambda *a: jmod.apply({"params": p}, *a),
                           {k: jnp.asarray(v) for k, v in batch.items()})

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = BertForSequenceClassification(BertConfig(num_layers=2, dtype=torch.float32),
                                          device="cpu")
    model.load_state_dict(params_from_jax(params))
    loss = classification_loss_fn(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-5 * scale, rtol=0,
                                   err_msg=name)


def test_params_to_jax_inverts_params_from_jax(reference):
    _, params = reference
    back = params_to_jax(params_from_jax(params))
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(flat_back) == set(flat_want)
    for key, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_back[key].numpy(), leaf, err_msg=str(key))


def test_bf16_logits_near_fp32(reference):
    """bf16 compute over the same fp32 masters, as the reference's default
    config runs: the logits stay within bf16's resolution of fp32's."""
    _, params = reference
    batch = _torch(_batch(3))
    with torch.no_grad():
        full = _port(params)(batch["input_ids"], batch["attention_mask"])
        half = _port(params, dtype=torch.bfloat16)(batch["input_ids"], batch["attention_mask"])
    assert half.dtype == torch.float32
    np.testing.assert_allclose(half.numpy(), full.numpy(), atol=5e-2, rtol=0)


def test_seeded_init_and_device_none_means_cuda(monkeypatch):
    a = BertForSequenceClassification(BertConfig.tiny(), device="cpu", seed=3)
    b = BertForSequenceClassification(BertConfig.tiny(), device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.bert.layers[0].mlp_up.weight
    assert w.abs().max() <= 2 / np.sqrt(64) / 0.8796 + 1e-6  # truncated at two deviations
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertForSequenceClassification(BertConfig.tiny())
