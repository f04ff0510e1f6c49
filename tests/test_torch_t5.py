"""The port's T5 (`accelerate_tpu_torch.models.t5`) against the reference's,
on the CPU.

`relative_position_bucket` integer-equal to the reference's over relative
positions -1024..1024; `dot_product_attention(bias=)` with causal and with
mask and bias together; tiny T5 fp32 logits with padded source and target
masks, tied and untied, gated and ReLU, and ``return_hidden``; both losses
and every gradient against ``jax.grad`` with -100 labels (the reference's
fused loss runs its Pallas fused-CE kernels in interpret mode, the port's
the kernels' plain versions); bf16 logits; `shift_tokens_right`; three
AdamW `make_train_step` steps of the fused loss against the JAX step;
`params_from_hf_t5` on a synthetic Hugging Face state dict; the
`params_to_jax` round trip; the refusals. Weights are the reference's,
carried into the port by `params_from_jax`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.accelerator import BoundModel as JaxBoundModel  # noqa: E402
from accelerate_tpu.models import t5 as jt5  # noqa: E402
from accelerate_tpu.ops.attention import dot_product_attention as jax_attention  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel  # noqa: E402
from accelerate_tpu_torch.models.t5 import (  # noqa: E402
    T5Config,
    T5ForConditionalGeneration,
    params_from_hf_t5,
    params_from_jax,
    relative_position_bucket,
    seq2seq_loss_fn,
    seq2seq_loss_fn_fused,
    shift_tokens_right,
    t5_pipeline_forward,
    t5_sharding_rules,
)
from accelerate_tpu_torch.ops import fused_ce  # noqa: E402
from accelerate_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

B, SRC, TGT = 2, 12, 8
# fp32 on both sides: matmuls, norms and softmaxes reduce in other orders
ATTN_ATOL = 1e-6
LOGIT_ATOL = 1e-4  # logits of size ~10 (normal(1.0) embeddings through 2 + 2 blocks)
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
# bf16 compute over the same fp32 masters, both packages: the same roundings
# in other summation orders; one bf16 ulp of a logit of size ~10 is 0.06
BF16_LOGIT_ATOL = 0.25
# 3 AdamW steps at lr 1e-2, eps 1e-4 (a noise-level gradient then moves a
# coordinate by about lr * g / eps, not a full step)
ADAM_EPS = 1e-4
PARAM_ATOL = 5e-4

VARIANTS = {"untied_gated": dict(tie_word_embeddings=False, gated_ffn=True),
            "tied_gated": dict(tie_word_embeddings=True, gated_ffn=True),
            "untied_relu": dict(tie_word_embeddings=False, gated_ffn=False),
            "tied_relu": dict(tie_word_embeddings=True, gated_ffn=False)}


def _jcfg(**kw):
    return jt5.T5Config.tiny(**{"dtype": jnp.float32, **kw})


def _cfg(**kw):
    return T5Config.tiny(**{"dtype": torch.float32, **kw})


@pytest.fixture(scope="module")
def trees():
    """The reference's tiny params, one tree a variant."""
    out = {}
    for name, kw in VARIANTS.items():
        p = jt5.T5ForConditionalGeneration(_jcfg(**kw)).init_params(jax.random.key(0), batch=1,
                                                                   src=8, tgt=8)
        out[name] = jax.tree.map(np.asarray, p)
    return out


def _port(tree, **kw):
    model = T5ForConditionalGeneration(_cfg(**kw), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _batch(seed, vocab=512):
    r = np.random.default_rng(seed)
    labels = r.integers(1, vocab, (B, TGT)).astype(np.int32)
    labels[1, 5:] = -100  # a padded target
    src_mask = np.ones((B, SRC), np.int32)
    src_mask[1, 7:] = 0  # a padded source
    return {"input_ids": r.integers(0, vocab, (B, SRC)).astype(np.int32),
            "attention_mask": src_mask,
            "decoder_input_ids": np.array(jt5.shift_tokens_right(jnp.asarray(labels))),
            "decoder_attention_mask": (labels != -100).astype(np.int32),
            "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
@pytest.mark.parametrize("preset", ["base", "tiny"])
def test_relative_position_bucket_integer_equal(preset, bidirectional):
    """Every relative position in -1024..1024, the preset's buckets and
    distance: integer-equal, so a last-ulp tie in ``log`` would show."""
    jcfg, cfg = getattr(jt5.T5Config, preset)(), getattr(T5Config, preset)()
    rel = np.arange(-1024, 1025, dtype=np.int32)
    want = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional,
                                        jcfg.relative_attention_num_buckets,
                                        jcfg.relative_attention_max_distance)
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                   cfg.relative_attention_num_buckets,
                                   cfg.relative_attention_max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["causal_bias", "mask_and_bias"])
def test_dot_product_attention_bias_matches_reference(case):
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((2, 9, 3, 8)).astype(np.float32) for _ in range(3))
    bias = r.standard_normal((1, 3, 9, 9)).astype(np.float32)
    kw = {"causal": True}
    if case == "mask_and_bias":
        mask = np.ones((2, 1, 1, 9), bool)
        mask[1, ..., 4:] = False
        mask[0, ..., :] = False  # a fully masked row: uniform weights, as the reference
        kw = {"mask": mask}
    want = jax_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(bias), scale=1.0,
        **{key: jnp.asarray(val) if key == "mask" else val for key, val in kw.items()})
    got = dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), bias=torch.from_numpy(bias), scale=1.0,
        **{key: torch.from_numpy(val) if key == "mask" else val for key, val in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_hidden_match_reference(trees, variant):
    """fp32 logits with padded source and target masks, and the decoder's
    hidden states with ``return_hidden``."""
    tree, kw = trees[variant], VARIANTS[variant]
    batch = _batch(1)
    jmod = jt5.T5ForConditionalGeneration(_jcfg(**kw))
    args = [batch[k] for k in ("input_ids", "decoder_input_ids", "attention_mask",
                               "decoder_attention_mask")]
    model = _port(tree, **kw)
    for hidden in (False, True):
        want = jmod.apply({"params": tree}, *(jnp.asarray(a) for a in args), return_hidden=hidden)
        with torch.no_grad():
            got = model(*(torch.from_numpy(a) for a in args), return_hidden=hidden)
        assert got.dtype == torch.float32
        assert got.shape == ((B, TGT, 64) if hidden else (B, TGT, 512))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("variant", ["untied_gated", "tied_gated"])
def test_losses_and_every_gradient_match(trees, variant, fused):
    tree, kw = trees[variant], VARIANTS[variant]
    jmod = jt5.T5ForConditionalGeneration(_jcfg(**kw))
    batch = _batch(2)

    def jloss(p):
        bound = JaxBoundModel(lambda q, *a, **k: jmod.apply({"params": q}, *a, **k), p)
        if fused:
            return jt5.seq2seq_loss_fn_fused(bound, _jbatch(batch), block_r=16, block_v=128)
        return jt5.seq2seq_loss_fn(bound, _jbatch(batch))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(tree)
    model = _port(tree, **kw)
    named = dict(model.named_parameters())
    before = (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_dh.launches,
              fused_ce.fused_ce_dw.launches)
    loss = (seq2seq_loss_fn_fused if fused else seq2seq_loss_fn)(BoundModel(model, named),
                                                                 _torch(batch))
    loss.backward()
    assert (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_dh.launches,
            fused_ce.fused_ce_dw.launches) == before  # the CPU runs the plain versions
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    assert sorted(want) == sorted(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_fused_loss_equals_dense_and_ignores_tiles(trees):
    model = _port(trees["tied_gated"], tie_word_embeddings=True)
    bound = BoundModel(model, dict(model.named_parameters()))
    batch = _torch(_batch(3))
    with torch.no_grad():
        dense = seq2seq_loss_fn(bound, batch)
        fused = seq2seq_loss_fn_fused(bound, batch)
        tiles = seq2seq_loss_fn_fused(bound, batch, block_r=7, block_v=9)
    np.testing.assert_allclose(fused.item(), dense.item(), atol=LOSS_ATOL)
    assert tiles.item() == fused.item()


@pytest.mark.parametrize("variant", ["untied_gated", "tied_relu"])
def test_bf16_logits_match_reference_bf16(trees, variant):
    """bf16 compute over fp32 masters in both packages: the norm's product
    and every projection in bf16, the bias and softmax in fp32."""
    tree, kw = trees[variant], VARIANTS[variant]
    batch = _batch(4)
    args = [batch[k] for k in ("input_ids", "decoder_input_ids", "attention_mask",
                               "decoder_attention_mask")]
    want = jt5.T5ForConditionalGeneration(_jcfg(**{**kw, "dtype": jnp.bfloat16})).apply(
        {"params": tree}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = _port(tree, **kw, dtype=torch.bfloat16)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_LOGIT_ATOL, rtol=0)


def test_shift_tokens_right_matches_reference():
    labels = np.random.default_rng(5).integers(-1, 50, (3, 7)).astype(np.int32)
    labels[labels < 3] = -100
    for start in (0, 3):
        want = jt5.shift_tokens_right(jnp.asarray(labels), decoder_start_token_id=start)
        got = shift_tokens_right(torch.from_numpy(labels), decoder_start_token_id=start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_three_fused_train_steps_match_and_the_loss_falls(trees):
    """``prepare`` + ``make_train_step(seq2seq_loss_fn_fused)`` for 3 steps:
    optax ``adamw(1e-2, eps=ADAM_EPS)`` against torch ``AdamW(lr=1e-2,
    weight_decay=1e-4, eps=ADAM_EPS)``, clipping at 1.0, over one batch; the
    loss falls."""
    tree = trees["untied_gated"]
    batch = _batch(6)
    jacc = _jax_accelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jt5.T5ForConditionalGeneration(_jcfg()), tree),
                             optax.adamw(1e-2, eps=ADAM_EPS))
    jstep = jacc.make_train_step(
        lambda m, b: jt5.seq2seq_loss_fn_fused(m, b, block_r=16, block_v=128), max_grad_norm=1.0)
    want_losses = [float(jstep(_jbatch(batch))) for _ in range(3)]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port(tree)
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                      weight_decay=1e-4, eps=ADAM_EPS))
    step = acc.make_train_step(seq2seq_loss_fn_fused, max_grad_norm=1.0)
    losses = [step(_torch(batch)).item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    assert losses[-1] < losses[0]
    assert opt.num_updates == 3
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_bf16_train_steps_lower_the_loss():
    """``mixed_precision="bf16"``: the step hands the module bf16 copies of
    every floating parameter, the relative-bias tables and norm scales
    included, as the reference's cast rule does; the fused loss falls."""
    model = T5ForConditionalGeneration(T5Config.tiny(), device="cpu", seed=1)
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=3e-3))
    step = acc.make_train_step(seq2seq_loss_fn_fused)
    batch = _torch(_batch(7))
    losses = [step(batch).item() for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5, losses
    assert all(p.dtype == torch.float32 for p in model.module.parameters())


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "relu"])
def test_params_from_hf_t5_on_synthetic_state_dict(gated):
    """A Hugging Face-named state dict (``[out, in]`` Linear weights, the
    relative table in block 0) maps to the tree the reference's mapping
    gives."""
    rng = np.random.default_rng(9)
    e, f, inner, v = 64, 128, 64, 512

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    hf = {"shared.weight": w(v, e), "lm_head.weight": w(v, e)}
    ff_names = ("wi_0", "wi_1") if gated else ("wi",)
    for side, is_dec in (("encoder", False), ("decoder", True)):
        hf[f"{side}.final_layer_norm.weight"] = 1 + w(e)
        hf[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = w(32, 4)
        for i in range(2):
            pre = f"{side}.block.{i}.layer"
            attns = [("0", "SelfAttention")] + ([("1", "EncDecAttention")] if is_dec else [])
            for idx, att in attns:
                hf[f"{pre}.{idx}.layer_norm.weight"] = 1 + w(e)
                hf.update({f"{pre}.{idx}.{att}.{p}.weight": w(inner, e) for p in "qkv"})
                hf[f"{pre}.{idx}.{att}.o.weight"] = w(e, inner)
            ff = 2 if is_dec else 1
            hf[f"{pre}.{ff}.layer_norm.weight"] = 1 + w(e)
            hf.update({f"{pre}.{ff}.DenseReluDense.{p}.weight": w(f, e) for p in ff_names})
            hf[f"{pre}.{ff}.DenseReluDense.wo.weight"] = w(e, f)
    tree = jt5.params_from_hf_t5(hf, _jcfg(gated_ffn=gated))
    got = params_from_hf_t5({k: torch.from_numpy(x) for k, x in hf.items()}, _cfg(gated_ffn=gated))
    want = params_from_jax(tree)
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    model = _port(tree, gated_ffn=gated)
    assert sorted(model.state_dict()) == sorted(got)
    torch.testing.assert_close(got["encoder.block_1.self_attn.q.weight"],
                               torch.from_numpy(hf["encoder.block.1.layer.0.SelfAttention.q.weight"]))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_to_jax_inverts_params_from_jax(trees, variant):
    tree = trees[variant]
    model = _port(tree, **VARIANTS[variant])
    back = model.reference_state_dict()
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert set(flat_back) == set(flat_want)
    for key, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_back[key].numpy(), leaf, err_msg=str(key))


def test_seeded_init_and_refusals(monkeypatch):
    a = T5ForConditionalGeneration(T5Config.tiny(), device="cpu", seed=3)
    b = T5ForConditionalGeneration(T5Config.tiny(), device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert "lm_head" in dict(a.named_parameters())
    assert "lm_head" not in dict(T5ForConditionalGeneration(
        T5Config.tiny(tie_word_embeddings=True), device="cpu").named_parameters())
    with pytest.raises(NotImplementedError, match="21.3"):
        t5_sharding_rules()
    with pytest.raises(NotImplementedError, match="21.3"):
        t5_pipeline_forward(T5Config.tiny(), {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T5ForConditionalGeneration(T5Config.tiny())
