"""The port's fused LM head + cross-entropy against the reference's, on the CPU.

The same seeded numpy inputs go through the JAX package's
`fused_cross_entropy` (its Pallas kernels in interpret mode, which the
reference picks off the TPU) and the port's (the kernels' plain versions on a
CPU tensor): the loss and both gradients, at fp32 and bf16, an all-ignored
batch, the tiny GPT-2 `lm_loss_fn_pallas` through `BoundModel`, and three
AdamW steps of `make_train_step(lm_loss_fn_pallas)`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.accelerator import BoundModel as JaxBoundModel  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import lm_loss_fn_pallas as jax_lm_loss_fn_pallas  # noqa: E402
from accelerate_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_cross_entropy  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config,
    GPT2LMHead,
    lm_loss_fn,
    lm_loss_fn_pallas,
    params_from_jax,
)
from accelerate_tpu_torch.ops import fused_ce  # noqa: E402
from accelerate_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: E402

E = 64
# fp32 on both sides, the same logits summed in another order
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
# bf16 inputs: both sides take fp32 logits from the same bf16 operands and
# round dlogits to bf16 before the products, then each gradient once more to
# bf16 (one ulp is 2^-8 relative); a dlogit near a rounding boundary may
# round the other way on one side
BF16_LOSS_RTOL = 1e-5
BF16_GRAD_ATOL, BF16_GRAD_RTOL = 1e-4, 1e-2
# tiny GPT-2, fp32: the reference's own bar for its Pallas loss against the
# full-logits loss (tests/test_fused_ce.py)
MODEL_ATOL, MODEL_RTOL = 3e-5, 3e-4
MODEL_LOSS_ATOL = 1e-5
# after 3 AdamW steps at lr 1e-2 (as tests/test_torch_train.py)
PARAM_ATOL = 5e-4
B, S = 8, 32


def _inputs(n, v, dtype=np.float32, e=E):
    rng = np.random.default_rng(n + v)
    h = rng.normal(size=(n, e)).astype(dtype)
    w = (rng.normal(size=(v, e)) * 0.1).astype(dtype)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[3] = -100
    labels[n // 2] = -100
    return h, w, labels


def _jax_value_and_grads(h, w, labels, dtype):
    def loss(a, b):
        return jax_fused_cross_entropy(a, b, jnp.asarray(labels), block_r=32, block_v=128)

    val, (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(h, dtype), jnp.asarray(w, dtype))
    return float(val), np.asarray(gh.astype(jnp.float32)), np.asarray(gw.astype(jnp.float32))


def _port_value_and_grads(h, w, labels, dtype):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fused_cross_entropy(ht, wt, torch.from_numpy(labels).long())
    loss.backward()
    assert loss.dtype == torch.float32 and ht.grad.dtype == dtype and wt.grad.dtype == dtype
    return loss.item(), ht.grad.float().numpy(), wt.grad.float().numpy()


@pytest.mark.parametrize("n,v", [(96, 307), (64, 256), (33, 500)])
def test_value_and_grads_match_the_reference_fp32(n, v):
    h, w, labels = _inputs(n, v)
    want = _jax_value_and_grads(h, w, labels, jnp.float32)
    got = _port_value_and_grads(h, w, labels, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(got[2], want[2], atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("n,v", [(96, 307), (64, 256), (33, 500)])
def test_value_and_grads_match_the_reference_bf16(n, v):
    h, w, labels = _inputs(n, v)
    want = _jax_value_and_grads(h, w, labels, jnp.bfloat16)
    got = _port_value_and_grads(h, w, labels, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], atol=BF16_GRAD_ATOL, rtol=BF16_GRAD_RTOL)
    np.testing.assert_allclose(got[2], want[2], atol=BF16_GRAD_ATOL, rtol=BF16_GRAD_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_and_grads_match_the_reference_at_e96(dtype):
    """A width that is not a multiple of the kernels' 64-column chunk (the
    CUDA wrappers zero-pad it)."""
    h, w, labels = _inputs(40, 300, e=96)
    want = _jax_value_and_grads(h, w, labels, getattr(jnp, dtype))
    got = _port_value_and_grads(h, w, labels, getattr(torch, dtype))
    atol, rtol = (GRAD_ATOL, GRAD_RTOL) if dtype == "float32" else (BF16_GRAD_ATOL, BF16_GRAD_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], atol=atol, rtol=rtol)
    np.testing.assert_allclose(got[2], want[2], atol=atol, rtol=rtol)


def test_kernel_operands_zero_pad_e_exactly():
    """The CUDA wrappers' operands: e 96 padded with zero columns to 128,
    which add nothing to the logits (lse and the label logits agree up to
    summation order); dH and dW over the padded operands, cut back to e,
    agree with the unpadded ones; e 128 is passed through without a copy."""
    h, w, labels = (torch.from_numpy(x) for x in _inputs(24, 70, e=96))
    hp, wp, lp = fused_ce._operands("fused_ce_fwd", h, w, labels)
    assert hp.shape == (24, 128) and wp.shape == (70, 128) and lp.dtype == torch.int32
    assert not hp[:, 96:].any() and not wp[:, 96:].any()
    assert torch.equal(hp[:, :96], h) and torch.equal(wp[:, :96], w)
    lse, ll = fused_ce.fused_ce_forward_reference(h, w, labels)
    lse_p, ll_p = fused_ce.fused_ce_forward_reference(hp, wp, lp)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ll_p, ll, atol=1e-6, rtol=1e-6)
    g = torch.full((24,), 1 / 24)
    args, args_p = (h, w, labels, lse, g, -g), (hp, wp, lp, lse, g, -g)
    torch.testing.assert_close(fused_ce.fused_ce_dh_reference(*args_p)[:, :96],
                               fused_ce.fused_ce_dh_reference(*args), atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(fused_ce.fused_ce_dw_reference(*args_p)[:, :96],
                               fused_ce.fused_ce_dw_reference(*args), atol=1e-7, rtol=1e-6)
    h128, w128, _ = (torch.from_numpy(x) for x in _inputs(8, 10, e=128))
    hq, wq, _ = fused_ce._operands("fused_ce_fwd", h128, w128, torch.zeros(8, dtype=torch.int32))
    assert hq.data_ptr() == h128.data_ptr() and wq.data_ptr() == w128.data_ptr()


def test_all_ignored_batch_gives_zero_and_zero_grads():
    h, w, labels = _inputs(16, 100)
    labels[:] = -100
    want = _jax_value_and_grads(h, w, labels, jnp.float32)
    got = _port_value_and_grads(h, w, labels, torch.float32)
    assert got[0] == 0.0 == want[0]
    assert not got[1].any() and not got[2].any()


def test_plain_versions_follow_the_reference_rounding():
    """The plain forward gives the reference's lse and label logit, and a
    label outside the vocabulary matches no column (ll 0)."""
    h, w, labels = _inputs(20, 50)
    labels[0], labels[1] = 50, -7
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    lse, ll = fused_ce.fused_ce_fwd(ht, wt, torch.from_numpy(labels))
    logits = h.astype(np.float64) @ w.T.astype(np.float64)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(logits).sum(-1)), rtol=1e-6)
    valid = (labels >= 0) & (labels < 50)
    want_ll = np.where(valid, logits[np.arange(20), np.clip(labels, 0, 49)], 0.0)
    np.testing.assert_allclose(ll.numpy(), want_ll, rtol=1e-5, atol=1e-6)


def test_refusals():
    h, w, labels = (torch.from_numpy(x) for x in _inputs(8, 10))
    with pytest.raises(TypeError, match="ROADMAP"):
        fused_cross_entropy(h.half(), w.half(), labels)
    with pytest.raises(TypeError, match="one dtype"):
        fused_cross_entropy(h, w.bfloat16(), labels)
    with pytest.raises(ValueError, match="one e"):
        fused_ce.fused_ce_fwd(h, w[:, :-1], labels)
    with pytest.raises(ValueError, match=r"\[N\]"):
        fused_ce.fused_ce_fwd(h, w, labels[:-1])


# the clusters of each split count that an H100 SXM (132 SMs) runs at once
# for the bf16 forward kernel (`fused_ce.fwd_launch`, cudaOccupancyMaxActiveClusters
# on the card): a cluster lies inside one GPC, so 16-CTA clusters fit 7 at once
H100_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# a card of 132 SMs whose clusters could take any SMs
IDEAL_RESIDENT = {k: 132 // k for k in (1, 2, 4, 8, 16)}
# (N, V) -> the split count the plan gives on an H100: GPT-2 small's head
# (2: 64 clusters of 2 in one round); a short batch (8, not 16: eight
# 16-CTA clusters need two rounds); one row; one vocab entry; Mistral's
# head; 17 vocab tiles for one row (16 splits of 2 tiles, the last 7
# empty); row tiles that fill the card alone
H100_SPLITS = {(8192, 50257): 2, (1000, 50257): 8, (1, 50257): 16, (8192, 1): 1, (1, 1): 1,
               (8192, 32000): 2, (1, 17 * 128 - 5): 16, (132 * 128, 50257): 1}


@pytest.mark.parametrize("resident", [IDEAL_RESIDENT, H100_RESIDENT], ids=["ideal", "h100"])
@pytest.mark.parametrize("n,v", sorted(H100_SPLITS) + [(140 * 128, 50257), (300, 1000)])
def test_fwd_plan_splits_cover_the_vocab_in_the_fewest_steps(n, v, resident):
    """The bf16 forward's split plan: every vocab tile lies in exactly one
    split; a split count is a power of two of at most 16 CTAs (one cluster)
    and no more than the vocab tiles; no other split count takes fewer
    steps (rounds of resident clusters x vocab tiles a CTA), fewer rounds
    at equal steps, or fewer splits at both equal; and up to one row tile
    an SM the plan runs in one round."""
    plan = fused_ce.fwd_plan(n, v, resident)
    row_tiles, vocab_tiles = -(-n // 128), -(-v // 128)
    splits, per = plan["splits"], plan["tiles_per_split"]
    assert (plan["row_tiles"], plan["vocab_tiles"]) == (row_tiles, vocab_tiles)
    assert plan["grid"] == (row_tiles, splits)
    assert splits in (1, 2, 4, 8, 16) and (splits == 1 or splits <= vocab_tiles)
    owned = [t for y in range(splits) for t in range(y * per, (y + 1) * per) if t < vocab_tiles]
    assert sorted(owned) == list(range(vocab_tiles))
    def cost(k):
        rounds = -(-row_tiles // resident[k])
        return rounds * -(-vocab_tiles // k), rounds, k

    assert plan["waves"] == cost(splits)[1]
    assert cost(splits) == min(cost(k) for k in (1, 2, 4, 8, 16) if k == 1 or k <= vocab_tiles)
    if row_tiles <= 132:
        assert plan["waves"] == 1
    if resident is H100_RESIDENT and (n, v) in H100_SPLITS:
        assert splits == H100_SPLITS[n, v]


def test_fwd_plan_can_leave_splits_empty_and_refuses_nothing_positive():
    """17 vocab tiles over 16 splits of 2: splits 9 to 15 hold no tile (the
    kernel merges an empty state for them); a count <= 0 raises."""
    plan = fused_ce.fwd_plan(1, 17 * 128 - 5, H100_RESIDENT)
    first = [y * plan["tiles_per_split"] for y in range(plan["splits"])]
    assert [y for y, t in enumerate(first) if t >= plan["vocab_tiles"]] == list(range(9, 16))
    with pytest.raises(ValueError):
        fused_ce.fwd_plan(0, 10, H100_RESIDENT)


@pytest.fixture(scope="module")
def reference():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    return jmod, params


def _port_model(params):
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def test_gpt2_pallas_loss_and_every_gradient_match(reference):
    """The port's `lm_loss_fn_pallas` through `BoundModel` against the
    reference's through its `BoundModel`, and against the port's own
    `lm_loss_fn` (the full fp32 logits)."""
    jmod, params = reference
    ids = _ids(0)

    def jloss(p):
        bound = JaxBoundModel(lambda q, *a, **kw: jmod.apply({"params": q}, *a, **kw), p)
        return jax_lm_loss_fn_pallas(bound, {"input_ids": jnp.asarray(ids)}, block_r=32, block_v=128)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))

    batch = {"input_ids": torch.from_numpy(ids).long()}
    grads = {}
    losses = {}
    for fn in (lm_loss_fn_pallas, lm_loss_fn):
        model = _port_model(params)
        named = dict(model.named_parameters())
        loss = fn(BoundModel(model, named), batch)
        loss.backward()
        losses[fn.__name__] = loss.item()
        grads[fn.__name__] = {name: p.grad.numpy() for name, p in named.items()}

    np.testing.assert_allclose(losses["lm_loss_fn_pallas"], float(want_loss), atol=MODEL_LOSS_ATOL)
    np.testing.assert_allclose(losses["lm_loss_fn_pallas"], losses["lm_loss_fn"], atol=MODEL_LOSS_ATOL)
    assert sorted(grads["lm_loss_fn_pallas"]) == sorted(want)
    for name, got in grads["lm_loss_fn_pallas"].items():
        np.testing.assert_allclose(got, want[name].numpy(), atol=MODEL_ATOL, rtol=MODEL_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(got, grads["lm_loss_fn"][name], atol=MODEL_ATOL, rtol=MODEL_RTOL,
                                   err_msg=name)


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def test_three_pallas_train_steps_match(reference):
    """``prepare`` + ``make_train_step(lm_loss_fn_pallas)``, 3 AdamW updates
    with global-norm clipping at 0.5: optax ``adamw(1e-2)`` against torch
    ``AdamW(lr=1e-2, weight_decay=1e-4)``."""
    jmod, params = reference
    batches = [_ids(10 + i) for i in range(3)]

    jacc = _jax_accelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jmod, params), optax.adamw(1e-2))
    jstep = jacc.make_train_step(jax_lm_loss_fn_pallas, max_grad_norm=0.5)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params)
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4))
    step = acc.make_train_step(lm_loss_fn_pallas, max_grad_norm=0.5)
    before = fused_ce.fused_ce_fwd.launches  # the CPU runs the plain versions: no launch
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]

    assert fused_ce.fused_ce_fwd.launches == before
    np.testing.assert_allclose(losses, want_losses, atol=MODEL_LOSS_ATOL, rtol=0)
    assert opt.num_updates == 3 and step.grad_norm.item() > 0.5  # the clip engaged
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            # the key third's gradient is rounding noise on both sides (see
            # tests/test_torch_train.py): Adam moves it by ~lr either way
            e = got.shape[0] // 3
            np.testing.assert_allclose(got[e:2 * e], ref[e:2 * e], atol=2 * 1e-2 * 3, rtol=0)
            got, ref = np.delete(got, np.s_[e:2 * e]), np.delete(ref, np.s_[e:2 * e])
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_bound_model_params_are_the_compute_copies(reference):
    """Under ``mixed_precision="bf16"`` the `BoundModel` a loss receives
    holds bf16 copies of the fp32 masters, the fused loss reads its
    ``wte.weight`` there, and the head's and the embedding's gradients reach
    the fp32 master."""
    _, params = reference
    model = _port_model(params)
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2, device="cpu")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
    seen = {}

    def loss_fn(bound, batch):
        assert isinstance(bound, BoundModel)
        seen.update(bound.params)
        return lm_loss_fn_pallas(bound, batch)

    step = acc.make_train_step(loss_fn)
    ids = torch.from_numpy(_ids(4)).long()
    loss = step({"input_ids": ids})  # the first of two microbatches: no update yet
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert seen[name].dtype == torch.bfloat16, name
        torch.testing.assert_close(seen[name], p.detach().to(torch.bfloat16), atol=0, rtol=0)
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    # wte's gradient holds the head's (every row) and the embedding's (seen ids)
    unseen = torch.ones(256, dtype=torch.bool)
    unseen[ids.flatten()] = False
    assert unseen.any() and model.wte.weight.grad[unseen].abs().sum(-1).gt(0).all()
