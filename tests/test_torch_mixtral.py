"""The port's MoE layer and Mixtral against the reference's, on the CPU.

`build_dispatch_combine` equal to the reference's, bit for bit, with
tokens dropped over capacity; `MoEMLP` and its aux loss; tiny Mixtral
logits, aux loss, loss and every gradient (drop-free and dropping
capacity), and three AdamW `make_train_step` steps against the JAX step in
fp32, from the reference's weights carried over by `params_from_jax`;
`mixtral_loss_fn_fused` against the reference's, whose Pallas fused-CE
kernels run in interpret mode on the CPU (the port runs their plain
versions); `params_from_hf_mixtral` on a synthetic Hugging Face state dict;
remat adding each layer's aux term once; the refusals.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.accelerator import BoundModel as JaxBoundModel  # noqa: E402
from accelerate_tpu.models import mixtral as jmixtral  # noqa: E402
from accelerate_tpu.ops import moe as jmoe  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel  # noqa: E402
from accelerate_tpu_torch.models.mixtral import (  # noqa: E402
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_loss_fn,
    mixtral_loss_fn_fused,
    mixtral_sharding_rules,
    params_from_hf_mixtral,
    params_from_jax,
)
from accelerate_tpu_torch.ops import fused_ce  # noqa: E402
from accelerate_tpu_torch.ops import moe  # noqa: E402
from accelerate_tpu_torch.utils.intermediates import collecting_intermediates  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

B, S = 2, 16
# fp32 on both sides: matmuls, norms and softmaxes reduce in other orders
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
AUX_ATOL = 1e-7
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-4
# after 3 AdamW steps at lr 1e-2 with eps 1e-4, as
# tests/test_torch_llama_fused_loss.py: a noise-level gradient then moves a
# coordinate by about lr * g / eps instead of a full step
ADAM_EPS = 1e-4
PARAM_ATOL = 5e-4


def _jcfg(**kw):
    return jmixtral.MixtralConfig.tiny(**{"dtype": jnp.float32, "param_dtype": jnp.float32,
                                          "attention_impl": "xla", **kw})


def _cfg(**kw):
    return MixtralConfig.tiny(**{"dtype": torch.float32, "attention_impl": "xla", **kw})


@pytest.fixture(scope="module")
def params():
    jmod = jmixtral.MixtralForCausalLM(_jcfg())
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, variables["params"])


def _port_model(params, **cfg):
    model = MixtralForCausalLM(_cfg(**cfg), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _ids(seed, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _jax_bound(jmod, p):
    """The reference's BoundModel over a flax module with the intermediates
    collection, as its `PreparedModel` builds it."""
    def apply_fn(q, *args, extra_state=None, **kwargs):
        out, state = jmod.apply({"params": q, **extra_state}, *args,
                                mutable=list(extra_state), **kwargs)
        return out, state

    return JaxBoundModel(apply_fn, p, extra_state={"intermediates": {}})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5, 0.2])
def test_build_dispatch_combine_matches_reference(capacity_factor, dtype):
    """Equal to the reference's bit for bit, dropping the same tokens."""
    T, E, k = 64, 4, 2
    rng = np.random.default_rng(5)
    expert_idx = np.argsort(rng.standard_normal((T, E)), axis=-1)[:, :k].astype(np.int32)
    gates = rng.random((T, k)).astype(np.float32)
    capacity = moe.expert_capacity(capacity_factor, T, k, E)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_d, want_c = jmoe.build_dispatch_combine(jnp.asarray(expert_idx), jnp.asarray(gates), E,
                                                 capacity, jdtype)
    got_d, got_c = moe.build_dispatch_combine(torch.from_numpy(expert_idx),
                                              torch.from_numpy(gates), E, capacity, dtype)
    assert got_d.dtype == dtype and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_d.float().numpy(), np.asarray(want_d, np.float32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    kept = int(got_d.float().sum())
    if capacity_factor < 1.0:
        assert kept < T * k  # some tokens dropped
    else:
        assert kept == T * k


def test_dispatch_combine_gates_receive_gradient():
    """Kept places carry their gate, through which it gets gradient; a
    dropped one carries nothing."""
    idx = torch.tensor([[0, 1], [1, 0], [0, 1]])
    gates = torch.tensor([[0.7, 0.3], [0.6, 0.4], [0.5, 0.5]], requires_grad=True)
    # capacity 1: slot 0 keeps tokens 0 and 1; token 2's expert 0 is full, and
    # slot 1 finds both experts full
    _, combine = moe.build_dispatch_combine(idx, gates, 2, 1, torch.float32)
    (combine * (1 + torch.arange(6.0)).reshape(3, 2, 1)).sum().backward()
    assert (gates.grad[:2, 0] != 0).all()
    assert gates.grad[2].abs().sum() == 0 and gates.grad[:, 1].abs().sum() == 0


@pytest.mark.parametrize("capacity_factor,top_k", [(2.0, 2), (0.25, 1)])
def test_moe_mlp_matches_reference(capacity_factor, top_k):
    jcfg = jmoe.MoEConfig(num_experts=4, top_k=top_k, hidden_size=16, intermediate_size=32,
                          capacity_factor=capacity_factor, dtype=jnp.float32)
    jmod = jmoe.MoEMLP(jcfg)
    x = np.asarray(jax.random.normal(jax.random.key(0), (2, 8, 16)))
    p = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), jnp.asarray(x))["params"])
    want, inter = jmod.apply({"params": p}, jnp.asarray(x), mutable=["intermediates"])
    cfg = moe.MoEConfig(num_experts=4, top_k=top_k, hidden_size=16, intermediate_size=32,
                        capacity_factor=capacity_factor, dtype=torch.float32)
    layer = moe.MoEMLP(cfg, device="cpu")
    layer.load_state_dict({"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
                           "w_up": torch.from_numpy(p["w_up"]),
                           "w_down": torch.from_numpy(p["w_down"])})
    with collecting_intermediates() as sown:
        got = layer(torch.from_numpy(x))
    terms = sown["aux_loss"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert len(terms) == 1
    np.testing.assert_allclose(terms[0].item(), float(inter["intermediates"]["aux_loss"]),
                               atol=AUX_ATOL)
    assert float(moe.collect_aux_losses({"intermediates": {"aux_loss": terms}})) == terms[0].item()
    assert moe.collect_aux_losses(None).item() == 0.0


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_logits_aux_loss_and_every_gradient_match(params, capacity_factor):
    """``mixtral_loss_fn`` through each package's BoundModel: logits, the
    aux loss, the loss and every gradient (the routers' included)."""
    jmod = jmixtral.MixtralForCausalLM(_jcfg(capacity_factor=capacity_factor))
    ids = _ids(0)

    def jloss(p):
        bound = _jax_bound(jmod, p)
        loss = jmixtral.mixtral_loss_fn(bound, {"input_ids": jnp.asarray(ids)})
        return loss, jmoe.collect_aux_losses(bound.extra_state)

    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want_logits = jmod.apply({"params": params}, jnp.asarray(ids))

    model = _port_model(params, capacity_factor=capacity_factor)
    named = dict(model.named_parameters())
    bound = BoundModel(model, named)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    loss = mixtral_loss_fn(bound, batch)
    aux = moe.collect_aux_losses(bound.extra_state)
    assert len(bound.extra_state["intermediates"]["aux_loss"]) == model.config.num_layers
    loss.backward()
    with torch.no_grad():
        logits = model(batch["input_ids"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=AUX_ATOL)
    assert aux.item() > 0
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert named["layers.0.moe.gate.weight"].grad.abs().sum() > 0


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def test_prepared_model_loss_includes_aux_as_the_reference(params):
    """``mixtral_loss_fn`` on each package's prepared model, outside the
    train step: the same loss, the routers' aux terms included; a bare
    module has no ``extra_state`` and raises rather than drop them."""
    ids = _ids(4)
    jmodel, _ = _jax_accelerator(mixed_precision="no").prepare(
        (jmixtral.MixtralForCausalLM(_jcfg()), {"params": params, "intermediates": {}}),
        optax.adamw(1e-2))
    want = float(jmixtral.mixtral_loss_fn(jmodel, {"input_ids": jnp.asarray(ids)}))
    want_aux = float(jmoe.collect_aux_losses(jmodel.extra_state))

    module = _port_model(params)
    model = Accelerator(mixed_precision="no", device="cpu").prepare_model(module)
    batch = {"input_ids": torch.from_numpy(ids).long()}
    with torch.no_grad():
        loss = mixtral_loss_fn(model, batch).item()
    aux = moe.collect_aux_losses(model.extra_state).item()
    assert len(model.extra_state["intermediates"]["aux_loss"]) == module.config.num_layers
    assert aux > 0
    np.testing.assert_allclose(aux, want_aux, atol=AUX_ATOL)
    np.testing.assert_allclose(loss, want, atol=LOSS_ATOL)
    with pytest.raises(AttributeError, match="extra_state"), torch.no_grad():
        mixtral_loss_fn(module, batch)


@pytest.mark.parametrize("fused", [False, True], ids=["dense_head", "fused_ce"])
def test_three_train_steps_match(params, fused):
    """``prepare`` + ``make_train_step`` for 3 steps, aux loss included:
    optax ``adamw(1e-2, eps=ADAM_EPS)`` against torch ``AdamW(lr=1e-2,
    weight_decay=1e-4, eps=ADAM_EPS)``, clipping at 1.0. With ``fused`` both
    sides take `mixtral_loss_fn_fused` (the reference's Pallas kernels in
    interpret mode, tiles 32 x 128)."""
    batches = [_ids(10 + i) for i in range(3)]
    jacc = _jax_accelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jmixtral.MixtralForCausalLM(_jcfg()),
                              {"params": params, "intermediates": {}}),
                             optax.adamw(1e-2, eps=ADAM_EPS))
    jloss = (lambda m, b: jmixtral.mixtral_loss_fn_fused(m, b, block_r=32, block_v=128)) \
        if fused else jmixtral.mixtral_loss_fn
    jstep = jacc.make_train_step(jloss, max_grad_norm=1.0)
    want_losses = [float(jstep({"input_ids": jnp.asarray(b)})) for b in batches]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port_model(params)
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                      weight_decay=1e-4, eps=ADAM_EPS))
    before = (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_dh.launches)
    step = acc.make_train_step(mixtral_loss_fn_fused if fused else mixtral_loss_fn,
                               max_grad_norm=1.0)
    losses = [step({"input_ids": torch.from_numpy(b).long()}).item() for b in batches]
    assert (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_dh.launches) == before
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    assert opt.num_updates == 3
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_fused_loss_matches_reference_and_dense(params):
    """`mixtral_loss_fn_fused` against the reference's (Pallas interpret
    mode) and against the port's `mixtral_loss_fn`: loss and gradients."""
    jmod = jmixtral.MixtralForCausalLM(_jcfg())
    ids = _ids(6)

    def jloss(p):
        return jmixtral.mixtral_loss_fn_fused(_jax_bound(jmod, p), {"input_ids": jnp.asarray(ids)},
                                              block_r=32, block_v=128)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    batch = {"input_ids": torch.from_numpy(ids).long()}
    got = {}
    for fn in (mixtral_loss_fn_fused, mixtral_loss_fn):
        model = _port_model(params)
        named = dict(model.named_parameters())
        loss = fn(BoundModel(model, named), batch)
        loss.backward()
        got[fn.__name__] = (loss.item(), {n: p.grad.numpy() for n, p in named.items()})
    loss, grads = got["mixtral_loss_fn_fused"]
    np.testing.assert_allclose(loss, float(want_loss), atol=LOSS_ATOL)
    np.testing.assert_allclose(loss, got["mixtral_loss_fn"][0], atol=LOSS_ATOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(g, got["mixtral_loss_fn"][1][name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_params_from_hf_mixtral_on_synthetic_state_dict():
    """A Hugging Face-named state dict (``[out, in]`` Linear weights, one
    module per expert) maps to the tree the reference's mapping gives, and
    both models give the same logits (drop-free capacity, as HF routes every
    token)."""
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
              num_kv_heads=2, num_experts=4, top_k=2, max_position_embeddings=64,
              rope_theta=10000.0, capacity_factor=4.0)
    rng = np.random.default_rng(9)
    e, f, E, hd = 64, 96, 4, 16

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    hf = {"model.embed_tokens.weight": w(128, e), "model.norm.weight": 1 + w(e),
          "lm_head.weight": w(128, e)}
    for i in range(2):
        pre = f"model.layers.{i}."
        hf.update({pre + "input_layernorm.weight": 1 + w(e),
                   pre + "post_attention_layernorm.weight": 1 + w(e),
                   pre + "self_attn.q_proj.weight": w(4 * hd, e),
                   pre + "self_attn.k_proj.weight": w(2 * hd, e),
                   pre + "self_attn.v_proj.weight": w(2 * hd, e),
                   pre + "self_attn.o_proj.weight": w(e, 4 * hd),
                   pre + "block_sparse_moe.gate.weight": w(E, e)})
        for j in range(E):
            moe_pre = pre + f"block_sparse_moe.experts.{j}."
            hf.update({moe_pre + "w1.weight": w(f, e), moe_pre + "w3.weight": w(f, e),
                       moe_pre + "w2.weight": w(e, f)})
    jcfg = jmixtral.MixtralConfig(dtype=jnp.float32, attention_impl="xla", **kw)
    cfg = MixtralConfig(dtype=torch.float32, attention_impl="xla", **kw)
    tree = jmixtral.params_from_hf_mixtral(hf, jcfg)
    got = params_from_hf_mixtral({k: torch.from_numpy(v) for k, v in hf.items()}, cfg)
    want = params_from_jax(tree)
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    assert tuple(got["layers.1.moe.w2"].shape) == (E, f, e)
    model = MixtralForCausalLM(cfg, device="cpu")
    model.load_state_dict(got)
    ids = rng.integers(0, 128, (2, 12))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
    ref = jmixtral.MixtralForCausalLM(jcfg).apply({"params": tree}, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_remat_counts_each_aux_term_once(params):
    """Under remat the backward runs each layer again; those recomputes add
    no aux term, and loss and gradients equal the model without remat."""
    batch = {"input_ids": torch.from_numpy(_ids(2)).long()}
    out = {}
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        named = dict(model.named_parameters())
        bound = BoundModel(model, named)
        loss = mixtral_loss_fn(bound, batch)
        with collecting_intermediates() as during_backward:
            loss.backward()
        assert during_backward == {}
        assert len(bound.extra_state["intermediates"]["aux_loss"]) == model.config.num_layers
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in named.items()})
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, atol=0, rtol=0, msg=name)


def test_extra_state_is_emptied_every_forward(params):
    model = _port_model(params)
    bound = BoundModel(model, dict(model.named_parameters()))
    ids = torch.from_numpy(_ids(3)).long()
    with torch.no_grad():
        bound(ids)
        first = list(bound.extra_state["intermediates"]["aux_loss"])
        bound(ids)
    assert len(first) == len(bound.extra_state["intermediates"]["aux_loss"]) == 2


def test_capacity_drops_pass_through_residual(params):
    model = _port_model(params, capacity_factor=0.01)
    with torch.no_grad():
        out = model(torch.from_numpy(_ids(1, s=8)).long())
    assert torch.isfinite(out).all()


def test_sliding_window_plumbs_through(params):
    ids = torch.from_numpy((np.arange(24)[None, :] % 7)).long()
    outs = {}
    for window in (None, 4):
        assert _cfg(sliding_window=window).as_llama().sliding_window == window
        with torch.no_grad():
            outs[window] = _port_model(params, sliding_window=window)(ids)
    torch.testing.assert_close(outs[None][:, :4], outs[4][:, :4], atol=1e-5, rtol=1e-5)
    assert (outs[None][:, 10:] - outs[4][:, 10:]).abs().max() > 1e-4


def test_refusals():
    with pytest.raises(NotImplementedError, match="21.3"):
        mixtral_sharding_rules()
    with pytest.raises(NotImplementedError, match="21.3"):
        moe.moe_sharding_rules()
    with pytest.raises(NotImplementedError, match="ring"):
        MixtralForCausalLM(_cfg(attention_impl="ring"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MixtralForCausalLM(_cfg())
    with pytest.raises(ValueError, match="make_cache"):
        MixtralForCausalLM(_cfg(), device="cpu")(torch.zeros((1, 4), dtype=torch.long),
                                                 decode=True)
